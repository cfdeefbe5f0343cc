"""Standalone CaiT talking-heads attention for Hopper (B5).

    L_h = dh^-0.5 q_h . k_h^T                  (f32, per head)
    m_g = sum_h wl[g, h] L_h + bl_g;  P_g = softmax(m_g)
    z_j = sum_g ww[j, g] P_g + bw_j;  out_j = drop(z_j) . v_j

Replaces the TPU kernels spe_tpu/ops/pallas_attention.py:112
`talking_heads_attention` (`pallas_call` :132, body `_kernel` :30) and its
backward spe_tpu/ops/pallas_attention_bwd.py:191 `fused_talking_heads`
(`_bwd_call` :136, `pallas_call` :152, body `_bwd_kernel` :40). They serve
the patch blocks with `use_pallas_attention` and the fused block off
(spe_tpu/models/attention.py:85-111): the block's LN, qkv, projection, MLP
and dropout stay plain, only its attention runs here.

wl and ww are (H, H) in the torch Linear layout (out x in), as the port's
modules hold `attn.proj_l.weight` and `attn.proj_w.weight`: the JAX
package's (in x out) matrices transposed. q/k/v are the port's (B, N, H*dh)
head-strided views (any row stride, the last dim contiguous): the block
slices them out of its qkv rows without a copy. The output is in q's dtype.

On the card the TPU kernel's (q_tile, N) rows of every head, held in VMEM,
become device planes of one call (the fused block's training form does the
same): spe_gemm writes the per-head logits L (B, H, N, N) f32 at the scale,
the row pass th_fwd_rows mixes them with wl in f32 as the TPU kernel does
(no wl-fold: the eval block's fold rounds q (.) row_g to bf16, which this
kernel does not), takes each mixed row's log-sum-exp (saved for the
backward), mixes the probabilities with ww, applies the counter dropout at
site TH_ATTN and writes zd in bf16; spe_gemm takes zd_j . v_j. The
backward follows _bwd_kernel step by step: L and dzd = dY . V^T (spe_gemm),
th_bwd_rows with wl (zd, dL_h = sum_g wl[g, h] dm_g in bf16 and per row
partials of dww, dbw, dbl and dwl, reduced in a fixed order), then dV =
zd^T dY, dQ = scale dL . K and dK = scale dL^T . Q (spe_gemm). Two runs of
the backward give the same bits. What bounds it on the H100: the N^2 dh
products per head, two forward and five backward (compute), and the f32
planes (bytes); spe_gemm runs the products on the tensor cores.

Dispatch is by tensor device only: CPU tensors take the plain versions
(`talking_heads_reference`, `talking_heads_train_reference`,
`talking_heads_backward_reference`), CUDA tensors the kernels (bf16 only;
anything else raises). `talking_heads_attention` counts its CUDA launches:
`.launches` (no grad, no dropout), `.train_launches` (the autograd
Function's forward) and `.bwd_launches`.
"""

from __future__ import annotations

import torch

from spe_tpu_torch.ops import kernels as K
from spe_tpu_torch.ops.kernels import as_f32 as _f
from spe_tpu_torch.ops.refmath import (SITE_TH_ATTN, CounterDropout,
                                       draw_seed, merge_heads, needs_grad,
                                       no_dropout, split_heads)

PARAM_NAMES = ("proj_l.weight", "proj_l.bias", "proj_w.weight",
               "proj_w.bias")


def _logits(q, k, p, H):
    """(L (B, H, N, N) f32 per-head scaled logits, m the mixed logits + bl)."""
    dh = q.shape[-1] // H
    L = (split_heads(q, H).float()
         @ split_heads(k, H).float().transpose(-1, -2)) * dh ** -0.5
    m = torch.einsum("bhqk,gh->bgqk", L, p["proj_l.weight"].float())
    return L, m + p["proj_l.bias"].float()[None, :, None, None]


def _mix_out(probs, v, p, H, drop):
    """zd = drop(ww . P + bw) and the output merge(zd_j . v_j) in v's dtype."""
    z = torch.einsum("bgqk,jg->bjqk", probs, p["proj_w.weight"].float())
    z = z + p["proj_w.bias"].float()[None, :, None, None]
    zd = drop.site(z, SITE_TH_ATTN, drop.attn, head_dim=True)
    out = merge_heads(zd.to(v.dtype).float() @ split_heads(v, H).float())
    return zd, out.to(v.dtype)


def talking_heads_train_reference(q, k, v, p, num_heads, drop=None):
    """Plain PyTorch version of `_kernel` (pallas_attention.py:30-81) as the
    kernels compute it in training. q/k/v (B, N, H*dh); p {PARAM_NAMES:
    tensor}; drop: a refmath.CounterDropout (its attention rate, keys (b,
    g, q, k) at site TH_ATTN) or None -> (out (B, N, H*dh) in q's dtype,
    lse (B, H, N) f32: each mixed row's log-sum-exp, saved for the
    backward)."""
    drop = drop or no_dropout(q.device)
    _, m = _logits(q, k, p, num_heads)
    lse = torch.logsumexp(m, dim=-1)
    out = _mix_out(torch.exp(m - lse[..., None]), v, p, num_heads, drop)[1]
    return out.to(q.dtype), lse


def talking_heads_reference(q, k, v, p, num_heads, drop=None):
    """The plain eval forward: `talking_heads_train_reference` without the
    lse -> (B, N, H*dh) in q's dtype."""
    return talking_heads_train_reference(q, k, v, p, num_heads, drop)[0]


def talking_heads_backward_reference(dy, q, k, v, lse, p, num_heads,
                                     drop=None):
    """Plain, hand-derived backward mirroring `_bwd_kernel`
    (pallas_attention_bwd.py:40-133) step by step: the operands of every
    product in the input dtype (zd and dL rounded to it), the mixes,
    softmax and dropout in f32. -> (dq, dk, dv in the inputs' dtypes,
    {PARAM_NAMES: f32 gradient summed over the batch})."""
    drop = drop or no_dropout(q.device)
    H = num_heads
    dt = q.dtype
    scale = (q.shape[-1] // H) ** -0.5
    L, m = _logits(q, k, p, H)
    probs = torch.exp(m - lse[..., None])
    zd, _ = _mix_out(probs, v, p, H, drop)
    dyh = split_heads(dy.to(dt).float(), H)
    dv = zd.to(dt).float().transpose(-1, -2) @ dyh
    dz = drop.site(dyh @ split_heads(v, H).float().transpose(-1, -2),
                   SITE_TH_ATTN, drop.attn, head_dim=True)
    g = {"proj_w.weight": torch.einsum("bgqk,bjqk->jg", probs, dz),
         "proj_w.bias": dz.sum((0, 2, 3))}
    dp = torch.einsum("bjqk,jg->bgqk", dz, p["proj_w.weight"].float())
    dm = probs * (dp - (dp * probs).sum(-1, keepdim=True))
    g["proj_l.bias"] = dm.sum((0, 2, 3))
    g["proj_l.weight"] = torch.einsum("bhqk,bgqk->gh", L, dm)
    dl = torch.einsum("bgqk,gh->bhqk", dm,
                      p["proj_l.weight"].float()).to(dt).float()
    dq = scale * (dl @ split_heads(k, H).float())
    dk = scale * (dl.transpose(-1, -2) @ split_heads(q, H).float())
    return (merge_heads(dq).to(dt), merge_heads(dk).to(k.dtype),
            merge_heads(dv).to(v.dtype), g)


def _need_bf16(*ts):
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise TypeError("the talking-heads kernels take bf16, got "
                            f"{t.dtype}")


def _heads_str(t, dh):
    """(batch, head, row) strides of a (B, N, H*dh) view."""
    return t.stride(0), dh, t.stride(1)


def _planes(a, b, H, N, dh, alpha=1.0):
    """(B, H, N, N) f32 = alpha * a_h . b_h^T of two (B, N, H*dh) views."""
    B = a.shape[0]
    out = torch.empty((B, H, N, N), device=a.device, dtype=torch.float32)
    sa, sb = _heads_str(a, dh), _heads_str(b, dh)
    return K.gemm(a, b, out, M=N, N=N, K=dh, nb=(B, H), alpha=alpha,
                  a_str=(sa[0], sa[1], sa[2], 1),
                  b_str=(sb[0], sb[1], 1, sb[2]),
                  c_str=(H * N * N, N * N, N, 1))


def _train_cuda(q, k, v, p, num_heads, drop=None):
    """The kernels' forward -> (out (B, N, H*dh) bf16, lse (B, H, N) f32)."""
    _need_bf16(q, k, v)
    drop = drop or no_dropout(q.device)
    B, N, D = q.shape
    H = num_heads
    dh = D // H
    s = _planes(q, k, H, N, dh, dh ** -0.5)
    lse, zd = K.th_fwd_rows(s, _f(p["proj_l.bias"]), _f(p["proj_w.weight"]),
                            _f(p["proj_w.bias"]), drop.seed, drop.attn,
                            wl=_f(p["proj_l.weight"]), site=SITE_TH_ATTN)
    del s
    out = torch.empty((B, N, D), device=q.device, dtype=q.dtype)
    sv = _heads_str(v, dh)
    K.gemm(zd, v, out, M=N, N=dh, K=N, nb=(B, H),
           a_str=(H * N * N, N * N, N, 1), b_str=(sv[0], sv[1], sv[2], 1),
           c_str=(N * D, dh, D, 1))
    return out, lse


def _forward_cuda(q, k, v, p, num_heads):
    """The kernels' eval forward (the training form at rate 0)."""
    return _train_cuda(q, k, v, p, num_heads)[0]


def _backward_cuda(dy, q, k, v, lse, p, num_heads, drop=None):
    """The kernels' backward -> (dq, dk, dv, {PARAM_NAMES: gradient}) as the
    plain version returns them."""
    drop = drop or no_dropout(q.device)
    B, N, D = q.shape
    H = num_heads
    dh = D // H
    scale = dh ** -0.5
    dy = dy.to(q.dtype).contiguous()
    s = _planes(q, k, H, N, dh, scale)
    dzd = _planes(dy, v, H, N, dh)
    zd, dl, dww, dbw, dbl, dwl = K.th_bwd_rows(
        s, lse, dzd, _f(p["proj_l.bias"]), _f(p["proj_w.weight"]),
        _f(p["proj_w.bias"]), drop.seed, drop.attn,
        wl=_f(p["proj_l.weight"]), site=SITE_TH_ATTN)
    del s, dzd
    grads = []
    plane = (H * N * N, N * N)
    # dV_j = zd_j^T dY_j, dQ_h = scale dL_h . K_h, dK_h = scale dL_h^T . Q_h
    for a, a_t, b, alpha in ((zd, True, dy, 1.0), (dl, False, k, scale),
                             (dl, True, q, scale)):
        out = torch.empty((B, N, D), device=q.device, dtype=torch.float32)
        sb = _heads_str(b, dh)
        K.gemm(a, b, out, M=N, N=dh, K=N, nb=(B, H), alpha=alpha,
               a_str=(*plane, 1, N) if a_t else (*plane, N, 1),
               b_str=(sb[0], sb[1], sb[2], 1), c_str=(N * D, dh, D, 1))
        grads.append(out)
    dv, dq, dk = grads
    g = {"proj_l.weight": dwl, "proj_l.bias": dbl, "proj_w.weight": dww,
         "proj_w.bias": dbw}
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), g


def _plain(t):
    """The device dispatch: CPU tensors take the plain versions."""
    return t.device.type == "cpu"


class TalkingHeadsFn(torch.autograd.Function):
    """The attention in training: forward and backward each dispatched by
    the device of q (CPU: the plain versions; CUDA: the kernels)."""

    @staticmethod
    def forward(ctx, q, k, v, seed, rate, num_heads, *params):
        p = dict(zip(PARAM_NAMES, params))
        drop = CounterDropout(seed, attn=rate)
        if _plain(q):
            out, lse = talking_heads_train_reference(q, k, v, p, num_heads,
                                                     drop)
        else:
            out, lse = _train_cuda(q, k, v, p, num_heads, drop)
            talking_heads_attention.train_launches += 1
        ctx.save_for_backward(q, k, v, seed, lse, *params)
        ctx.rate, ctx.num_heads = rate, num_heads
        return out

    @staticmethod
    def backward(ctx, dy):
        q, k, v, seed, lse, *params = ctx.saved_tensors
        p = dict(zip(PARAM_NAMES, params))
        drop = CounterDropout(seed, attn=ctx.rate)
        if _plain(q):
            dq, dk, dv, g = talking_heads_backward_reference(
                dy, q, k, v, lse, p, ctx.num_heads, drop)
        else:
            dq, dk, dv, g = _backward_cuda(dy, q, k, v, lse, p,
                                           ctx.num_heads, drop)
            talking_heads_attention.bwd_launches += 1
        need = ctx.needs_input_grad
        grads = [g[n].to(t.dtype) if need[6 + i] else None
                 for i, (n, t) in enumerate(zip(PARAM_NAMES, params))]
        return (dq if need[0] else None, dk if need[1] else None,
                dv if need[2] else None, None, None, None, *grads)


def talking_heads_attention(q, k, v, params, num_heads, drop=None):
    """The standalone talking-heads attention. q/k/v: (B, N, H*dh) views;
    params: {PARAM_NAMES: tensor}; drop: a refmath.CounterDropout (its
    `attn` rate) or None. With grad needed or a dropout rate: the autograd
    Function; otherwise the eval forward."""
    p = {n: params[n] for n in PARAM_NAMES}
    if needs_grad([q, k, v, *p.values()]) or (drop is not None and drop.attn):
        drop = drop or no_dropout(q.device)
        return TalkingHeadsFn.apply(q, k, v, drop.seed, drop.attn, num_heads,
                                    *p.values())
    if _plain(q):
        return talking_heads_reference(q, k, v, p, num_heads)
    out = _forward_cuda(q, k, v, p, num_heads)
    talking_heads_attention.launches += 1
    return out


talking_heads_attention.launches = 0
talking_heads_attention.train_launches = 0
talking_heads_attention.bwd_launches = 0


def block_attention(q, k, v, p, num_heads, drop=None):
    """The patch block's attention through this kernel, as the plain block
    (fused_block.layer_scale_block_reference) calls it: q/k/v (B, N, D),
    p the block's parameters (`attn.proj_l.weight`, ...), drop the plain
    block's refmath.Dropout or None. One seed per call, drawn from its
    generator when the attention rate is on, as JAX draws one per
    fused_talking_heads call (attention.py:98-101)."""
    cd = None
    if drop is not None and drop.attn > 0.0:
        cd = CounterDropout(draw_seed(drop.gen, q.device), attn=drop.attn)
    return talking_heads_attention(q, k, v,
                                   {n: p[f"attn.{n}"] for n in PARAM_NAMES},
                                   num_heads, cd)
