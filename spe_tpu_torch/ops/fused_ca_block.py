"""The CaiT class-attention token block, fused for Hopper (kernel 2).

    u  = LN1([cls ++ x]);  o = class_attention(q(u[:t]), k(u), v(u))
    c1 = cls + gamma1 * proj(o);  c2 = c1 + gamma2 * MLP(LN2 c1)
    returns (c2, attn) with attn (B, H, t, t+P) f32 — block 0's is the CAM

Replaces the TPU kernels spe_tpu/ops/pallas_ca_block.py:268
`fused_class_attn_block`: the forward (`_fwd_call` :217, `pallas_call` :228,
body `_ca_fwd_kernel` :58) and the backward (`_bwd_call` :243,
`pallas_call` :253, body `_ca_bwd_kernel` :104).

The t = 21 query rows and N = 1045 keys are both ragged; the attention
kernel masks its edge tiles instead of padding. The probabilities are an
output (the CAM reads them), so the attention kernel's second pass writes
them exactly normalised, exp(s - m) / l with the final row max and sum.

Forward launches: ln_linear (LN1 + q|k|v over [cls ++ x]), attention (4
heads of 48, probabilities on), ln_linear (proj + gamma1 residual, f32),
ln_linear (LN2 + fc1 + GELU), ln_linear (fc2 + gamma2 residual; in
training also the f32 MLP output `mm`, saved with the attention output
`o`). The backward takes the probabilities from the forward instead of
recomputing the softmax, recomputes the linear parts, and runs the
products through spe_gemm (the per-head dp, dV, dq, dk included),
softmax_backward, ln_backward and branch_backward, with a `dattn`
cotangent when the CAM carries one (in the port's training step it is
detached, so there is none and nothing launches for it). What bounds it
on the H100: the k/v projections of all 1045 rows and their gradients,
and the f32 write of the (B, 4, 21, 1045) map; the t-row products are
small.

`fused_class_attn_block` chooses by device only: CPU tensors go to the
plain versions, CUDA tensors to the kernels (bf16 only). The block has no
dropout sites: the JAX package passes none to it (cait.py:209-218). It
counts its CUDA launches: `.launches` (eval), `.train_launches`,
`.bwd_launches`.
"""

from __future__ import annotations

import torch

from spe_tpu_torch.ops import kernels as K
from spe_tpu_torch.ops.kernels import as_bf16 as _bf, as_f32 as _f
from spe_tpu_torch.ops.refmath import (gelu_tanh, gelu_tanh_grad, layer_norm,
                                       ln_backward_reference, merge_heads, mm,
                                       needs_grad, scale_in, split_heads,
                                       weight_grad)
from spe_tpu_torch.parallel.tp import NO_TP

EPS = 1e-6
PARAM_NAMES = (
    "norm1.weight", "norm1.bias", "attn.q.weight", "attn.q.bias",
    "attn.k.weight", "attn.k.bias", "attn.v.weight", "attn.v.bias",
    "attn.proj.weight", "attn.proj.bias", "gamma_1", "norm2.weight",
    "norm2.bias", "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight",
    "mlp.fc2.bias", "gamma_2")
ROUNDED = ("attn.q.weight", "attn.k.weight", "attn.v.weight",
           "attn.proj.weight", "mlp.fc1.weight", "mlp.fc2.weight")


def class_attention(q, k, v, num_heads, key_padding_mask=None, drop=None,
                    return_attn=True):
    """Class attention as the fused block's kernels compute it: q (B, t, D)
    pre-scaled in the working dtype (refmath.scale_in), k/v (B, t+P, D);
    no mask, no dropout (the block has none) -> (o (B, t, D) in v's dtype,
    probabilities (B, H, t, t+P) f32)."""
    dt = v.dtype
    H = num_heads
    dh = q.shape[-1] // H
    qh = (split_heads(q, H).float() * scale_in(dt, dh ** -0.5)).to(dt)
    logits = qh.float() @ split_heads(k, H).float().transpose(-1, -2)
    attn = torch.softmax(logits, dim=-1)
    o = merge_heads(attn.to(dt).float() @ split_heads(v, H).float()).to(dt)
    return o, attn


def class_attn_block_train_reference(cls, x, p, num_heads,
                                     attention=class_attention, tp=NO_TP):
    """Plain PyTorch version of the training forward. cls: (B, t, D) class
    tokens; x: (B, P, D) patches. Returns (new cls (B, t, D), attn (B, H,
    t, t+P) f32, o (B, t, D) in cls's dtype, mm (B, t, D) f32: the MLP
    output before gamma2). attention(q, k, v, num_heads, return_attn=True)
    -> (o, probabilities): by default `class_attention`
    (`fused_mha.layer_attention` with use_pallas_attention). Under tensor
    parallelism (`tp`) p holds this rank's shards: q's, k's, v's and fc1's
    rows (column-parallel), proj's and fc2's columns (row-parallel); the
    attention runs on its num_heads / tp.size heads and its probabilities
    are gathered over every head (the CAM reweights them across heads); o
    is this rank's columns."""
    dt = cls.dtype
    t = cls.shape[1]
    un = tp.copy(layer_norm(torch.cat([cls, x], dim=1), p["norm1.weight"],
                            p["norm1.bias"], EPS).to(dt))
    q = tp.col(un[:, :t], p["attn.q.weight"], p["attn.q.bias"]).to(dt)
    k = tp.col(un, p["attn.k.weight"], p["attn.k.bias"]).to(dt)
    v = tp.col(un, p["attn.v.weight"], p["attn.v.bias"]).to(dt)
    o, attn = attention(q, k, v, num_heads // tp.size, return_attn=True)
    o = o.to(dt)
    c1 = cls.float() + p["gamma_1"].float() * tp.row(
        o, p["attn.proj.weight"], p["attn.proj.bias"])
    h2 = layer_norm(c1, p["norm2.weight"], p["norm2.bias"], EPS).to(dt)
    u = gelu_tanh(tp.col(tp.copy(h2), p["mlp.fc1.weight"],
                         p["mlp.fc1.bias"])).to(dt)
    m = tp.row(u, p["mlp.fc2.weight"], p["mlp.fc2.bias"])
    return (c1 + p["gamma_2"].float() * m).to(dt), tp.gather(attn, 1), o, m


def class_attn_block_reference(cls, x, p, num_heads,
                               attention=class_attention, tp=NO_TP):
    """Plain PyTorch version -> (new cls (B, t, D), attn (B, H, t, t+P) f32)."""
    return class_attn_block_train_reference(cls, x, p, num_heads,
                                            attention, tp)[:2]


def class_attn_block_backward_reference(dy, dattn, cls, x, attn, o, m, p,
                                        num_heads):
    """Plain, hand-derived backward mirroring `_ca_bwd_kernel`
    (pallas_ca_block.py:123-197), rounding where it rounds. dattn: the
    probabilities' cotangent or None. The forward rounds the q scale to
    the working dtype (scale_in); the backward, like the TPU kernel, uses
    the f32 dh^-0.5. -> (dcls, dx, {PARAM_NAMES: f32 gradient})."""
    dt = cls.dtype
    B, t, D = cls.shape
    H = num_heads
    dh = D // H
    scale = dh ** -0.5

    def c(a):
        return a.to(dt).float()

    u = torch.cat([cls, x], dim=1)
    un = layer_norm(u, p["norm1.weight"], p["norm1.bias"], EPS).to(dt)
    q = mm(un[:, :t], p["attn.q.weight"], p["attn.q.bias"]).to(dt)
    k = mm(un, p["attn.k.weight"], p["attn.k.bias"]).to(dt)
    v = mm(un, p["attn.v.weight"], p["attn.v.bias"]).to(dt)
    ao = mm(o, p["attn.proj.weight"], p["attn.proj.bias"])
    c1 = cls.float() + p["gamma_1"].float() * ao
    h2 = layer_norm(c1, p["norm2.weight"], p["norm2.bias"], EPS).to(dt)
    u2 = mm(h2, p["mlp.fc1.weight"], p["mlp.fc1.bias"])
    ug = gelu_tanh(u2)
    g = {}

    dy = dy.float()
    g["gamma_2"] = (dy * m).sum((0, 1))
    dm = dy * p["gamma_2"].float()
    g["mlp.fc2.weight"] = weight_grad(c(dm), c(ug))
    g["mlp.fc2.bias"] = dm.sum((0, 1))
    du2 = (c(dm) @ c(p["mlp.fc2.weight"])) * gelu_tanh_grad(u2)
    g["mlp.fc1.weight"] = weight_grad(c(du2), h2)
    g["mlp.fc1.bias"] = du2.sum((0, 1))
    dh2 = c(du2) @ c(p["mlp.fc1.weight"])
    dc1_ln, g["norm2.weight"], g["norm2.bias"] = ln_backward_reference(
        dh2, c1, p["norm2.weight"], EPS)
    dc1 = dy + dc1_ln
    g["gamma_1"] = (dc1 * ao).sum((0, 1))
    dao = dc1 * p["gamma_1"].float()
    g["attn.proj.weight"] = weight_grad(c(dao), o)
    g["attn.proj.bias"] = dao.sum((0, 1))
    do_h = split_heads(c(c(dao) @ c(p["attn.proj.weight"])), H)  # (B, H, t, dh)

    dp = do_h @ split_heads(v, H).float().transpose(-1, -2)       # (B, H, t, N)
    dv = c(attn).transpose(-1, -2) @ do_h                         # (B, H, N, dh)
    if dattn is not None:
        dp = dp + dattn.float()
    dl = c(attn * (dp - (dp * attn).sum(-1, keepdim=True)))
    dq = merge_heads(scale * (dl @ split_heads(k, H).float()))
    dk = merge_heads(scale * (dl.transpose(-1, -2) @ split_heads(q, H).float()))
    dv = merge_heads(dv)
    for n, d, rows in (("q", dq, un[:, :t]), ("k", dk, un), ("v", dv, un)):
        g[f"attn.{n}.weight"] = weight_grad(c(d), rows)
        g[f"attn.{n}.bias"] = d.sum((0, 1))
    dun = c(dk) @ c(p["attn.k.weight"]) + c(dv) @ c(p["attn.v.weight"])
    dun = torch.cat([dun[:, :t] + c(dq) @ c(p["attn.q.weight"]), dun[:, t:]],
                    dim=1)
    du, g["norm1.weight"], g["norm1.bias"] = ln_backward_reference(
        dun, u, p["norm1.weight"], EPS)
    for name in ROUNDED:
        g[name] = c(g[name])
    return (dc1 + du[:, :t]).to(cls.dtype), du[:, t:].to(x.dtype), g


def _qkv_weights(p):
    return (_bf(torch.cat([p["attn.q.weight"], p["attn.k.weight"],
                           p["attn.v.weight"]])),
            _f(torch.cat([p["attn.q.bias"], p["attn.k.bias"],
                          p["attn.v.bias"]])))


def _forward_cuda(cls, x, p, num_heads, mm_out=None):
    """The kernels' forward -> (new cls, attn, o); with mm_out (B*t, D) f32
    the fc2 launch also writes the MLP output there (the training form)."""
    if cls.dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise TypeError("the fused class-attention kernels take bf16, got "
                        f"{cls.dtype}/{x.dtype}")
    B, t, D = cls.shape
    N = t + x.shape[1]
    H = num_heads
    dh = D // H
    u = torch.cat([cls, x], dim=1).reshape(B * N, D)
    w_qkv, b_qkv = _qkv_weights(p)
    qkv = K.ln_linear(u, w_qkv, b_qkv,
                      ln=(_f(p["norm1.weight"]), _f(p["norm1.bias"]), EPS))
    qkv = qkv.view(B, N, 3 * D)
    o = torch.empty((B, t, D), device=cls.device, dtype=torch.bfloat16)
    attn = torch.empty((B, H, t, N), device=cls.device, dtype=torch.float32)
    qscale = torch.full((H, dh), scale_in(torch.bfloat16, dh ** -0.5),
                        device=cls.device, dtype=torch.float32)
    K.attention(qkv[:, :t, :D], qkv[..., D:2 * D], qkv[..., 2 * D:], o,
                num_heads=H, dq=dh, dv=dh, q_hs=dh, k_hs=dh, v_hs=dh,
                o_hs=dh, qscale=qscale, probs=attn)
    cls2 = cls.reshape(B * t, D)
    c1 = K.ln_linear(o.view(B * t, D), _bf(p["attn.proj.weight"]),
                     _f(p["attn.proj.bias"]), res=cls2, gamma=_f(p["gamma_1"]),
                     out_dtype=torch.float32)
    h = K.ln_linear(c1, _bf(p["mlp.fc1.weight"]), _f(p["mlp.fc1.bias"]),
                    ln=(_f(p["norm2.weight"]), _f(p["norm2.bias"]), EPS),
                    act="gelu")
    out = K.ln_linear(h, _bf(p["mlp.fc2.weight"]), _f(p["mlp.fc2.bias"]),
                      res=c1, gamma=_f(p["gamma_2"]), aux=mm_out)
    return out.view(B, t, D), attn, o


def _train_cuda(cls, x, p, num_heads):
    """The kernels' training forward -> (new cls, attn, o, mm)."""
    B, t, D = cls.shape
    m = torch.empty((B * t, D), device=cls.device, dtype=torch.float32)
    out, attn, o = _forward_cuda(cls, x, p, num_heads, mm_out=m)
    return out, attn, o, m.view(B, t, D)


def _backward_cuda(dy, dattn, cls, x, attn, o, m, p, num_heads):
    """The kernels' backward -> (dcls, dx, {PARAM_NAMES: gradient})."""
    B, t, D = cls.shape
    N = t + x.shape[1]
    H = num_heads
    dh = D // H
    F32 = torch.float32
    w = {n: _bf(p[n]) for n in ROUNDED}
    g = {}
    u = torch.cat([cls, x], dim=1).reshape(B * N, D)
    _, un = K.layernorm(u, _f(p["norm1.weight"]), _f(p["norm1.bias"]), EPS,
                        want_f32=False, want_bf16=True)
    w_qkv, b_qkv = _qkv_weights(p)
    qkv = K.ln_linear(un, w_qkv, b_qkv).view(B, N, 3 * D)
    o2 = o.reshape(B * t, D)
    ao = torch.empty((B * t, D), device=cls.device, dtype=F32)
    c1 = K.ln_linear(o2, w["attn.proj.weight"], _f(p["attn.proj.bias"]),
                     res=cls.reshape(B * t, D), gamma=_f(p["gamma_1"]),
                     out_dtype=F32, aux=ao)
    _, h2 = K.layernorm(c1, _f(p["norm2.weight"]), _f(p["norm2.bias"]), EPS,
                        want_f32=False, want_bf16=True)
    u2 = torch.empty((B * t, w["mlp.fc1.weight"].shape[0]), device=cls.device,
                     dtype=F32)
    ug = K.ln_linear(h2, w["mlp.fc1.weight"], _f(p["mlp.fc1.bias"]),
                     act="gelu", aux=u2, aux_pre=True)

    dy2 = dy.reshape(B * t, D).float()
    dm, g["gamma_2"] = K.branch_backward(dy2, m.reshape(B * t, D),
                                         _f(p["gamma_2"]))
    g["mlp.fc2.weight"] = K.grad_weight(dm, ug)
    g["mlp.fc2.bias"] = K.colsum_f32(dm)
    du2 = K.matmul_dx(dm, w["mlp.fc2.weight"], gelu_aux=u2)
    g["mlp.fc1.weight"] = K.grad_weight(du2, h2)
    g["mlp.fc1.bias"] = K.colsum_f32(du2)
    dh2 = K.matmul_dx(du2, w["mlp.fc1.weight"])
    dc1, g["norm2.weight"], g["norm2.bias"] = K.ln_backward(
        dh2, c1, _f(p["norm2.weight"]), EPS, res=dy2)
    dao, g["gamma_1"] = K.branch_backward(dc1, ao, _f(p["gamma_1"]))
    g["attn.proj.weight"] = K.grad_weight(dao, o2)
    g["attn.proj.bias"] = K.colsum_f32(dao)
    do = K.matmul_dx(dao, w["attn.proj.weight"])            # (B*t, D) f32

    dp = torch.empty((B, H, t, N), device=cls.device, dtype=F32)
    K.gemm(do, qkv[..., 2 * D:], dp, M=t, N=N, K=dh, nb=(B, H),
           a_str=(t * D, dh, D, 1), b_str=(N * 3 * D, dh, 1, 3 * D),
           c_str=(H * t * N, t * N, N, 1))
    dqkv = torch.zeros((B, N, 3 * D), device=cls.device, dtype=F32)
    K.gemm(attn, do, dqkv[..., 2 * D:], M=N, N=dh, K=t, nb=(B, H),   # dV
           a_str=(H * t * N, t * N, 1, N), b_str=(t * D, dh, D, 1),
           c_str=(N * 3 * D, dh, 3 * D, 1))
    dl = K.softmax_backward(attn, dp, dattn)
    del dp
    scale = dh ** -0.5
    K.gemm(dl, qkv[..., D:2 * D], dqkv, M=t, N=dh, K=N, nb=(B, H),  # dq
           a_str=(H * t * N, t * N, N, 1), b_str=(N * 3 * D, dh, 3 * D, 1),
           c_str=(N * 3 * D, dh, 3 * D, 1), alpha=scale)
    K.gemm(dl, qkv, dqkv[..., D:2 * D], M=N, N=dh, K=t, nb=(B, H),  # dk
           a_str=(H * t * N, t * N, 1, N), b_str=(N * 3 * D, dh, 3 * D, 1),
           c_str=(N * 3 * D, dh, 3 * D, 1), alpha=scale)
    dqkv2 = dqkv.view(B * N, 3 * D)
    dw = K.grad_weight(dqkv2, un)
    db = K.colsum_f32(dqkv2)
    for i, n in enumerate(("q", "k", "v")):
        g[f"attn.{n}.weight"] = dw[i * D:(i + 1) * D]
        g[f"attn.{n}.bias"] = db[i * D:(i + 1) * D]
    dun = K.matmul_dx(dqkv2, w_qkv)
    du, g["norm1.weight"], g["norm1.bias"] = K.ln_backward(
        dun, u, _f(p["norm1.weight"]), EPS)
    du = du.view(B, N, D)
    dcls = (dc1.view(B, t, D) + du[:, :t]).to(cls.dtype)
    return dcls, du[:, t:].to(x.dtype), g


def _plain(t):
    """The device dispatch: CPU tensors take the plain versions."""
    return t.device.type == "cpu"


class ClassAttnBlockFn(torch.autograd.Function):
    """The class-attention block in training, each direction dispatched by
    the device of cls (CPU: the plain versions; CUDA: the kernels)."""

    @staticmethod
    def forward(ctx, cls, x, num_heads, *params):
        p = dict(zip(PARAM_NAMES, params))
        if _plain(cls):
            out, attn, o, m = class_attn_block_train_reference(cls, x, p,
                                                               num_heads)
        else:
            out, attn, o, m = _train_cuda(cls, x, p, num_heads)
            fused_class_attn_block.train_launches += 1
        ctx.save_for_backward(cls, x, attn, o, m, *params)
        ctx.num_heads = num_heads
        ctx.set_materialize_grads(False)   # no dattn when the CAM is detached
        return out, attn

    @staticmethod
    def backward(ctx, dy, dattn):
        cls, x, attn, o, m, *params = ctx.saved_tensors
        p = dict(zip(PARAM_NAMES, params))
        if dy is None:
            dy = torch.zeros_like(cls)
        if _plain(cls):
            dcls, dx, g = class_attn_block_backward_reference(
                dy, dattn, cls, x, attn, o, m, p, ctx.num_heads)
        else:
            dcls, dx, g = _backward_cuda(dy, dattn, cls, x, attn, o, m, p,
                                         ctx.num_heads)
            fused_class_attn_block.bwd_launches += 1
        need = ctx.needs_input_grad
        grads = [g[n].to(t.dtype) if need[3 + i] else None
                 for i, (n, t) in enumerate(zip(PARAM_NAMES, params))]
        return (dcls if need[0] else None, dx if need[1] else None, None,
                *grads)


def fused_class_attn_block(cls, x, params, num_heads):
    """One class-attention block -> (new cls, attn f32): the autograd
    Function when a gradient is needed, else the eval forward."""
    p = {n: params[n] for n in PARAM_NAMES}
    if needs_grad([cls, x, *p.values()]):
        return ClassAttnBlockFn.apply(cls, x, num_heads, *p.values())
    if _plain(cls):
        return class_attn_block_reference(cls, x, p, num_heads)
    out = _forward_cuda(cls, x, p, num_heads)[:2]
    fused_class_attn_block.launches += 1
    return out


fused_class_attn_block.launches = 0
fused_class_attn_block.train_launches = 0
fused_class_attn_block.bwd_launches = 0
