"""The CaiT LayerScale block, fused for Hopper (kernel 1 of the slice).

    x += dp1 * gamma1 * drop(proj(talking_heads(LN1 x)))
    x += dp2 * gamma2 * drop(fc2(drop(GELU(fc1(LN2 x)))))

Replaces the TPU kernels spe_tpu/ops/pallas_block.py:548
`fused_layer_scale_block`: the forward (`_fwd_call` :483, `pallas_call`
:495, body `_block_fwd_kernel` :166) in its eval and training forms, and
the backward (`_bwd_call` :513, `pallas_call` :530, body
`_block_bwd_kernel` :225).

**Eval** (no grad, no dropout). The TPU kernel keeps (q_tile=512, N) logit
rows of all H heads in VMEM, which a Hopper SM cannot hold. Without
attention dropout the op is linear after the softmax and becomes H
online-softmax passes plus an H x H epilogue:

    P_g = softmax((q (.) row_g) . k^T + bl_g)   (the wl-fold, over all of D)
    out_j = sum_g ww[j, g] (P_g V)_j + bw_j colsum(V_j)

Launches: ln_linear (LN1 + qkv), attention (4 mixed heads of width 192, k
and v shared), colsum, th_mix, ln_linear (proj + gamma1 residual, f32
stream), ln_linear (LN2 + fc1 + GELU), ln_linear (fc2 + gamma2 residual).

**Training.** Attention dropout sits after the post-softmax mix, so the
mix cannot move past PV. The training forward computes the logits s_g of
one call into a (B, H, N, N) f32 plane (spe_gemm), takes each row's
log-sum-exp per mixed head (saved, (B, H, N)), then mixes, drops and
writes zd in bf16 for zd_g . V_g (th_fwd_rows, spe_gemm). The MLP and
projection launches carry the counter dropout and DropPath in their
epilogues (refmath `counter_keep`). It saves x, the attention output o
(bf16), the post-dropout MLP output md (f32) and the statistics: about
13 MB per block at B=8, N=1024, against ~0.4 GB of f32 (B, 4, N, N)
tensors that autograd keeps through the plain layers. The backward
recomputes the linear parts and follows _block_bwd_kernel step by step
(spe_gemm products, th_bwd_rows for the mix and softmax, th_dq for the
fold, ln_backward, branch_backward); every parameter gradient is a sum of
partials reduced in a fixed order, so two runs give the same bits. What
bounds it on the H100: the products (about 10 B N^2 D attention operations
plus twice the forward's linear products per backward), the attention and
the backward's on the tensor cores (attention.cu, grad.cu), the forward's
linear products on the CUDA cores (linear.cu).

Dispatch is by tensor device only: CPU tensors take the plain versions
(`layer_scale_block_reference` at eval, `layer_scale_block_train_reference`
and `layer_scale_block_backward_reference` in training), CUDA tensors the
kernels (bf16 only; anything else raises). `fused_layer_scale_block`
counts its CUDA launches: `.launches` (eval), `.train_launches` (training
forward) and `.bwd_launches` (backward).
"""

from __future__ import annotations

import torch

from spe_tpu_torch.ops import kernels as K
from spe_tpu_torch.ops.kernels import as_bf16 as _bf, as_f32 as _f
from spe_tpu_torch.ops.refmath import (SITE_ATTN, SITE_HIDDEN, SITE_OUT,
                                       SITE_PATH1, SITE_PATH2, SITE_PROJ,
                                       CounterDropout, drop_path, drop_site,
                                       gelu_tanh, gelu_tanh_grad, layer_norm,
                                       ln_backward_reference, merge_heads, mm,
                                       needs_grad, no_dropout, split_heads,
                                       weight_grad)

EPS = 1e-6
PARAM_NAMES = (
    "norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
    "attn.proj_l.weight", "attn.proj_l.bias", "attn.proj_w.weight",
    "attn.proj_w.bias", "attn.proj.weight", "attn.proj.bias", "gamma_1",
    "norm2.weight", "norm2.bias", "mlp.fc1.weight", "mlp.fc1.bias",
    "mlp.fc2.weight", "mlp.fc2.bias", "gamma_2")
# the matrices the kernels read in the working dtype: their gradients come
# back rounded to it, as JAX's `_fused_bwd` casts them (pallas_block.py:591)
ROUNDED = ("attn.qkv.weight", "attn.proj.weight", "mlp.fc1.weight",
           "mlp.fc2.weight")


def _fold_rows(p, H, dh):
    """(H, D) f32: row_g[h*dh:(h+1)*dh] = scale * wl[h, g] (the wl-fold)."""
    return (p["attn.proj_l.weight"].float() * dh ** -0.5).repeat_interleave(
        dh, dim=1)


def fold_attention(q, k, v, p, num_heads, drop=None):
    """The block's talking-heads attention as the fused block's kernels
    compute it, through the wl-fold. q/k/v: (B, N, D) in the working
    dtype; p the block's parameters; drop: a refmath.Dropout (its `attn`
    rate on the post-mix probabilities) or None -> (B, N, D) in v's
    dtype."""
    dt = v.dtype
    H = num_heads
    # wl-fold: mixed_g = sum_h wl[g, h] (scale q_h k_h^T) = (q (.) row_g) k^T
    rows = _fold_rows(p, H, q.shape[-1] // H)                  # (H, D)
    qg = (q.float()[:, None] * rows[None, :, None, :]).to(dt)  # (B, H, N, D)
    logits = qg.float() @ k.float()[:, None].transpose(-1, -2)
    logits = logits + p["attn.proj_l.bias"].float()[None, :, None, None]
    probs = torch.softmax(logits, dim=-1)
    z = torch.einsum("bhqk,gh->bgqk", probs, p["attn.proj_w.weight"].float())
    z = z + p["attn.proj_w.bias"].float()[None, :, None, None]
    z = drop_site(drop, z, "attn")
    return merge_heads(z.to(dt).float() @ split_heads(v, H).float()).to(dt)


def layer_scale_block_reference(x, p, num_heads, drop=None,
                                attention=fold_attention):
    """Plain PyTorch version. x: (B, N, D); p: {PARAM_NAMES: tensor} in the
    reference state-dict layout (proj_l/proj_w are (H, H) Linear weights,
    out x in). Rounds where the TPU kernel rounds. drop: a refmath.Dropout
    for the training forward, at the JAX flax block's sites (attention.py
    :124-131, layers.py:38-41, cait.py:150-154): `attn` on the post-mix
    probabilities, `proj` on the projection and both MLP outputs, DropPath
    on each gamma-scaled branch. attention(q, k, v, p, num_heads, drop):
    the talking-heads attention, by default `fold_attention`
    (`talking_heads.block_attention` with use_pallas_attention)."""
    dt = x.dtype
    D = x.shape[-1]
    h1 = layer_norm(x, p["norm1.weight"], p["norm1.bias"], EPS).to(dt)
    qkv = mm(h1, p["attn.qkv.weight"], p["attn.qkv.bias"]).to(dt)
    q, k, v = qkv.split(D, dim=-1)
    o = attention(q, k, v, p, num_heads, drop)
    h = drop_site(drop, mm(o, p["attn.proj.weight"], p["attn.proj.bias"]),
                  "proj")
    x1 = x.float() + drop_path(drop, p["gamma_1"].float() * h)
    h2 = layer_norm(x1, p["norm2.weight"], p["norm2.bias"], EPS).to(dt)
    u = gelu_tanh(mm(h2, p["mlp.fc1.weight"], p["mlp.fc1.bias"]))
    u = drop_site(drop, u, "proj").to(dt)
    m = drop_site(drop, mm(u, p["mlp.fc2.weight"], p["mlp.fc2.bias"]), "proj")
    return (x1 + drop_path(drop, p["gamma_2"].float() * m)).to(dt)


def _attention_train(x, p, H, drop, lse=None):
    """The recomputable front of the training forward: (h1, q, k, v, rows,
    qg, probs, zd, lse) of the plain version; with `lse` given (the
    backward), the probabilities are rebuilt from it as the kernels do."""
    dt = x.dtype
    D = x.shape[-1]
    h1 = layer_norm(x, p["norm1.weight"], p["norm1.bias"], EPS).to(dt)
    qkv = mm(h1, p["attn.qkv.weight"], p["attn.qkv.bias"]).to(dt)
    q, k, v = qkv.split(D, dim=-1)
    rows = _fold_rows(p, H, D // H)
    qg = (q.float()[:, None] * rows[None, :, None, :]).to(dt)
    s = qg.float() @ k.float()[:, None].transpose(-1, -2)
    s = s + p["attn.proj_l.bias"].float()[None, :, None, None]
    if lse is None:
        lse = torch.logsumexp(s, dim=-1)
    probs = torch.exp(s - lse[..., None])
    z = torch.einsum("bhqk,gh->bgqk", probs, p["attn.proj_w.weight"].float())
    z = z + p["attn.proj_w.bias"].float()[None, :, None, None]
    zd = drop.site(z, SITE_ATTN, drop.attn, head_dim=True)
    return h1, q, k, v, rows, qg, probs, zd, lse


def layer_scale_block_train_reference(x, p, num_heads, drop=None):
    """Plain training forward with the counter masks (refmath.CounterDropout;
    None: every rate 0) -> (out, o (B, N, D) in x's dtype, md (B, N, D) f32,
    lse (B, H, N) f32: each mixed head's row log-sum-exp)."""
    drop = drop or no_dropout(x.device)
    dt = x.dtype
    B = x.shape[0]
    H = num_heads
    _, _, _, v, _, _, _, zd, lse = _attention_train(x, p, H, drop)
    o = merge_heads(zd.to(dt).float() @ split_heads(v, H).float()).to(dt)
    x1, _ = _proj_branch(x, o, p, drop)
    h2 = layer_norm(x1, p["norm2.weight"], p["norm2.bias"], EPS).to(dt)
    _, ugd = _fc1(h2, p, drop)
    m = mm(ugd, p["mlp.fc2.weight"], p["mlp.fc2.bias"])
    md = drop.site(m, SITE_OUT, drop.proj)
    out = x1 + drop.path_factor(SITE_PATH2, B) * p["gamma_2"].float() * md
    return out.to(dt), o, md, lse


def _proj_branch(x, o, p, drop):
    """-> (x1 = x + dp1 * gamma1 * aod, aod) in f32."""
    ao = mm(o, p["attn.proj.weight"], p["attn.proj.bias"])
    aod = drop.site(ao, SITE_PROJ, drop.proj)
    dp1 = drop.path_factor(SITE_PATH1, x.shape[0])
    return x.float() + dp1 * p["gamma_1"].float() * aod, aod


def _fc1(h2, p, drop):
    """-> (u pre-activation f32, ugd = drop(GELU(u)) in h2's dtype)."""
    u = mm(h2, p["mlp.fc1.weight"], p["mlp.fc1.bias"])
    return u, drop.site(gelu_tanh(u), SITE_HIDDEN, drop.proj).to(h2.dtype)


def layer_scale_block_backward_reference(dy, x, o, md, lse, p, num_heads,
                                         drop=None):
    """Plain, hand-derived backward mirroring `_block_bwd_kernel`
    (pallas_block.py:328-456) step by step, rounding where it rounds (dm,
    du, dao, dzd's operands, dmix and dqkv to the working dtype before each
    product). -> (dx in x's dtype, {PARAM_NAMES: f32 gradient}); the
    ROUNDED matrices' gradients come back rounded to the working dtype."""
    drop = drop or no_dropout(x.device)
    dt = x.dtype
    B, N, D = x.shape
    H = num_heads
    dh = D // H
    scale = dh ** -0.5

    def c(t):   # the working-dtype rounding before a product
        return t.to(dt).float()

    h1, q, k, v, rows, qg, probs, zd, _ = _attention_train(x, p, H, drop,
                                                           lse)
    x1, aod = _proj_branch(x, o, p, drop)
    h2 = layer_norm(x1, p["norm2.weight"], p["norm2.bias"], EPS).to(dt)
    u, ugd = _fc1(h2, p, drop)
    dp1 = drop.path_factor(SITE_PATH1, B)
    dp2 = drop.path_factor(SITE_PATH2, B)
    g = {}

    dy = dy.float()
    # MLP branch: out = x1 + dp2 * gamma2 * md
    g["gamma_2"] = (dy * dp2 * md).sum((0, 1))
    dm = drop.site(dy * dp2 * p["gamma_2"].float(), SITE_OUT, drop.proj)
    g["mlp.fc2.weight"] = weight_grad(c(dm), ugd)
    g["mlp.fc2.bias"] = dm.sum((0, 1))
    dugd = c(dm) @ c(p["mlp.fc2.weight"])
    du = drop.site(dugd, SITE_HIDDEN, drop.proj) * gelu_tanh_grad(u)
    g["mlp.fc1.weight"] = weight_grad(c(du), h2)
    g["mlp.fc1.bias"] = du.sum((0, 1))
    dh2 = c(du) @ c(p["mlp.fc1.weight"])
    dx1_ln, g["norm2.weight"], g["norm2.bias"] = ln_backward_reference(
        dh2, x1, p["norm2.weight"], EPS)
    dx1 = dy + dx1_ln

    # attention branch: x1 = x + dp1 * gamma1 * aod
    g["gamma_1"] = (dx1 * dp1 * aod).sum((0, 1))
    dao = drop.site(dx1 * dp1 * p["gamma_1"].float(), SITE_PROJ, drop.proj)
    g["attn.proj.weight"] = weight_grad(c(dao), o)
    g["attn.proj.bias"] = dao.sum((0, 1))
    do = c(c(dao) @ c(p["attn.proj.weight"]))              # (B, N, D)

    # talking heads: z_g = sum_h ww[g, h] p_h + bw_g, zd = drop(z)
    do_h = split_heads(do, H)                               # (B, G, N, dh)
    dzd = do_h @ split_heads(v, H).float().transpose(-1, -2)
    dv = c(zd).transpose(-1, -2) @ do_h                     # (B, G, N, dh)
    dz = drop.site(dzd, SITE_ATTN, drop.attn, head_dim=True)
    ww = p["attn.proj_w.weight"].float()
    dpr = torch.einsum("bgqk,gh->bhqk", dz, ww)
    g["attn.proj_w.weight"] = torch.einsum("bhqk,bgqk->gh", probs, dz)
    g["attn.proj_w.bias"] = dz.sum((0, 2, 3))
    ds = probs * (dpr - (dpr * probs).sum(-1, keepdim=True))
    dqt = c(ds) @ k.float()[:, None]                        # (B, G, N, D)
    dk = torch.einsum("bgqk,bgqc->bkc", c(ds), qg.float())
    dq = (dqt * rows[None, :, None, :]).sum(1)
    qdq = q.float()[:, None] * dqt                          # (B, G, N, D)
    g["attn.proj_l.weight"] = scale * qdq.reshape(B, H, N, H, dh).sum(
        (0, 2, 4))
    g["attn.proj_l.bias"] = ds.sum((0, 2, 3))
    dqkv = torch.cat([dq, dk, merge_heads(dv)], dim=-1)     # (B, N, 3D)
    g["attn.qkv.weight"] = weight_grad(c(dqkv), h1)
    g["attn.qkv.bias"] = dqkv.sum((0, 1))
    dh1 = c(dqkv) @ c(p["attn.qkv.weight"])
    dx_ln, g["norm1.weight"], g["norm1.bias"] = ln_backward_reference(
        dh1, x, p["norm1.weight"], EPS)
    for name in ROUNDED:
        g[name] = c(g[name])
    return (dx1 + dx_ln).to(x.dtype), g


def _forward_cuda(x, p, num_heads):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the fused block kernels take bf16, got {x.dtype}")
    B, N, D = x.shape
    H = num_heads
    dh = D // H
    x2 = x.reshape(B * N, D)
    qkv = K.ln_linear(x2, _bf(p["attn.qkv.weight"]), _f(p["attn.qkv.bias"]),
                      ln=(_f(p["norm1.weight"]), _f(p["norm1.bias"]), EPS))
    qkv = qkv.view(B, N, 3 * D)
    rows = _fold_rows(p, H, dh).contiguous()
    pv = torch.empty((B, N, H, D), device=x.device, dtype=torch.float32)
    K.attention(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:],
                pv.view(B, N, H * D), num_heads=H, dq=D, dv=D, q_hs=0,
                k_hs=0, v_hs=0, o_hs=D, qscale=rows,
                hbias=_f(p["attn.proj_l.bias"]))
    o = K.th_mix(pv, K.colsum(qkv[..., 2 * D:]), _f(p["attn.proj_w.weight"]),
                 _f(p["attn.proj_w.bias"]))
    x1 = K.ln_linear(o.view(B * N, D), _bf(p["attn.proj.weight"]),
                     _f(p["attn.proj.bias"]), res=x2, gamma=_f(p["gamma_1"]),
                     out_dtype=torch.float32)
    u = K.ln_linear(x1, _bf(p["mlp.fc1.weight"]), _f(p["mlp.fc1.bias"]),
                    ln=(_f(p["norm2.weight"]), _f(p["norm2.bias"]), EPS),
                    act="gelu")
    out = K.ln_linear(u, _bf(p["mlp.fc2.weight"]), _f(p["mlp.fc2.bias"]),
                      res=x1, gamma=_f(p["gamma_2"]))
    return out.view(B, N, D)


def _logits_cuda(qg, qkv3):
    """s_g = q~_g . k^T -> (B, H, N, N) f32 (without the head bias)."""
    B, H, N, D = qg.shape
    s = torch.empty((B, H, N, N), device=qg.device, dtype=torch.float32)
    return K.gemm(qg, qkv3[..., D:], s, M=N, N=N, K=D, nb=(B, H),
                  a_str=(H * N * D, N * D, D, 1),
                  b_str=(N * 3 * D, 0, 1, 3 * D),
                  c_str=(H * N * N, N * N, N, 1))


def _proj_cuda(x2, o2, p, drop, N, aux=None):
    """x1 = x + dp1 * gamma1 * drop(o @ Wp^T + bp), f32 (M, D)."""
    return K.ln_linear(o2, _bf(p["attn.proj.weight"]), _f(p["attn.proj.bias"]),
                       res=x2, gamma=_f(p["gamma_1"]), out_dtype=torch.float32,
                       seed=drop.seed, drop=(SITE_PROJ, drop.proj),
                       path=(SITE_PATH1, drop.path), rows_per_sample=N,
                       aux=aux)


def _fc1_cuda(x1, p, drop, N, ln, aux=None):
    """drop(GELU(LN2?(x1) @ W1^T + b1)) bf16; aux receives the
    pre-activation."""
    return K.ln_linear(x1, _bf(p["mlp.fc1.weight"]), _f(p["mlp.fc1.bias"]),
                       ln=ln, act="gelu", seed=drop.seed,
                       drop=(SITE_HIDDEN, drop.proj), rows_per_sample=N,
                       aux=aux, aux_pre=True)


def _train_cuda(x, p, num_heads, drop):
    """The kernels' training forward -> (out, o, md, lse) as the plain
    version returns them."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the fused block kernels take bf16, got {x.dtype}")
    B, N, D = x.shape
    H = num_heads
    dh = D // H
    x2 = x.reshape(B * N, D)
    qkv = K.ln_linear(x2, _bf(p["attn.qkv.weight"]), _f(p["attn.qkv.bias"]),
                      ln=(_f(p["norm1.weight"]), _f(p["norm1.bias"]), EPS))
    qkv3 = qkv.view(B, N, 3 * D)
    qg = K.th_fold(qkv3[..., :D], _fold_rows(p, H, dh).contiguous())
    s = _logits_cuda(qg, qkv3)
    lse, zd = K.th_fwd_rows(s, _f(p["attn.proj_l.bias"]),
                            _f(p["attn.proj_w.weight"]),
                            _f(p["attn.proj_w.bias"]), drop.seed, drop.attn)
    del s, qg
    o = torch.empty((B, N, D), device=x.device, dtype=torch.bfloat16)
    K.gemm(zd, qkv3[..., 2 * D:], o, M=N, N=dh, K=N, nb=(B, H),
           a_str=(H * N * N, N * N, N, 1), b_str=(N * 3 * D, dh, 3 * D, 1),
           c_str=(N * D, dh, D, 1))
    del zd
    x1 = _proj_cuda(x2, o.view(B * N, D), p, drop, N)
    u = _fc1_cuda(x1, p, drop, N,
                  ln=(_f(p["norm2.weight"]), _f(p["norm2.bias"]), EPS))
    md = torch.empty((B * N, D), device=x.device, dtype=torch.float32)
    out = K.ln_linear(u, _bf(p["mlp.fc2.weight"]), _f(p["mlp.fc2.bias"]),
                      res=x1, gamma=_f(p["gamma_2"]), seed=drop.seed,
                      drop=(SITE_OUT, drop.proj), path=(SITE_PATH2, drop.path),
                      rows_per_sample=N, aux=md)
    return out.view(B, N, D), o, md.view(B, N, D), lse


def _backward_cuda(dy, x, o, md, lse, p, num_heads, drop):
    """The kernels' backward -> (dx, {PARAM_NAMES: gradient}) as the plain
    version returns them."""
    B, N, D = x.shape
    H = num_heads
    dh = D // H
    M = B * N
    F32 = torch.float32
    seed = drop.seed
    x2, o2 = x.reshape(M, D), o.reshape(M, D)
    w = {n: _bf(p[n]) for n in ROUNDED}
    g = {}
    # recompute the linear parts (the forward's launches, same bits)
    _, h1 = K.layernorm(x2, _f(p["norm1.weight"]), _f(p["norm1.bias"]), EPS,
                        want_f32=False, want_bf16=True)
    qkv = K.ln_linear(h1, w["attn.qkv.weight"], _f(p["attn.qkv.bias"]))
    qkv3 = qkv.view(B, N, 3 * D)
    aod = torch.empty((M, D), device=x.device, dtype=F32)
    x1 = _proj_cuda(x2, o2, p, drop, N, aux=aod)
    _, h2 = K.layernorm(x1, _f(p["norm2.weight"]), _f(p["norm2.bias"]), EPS,
                        want_f32=False, want_bf16=True)
    u = torch.empty((M, w["mlp.fc1.weight"].shape[0]), device=x.device,
                    dtype=F32)
    ugd = _fc1_cuda(h2, p, drop, N, ln=None, aux=u)

    dy2 = dy.reshape(M, D).float()
    # MLP branch
    dm, g["gamma_2"] = K.branch_backward(
        dy2, md.reshape(M, D), _f(p["gamma_2"]), seed=seed,
        drop=(SITE_OUT, drop.proj), path=(SITE_PATH2, drop.path),
        rows_per_sample=N)
    g["mlp.fc2.weight"] = K.grad_weight(dm, ugd)
    g["mlp.fc2.bias"] = K.colsum_f32(dm)
    du = K.matmul_dx(dm, w["mlp.fc2.weight"], seed=seed,
                     drop=(SITE_HIDDEN, drop.proj), rows_per_sample=N,
                     gelu_aux=u)
    g["mlp.fc1.weight"] = K.grad_weight(du, h2)
    g["mlp.fc1.bias"] = K.colsum_f32(du)
    dh2 = K.matmul_dx(du, w["mlp.fc1.weight"])
    dx1, g["norm2.weight"], g["norm2.bias"] = K.ln_backward(
        dh2, x1, _f(p["norm2.weight"]), EPS, res=dy2)
    # attention branch
    dao, g["gamma_1"] = K.branch_backward(
        dx1, aod, _f(p["gamma_1"]), seed=seed, drop=(SITE_PROJ, drop.proj),
        path=(SITE_PATH1, drop.path), rows_per_sample=N)
    g["attn.proj.weight"] = K.grad_weight(dao, o2)
    g["attn.proj.bias"] = K.colsum_f32(dao)
    do = K.matmul_dx(dao, w["attn.proj.weight"])            # (M, D) f32
    # talking heads
    rows = _fold_rows(p, H, dh).contiguous()
    qg = K.th_fold(qkv3[..., :D], rows)
    s = _logits_cuda(qg, qkv3)
    dzd = torch.empty((B, H, N, N), device=x.device, dtype=F32)
    K.gemm(do, qkv3[..., 2 * D:], dzd, M=N, N=N, K=dh, nb=(B, H),
           a_str=(N * D, dh, D, 1), b_str=(N * 3 * D, dh, 1, 3 * D),
           c_str=(H * N * N, N * N, N, 1))
    zd, ds, g["attn.proj_w.weight"], g["attn.proj_w.bias"], \
        g["attn.proj_l.bias"] = K.th_bwd_rows(
            s, lse, dzd, _f(p["attn.proj_l.bias"]),
            _f(p["attn.proj_w.weight"]), _f(p["attn.proj_w.bias"]), seed,
            drop.attn)
    del s, dzd
    dqkv = torch.empty((B, N, 3 * D), device=x.device, dtype=F32)
    K.gemm(zd, do, dqkv[..., 2 * D:], M=N, N=dh, K=N, nb=(B, H),   # dV_g
           a_str=(H * N * N, N * N, 1, N), b_str=(N * D, dh, D, 1),
           c_str=(N * 3 * D, dh, 3 * D, 1))
    del zd
    dqt = torch.empty((B, H, N, D), device=x.device, dtype=F32)
    K.gemm(ds, qkv3[..., D:2 * D], dqt, M=N, N=D, K=N, nb=(B, H),  # dq~_g
           a_str=(H * N * N, N * N, N, 1), b_str=(N * 3 * D, 0, 3 * D, 1),
           c_str=(H * N * D, N * D, D, 1))
    # dQ and dwl while dq~ (25 MB at the recipe's shape) is still in L2
    g["attn.proj_l.weight"] = K.th_dq(dqt, qkv3[..., :D], rows, dh ** -0.5,
                                      dqkv[..., :D])
    del dqt
    K.gemm(ds, qg, dqkv[..., D:2 * D], M=N, N=D, K=H * N, nb=(B, 1),  # dK
           a_str=(H * N * N, 0, 1, N), b_str=(H * N * D, 0, D, 1),
           c_str=(N * 3 * D, 0, 3 * D, 1))
    del ds, qg
    dqkv2 = dqkv.view(M, 3 * D)
    g["attn.qkv.weight"] = K.grad_weight(dqkv2, h1)
    g["attn.qkv.bias"] = K.colsum_f32(dqkv2)
    dh1 = K.matmul_dx(dqkv2, w["attn.qkv.weight"])
    dx, g["norm1.weight"], g["norm1.bias"] = K.ln_backward(
        dh1, x2, _f(p["norm1.weight"]), EPS, res=dx1, out_dtype=x.dtype)
    return dx.view(B, N, D), g


def _plain(t):
    """The device dispatch: CPU tensors take the plain versions."""
    return t.device.type == "cpu"


class LayerScaleBlockFn(torch.autograd.Function):
    """The block in training: forward and backward each dispatched by the
    device of x (CPU: the plain versions; CUDA: the kernels)."""

    @staticmethod
    def forward(ctx, x, seed, rates, num_heads, *params):
        p = dict(zip(PARAM_NAMES, params))
        drop = CounterDropout(seed, *rates)
        if _plain(x):
            out, o, md, lse = layer_scale_block_train_reference(
                x, p, num_heads, drop)
        else:
            out, o, md, lse = _train_cuda(x, p, num_heads, drop)
            fused_layer_scale_block.train_launches += 1
        ctx.save_for_backward(x, seed, o, md, lse, *params)
        ctx.rates, ctx.num_heads = rates, num_heads
        return out

    @staticmethod
    def backward(ctx, dy):
        x, seed, o, md, lse, *params = ctx.saved_tensors
        p = dict(zip(PARAM_NAMES, params))
        drop = CounterDropout(seed, *ctx.rates)
        if _plain(x):
            dx, g = layer_scale_block_backward_reference(
                dy, x, o, md, lse, p, ctx.num_heads, drop)
        else:
            dx, g = _backward_cuda(dy, x, o, md, lse, p, ctx.num_heads, drop)
            fused_layer_scale_block.bwd_launches += 1
        need = ctx.needs_input_grad
        grads = [g[n].to(t.dtype) if need[4 + i] else None
                 for i, (n, t) in enumerate(zip(PARAM_NAMES, params))]
        return (dx if need[0] else None, None, None, None, *grads)


def fused_layer_scale_block(x, params, num_heads, drop=None):
    """One CaiT LayerScale block. x: (B, N, D); drop: a
    refmath.CounterDropout in training, or None. With grad needed on x or
    a parameter, or any dropout rate: the autograd Function; otherwise the
    eval forward."""
    p = {n: params[n] for n in PARAM_NAMES}
    if needs_grad([x, *p.values()]) or (drop is not None and any(drop.rates)):
        drop = drop or no_dropout(x.device)
        return LayerScaleBlockFn.apply(x, drop.seed, drop.rates, num_heads,
                                       *p.values())
    if _plain(x):
        return layer_scale_block_reference(x, p, num_heads)
    out = _forward_cuda(x, p, num_heads)
    fused_layer_scale_block.launches += 1
    return out


fused_layer_scale_block.launches = 0
fused_layer_scale_block.train_launches = 0
fused_layer_scale_block.bwd_launches = 0
