"""The post-norm DETR encoder layer, fused for Hopper (kernel 3).

    s   = LN1(x + drop(out_proj(MHA(q=k=x+pos, v=x, key-padding bias))))
    out = LN2(s + drop(linear2(drop(relu(linear1(s))))))     (LN eps 1e-5)

Replaces the TPU kernels spe_tpu/ops/pallas_encoder.py:375
`fused_encoder_layer`: the forward (`_fwd_call` :314, `pallas_call` :327,
body `_enc_fwd_kernel` :129) in its eval and training forms, and the
backward (`_bwd_call` :344, `pallas_call` :357, body `_enc_bwd_kernel`
:181).

**Eval** launches per layer: ln_linear (q|k from x+pos, the sum rounded
once as the TPU kernel rounds qk_in), ln_linear (v), attention (8 heads of
24, key bias -1e9 on padded keys, scale after the dot), ln_linear
(out_proj + residual, f32), layernorm, ln_linear (linear1 + ReLU),
ln_linear (linear2 + residual, f32), layernorm. The attention kernel pads
the head width of 24 to a q.k depth of 32 for its m16n8k16 products.

**Training.** The same launches carry the four dropout sites (counter
masks, refmath `counter_keep`): the attention kernel drops the
probabilities inside its online softmax and writes each row's log-sum-exp,
and the projection launches drop in their epilogues. The forward saves x,
pos, the attention output o (bf16), the post-dropout FFN output h2d (f32)
and the log-sum-exp (B, H, N) f32, as the TPU kernel's `save_residuals`
form saves o and h2, and linear1's pre-activation u (bf16): its sign is
the backward's ReLU mask, so a backward on the same saved tensors takes
the forward's ReLU decisions whatever its own recompute rounds (about 44
MB per layer at B=8, N=1024, against the (B, 8, N, N) f32 probabilities
autograd keeps through the plain layer). The backward recomputes the
other linear parts and follows _enc_bwd_kernel :250-296 step by step: ln_backward, dropout_grad, grad_weight, colsum_f32,
matmul_dx (ReLU mask in its epilogue, accumulating into dx), and the
attention backward of kernels.attention_backward (spe_gemm products on
f32 (B, H, N, N) planes of the logits and dO . V^T, the attn_bwd_rows
pass). Every parameter gradient is a sum of partials reduced in a fixed
order, so two runs give the same bits. What bounds it on the H100: the
FFN products (2 x N x 192 x 2048 multiply-adds per image and direction)
and the 8-head attention: the attention and the backward products on the
tensor cores, the forward's linear products on the CUDA cores.

Dispatch is by tensor device only: CPU tensors take the plain versions
(`encoder_layer_reference` at eval, `encoder_layer_train_reference` and
`encoder_layer_backward_reference` in training), CUDA tensors the kernels
(bf16 only; anything else raises). `fused_encoder_layer` counts its CUDA
launches: `.launches` (eval), `.train_launches` (training forward) and
`.bwd_launches` (backward).
"""

from __future__ import annotations

import torch

from spe_tpu_torch.ops import kernels as K
from spe_tpu_torch.ops.kernels import as_bf16 as _bf, as_f32 as _f
from spe_tpu_torch.ops.refmath import (SITE_ATTN, SITE_HIDDEN, SITE_OUT,
                                       SITE_PROJ, CounterDropout, drop_site,
                                       key_bias, layer_norm,
                                       ln_backward_reference, merge_heads, mm,
                                       needs_grad, no_dropout, split_heads,
                                       weight_grad)

EPS = 1e-5
PARAM_NAMES = (
    "self_attn.in_proj_weight", "self_attn.in_proj_bias",
    "self_attn.out_proj.weight", "self_attn.out_proj.bias", "norm1.weight",
    "norm1.bias", "linear1.weight", "linear1.bias", "linear2.weight",
    "linear2.bias", "norm2.weight", "norm2.bias")
# the matrices the kernels read in the working dtype: their gradients come
# back rounded to it, as JAX's `_fused_bwd` casts them (pallas_encoder.py:408)
ROUNDED = ("self_attn.in_proj_weight", "self_attn.out_proj.weight",
           "linear1.weight", "linear2.weight")


def softmax_attention(q, k, v, num_heads, key_padding_mask=None, drop=None,
                      return_attn=False):
    """softmax(q . k^T * dq^-0.5 + bias) v per head as the fused layers'
    kernels compute it: f32 logits, the scale after the dot, -1e9 on
    padded keys, the probabilities through `drop`'s attention dropout and
    rounded to v's dtype before the PV product. q/k: (B, Nq|Nk, H*dq), v:
    (B, Nk, H*dv); drop: a refmath.Dropout or None -> (B, Nq, H*dv) in v's
    dtype (and the probabilities f32 with return_attn)."""
    dt = v.dtype
    H = num_heads
    logits = (split_heads(q, H).float()
              @ split_heads(k, H).float().transpose(-1, -2)) * (
                  q.shape[-1] // H) ** -0.5
    bias = key_bias(key_padding_mask, k.shape[0], k.shape[1], q.device)
    if bias is not None:
        logits = logits + bias[:, None, None, :]
    probs = torch.softmax(logits, dim=-1)
    attn = drop_site(drop, probs, "attn")
    o = merge_heads(attn.to(dt).float() @ split_heads(v, H).float()).to(dt)
    return (o, probs) if return_attn else o


def encoder_layer_reference(x, pos, key_padding_mask, p, num_heads,
                            drop=None, attention=softmax_attention):
    """Plain PyTorch version. x/pos: (B, N, D); key_padding_mask: (B, N)
    bool, True = padded key, or None. drop: a refmath.Dropout for the
    training forward at the JAX flax layer's four sites (transformer.py
    :117-131): `attn` on the attention probabilities, `proj` on the
    attention output, the ReLU and the second linear's output.
    attention(q, k, v, num_heads, key_padding_mask, drop): the
    self-attention, by default `softmax_attention`
    (`fused_mha.layer_attention` with use_pallas_attention)."""
    dt = x.dtype
    D = x.shape[-1]
    w, b = p["self_attn.in_proj_weight"], p["self_attn.in_proj_bias"]
    qk_in = (x.float() + pos.float()).to(dt)
    q = mm(qk_in, w[:D], b[:D]).to(dt)
    k = mm(qk_in, w[D:2 * D], b[D:2 * D]).to(dt)
    v = mm(x, w[2 * D:], b[2 * D:]).to(dt)
    o = attention(q, k, v, num_heads, key_padding_mask, drop).to(dt)
    h = drop_site(drop, mm(o, p["self_attn.out_proj.weight"],
                           p["self_attn.out_proj.bias"]), "proj")
    s1 = layer_norm(x.float() + h, p["norm1.weight"], p["norm1.bias"], EPS)
    u = torch.relu(mm(s1.to(dt), p["linear1.weight"], p["linear1.bias"]))
    u = drop_site(drop, u, "proj")
    h2 = drop_site(drop, mm(u.to(dt), p["linear2.weight"], p["linear2.bias"]),
                   "proj")
    return layer_norm(s1 + h2, p["norm2.weight"], p["norm2.bias"],
                      EPS).to(dt)


def attend_train(q, k, v, num_heads, scale, bias, drop, site, mask_heads,
                 lse=None):
    """Softmax attention in training, as the kernels compute it: logits
    (q . k^T) * scale + bias (B, N) in f32, probabilities exp(logits - lse),
    dropped at `site` (keys (z // mask_heads, z % mask_heads) for z = b * H
    + h), rounded to v's dtype before the product with V. q/k: (B, Nq|Nk,
    H * dq); with `lse` given (the backward) the probabilities are rebuilt
    from it. -> (o (B, Nq, H * dv) f32, probs, zd, lse (B, H, Nq))."""
    H = num_heads
    logits = (split_heads(q, H).float()
              @ split_heads(k, H).float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias[:, None, None, :]
    if lse is None:
        lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    zd = drop.site(probs, site, drop.attn, mask_heads=mask_heads)
    o = merge_heads(zd.to(v.dtype).float() @ split_heads(v, H).float())
    return o, probs, zd, lse


def attend_backward(do, q, k, v, probs, zd, num_heads, scale, drop, site,
                    mask_heads):
    """The backward of `attend_train` as _attn_bwd_loop computes it
    (pallas_encoder.py:97-126): do and dl rounded to the working dtype
    before their products, f32 sums -> (dq, dk, dv) (B, rows, H * d) f32."""
    H = num_heads
    dt = v.dtype
    do_h = split_heads(do.to(dt).float(), H)
    dzd = do_h @ split_heads(v, H).float().transpose(-1, -2)
    dv = zd.to(dt).float().transpose(-1, -2) @ do_h
    dp = drop.site(dzd, site, drop.attn, mask_heads=mask_heads)
    dl = (probs * (dp - (dp * probs).sum(-1, keepdim=True))).to(dt).float()
    dq = scale * (dl @ split_heads(k, H).float())
    dk = scale * (dl.transpose(-1, -2) @ split_heads(q, H).float())
    return merge_heads(dq), merge_heads(dk), merge_heads(dv)


def _front(x, pos, mask, p, H, drop, lse=None):
    """The recomputable attention front of the training forward: (qk_in,
    q, k, v, o f32, probs, zd, lse)."""
    dt = x.dtype
    B, N, D = x.shape
    w, b = p["self_attn.in_proj_weight"], p["self_attn.in_proj_bias"]
    qk_in = (x.float() + pos.float()).to(dt)
    q = mm(qk_in, w[:D], b[:D]).to(dt)
    k = mm(qk_in, w[D:2 * D], b[D:2 * D]).to(dt)
    v = mm(x, w[2 * D:], b[2 * D:]).to(dt)
    o, probs, zd, lse = attend_train(
        q, k, v, H, (D // H) ** -0.5, key_bias(mask, B, N, x.device), drop,
        SITE_ATTN, H, lse)
    return qk_in, q, k, v, o, probs, zd, lse


def _proj_fc1(x, o, p, drop):
    """-> (y1 = x + drop(o Wo + bo) f32, s1 = LN1(y1) f32, u = linear1's
    pre-activation f32, urd = drop(relu(u)) in x's dtype)."""
    ao = mm(o, p["self_attn.out_proj.weight"], p["self_attn.out_proj.bias"])
    y1 = x.float() + drop.site(ao, SITE_PROJ, drop.proj)
    s1 = layer_norm(y1, p["norm1.weight"], p["norm1.bias"], EPS)
    u = mm(s1.to(x.dtype), p["linear1.weight"], p["linear1.bias"])
    urd = drop.site(torch.relu(u), SITE_HIDDEN, drop.proj).to(x.dtype)
    return y1, s1, u, urd


def encoder_layer_train_reference(x, pos, key_padding_mask, p, num_heads,
                                  drop=None):
    """Plain training forward with the counter masks (refmath.CounterDropout;
    None: every rate 0) -> (out, o (B, N, D) in x's dtype, h2d (B, N, D)
    f32: the FFN output after its dropout, lse (B, H, N) f32: each
    attention row's log-sum-exp, u (B, N, F) in x's dtype: linear1's
    pre-activation, whose sign is the backward's ReLU mask)."""
    drop = drop or no_dropout(x.device)
    dt = x.dtype
    *_, o, _, _, lse = _front(x, pos, key_padding_mask, p, num_heads, drop)
    o = o.to(dt)
    _, s1, u, urd = _proj_fc1(x, o, p, drop)
    h2d = drop.site(mm(urd, p["linear2.weight"], p["linear2.bias"]), SITE_OUT,
                    drop.proj)
    out = layer_norm(s1 + h2d, p["norm2.weight"], p["norm2.bias"], EPS)
    return out.to(dt), o, h2d, lse, u.to(dt)


def encoder_layer_backward_reference(dy, x, pos, key_padding_mask, o, h2d,
                                     lse, u, p, num_heads, drop=None):
    """Plain, hand-derived backward mirroring `_enc_bwd_kernel`
    (pallas_encoder.py:250-296) step by step, rounding where it rounds
    (dh2, du, dao, do, dl, dq/dk/dv to the working dtype before each
    product). -> (dx in x's dtype, dpos in pos's dtype, {PARAM_NAMES: f32
    gradient}); the ROUNDED matrices' gradients come back rounded to the
    working dtype."""
    drop = drop or no_dropout(x.device)
    dt = x.dtype
    D = x.shape[-1]
    H = num_heads

    def c(t):   # the working-dtype rounding before a product
        return t.to(dt).float()

    qk_in, q, k, v, _, probs, zd, _ = _front(x, pos, key_padding_mask, p, H,
                                             drop, lse)
    y1, s1, _, urd = _proj_fc1(x, o, p, drop)
    w = p["self_attn.in_proj_weight"]
    g = {}

    dy2, g["norm2.weight"], g["norm2.bias"] = ln_backward_reference(
        dy.float(), s1 + h2d, p["norm2.weight"], EPS)
    # FFN branch: y2 = s1 + drop(linear2(drop(relu(linear1(s1)))))
    dh2 = drop.site(dy2, SITE_OUT, drop.proj)
    g["linear2.weight"] = weight_grad(c(dh2), urd)
    g["linear2.bias"] = dh2.sum((0, 1))
    durd = c(dh2) @ c(p["linear2.weight"])
    du = torch.where(u > 0, drop.site(durd, SITE_HIDDEN, drop.proj), 0.0)
    g["linear1.weight"] = weight_grad(c(du), c(s1))
    g["linear1.bias"] = du.sum((0, 1))
    ds1 = dy2 + c(du) @ c(p["linear1.weight"])
    dy1, g["norm1.weight"], g["norm1.bias"] = ln_backward_reference(
        ds1, y1, p["norm1.weight"], EPS)
    # attention branch: y1 = x + drop(out_proj(o))
    dao = drop.site(dy1, SITE_PROJ, drop.proj)
    g["self_attn.out_proj.weight"] = weight_grad(c(dao), o)
    g["self_attn.out_proj.bias"] = dao.sum((0, 1))
    do = c(dao) @ c(p["self_attn.out_proj.weight"])
    dq, dk, dv = attend_backward(do, q, k, v, probs, zd, H, (D // H) ** -0.5,
                                 drop, SITE_ATTN, H)
    g["self_attn.in_proj_weight"] = torch.cat([
        weight_grad(c(dq), qk_in), weight_grad(c(dk), qk_in),
        weight_grad(c(dv), x)])
    g["self_attn.in_proj_bias"] = torch.cat([dq.sum((0, 1)), dk.sum((0, 1)),
                                             dv.sum((0, 1))])
    dqk_in = c(dq) @ c(w[:D]) + c(dk) @ c(w[D:2 * D])
    dx = dy1 + dqk_in + c(dv) @ c(w[2 * D:])
    for name in ROUNDED:
        g[name] = c(g[name])
    return dx.to(x.dtype), dqk_in.to(pos.dtype), g


def _need_bf16(*ts):
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the fused encoder kernels take bf16, got {t.dtype}")


def _qkv_cuda(x2, pos2, p, D):
    """-> (q|k (M, 2D) bf16 from bf16(x + pos), v (M, D) bf16)."""
    w = _bf(p["self_attn.in_proj_weight"])
    b = _f(p["self_attn.in_proj_bias"])
    return (K.ln_linear(x2, w[:2 * D], b[:2 * D], a2=pos2),
            K.ln_linear(x2, w[2 * D:], b[2 * D:]))


def _attn_args(x, H, mask):
    B, N, D = x.shape
    dh = D // H
    return dict(num_heads=H, dq=dh, dv=dh, q_hs=dh, k_hs=dh, v_hs=dh,
                kbias=key_bias(mask, B, N, x.device), logit_scale=dh ** -0.5)


def _layer_cuda(x, pos, key_padding_mask, p, num_heads, drop=None):
    """The kernels' forward: eval without `drop`, else the training form
    -> (out, o, h2d, lse, u) (the last three None at eval)."""
    _need_bf16(x, pos)
    B, N, D = x.shape
    H = num_heads
    M = B * N
    x2 = x.reshape(M, D)
    qk, v = _qkv_cuda(x2, pos.reshape(M, D), p, D)
    qk, v = qk.view(B, N, 2 * D), v.view(B, N, D)
    o = torch.empty((B, N, D), device=x.device, dtype=torch.bfloat16)
    lse = h2d = u32 = None
    train = {}
    if drop is not None:
        lse = torch.empty((B, H, N), device=x.device, dtype=torch.float32)
        h2d = torch.empty((M, D), device=x.device, dtype=torch.float32)
        u32 = torch.empty((M, p["linear1.weight"].shape[0]), device=x.device,
                          dtype=torch.float32)
        train = dict(seed=drop.seed, drop=(SITE_ATTN, drop.attn), lse=lse)
    K.attention(qk[..., :D], qk[..., D:], v, o, o_hs=D // H,
                **_attn_args(x, H, key_padding_mask), **train)

    def site(s, **kw):   # a projection's dropout site in training
        return {} if drop is None else dict(
            seed=drop.seed, drop=(s, drop.proj), rows_per_sample=N, **kw)

    y1 = K.ln_linear(o.view(M, D), _bf(p["self_attn.out_proj.weight"]),
                     _f(p["self_attn.out_proj.bias"]), res=x2,
                     out_dtype=torch.float32, **site(SITE_PROJ))
    s1, _ = K.layernorm(y1, _f(p["norm1.weight"]), _f(p["norm1.bias"]), EPS)
    urd = K.ln_linear(s1, _bf(p["linear1.weight"]), _f(p["linear1.bias"]),
                      act="relu", **site(SITE_HIDDEN, aux=u32, aux_pre=True))
    y2 = K.ln_linear(urd, _bf(p["linear2.weight"]), _f(p["linear2.bias"]),
                     res=s1, out_dtype=torch.float32,
                     **site(SITE_OUT, aux=h2d))
    _, out = K.layernorm(y2, _f(p["norm2.weight"]), _f(p["norm2.bias"]), EPS,
                         want_f32=False, want_bf16=True)
    if drop is None:
        return out.view(B, N, D), o, None, None, None
    return (out.view(B, N, D), o, h2d.view(B, N, D), lse,
            u32.to(torch.bfloat16).view(B, N, -1))


def _forward_cuda(x, pos, key_padding_mask, p, num_heads):
    return _layer_cuda(x, pos, key_padding_mask, p, num_heads)[0]


def _train_cuda(x, pos, key_padding_mask, p, num_heads, drop):
    """The kernels' training forward -> (out, o, h2d, lse, u) as the plain
    version returns them."""
    return _layer_cuda(x, pos, key_padding_mask, p, num_heads, drop)


def _backward_cuda(dy, x, pos, key_padding_mask, o, h2d, lse, u, p,
                   num_heads, drop):
    """The kernels' backward -> (dx f32, dpos f32, {PARAM_NAMES: gradient})
    as the plain version returns them (dx and dpos before the cast to the
    inputs' dtype)."""
    _need_bf16(x, pos, o)
    B, N, D = x.shape
    H = num_heads
    dh = D // H
    M = B * N
    seed = drop.seed
    x2, pos2, o2 = x.reshape(M, D), pos.reshape(M, D), o.reshape(M, D)
    w = {n: _bf(p[n]) for n in ROUNDED}
    g = {}

    def site(s):
        return dict(seed=seed, drop=(s, drop.proj), rows_per_sample=N)

    # recompute the linear parts (the forward's launches, same bits)
    qk, v = _qkv_cuda(x2, pos2, p, D)
    y1 = K.ln_linear(o2, w["self_attn.out_proj.weight"],
                     _f(p["self_attn.out_proj.bias"]), res=x2,
                     out_dtype=torch.float32, **site(SITE_PROJ))
    s1, _ = K.layernorm(y1, _f(p["norm1.weight"]), _f(p["norm1.bias"]), EPS)
    urd = K.ln_linear(s1, w["linear1.weight"], _f(p["linear1.bias"]),
                      act="relu", **site(SITE_HIDDEN))
    u = u.reshape(M, -1).float()   # the forward's ReLU decisions

    # FFN branch; ds1 accumulates dy2 + du . W1 in place
    ds1, g["norm2.weight"], g["norm2.bias"] = K.ln_backward(
        dy.reshape(M, D).float(), s1 + h2d.reshape(M, D),
        _f(p["norm2.weight"]), EPS)
    dh2 = K.dropout_grad(ds1, seed, (SITE_OUT, drop.proj), N)
    g["linear2.weight"] = K.grad_weight(dh2, urd)
    g["linear2.bias"] = K.colsum_f32(dh2)
    du = K.matmul_dx(dh2, w["linear2.weight"], relu_aux=u,
                     **site(SITE_HIDDEN))
    g["linear1.weight"] = K.grad_weight(du, s1)
    g["linear1.bias"] = K.colsum_f32(du)
    K.matmul_dx(du, w["linear1.weight"], out=ds1)
    dy1, g["norm1.weight"], g["norm1.bias"] = K.ln_backward(
        ds1, y1, _f(p["norm1.weight"]), EPS)
    # attention branch
    dao = K.dropout_grad(dy1, seed, (SITE_PROJ, drop.proj), N)
    g["self_attn.out_proj.weight"] = K.grad_weight(dao, o2)
    g["self_attn.out_proj.bias"] = K.colsum_f32(dao)
    do = K.matmul_dx(dao, w["self_attn.out_proj.weight"])      # (M, D) f32
    dqkv = torch.empty((B, N, 3 * D), device=x.device, dtype=torch.float32)
    qk3 = qk.view(B, N, 2 * D)
    K.attention_backward(
        qk3[..., :D], qk3[..., D:], v.view(B, N, D), do.view(B, N, D), lse,
        do_hs=dh, dq_out=dqkv[..., :D], dk_out=dqkv[..., D:2 * D],
        dv_out=dqkv[..., 2 * D:], dq_hs=dh, dk_hs=dh, dv_hs=dh, seed=seed,
        drop=(SITE_ATTN, drop.attn), **_attn_args(x, H, key_padding_mask))
    dqkv2 = dqkv.view(M, 3 * D)
    qk_in = x2 + pos2                     # bf16(x + pos), as the forward reads it
    g["self_attn.in_proj_weight"] = torch.cat([
        K.grad_weight(dqkv2[:, :2 * D], qk_in),
        K.grad_weight(dqkv2[:, 2 * D:], x2)])
    g["self_attn.in_proj_bias"] = K.colsum_f32(dqkv2)
    w_in = w["self_attn.in_proj_weight"]
    dpos = K.matmul_dx(dqkv2[:, :2 * D], w_in[:2 * D])        # dq Wq + dk Wk
    K.matmul_dx(dqkv2, w_in, out=dy1)                          # dx, in place
    return dy1.view(B, N, D), dpos.view(B, N, D), g


def _plain(t):
    """The device dispatch: CPU tensors take the plain versions."""
    return t.device.type == "cpu"


class EncoderLayerFn(torch.autograd.Function):
    """The encoder layer in training: forward and backward each dispatched
    by the device of x (CPU: the plain versions; CUDA: the kernels)."""

    @staticmethod
    def forward(ctx, x, pos, key_padding_mask, seed, rates, num_heads,
                *params):
        p = dict(zip(PARAM_NAMES, params))
        drop = CounterDropout(seed, *rates)
        if _plain(x):
            out, *saved = encoder_layer_train_reference(
                x, pos, key_padding_mask, p, num_heads, drop)
        else:
            out, *saved = _train_cuda(x, pos, key_padding_mask, p, num_heads,
                                      drop)
            fused_encoder_layer.train_launches += 1
        ctx.save_for_backward(x, pos, key_padding_mask, seed, *saved,
                              *params)
        ctx.rates, ctx.num_heads = rates, num_heads
        return out

    @staticmethod
    def backward(ctx, dy):
        x, pos, mask, seed, o, h2d, lse, u, *params = ctx.saved_tensors
        p = dict(zip(PARAM_NAMES, params))
        drop = CounterDropout(seed, *ctx.rates)
        if _plain(x):
            dx, dpos, g = encoder_layer_backward_reference(
                dy, x, pos, mask, o, h2d, lse, u, p, ctx.num_heads, drop)
        else:
            dx, dpos, g = _backward_cuda(dy, x, pos, mask, o, h2d, lse, u, p,
                                         ctx.num_heads, drop)
            fused_encoder_layer.bwd_launches += 1
        need = ctx.needs_input_grad
        grads = [g[n].to(t.dtype) if need[6 + i] else None
                 for i, (n, t) in enumerate(zip(PARAM_NAMES, params))]
        return (dx.to(x.dtype) if need[0] else None,
                dpos.to(pos.dtype) if need[1] else None, None, None, None,
                None, *grads)


def fused_encoder_layer(x, pos, key_padding_mask, params, num_heads,
                        drop=None):
    """One post-norm encoder layer. x/pos: (B, N, D); drop: a
    refmath.CounterDropout in training, or None. With grad needed on x,
    pos or a parameter, or any dropout rate: the autograd Function;
    otherwise the eval forward."""
    p = {n: params[n] for n in PARAM_NAMES}
    if needs_grad([x, pos, *p.values()]) or (
            drop is not None and (drop.attn or drop.proj)):
        drop = drop or no_dropout(x.device)
        return EncoderLayerFn.apply(x, pos, key_padding_mask, drop.seed,
                                    (drop.attn, drop.proj), num_heads,
                                    *p.values())
    if _plain(x):
        return encoder_layer_reference(x, pos, key_padding_mask, p, num_heads)
    out = _forward_cuda(x, pos, key_padding_mask, p, num_heads)
    fused_encoder_layer.launches += 1
    return out


fused_encoder_layer.launches = 0
fused_encoder_layer.train_launches = 0
fused_encoder_layer.bwd_launches = 0
