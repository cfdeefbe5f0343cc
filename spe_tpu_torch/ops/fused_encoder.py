"""The post-norm DETR encoder layer, fused for Hopper (kernel 3).

    s   = LN1(x + out_proj(MHA(q=k=x+pos, v=x, key-padding bias)))
    out = LN2(s + linear2(relu(linear1(s))))          (LN eps 1e-5)

Replaces the TPU kernel spe_tpu/ops/pallas_encoder.py:375
`fused_encoder_layer` (forward `_fwd_call` :314, `pallas_call` :327, body
`_enc_fwd_kernel` :129), forward only, dropout 0 (eval).

Launches per layer: ln_linear (q|k from x+pos, the sum rounded once as the
TPU kernel rounds qk_in), ln_linear (v), attention (8 heads of 24, key bias
-1e9 on padded keys, scale after the dot), ln_linear (out_proj + residual,
f32), layernorm, ln_linear (linear1 + ReLU), ln_linear (linear2 +
residual, f32), layernorm. What bounds it on the H100: the FFN products
(2 x N x 192 x 2048 MACs per image) and the 8-head attention, on the CUDA
cores in this first version. A head width of 24 is no wgmma tile; the SIMT
attention kernel takes it as it is.

`fused_encoder_layer` chooses by device only: CPU tensors go to
`encoder_layer_reference`, CUDA tensors to the kernels (bf16 only; with
grad enabled on a parameter or input, or a dropout rate above 0, they
raise: ROADMAP B1b).
`fused_encoder_layer.launches` counts the CUDA launches.
"""

from __future__ import annotations

import torch

from spe_tpu_torch.ops import kernels as K
from spe_tpu_torch.ops.kernels import as_bf16 as _bf, as_f32 as _f
from spe_tpu_torch.ops.refmath import (drop_site, key_bias, layer_norm,
                                       merge_heads, mm, refuse_training,
                                       split_heads)

EPS = 1e-5
PARAM_NAMES = (
    "self_attn.in_proj_weight", "self_attn.in_proj_bias",
    "self_attn.out_proj.weight", "self_attn.out_proj.bias", "norm1.weight",
    "norm1.bias", "linear1.weight", "linear1.bias", "linear2.weight",
    "linear2.bias", "norm2.weight", "norm2.bias")


def encoder_layer_reference(x, pos, key_padding_mask, p, num_heads,
                            drop=None):
    """Plain PyTorch version. x/pos: (B, N, D); key_padding_mask: (B, N)
    bool, True = padded key, or None. drop: a refmath.Dropout for the
    training forward at the JAX flax layer's four sites (transformer.py
    :117-131): `attn` on the attention probabilities, `proj` on the
    attention output, the ReLU and the second linear's output."""
    dt = x.dtype
    B, N, D = x.shape
    H = num_heads
    dh = D // H
    w, b = p["self_attn.in_proj_weight"], p["self_attn.in_proj_bias"]
    qk_in = (x.float() + pos.float()).to(dt)
    q = mm(qk_in, w[:D], b[:D]).to(dt)
    k = mm(qk_in, w[D:2 * D], b[D:2 * D]).to(dt)
    v = mm(x, w[2 * D:], b[2 * D:]).to(dt)
    logits = (split_heads(q, H).float()
              @ split_heads(k, H).float().transpose(-1, -2)) * dh ** -0.5
    bias = key_bias(key_padding_mask, B, N, x.device)
    if bias is not None:
        logits = logits + bias[:, None, None, :]
    attn = drop_site(drop, torch.softmax(logits, dim=-1), "attn")
    o = merge_heads(attn.to(dt).float() @ split_heads(v, H).float()).to(dt)
    h = drop_site(drop, mm(o, p["self_attn.out_proj.weight"],
                           p["self_attn.out_proj.bias"]), "proj")
    s1 = layer_norm(x.float() + h, p["norm1.weight"], p["norm1.bias"], EPS)
    u = torch.relu(mm(s1.to(dt), p["linear1.weight"], p["linear1.bias"]))
    u = drop_site(drop, u, "proj")
    h2 = drop_site(drop, mm(u.to(dt), p["linear2.weight"], p["linear2.bias"]),
                   "proj")
    return layer_norm(s1 + h2, p["norm2.weight"], p["norm2.bias"],
                      EPS).to(dt)


def _forward_cuda(x, pos, key_padding_mask, p, num_heads):
    if x.dtype != torch.bfloat16 or pos.dtype != torch.bfloat16:
        raise TypeError(f"the fused encoder kernels take bf16, got {x.dtype}")
    B, N, D = x.shape
    H = num_heads
    dh = D // H
    x2 = x.reshape(B * N, D)
    w = _bf(p["self_attn.in_proj_weight"])
    b = _f(p["self_attn.in_proj_bias"])
    qk = K.ln_linear(x2, w[:2 * D], b[:2 * D],
                     a2=pos.reshape(B * N, D)).view(B, N, 2 * D)
    v = K.ln_linear(x2, w[2 * D:], b[2 * D:]).view(B, N, D)
    o = torch.empty((B, N, D), device=x.device, dtype=torch.bfloat16)
    K.attention(qk[..., :D], qk[..., D:], v, o, num_heads=H, dq=dh, dv=dh,
                q_hs=dh, k_hs=dh, v_hs=dh, o_hs=dh,
                kbias=key_bias(key_padding_mask, B, N, x.device),
                logit_scale=dh ** -0.5)
    y1 = K.ln_linear(o.view(B * N, D), _bf(p["self_attn.out_proj.weight"]),
                     _f(p["self_attn.out_proj.bias"]), res=x2,
                     out_dtype=torch.float32)
    s1, _ = K.layernorm(y1, _f(p["norm1.weight"]), _f(p["norm1.bias"]), EPS)
    u = K.ln_linear(s1, _bf(p["linear1.weight"]), _f(p["linear1.bias"]),
                    act="relu")
    y2 = K.ln_linear(u, _bf(p["linear2.weight"]), _f(p["linear2.bias"]),
                     res=s1, out_dtype=torch.float32)
    _, out = K.layernorm(y2, _f(p["norm2.weight"]), _f(p["norm2.bias"]), EPS,
                         want_f32=False, want_bf16=True)
    return out.view(B, N, D)


def fused_encoder_layer(x, pos, key_padding_mask, params, num_heads,
                        drop=None):
    """One post-norm encoder layer. x/pos: (B, N, D). On the card: the eval
    forward only."""
    if x.device.type == "cpu":
        return encoder_layer_reference(x, pos, key_padding_mask, params,
                                       num_heads, drop)
    refuse_training("fused_encoder_layer", [x, pos, *params.values()], drop)
    out = _forward_cuda(x, pos, key_padding_mask, params, num_heads)
    fused_encoder_layer.launches += 1
    return out


fused_encoder_layer.launches = 0
