"""The CaiT class-attention token block, fused for Hopper (kernel 2).

    u  = LN1([cls ++ x]);  o = class_attention(q(u[:t]), k(u), v(u))
    c1 = cls + gamma1 * proj(o);  c2 = c1 + gamma2 * MLP(LN2 c1)
    returns (c2, attn) with attn (B, H, t, t+P) f32 — block 0's is the CAM

Replaces the TPU kernel spe_tpu/ops/pallas_ca_block.py:268
`fused_class_attn_block` (forward `_fwd_call` :217, `pallas_call` :228, body
`_ca_fwd_kernel` :58), forward only.

The t = 21 query rows and N = 1045 keys are both ragged; the attention
kernel masks its edge tiles instead of padding. The probabilities are an
output (the CAM reads them), so the attention kernel's second pass writes
them exactly normalised, exp(s - m) / l with the final row max and sum.

Launches per block: ln_linear (LN1 + q|k|v over [cls ++ x]), attention
(4 heads of 48, probabilities on), ln_linear (proj + gamma1 residual, f32),
ln_linear (LN2 + fc1 + GELU), ln_linear (fc2 + gamma2 residual). What bounds
it on the H100: the k/v projection of all 1045 rows and the f32 write of the
(B, 4, 21, 1045) map; the t-row products are small.

`fused_class_attn_block` chooses by device only: CPU tensors go to
`class_attn_block_reference`, CUDA tensors to the kernels (bf16 only).
`fused_class_attn_block.launches` counts the CUDA launches.
"""

from __future__ import annotations

import torch

from spe_tpu_torch.ops import kernels as K
from spe_tpu_torch.ops.kernels import as_bf16 as _bf, as_f32 as _f
from spe_tpu_torch.ops.refmath import (gelu_tanh, layer_norm, merge_heads, mm,
                                       scale_in, split_heads)

EPS = 1e-6
PARAM_NAMES = (
    "norm1.weight", "norm1.bias", "attn.q.weight", "attn.q.bias",
    "attn.k.weight", "attn.k.bias", "attn.v.weight", "attn.v.bias",
    "attn.proj.weight", "attn.proj.bias", "gamma_1", "norm2.weight",
    "norm2.bias", "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight",
    "mlp.fc2.bias", "gamma_2")


def class_attn_block_reference(cls, x, p, num_heads):
    """Plain PyTorch version. cls: (B, t, D) class tokens; x: (B, P, D)
    patches. Returns (new cls (B, t, D), attn (B, H, t, t+P) f32)."""
    dt = cls.dtype
    t, D = cls.shape[1:]
    H = num_heads
    dh = D // H
    un = layer_norm(torch.cat([cls, x], dim=1), p["norm1.weight"],
                    p["norm1.bias"], EPS).to(dt)
    q = mm(un[:, :t], p["attn.q.weight"], p["attn.q.bias"]).to(dt)
    k = mm(un, p["attn.k.weight"], p["attn.k.bias"]).to(dt)
    v = mm(un, p["attn.v.weight"], p["attn.v.bias"]).to(dt)
    qh = (split_heads(q, H).float() * scale_in(dt, dh ** -0.5)).to(dt)
    logits = qh.float() @ split_heads(k, H).float().transpose(-1, -2)
    attn = torch.softmax(logits, dim=-1)
    o = merge_heads(attn.to(dt).float() @ split_heads(v, H).float()).to(dt)
    c1 = cls.float() + p["gamma_1"].float() * mm(o, p["attn.proj.weight"],
                                                  p["attn.proj.bias"])
    h2 = layer_norm(c1, p["norm2.weight"], p["norm2.bias"], EPS).to(dt)
    u = gelu_tanh(mm(h2, p["mlp.fc1.weight"], p["mlp.fc1.bias"])).to(dt)
    m = mm(u, p["mlp.fc2.weight"], p["mlp.fc2.bias"])
    return (c1 + p["gamma_2"].float() * m).to(dt), attn


def _forward_cuda(cls, x, p, num_heads):
    if cls.dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise TypeError("the fused class-attention kernels take bf16, got "
                        f"{cls.dtype}/{x.dtype}")
    B, t, D = cls.shape
    N = t + x.shape[1]
    H = num_heads
    dh = D // H
    u = torch.cat([cls, x], dim=1).reshape(B * N, D)
    w_qkv = _bf(torch.cat([p["attn.q.weight"], p["attn.k.weight"],
                           p["attn.v.weight"]]))
    b_qkv = _f(torch.cat([p["attn.q.bias"], p["attn.k.bias"],
                          p["attn.v.bias"]]))
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
                      res=c1, gamma=_f(p["gamma_2"]))
    return out.view(B, t, D), attn


def fused_class_attn_block(cls, x, params, num_heads):
    """One class-attention block, eval forward -> (new cls, attn f32)."""
    if cls.device.type == "cpu":
        return class_attn_block_reference(cls, x, params, num_heads)
    out = _forward_cuda(cls, x, params, num_heads)
    fused_class_attn_block.launches += 1
    return out


fused_class_attn_block.launches = 0
