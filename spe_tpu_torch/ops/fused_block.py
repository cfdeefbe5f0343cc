"""The CaiT LayerScale block, fused for Hopper (kernel 1 of the slice).

    x += gamma1 * proj(talking_heads(LN1 x));  x += gamma2 * MLP(LN2 x)

Replaces the TPU kernel spe_tpu/ops/pallas_block.py:548
`fused_layer_scale_block` (forward `_fwd_call` :483, `pallas_call` :495,
body `_block_fwd_kernel` :166), eval/inference forward only.

The TPU kernel keeps (q_tile=512, N) logit rows of all H heads in VMEM, which
a Hopper SM cannot hold. At eval there is no attention dropout, so the op is
linear after the softmax and becomes H online-softmax passes plus an H x H
epilogue:

    P_g = softmax((q (.) row_g) . k^T + bl_g)   (the wl-fold, over all of D)
    out_j = sum_g ww[j, g] (P_g V)_j + bw_j colsum(V_j)

Launches per block (spe_tpu_torch/csrc): ln_linear (LN1 + qkv), attention
(4 mixed heads of width 192, k and v shared), colsum, th_mix, ln_linear
(proj + gamma1 residual, f32 stream), ln_linear (LN2 + fc1 + GELU),
ln_linear (fc2 + gamma2 residual). What bounds it on the H100: the attention
products (2 x 4 x N^2 x 192 MACs per image), run on the CUDA cores by this
first version.

`fused_layer_scale_block` chooses by the tensor's device only: a CPU tensor
goes to `layer_scale_block_reference`, a CUDA tensor to the kernels (bf16
only; anything else raises). `fused_layer_scale_block.launches` counts the
CUDA launches of the fused block.
"""

from __future__ import annotations

import torch

from spe_tpu_torch.ops import kernels as K
from spe_tpu_torch.ops.kernels import as_bf16 as _bf, as_f32 as _f
from spe_tpu_torch.ops.refmath import (gelu_tanh, layer_norm, merge_heads, mm,
                                       split_heads)

EPS = 1e-6
PARAM_NAMES = (
    "norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
    "attn.proj_l.weight", "attn.proj_l.bias", "attn.proj_w.weight",
    "attn.proj_w.bias", "attn.proj.weight", "attn.proj.bias", "gamma_1",
    "norm2.weight", "norm2.bias", "mlp.fc1.weight", "mlp.fc1.bias",
    "mlp.fc2.weight", "mlp.fc2.bias", "gamma_2")


def layer_scale_block_reference(x, p, num_heads):
    """Plain PyTorch version. x: (B, N, D); p: {PARAM_NAMES: tensor} in the
    reference state-dict layout (proj_l/proj_w are (H, H) Linear weights,
    out x in). Rounds where the TPU kernel rounds."""
    dt = x.dtype
    B, N, D = x.shape
    H = num_heads
    dh = D // H
    h1 = layer_norm(x, p["norm1.weight"], p["norm1.bias"], EPS).to(dt)
    qkv = mm(h1, p["attn.qkv.weight"], p["attn.qkv.bias"]).to(dt)
    q, k, v = qkv.split(D, dim=-1)
    # wl-fold: mixed_g = sum_h wl[g, h] (scale q_h k_h^T) = (q (.) row_g) k^T
    rows = (p["attn.proj_l.weight"].float() * dh ** -0.5).repeat_interleave(
        dh, dim=1)                                             # (H, D)
    qg = (q.float()[:, None] * rows[None, :, None, :]).to(dt)  # (B, H, N, D)
    logits = qg.float() @ k.float()[:, None].transpose(-1, -2)
    logits = logits + p["attn.proj_l.bias"].float()[None, :, None, None]
    probs = torch.softmax(logits, dim=-1)
    z = torch.einsum("bhqk,gh->bgqk", probs, p["attn.proj_w.weight"].float())
    z = z + p["attn.proj_w.bias"].float()[None, :, None, None]
    o = merge_heads(z.to(dt).float() @ split_heads(v, H).float()).to(dt)
    x1 = x.float() + p["gamma_1"].float() * mm(o, p["attn.proj.weight"],
                                                p["attn.proj.bias"])
    h2 = layer_norm(x1, p["norm2.weight"], p["norm2.bias"], EPS).to(dt)
    u = gelu_tanh(mm(h2, p["mlp.fc1.weight"], p["mlp.fc1.bias"])).to(dt)
    m = mm(u, p["mlp.fc2.weight"], p["mlp.fc2.bias"])
    return (x1 + p["gamma_2"].float() * m).to(dt)


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
    rows = (_f(p["attn.proj_l.weight"]) * dh ** -0.5).repeat_interleave(
        dh, dim=1).contiguous()
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


def fused_layer_scale_block(x, params, num_heads):
    """One CaiT LayerScale block, eval forward. x: (B, N, D)."""
    if x.device.type == "cpu":
        return layer_scale_block_reference(x, params, num_heads)
    out = _forward_cuda(x, params, num_heads)
    fused_layer_scale_block.launches += 1
    return out


fused_layer_scale_block.launches = 0
