"""Arithmetic shared by the plain PyTorch versions of the fused layers.

The plain versions round at the same points as the TPU kernels they stand
beside: matmul operands in the working dtype (bf16 on the recipe), products
accumulated in f32, LayerNorm statistics, softmax and residual streams in
f32. With f32 inputs every rounding is a no-op and they are the f32 math.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mm(a, w, b=None):
    """a @ w.T + b in f32, from a (already in the working dtype) and w
    rounded to a's dtype — the TPU kernels' `_dot(a, w) + b`."""
    return F.linear(a.float(), w.to(a.dtype).float(),
                    None if b is None else b.float())


def layer_norm(x, w, b, eps):
    """f32 LayerNorm of any-dtype rows (the kernels' `_ln_fwd`)."""
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def key_bias(mask, B, N, device):
    """Key-padding mask (B, N) bool, True = padded -> f32 logit bias -1e9
    (None when there is no mask)."""
    if mask is None:
        return None
    return torch.where(mask.reshape(B, N), -1e9, 0.0).to(
        device=device, dtype=torch.float32)


def split_heads(x, num_heads):
    B, N, D = x.shape
    return x.reshape(B, N, num_heads, D // num_heads).transpose(1, 2)


def merge_heads(x):
    B, H, N, dh = x.shape
    return x.transpose(1, 2).reshape(B, N, H * dh)


def scale_in(dtype, value: float) -> float:
    """A python scale as the working dtype rounds it (JAX multiplies a bf16
    array by a weakly typed float in bf16)."""
    return torch.tensor(value, dtype=dtype).item()
