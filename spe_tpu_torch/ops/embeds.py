"""Sinusoidal positional embeddings (port of spe_tpu/ops/embeds.py).

Batch-first like the JAX package: (B, N, ...) and (B, H, W, C).
"""

from __future__ import annotations

import math

import torch


def _interleave_sin_cos(x):
    """stack(sin(x[..., 0::2]), cos(x[..., 1::2])) flattened, torch-style."""
    return torch.stack([x[..., 0::2].sin(), x[..., 1::2].cos()],
                       dim=-1).flatten(-2)


def gen_sineembed_for_position(pos, d_model: int = 256):
    """Sine embedding of (x, y) in [0, 1]: (..., 2) -> (..., d_model), f32.

    Keeps the reference's hardcoded /128 exponent denominator
    (reference transformer.py:35-49). `pos * 2pi` is taken in pos's dtype
    before the f32 division, as the JAX function computes it."""
    n_steps = d_model // 2
    dim_t = torch.arange(n_steps, dtype=torch.float32, device=pos.device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / 128.0)
    x_embed = (pos[..., 0] * (2 * math.pi)).float()
    y_embed = (pos[..., 1] * (2 * math.pi)).float()
    pos_x = _interleave_sin_cos(x_embed[..., None] / dim_t)
    pos_y = _interleave_sin_cos(y_embed[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1)


def position_embedding_sine(mask, num_pos_feats: int = 64,
                            temperature: float = 10000.0,
                            normalize: bool = True, scale=None):
    """2D sine position embedding from a padding mask (B, H, W) bool, True on
    padded cells -> (B, H, W, 2*num_pos_feats) f32."""
    if scale is None:
        scale = 2 * math.pi
    not_mask = (~mask).float()
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_pos_feats)
    pos_x = _interleave_sin_cos(x_embed[..., None] / dim_t)
    pos_y = _interleave_sin_cos(y_embed[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1)


def inverse_sigmoid(x, eps: float = 1e-5):
    """logit with clamping (reference util/misc.py:475-481)."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))
