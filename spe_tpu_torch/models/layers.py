"""Shared building blocks (port of spe_tpu/models/layers.py).

Parameters are f32 and carry the reference PyTorch state-dict names; the
activations' dtype is the compute dtype (bf16 on the recipe), so `Linear`
casts its weight to the input's dtype and `LayerNorm` normalises in f32 and
returns the input's dtype, as flax Dense/LayerNorm with `dtype=` do.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from spe_tpu_torch.ops.refmath import Dropout
from spe_tpu_torch.parallel.tp import NO_TP


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with f32 statistics, output in the input's dtype."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


def dropout_for(module: nn.Module, gen, attn=0.0, proj=0.0, path=0.0):
    """The module's training-mode refmath.Dropout, or None in eval mode or
    when every rate is 0 (the forward is then exactly the eval forward).
    Training with a rate above 0 needs an explicit torch.Generator."""
    if not module.training or not (attn or proj or path):
        return None
    if gen is None:
        raise ValueError(f"{type(module).__name__} trains with dropout: pass "
                         "the torch.Generator its masks are drawn from")
    return Dropout(gen, attn, proj, path)


def trunc_normal_(t, std=0.02, generator=None):
    """Truncated normal at +-2 std, as flax's truncated_normal(std)."""
    with torch.no_grad():
        return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)


def lecun_normal_(t, generator=None):
    """flax's default Dense init: truncated normal, variance 1/fan_in."""
    fan_in = t.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return trunc_normal_(t, std=std, generator=generator)


class Mlp(nn.Module):
    """The CaiT blocks' FFN parameters, fc1 and fc2; the blocks compute
    fc1 -> tanh-GELU -> fc2 in their fused layer or its plain version."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)


class PatchEmbed(nn.Module):
    """Image (B, H, W, 3) -> patch tokens (B, gh*gw, D).

    The weight keeps the reference Conv2d layout (D, C, p, p); a stride-p
    conv is computed as the reshaped matmul the JAX package uses, with
    (py, px, c) patch flattening. Under tensor parallelism that matmul is
    row-parallel, as the JAX rules shard its Dense kernel: the weight holds
    this rank's rows py (parallel/sharding_rules.py), its columns of the
    flattened patches, and the products are summed over the model group."""

    tp = NO_TP   # tensor parallelism (parallel/sharding_rules.shard_model)

    def __init__(self, patch_size: int, embed_dim: int, in_chans: int = 3):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)

    def forward(self, x):
        B, H, W, C = x.shape
        p = self.patch_size
        gh, gw = H // p, W // p
        x = x.reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, gh * gw, p * p * C)
        w = self.proj.weight.permute(0, 2, 3, 1).reshape(
            self.proj.weight.shape[0], -1)
        if self.tp.size > 1:
            return self.tp.row(self.tp.scatter(x), w,
                               self.proj.bias).to(x.dtype)
        return F.linear(x, w.to(x.dtype), self.proj.bias.to(x.dtype))


def interpolate_pos_embed(pos_embed, src_hw, dst_hw):
    """Bicubic re-interpolation of a (1, N, D) pos-embed grid: torch bicubic,
    a = -0.75, align_corners=False — the reference's per-forward
    InterpolateInitPosEmbed (cait.py:744-759)."""
    (sh, sw), (dh, dw) = src_hw, dst_hw
    if (sh, sw) == (dh, dw):
        return pos_embed
    d = pos_embed.shape[-1]
    grid = pos_embed.reshape(1, sh, sw, d).permute(0, 3, 1, 2).float()
    grid = F.interpolate(grid, size=(dh, dw), mode="bicubic",
                         align_corners=False)
    return grid.permute(0, 2, 3, 1).reshape(1, dh * dw, d)
