"""Bilinear resize as jax.image.resize(..., "bilinear") computes it, both
ways: sampling at half-pixel centres, and antialiased when it shrinks (the
triangle kernel widened by the scale, so every source pixel counts). One
F.interpolate(mode="bilinear", align_corners=False, antialias=True) call
is that function; without antialias a shrink samples only the pixels next
to each centre and differs from JAX by up to a quarter of the range or
more. Callers: the mask losses' GT shrink (512 -> 128 on the recipe), the
segmentation postprocesses (mostly enlarging) and the CAM grid of
ops/cam_boxes.py.
"""

from __future__ import annotations

import torch.nn.functional as F


def resize_bilinear(x, size):
    """x (..., H, W) float -> (..., h, w) for size (h, w), in x's dtype."""
    h, w = (int(s) for s in size)
    H, W = x.shape[-2:]
    if (H, W) == (h, w):
        return x
    lead = x.shape[:-2]
    out = F.interpolate(x.reshape(-1, 1, H, W), size=(h, w), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.reshape(*lead, h, w)
