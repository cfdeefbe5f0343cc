"""Instance-mask decoding without pycocotools (the port's copy of
spe_tpu/data/masks.py).

The reference's ConvertCocoPolysToMask(return_masks=True) path
(datasets/coco.py:164-196) rasterizes polygon segmentations and decodes
RLE via pycocotools.mask.{frPyObjects, decode}. This module reimplements
both in numpy:

  * polygon -> binary mask: even-odd scanline fill sampled at pixel
    centers (x+0.5, y+0.5). pycocotools uses an integer line-rasterization
    variant; the two agree except along boundary pixels (IoU > 0.95 on
    random polygons against cv2.fillPoly).
  * uncompressed RLE ({"counts": [..], "size": [h, w]}) and compressed RLE
    (the pycocotools LEB128-style ascii string) -> binary mask. COCO RLE is
    column-major (Fortran order).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np


def rasterize_polygon(poly: Sequence[float], h: int, w: int,
                      supersample: int = 3) -> np.ndarray:
    """Even-odd fill of a flat [x0, y0, x1, y1, ...] polygon. (h, w) uint8.

    Sampled at `supersample`² points per pixel with an any-inside rule:
    pixels the boundary passes through count as foreground, matching the
    boundary-inclusive rasterization of pycocotools/cv2 (a strict
    pixel-center fill is systematically half a pixel thinner)."""
    xy = np.asarray(poly, np.float64).reshape(-1, 2)
    if len(xy) < 3:
        return np.zeros((h, w), np.uint8)
    s = supersample
    x0, y0 = xy[:, 0] * s, xy[:, 1] * s
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    H, W = h * s, w * s
    fine = np.zeros((H, W), np.uint8)
    ys = np.arange(H, dtype=np.float64) + 0.5
    # for each scanline, x-intersections with edges straddling it (half-open
    # rule [min, max) avoids double counting at shared vertices)
    ymin = np.minimum(y0, y1)[None, :]
    ymax = np.maximum(y0, y1)[None, :]
    straddle = (ys[:, None] >= ymin) & (ys[:, None] < ymax)    # (H, E)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (ys[:, None] - y0[None, :]) / (y1 - y0)[None, :]
    xint = x0[None, :] + t * (x1 - x0)[None, :]                # (H, E)
    xint = np.where(straddle, xint, np.inf)
    xint.sort(axis=1)
    # sub-pixel x+0.5 is inside if an odd number of intersections lie to
    # its left: count via searchsorted per row
    xs = np.arange(W, dtype=np.float64) + 0.5
    for row in range(H):
        ints = xint[row]
        n = np.searchsorted(ints, np.inf)
        if n == 0:
            continue
        cnt = np.searchsorted(ints[:n], xs, side="right")
        fine[row] = (cnt % 2).astype(np.uint8)
    # any-inside pooling back to (h, w)
    return fine.reshape(h, s, w, s).max(axis=(1, 3))


def _decode_compressed_counts(s: Union[str, bytes]) -> List[int]:
    """pycocotools' ascii-packed RLE: 5-bit groups, 6th bit = continuation,
    signed zig-zag-ish delta coding (each count>2 is stored as a delta from
    the count two positions back)."""
    if isinstance(s, str):
        s = s.encode()
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def decode_rle(rle: Dict, h: int = None, w: int = None) -> np.ndarray:
    """COCO RLE dict -> (h, w) uint8 mask. Column-major runs starting with
    background, like pycocotools."""
    size = rle.get("size")
    if size is not None:
        h, w = int(size[0]), int(size[1])
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _decode_compressed_counts(counts)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T  # Fortran order


def ann_to_mask(segmentation, h: int, w: int) -> np.ndarray:
    """One annotation's segmentation (list of polygons, or RLE dict) ->
    (h, w) uint8 union mask (reference convert_coco_poly_to_mask semantics:
    any polygon covers the pixel)."""
    if isinstance(segmentation, dict):
        return decode_rle(segmentation, h, w)
    mask = np.zeros((h, w), np.uint8)
    for poly in segmentation:
        mask |= rasterize_polygon(poly, h, w)
    return mask
