"""Segmentation head of `--masks` (port of spe_tpu/models/segmentation.py;
reference models/segmentation.py:33-200 DETRsegm, MHAttentionMap,
MaskHeadSmallConv, and PostProcessSegm / PostProcessPanoptic :203-371).

  MHAttentionMap   per-query attention heatmaps over the patch grid:
                   softmax over positions of q_linear(hs) . k_linear(feat)
                   / sqrt(dh), padded cells at -1e9 -> (B, Q, heads, h, w)
  MaskHead         the patch features (feat_proj) broadcast to every query
                   and concatenated with its heatmaps, then 3x3 conv,
                   GroupNorm (min(8, d) groups, eps 1e-6 as flax's), ReLU
                   and a 2x nearest upsample, twice, a third conv block and
                   a 1-channel 3x3 conv -> mask logits (B, Q, 4h, 4w)
  SegmentationHead the two, on stage 0's last decoder states

Kept from the JAX package: no FPN laterals (the CaiT backbone is single
scale), no `normalize_fact` in the logits, no dropout in MHAttentionMap.
Everything here is f32 plain PyTorch: the JAX package computes the head
with XLA, not in a Pallas body, so it has no kernel of its own. Its
convolutions run under torch's cuDNN default on the card, TF32 (the JAX
package runs its f32 convolutions at the TPU's default precision, bf16
passes); its matmuls are f32. Nothing here sets a global torch flag.
State-dict names: DETR's where the JAX package mirrors DETR
(`bbox_attention.q_linear`, `bbox_attention.k_linear` and the
`mask_head.` prefix, at the detector's top level), the JAX package's
inside the mask head, which departs from DETR's (`mask_head.feat_proj`,
`mask_head.conv_{i}`, `mask_head.gn_{i}`, `mask_head.out`).

`postprocess_segm` thresholds the kept queries' masks at a size;
`postprocess_panoptic` is one image's panoptic map, host numpy as in the
JAX package (segment ids from 1, 0 the void id of data/panoptic_eval.py).
"""

from __future__ import annotations

import io
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from spe_tpu_torch.ops.resize import resize_bilinear

# the head's parameters in the detector's state dict (the frozen group of
# --frozen_weights is everything else)
SEGM_PREFIXES = ("bbox_attention.", "mask_head.")
GN_EPS = 1e-6   # flax nn.GroupNorm's default


class MHAttentionMap(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_linear = nn.Linear(hidden_dim, hidden_dim)
        self.k_linear = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, q, feat, pad_mask=None):
        """q (B, Q, D), feat (B, h, w, D), pad_mask (B, h*w) True on padded
        cells or None -> (B, Q, heads, h, w) f32."""
        B, Q, D = q.shape
        h, w = feat.shape[1:3]
        nh = self.num_heads
        dh = D // nh
        qh = self.q_linear(q).reshape(B, Q, nh, dh)
        kh = self.k_linear(feat).reshape(B, h * w, nh, dh)
        logits = torch.einsum("bqnd,bpnd->bqnp", qh, kh) / math.sqrt(dh)
        if pad_mask is not None:
            logits = logits.masked_fill(pad_mask.reshape(B, 1, 1, h * w),
                                        -1e9)
        return torch.softmax(logits.float(), dim=-1).reshape(B, Q, nh, h, w)


class MaskHead(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int,
                 num_upsamples: int = 2):
        super().__init__()
        self.num_upsamples = num_upsamples
        self.feat_proj = nn.Linear(hidden_dim, hidden_dim)
        dims = [hidden_dim, hidden_dim // 2, hidden_dim // 4, hidden_dim // 8]
        cin = hidden_dim + num_heads
        for i in range(num_upsamples + 1):
            d = dims[min(i, len(dims) - 1)]
            setattr(self, f"conv_{i}", nn.Conv2d(cin, d, 3, padding=1))
            setattr(self, f"gn_{i}", nn.GroupNorm(min(8, d), d, eps=GN_EPS))
            cin = d
        self.out = nn.Conv2d(cin, 1, 3, padding=1)

    def forward(self, feat, attn_maps):
        """feat (B, h, w, D), attn_maps (B, Q, heads, h, w) -> mask logits
        (B, Q, h * 2^u, w * 2^u) f32."""
        B, Q, nh, h, w = attn_maps.shape
        fproj = self.feat_proj(feat).permute(0, 3, 1, 2)      # (B, D, h, w)
        x = torch.cat([fproj[:, None].expand(B, Q, -1, h, w),
                       attn_maps.to(fproj.dtype)], dim=2)
        x = x.reshape(B * Q, -1, h, w)
        for i in range(self.num_upsamples + 1):
            x = getattr(self, f"conv_{i}")(x)
            x = torch.relu(getattr(self, f"gn_{i}")(x))
            if i < self.num_upsamples:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = self.out(x)
        return x.reshape(B, Q, *x.shape[-2:]).float()


def segmentation_head(bbox_attention, mask_head, hs, feat, pad_mask=None):
    """Mask logits of the queries hs (B, Q, D) over feat (B, h, w, D)."""
    return mask_head(feat, bbox_attention(hs, feat, pad_mask))


class SegmentationHead(nn.Module):
    """MHAttentionMap + MaskHead (the JAX package's SegmentationHead; the
    detector holds the two parts under DETR's names itself)."""

    def __init__(self, hidden_dim: int, num_heads: int = 8):
        super().__init__()
        self.bbox_attention = MHAttentionMap(hidden_dim, num_heads)
        self.mask_head = MaskHead(hidden_dim, num_heads)

    def forward(self, hs, feat, pad_mask=None):
        return segmentation_head(self.bbox_attention, self.mask_head, hs,
                                 feat, pad_mask)


def postprocess_segm(mask_logits, keep_q, out_hw, threshold: float = 0.5):
    """The kept queries' masks: mask_logits (B, Q, h, w), keep_q (B, K)
    query indices -> (B, K, *out_hw) bool (reference PostProcessSegm)."""
    sel = mask_logits.gather(1, keep_q[:, :, None, None].expand(
        -1, -1, *mask_logits.shape[-2:]))
    return torch.sigmoid(resize_bilinear(sel, out_hw)) > threshold


def id2rgb(id_map):
    """Panoptic id -> RGB (id = R + 256 G + 256^2 B)."""
    rgb = np.zeros(id_map.shape + (3,), np.uint8)
    rgb[..., 0] = id_map % 256
    rgb[..., 1] = (id_map // 256) % 256
    rgb[..., 2] = id_map // (256 ** 2)
    return rgb


def postprocess_panoptic(logits, mask_logits, is_thing_map, processed_size,
                         target_size=None, threshold: float = 0.85,
                         min_area: int = 4):
    """One image's panoptic prediction from class logits (Q, K) and mask
    logits (Q, h, w), as the JAX package computes it: queries kept whose
    softmax top class is not no-object (column K-1) and scores above
    threshold; their masks resized bilinearly to processed_size; each pixel
    to the kept query of the largest softmax across queries; same-class
    stuff merged into its first query; the map resized nearest to
    target_size; segments of at most min_area pixels dropped and the
    pixels reassigned until none is; ids renumbered 1..N (0 void).
    -> {"id_map" (H, W) int32, "segments_info", "png_string"}."""
    from PIL import Image

    logits = np.asarray(logits, np.float32)
    masks = np.asarray(mask_logits, np.float32)
    K = logits.shape[-1]
    e = np.exp(logits - logits.max(-1, keepdims=True))
    prob = e / e.sum(-1, keepdims=True)
    scores = prob.max(-1)
    classes = prob.argmax(-1)
    keep = (classes != K - 1) & (scores > threshold)
    scores, classes, masks = scores[keep], classes[keep], masks[keep]
    h, w = processed_size
    if masks.shape[0]:
        masks = resize_bilinear(torch.from_numpy(masks), (h, w)).numpy()
    target_size = target_size or processed_size

    def assign(masks_, classes_):
        if masks_.shape[0] == 0:
            return np.zeros(tuple(target_size), np.int32)
        m = masks_ - masks_.max(0, keepdims=True)
        soft = np.exp(m) / np.exp(m).sum(0, keepdims=True)
        m_id = soft.argmax(0).astype(np.int32)
        first_of_stuff = {}
        for k, c in enumerate(classes_):
            if not is_thing_map.get(int(c), True):
                if int(c) in first_of_stuff:
                    m_id[m_id == k] = first_of_stuff[int(c)]
                else:
                    first_of_stuff[int(c)] = k
        th, tw = target_size
        if (th, tw) != m_id.shape:
            yi = (np.arange(th) * m_id.shape[0] / th).astype(np.int64)
            xi = (np.arange(tw) * m_id.shape[1] / tw).astype(np.int64)
            m_id = m_id[yi][:, xi]
        return m_id

    while True:
        m_id = assign(masks, classes)
        areas = np.array([(m_id == i).sum() for i in range(len(classes))])
        small = areas <= min_area
        if len(classes) == 0 or not small.any():
            break
        classes, scores, masks = classes[~small], scores[~small], masks[~small]

    id_map = np.zeros(m_id.shape, np.int32)
    segments_info = []
    for new_id, k in enumerate(
            [i for i in range(len(classes)) if (m_id == i).any()], start=1):
        id_map[m_id == k] = new_id
        cat = int(classes[k])
        segments_info.append({"id": new_id,
                              "isthing": bool(is_thing_map.get(cat, True)),
                              "category_id": cat,
                              "area": int((m_id == k).sum())})
    buf = io.BytesIO()
    Image.fromarray(id2rgb(id_map)).save(buf, format="PNG")
    return {"id_map": id_map, "segments_info": segments_info,
            "png_string": buf.getvalue()}
