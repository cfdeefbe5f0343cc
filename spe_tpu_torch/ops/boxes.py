"""Box geometry used by postprocess and NMS (port of spe_tpu/ops/boxes.py)."""

from __future__ import annotations

import torch

_EPS = 1e-9


def box_cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], dim=-1)


def box_area(b):
    return (b[..., 2] - b[..., 0]).clamp(min=0) * (
        b[..., 3] - b[..., 1]).clamp(min=0)


def box_iou_pairwise(boxes1, boxes2):
    """(..., N, 4) x (..., M, 4) xyxy -> (iou, union), each (..., N, M)."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1)[..., :, None] + box_area(boxes2)[..., None, :] - inter
    return inter / union.clamp(min=_EPS), union
