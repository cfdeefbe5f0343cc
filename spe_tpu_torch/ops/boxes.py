"""Box geometry: postprocess, NMS, the matcher cost and the box losses
(port of spe_tpu/ops/boxes.py; reference util/box_ops.py). Degenerate
boxes give finite values through eps-guarded divisions."""

from __future__ import annotations

import torch

_EPS = 1e-9


def box_cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b):
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0],
                       dim=-1)


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


def generalized_box_iou_pairwise(boxes1, boxes2):
    """Pairwise GIoU of xyxy boxes (reference util/box_ops.py:49-74)."""
    iou, union = box_iou_pairwise(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp(min=_EPS)


def box_iou_aligned(boxes1, boxes2):
    """Elementwise IoU of equal-shaped xyxy box tensors (..., 4)."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    return inter / union.clamp(min=_EPS)


def generalized_box_iou_aligned(boxes1, boxes2):
    """Elementwise GIoU of equal-shaped xyxy box tensors (..., 4): the
    diagonal of the pairwise GIoU without the N x N matrix."""
    iou = box_iou_aligned(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    area = wh[..., 0] * wh[..., 1]
    inter_wh = (torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
                - torch.maximum(boxes1[..., :2], boxes2[..., :2])).clamp(min=0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    return iou - (area - union) / area.clamp(min=_EPS)


def masks_to_boxes(masks):
    """Boxes (N, 4) xyxy around the nonzero pixels of masks (N, H, W), in
    pixel indices; zeros for an empty mask (reference util/box_ops.py
    :77-101, spe_tpu/ops/boxes.py:90-106)."""
    n, h, w = masks.shape
    m = masks.bool()
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)[None, None, :]
    big = 1e8
    out = torch.stack([
        torch.where(m, xs, big).amin((1, 2)),
        torch.where(m, ys, big).amin((1, 2)),
        torch.where(m, xs, -big).amax((1, 2)),
        torch.where(m, ys, -big).amax((1, 2))], dim=1)
    return torch.where(m.any((1, 2))[:, None], out, 0.0)
