"""Batched per-class NMS, fixpoint form (port of spe_tpu/ops/nms.py).

Greedy NMS is keep[i] = valid[i] & ~any_{j<i}(keep[j] & suppress[j, i])
over score-sorted boxes. Starting from keep = valid and applying that map
until nothing changes converges to the greedy solution in (longest
suppression chain) + 1 sweeps, each one (N, N) masked reduction over the
whole batch. Plain PyTorch: this is not a Pallas kernel in the JAX package.
"""

from __future__ import annotations

import torch

from spe_tpu_torch.ops.boxes import box_iou_pairwise


def batched_nms(boxes, scores, labels, valid, iou_threshold: float = 0.5):
    """boxes (B, N, 4) xyxy, scores (B, N), labels (B, N), valid (B, N) bool
    -> keep (B, N) bool, the survivors of class-wise greedy NMS."""
    B, n = scores.shape
    order = torch.argsort(-torch.where(valid, scores, -torch.inf), dim=1,
                          stable=True)
    b = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    lab = labels.gather(1, order)
    v = valid.gather(1, order)
    iou, _ = box_iou_pairwise(b, b)
    ar = torch.arange(n, device=scores.device)
    sup = ((iou > iou_threshold) & (lab[:, :, None] == lab[:, None, :])
           & (ar[:, None] < ar[None, :]))
    keep = v
    for _ in range(n + 1):
        killed = (keep[:, :, None] & sup).any(dim=1)
        new = v & ~killed
        if torch.equal(new, keep):
            break
        keep = new
    out = torch.zeros_like(valid)
    return out.scatter(1, order, keep)
