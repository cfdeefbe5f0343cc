"""Top-k detection output (port of spe_tpu/ops/postprocess.py
`postprocess_topk`, reference conditional_detr.py:592-623 PostProcess)."""

from __future__ import annotations

import torch

from spe_tpu_torch.ops.boxes import box_cxcywh_to_xyxy


def postprocess_topk(pred_logits, pred_boxes, target_sizes,
                     keep_queries: int = 100):
    """(B, Q, K) logits + (B, Q, 4) cxcywh + (B, 2) (h, w) -> dict of scores
    (B, k), labels (B, k), boxes (B, k, 4) xyxy in target-size pixels."""
    B, Q, K = pred_logits.shape
    prob = pred_logits.float().sigmoid().reshape(B, Q * K)
    scores, idx = prob.topk(min(keep_queries, Q * K), dim=1)
    q_idx = torch.div(idx, K, rounding_mode="floor")
    labels = idx % K
    boxes = box_cxcywh_to_xyxy(pred_boxes.float()).clamp(min=0.0)
    boxes = boxes.gather(1, q_idx[..., None].expand(-1, -1, 4))
    sizes = target_sizes.float()
    h, w = sizes[:, 0], sizes[:, 1]
    scale = torch.stack([w, h, w, h], dim=-1)
    return {"scores": scores, "labels": labels, "boxes": boxes * scale[:, None]}
