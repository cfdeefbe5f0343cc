"""Set criterion: box-repeat jitter -> assignment -> focal/L1/GIoU losses
(port of spe_tpu/train/criterion.py; reference models/conditional_detr.py
:190-589 SetCriterion/SetCriterionRefine, models/matcher.py:20-88).

Targets are padded tensors with masks:
  {"boxes": (B, T, 4) cxcywh in [0, 1], "labels": (B, T) det-class columns,
   "scores": (B, T) (refinement stages), "mask": (B, T) bool}

As in the JAX package: the box-repeat draws a fixed pool of candidates per
box (here from a torch.Generator), matching runs the auction
(ops/auction.py; `assignment='hungarian_cpu'` takes the exact host solver),
and every (stage, decoder layer, image) problem of a step goes to ONE
auction launch. The instance-mask losses and the matching-cost audit
(`log_match_cost`) are not ported.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from spe_tpu_torch.ops import boxes as box_ops
from spe_tpu_torch.ops.auction import (auction_assignment_stats_batched,
                                       hungarian_batched)
from spe_tpu_torch.ops.losses import (image_label_bce, masked_giou_loss,
                                      masked_l1_loss,
                                      weighted_sigmoid_focal_loss)


@torch.no_grad()
def jitter_repeat_targets(targets, gen, ratio: int, box_jitter: float,
                          num_candidates: int = 64):
    """Repeat each target `ratio` times (conditional_detr.py:409-431): the
    first ratio-1 slots are scale-jittered copies with IoU > 0.7, the first
    passing candidates in draw order (the box itself where too few pass),
    the last slot is the box."""
    boxes = targets["boxes"]
    B, T = targets["labels"].shape
    u = torch.rand((B, T, num_candidates, 4), generator=gen,
                   device=boxes.device)
    cand = boxes[:, :, None] * ((1 - box_jitter) + 2 * box_jitter * u)
    ref = box_ops.box_cxcywh_to_xyxy(boxes)[:, :, None].expand_as(cand)
    ok = box_ops.box_iou_aligned(box_ops.box_cxcywh_to_xyxy(cand), ref) > 0.7
    ar = torch.arange(num_candidates, device=boxes.device)
    order = torch.argsort(torch.where(ok, ar, num_candidates + ar), dim=-1)
    pick = order[..., :ratio - 1]
    picked = cand.gather(2, pick[..., None].expand(-1, -1, -1, 4))
    picked_ok = ok.gather(2, pick)
    jittered = torch.where(picked_ok[..., None], picked, boxes[:, :, None])
    rep = torch.cat([jittered, boxes[:, :, None]], 2)         # (B, T, r, 4)
    out = {"boxes": rep.reshape(B, T * ratio, 4),
           "labels": targets["labels"].repeat_interleave(ratio, 1),
           "mask": targets["mask"].repeat_interleave(ratio, 1)}
    if "scores" in targets:
        out["scores"] = targets["scores"].repeat_interleave(ratio, 1)
    return out


def matcher_cost(pred_logits, pred_boxes, tgt_labels, tgt_boxes, tgt_mask,
                 cost_class: float = 2.0, cost_bbox: float = 5.0,
                 cost_giou: float = 2.0):
    """Cost matrices (P, Q, T) of P problems (models/matcher.py:59-87, focal
    alpha 0.25 and gamma 2 as hardcoded there); padded target columns at a
    flat 1e4. pred_logits (P, Q, K), pred_boxes (P, Q, 4)."""
    prob = pred_logits.float().sigmoid()
    alpha, gamma = 0.25, 2.0
    neg = (1 - alpha) * (prob ** gamma) * (-torch.log(1 - prob + 1e-8))
    pos = alpha * ((1 - prob) ** gamma) * (-torch.log(prob + 1e-8))
    P, Q, K = prob.shape
    ids = tgt_labels.long().clamp(0, K - 1)[:, None, :].expand(P, Q, -1)
    c_class = pos.gather(2, ids) - neg.gather(2, ids)
    c_bbox = (pred_boxes[:, :, None, :] - tgt_boxes[:, None, :, :]).abs().sum(-1)
    c_giou = -box_ops.generalized_box_iou_pairwise(
        box_ops.box_cxcywh_to_xyxy(pred_boxes),
        box_ops.box_cxcywh_to_xyxy(tgt_boxes))
    cost = cost_bbox * c_bbox + cost_class * c_class + cost_giou * c_giou
    return torch.where(tgt_mask[:, None, :], cost, 1e4)


@torch.no_grad()
def match(pred_logits, pred_boxes, targets, *, method: str = "auction",
          cost_class: float = 2.0, cost_bbox: float = 5.0,
          cost_giou: float = 2.0):
    """Batched assignment, not differentiated (matcher.py:42) -> (row_for_col
    (P, T) query per target, {"iters": (P,), "cleanup": (P,)}; zeros for the
    exact host solver)."""
    cost = matcher_cost(pred_logits.detach(), pred_boxes.detach().float(),
                        targets["labels"], targets["boxes"].float(),
                        targets["mask"], cost_class, cost_bbox, cost_giou)
    if method == "hungarian_cpu":
        rows = hungarian_batched(cost, targets["mask"])
        zeros = torch.zeros(rows.shape[0], dtype=torch.int32,
                            device=rows.device)
        return rows, {"iters": zeros, "cleanup": zeros}
    if method != "auction":
        raise ValueError(f"unknown assignment {method!r}")
    rows, _, stats = auction_assignment_stats_batched(cost, targets["mask"])
    return rows, stats


def _layer_losses(pred_logits, pred_boxes, targets, row_for_col, num_boxes,
                  *, focal_alpha, focal_gamma, refine_weights: bool):
    """Losses of one decoder layer's outputs (B, Q, K) / (B, Q, 4) against
    targets matched by row_for_col (B, T). A valid target left unassigned
    (row -1, an over-subscribed problem) contributes nothing."""
    B, Q, K = pred_logits.shape
    mask = targets["mask"] & (row_for_col >= 0)
    maskf = mask.float()
    labels = targets["labels"].long().clamp(0, K - 1)
    row = row_for_col.long().clamp(0, Q - 1)

    sel = F.one_hot(row, Q).float() * maskf[:, :, None]        # (B, T, Q)
    labhot = F.one_hot(labels, K).float()                      # (B, T, K)
    onehot = torch.einsum("btq,btk->bqk", sel, labhot).clamp(max=1.0)
    if refine_weights:
        scores = targets["scores"]
        avg_score = (scores * maskf).sum(1) / maskf.sum(1).clamp(min=1.0)
        wvals = (scores * 3.0).clamp(max=1.0)
        matched = sel.sum(1).clamp(max=1.0)                    # (B, Q)
        wsum = torch.einsum("btq,bt->bq", sel, wvals)
        qw = avg_score[:, None] * (1.0 - matched) + wsum
        weights = qw[:, :, None].expand(B, Q, K)
    else:
        weights = torch.ones((B, Q, K), device=pred_logits.device)
    loss_ce = weighted_sigmoid_focal_loss(
        pred_logits.float(), onehot, num_boxes, weights, alpha=focal_alpha,
        gamma=focal_gamma) * Q

    src = pred_boxes.float().gather(1, row[..., None].expand(-1, -1, 4))
    tgt = targets["boxes"].float()
    pair_w = targets["scores"] if refine_weights else None
    card_pred = (pred_logits.argmax(-1) != K - 1).sum(-1).float()
    return {"loss_ce": loss_ce,
            "loss_bbox": masked_l1_loss(src, tgt, maskf, num_boxes, pair_w),
            "loss_giou": masked_giou_loss(box_ops.box_cxcywh_to_xyxy(src),
                                          box_ops.box_cxcywh_to_xyxy(tgt),
                                          maskf, num_boxes, pair_w),
            "cardinality_error": (card_pred - maskf.sum(1)).abs().mean()}


def repeated_num_boxes(targets, ratio: int):
    """The stage's num_boxes normalizer: valid targets x the repeat ratio."""
    return targets["mask"].float().sum() * ratio


def image_label_losses(backbone_out, img_label) -> Dict[str, torch.Tensor]:
    """Multilabel BCE heads (conditional_detr.py:225-235)."""
    return {"img_label_logits": image_label_bce(
                backbone_out["x_logits"].float(), img_label),
            "img_label_logits_tokens": image_label_bce(
                backbone_out["x_cls_logits"].float(), img_label)}


def set_criterion_multi(stage_outs, targets_per_stage, gens, num_boxes_per_stage,
                        refine_flags, *, hung_match_ratio: int = 5,
                        box_jitter: float = 0.1, focal_alpha: float = 0.25,
                        focal_gamma: float = 2.0, cost_class: float = 2.0,
                        cost_bbox: float = 5.0, cost_giou: float = 2.0,
                        assignment: str = "auction", training: bool = True,
                        aux_loss: bool = True, matching=None):
    """Every stage's criterion with ONE batched assignment over all S*L*B
    (stage, decoder layer, image) problems; each layer is matched on its
    own, as the reference re-matches per layer (conditional_detr.py
    :447-464). gens: one torch.Generator per stage for the box repeat (None
    skips it). `matching`, the second value of an earlier call, replaces
    the assignment (a run that replays another's). Returns (per stage
    {loss_ce, loss_bbox, loss_giou, cardinality_error, and `_{i}` for the
    aux layers}, the matching used: (row_for_col, stats) of `match`);
    stage 0 also carries match_iters (the most auction iterations of any
    problem) and match_cleanup (the cleanup activations summed)."""
    reps, logits_s, boxes_s = [], [], []
    for so, tgt, gen in zip(stage_outs, targets_per_stage, gens):
        if training and gen is not None:
            tgt = jitter_repeat_targets(tgt, gen, hung_match_ratio, box_jitter)
        reps.append(tgt)
        if aux_loss:
            logits_s.append(torch.cat([so["aux_pred_logits"],
                                       so["pred_logits"][None]], 0))
            boxes_s.append(torch.cat([so["aux_pred_boxes"],
                                      so["pred_boxes"][None]], 0))
        else:
            logits_s.append(so["pred_logits"][None])
            boxes_s.append(so["pred_boxes"][None])
    L = logits_s[0].shape[0]
    if any(lg.shape[0] != L for lg in logits_s):
        raise ValueError("every stage must have the same decoder layers")
    LG = torch.cat(logits_s, 0)                               # (S*L, B, Q, K)
    BX = torch.cat(boxes_s, 0)
    SL, B = LG.shape[:2]
    flat = {k: torch.cat([t[k][None].expand(L, *t[k].shape) for t in reps],
                         0).reshape(SL * B, *reps[0][k].shape[1:])
            for k in ("boxes", "labels", "mask")}
    if matching is None:
        matching = match(LG.reshape(SL * B, *LG.shape[2:]),
                         BX.reshape(SL * B, *BX.shape[2:]), flat,
                         method=assignment, cost_class=cost_class,
                         cost_bbox=cost_bbox, cost_giou=cost_giou)
    rows, mstats = matching
    rows = rows.reshape(SL, B, -1)

    outs = []
    for s, tgt in enumerate(reps):
        per_layer = [_layer_losses(LG[s * L + i], BX[s * L + i], tgt,
                                   rows[s * L + i], num_boxes_per_stage[s],
                                   focal_alpha=focal_alpha,
                                   focal_gamma=focal_gamma,
                                   refine_weights=refine_flags[s])
                     for i in range(L)]
        out = dict(per_layer[-1])
        for i in range(L - 1):
            for k, v in per_layer[i].items():
                if k != "cardinality_error":
                    out[f"{k}_{i}"] = v
        outs.append(out)
    outs[0]["match_iters"] = mstats["iters"].max().float()
    outs[0]["match_cleanup"] = mstats["cleanup"].sum().float()
    return outs, matching
