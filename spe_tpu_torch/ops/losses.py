"""Loss primitives (port of spe_tpu/ops/losses.py; reference
conditional_detr.py:225-235, 300-319, 468-494; the segmentation head's
dice and mask focal losses, segmentation.py): fixed shapes with masks,
every reduction over an explicit `num_boxes` normalizer."""

from __future__ import annotations

import torch

from spe_tpu_torch.ops.boxes import generalized_box_iou_aligned

_EPS = 1e-5


def sigmoid_binary_cross_entropy(logits, labels):
    """Elementwise BCE-with-logits, in the JAX package's stable form."""
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def weighted_sigmoid_focal_loss(logits, targets, num_boxes, weights,
                                alpha: float = 0.25, gamma: float = 2.0):
    """Focal loss with per-element weights over (B, Q, C): mean over Q, sum
    over (B, C), / num_boxes, with p_t clamped to [1e-5, 1 - 1e-5]."""
    prob = torch.sigmoid(logits)
    ce = sigmoid_binary_cross_entropy(logits, targets)
    p_t = prob * targets + (1 - prob) * (1 - targets)
    p_t = p_t.clamp(_EPS, 1 - _EPS)
    loss = weights * ce * (1 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    return loss.mean(dim=1).sum() / num_boxes


def image_label_bce(logits, labels):
    """Multilabel image classification BCE, mean over all elements."""
    return sigmoid_binary_cross_entropy(logits, labels.to(logits.dtype)).mean()


def masked_l1_loss(src_boxes, tgt_boxes, pair_mask, num_boxes,
                   pair_weight=None):
    """L1 box loss over matched aligned pairs; pair_mask 1.0 on real pairs."""
    l1 = (src_boxes - tgt_boxes).abs().sum(-1)
    if pair_weight is not None:
        l1 = l1 * pair_weight
    return (l1 * pair_mask).sum() / num_boxes


def masked_giou_loss(src_xyxy, tgt_xyxy, pair_mask, num_boxes,
                     pair_weight=None):
    """(1 - GIoU) over matched aligned pairs."""
    loss = 1.0 - generalized_box_iou_aligned(src_xyxy, tgt_xyxy)
    if pair_weight is not None:
        loss = loss * pair_weight
    return (loss * pair_mask).sum() / num_boxes


def dice_loss(logits, targets, num_boxes, row_mask=None):
    """Dice loss of flattened masks (N, P): 1 - (2 |p t| + 1) / (|p| + |t|
    + 1) a row, padded rows zeroed by row_mask (N,), summed / num_boxes."""
    probs = torch.sigmoid(logits)
    numerator = 2 * (probs * targets).sum(-1)
    denominator = probs.sum(-1) + targets.sum(-1)
    loss = 1 - (numerator + 1) / (denominator + 1)
    if row_mask is not None:
        loss = loss * row_mask
    return loss.sum() / num_boxes


def sigmoid_focal_loss_masks(logits, targets, num_boxes, alpha: float = 0.25,
                             gamma: float = 2.0, row_mask=None):
    """Focal loss of flattened mask logits (N, P), without the box focal
    loss's p_t clamp: mean over P, padded rows zeroed, summed / num_boxes."""
    prob = torch.sigmoid(logits)
    ce = sigmoid_binary_cross_entropy(logits, targets)
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    loss = loss.mean(dim=1)
    if row_mask is not None:
        loss = loss * row_mask
    return loss.sum() / num_boxes
