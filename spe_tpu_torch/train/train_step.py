"""One training step (port of spe_tpu/train/train_step.py:45-231; reference
engine.py:93-174 `train_one_epoch_refine`):

  forward in training mode -> CAM pseudo-boxes (no grad; kernel 5 on the
  card) -> refinement pseudo-labels from the detached stage outputs ->
  set_criterion_multi over every stage (one auction launch, kernel 6) ->
  the epoch-gated weighted total -> backward -> finiteness check ->
  AdamW3 update, or a skipped step counted in bad_steps.

The num_boxes normaliser of each stage is max(valid targets x repeat
ratio, 1): the JAX package's max(total, num_devices) on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from spe_tpu_torch.config import SPEConfig
from spe_tpu_torch.ops.cam_boxes import cam_pseudo_boxes
from spe_tpu_torch.ops.postprocess import postprocess_refine
from spe_tpu_torch.train.criterion import (image_label_losses,
                                           repeated_num_boxes,
                                           set_criterion_multi)
from spe_tpu_torch.train.optim import AdamW3


@dataclasses.dataclass(frozen=True)
class Gates:
    """The epoch's loss gates (reference engine.py:134-142)."""
    det_weight: float      # 0 while epoch < warmup_cls_epochs
    refine_weight: float   # 0 while epoch < refine_start_epoch
    cam_thr: float         # cam_thr, then cam_thr_low from cam_thr_drop_epoch

    @staticmethod
    def for_epoch(cfg: SPEConfig, epoch: int) -> "Gates":
        return Gates(
            det_weight=0.0 if epoch < cfg.warmup_cls_epochs else 1.0,
            refine_weight=0.0 if epoch < cfg.refine_start_epoch else 1.0,
            cam_thr=cfg.cam_thr_at_epoch(epoch))


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: AdamW3
    bad_steps: int = 0   # steps whose loss or gradients were not finite


def loss_weights(cfg: SPEConfig) -> Dict[str, float]:
    weight = {}
    for name, coef in (("loss_ce", cfg.cls_loss_coef),
                       ("loss_bbox", cfg.bbox_loss_coef),
                       ("loss_giou", cfg.giou_loss_coef)):
        weight[name] = coef
        if cfg.aux_loss:
            for i in range(cfg.dec_layers - 1):
                weight[f"{name}_{i}"] = coef
    weight["img_label_logits"] = cfg.img_label_loss_coef
    weight["img_label_logits_tokens"] = cfg.img_label_tokens_loss_coef
    return weight


def compute_losses(model, batch, cfg: SPEConfig, gates: Gates, gen=None,
                   supervision=None):
    """Forward + pseudo-labels + every criterion -> (total, {name: loss},
    supervision). The supervision is the step's discrete, undifferentiated
    part: {"cam": the CAM pseudo-boxes, "refine": the refinement
    pseudo-labels, "matching": the assignment}. Given one (another run's),
    the step uses it in place of its own, so that both runs differentiate
    one loss. In training mode (`model.training`) the dropout masks and the
    box repeat draw from `gen` (a torch.Generator on the model's device);
    in eval mode there is neither."""
    training = model.training
    out = model(batch["images"], pad_mask=batch.get("pad_mask"),
                generator=gen if training else None)
    stages = out["stages"]
    if supervision is None:
        cam_targets = cam_pseudo_boxes(
            out["backbone"]["cams_cls"].detach(), batch["img_label"],
            gates.cam_thr, area_ratio=cfg.multi_box_ratio,
            size=cfg.cam_cc_size, k=cfg.max_cam_boxes_per_class,
            max_boxes=cfg.max_gt_boxes, max_pos=cfg.max_pos_classes)
        cam_targets["scores"] = torch.ones_like(cam_targets["labels"],
                                                dtype=torch.float32)
        refine_targets = {
            k + 1: postprocess_refine(stages[k]["pred_logits"].detach(),
                                      stages[k]["pred_boxes"].detach(),
                                      cam_targets["labels"],
                                      cam_targets["mask"])
            for k in range(cfg.num_refines)}
        matching = None
    else:
        cam_targets, refine_targets, matching = (
            supervision["cam"], supervision["refine"], supervision["matching"])

    tgt_list = [cam_targets] + list(refine_targets.values())
    stage_losses, matching = set_criterion_multi(
        [stages[0]] + [stages[k] for k in refine_targets], tgt_list,
        [gen if training else None] * len(tgt_list),
        [repeated_num_boxes(t, cfg.hung_match_ratio).clamp(min=1.0)
         for t in tgt_list],
        [False] + [True] * len(refine_targets),
        hung_match_ratio=cfg.hung_match_ratio, box_jitter=cfg.box_jitter,
        focal_alpha=cfg.focal_alpha, focal_gamma=cfg.focal_gamma,
        cost_class=cfg.set_cost_class, cost_bbox=cfg.set_cost_bbox,
        cost_giou=cfg.set_cost_giou, assignment=cfg.assignment,
        training=training, aux_loss=cfg.aux_loss, matching=matching)
    losses = dict(stage_losses[0])
    losses.update(image_label_losses(out["backbone"], batch["img_label"]))
    for k, sl in zip(refine_targets, stage_losses[1:]):
        losses.update({f"ref_{k}_{name}": v for name, v in sl.items()})

    # the gated weighted total (engine.py:134-144): refinement losses gate on
    # refine_weight AND det_weight, the warmup keeps only the image labels
    weight = loss_weights(cfg)
    total = torch.zeros((), device=batch["images"].device)
    for name, v in losses.items():
        if name.startswith("ref_"):
            short = name.split("_", 2)[2]
            if short in weight:
                total = total + (gates.refine_weight * gates.det_weight
                                 * weight[short]) * v
        elif name in weight:
            gate = 1.0 if name.startswith("img_label") else gates.det_weight
            total = total + (gate * weight[name]) * v
    return total, losses, {"cam": cam_targets, "refine": refine_targets,
                           "matching": matching}


def train_step(state: TrainState, batch, cfg: SPEConfig, gates: Gates, gen):
    """One update of state.model in training mode -> metrics {loss,
    grad_norm, bad_steps, every loss term, match_iters, match_cleanup} as
    detached tensors (bad_steps an int)."""
    state.model.train()
    state.optimizer.zero_grad()
    total, losses, _ = compute_losses(state.model, batch, cfg, gates, gen)
    total.backward()
    grad_norm, finite = state.optimizer.step(total.detach())
    if not finite:
        state.bad_steps += 1
    return {"loss": total.detach(), "grad_norm": grad_norm,
            "bad_steps": state.bad_steps,
            **{k: v.detach() for k, v in losses.items()}}
