"""One training step (port of spe_tpu/train/train_step.py:45-231; reference
engine.py:93-174 `train_one_epoch_refine`):

  forward in training mode -> CAM pseudo-boxes (no grad; kernel 5 on the
  card) -> refinement pseudo-labels from the detached stage outputs ->
  set_criterion_multi over every stage (one auction launch, kernel 6) ->
  with `--masks` and GT masks in the batch, the mask branch -> the
  epoch-gated weighted total -> backward -> finiteness check -> AdamW3
  update, or a skipped step counted in bad_steps.

The mask branch (JAX train_step.py:118-142): the segmentation head's
masks (the model's forward with_masks), stage 0's last layer matched on
its own against the raw GT set (one more auction launch a step; as in the
JAX package, not the box losses' matching, whose targets are the CAM
pseudo-boxes, which have no masks), and loss_mask / loss_dice normalised
by max(GT count, W) / W over the W processes.

Each stage's num_boxes normaliser is max(N, W) / W, N the valid targets x
the repeat ratio summed over the W data-parallel processes (one all-reduce
of every stage's count): the reference's max(all_reduce(N) / W, 1)
(conditional_detr.py:435-440). With the gradients averaged over the
processes that is the JAX package's max(N, num_devices) on the global batch
(spe_tpu/train/train_step.py:12-16).

In a distributed run the step's gradients and loss are averaged over the
data-parallel processes in one flat bucket, one all-reduce after the whole
backward, so that the optimizer clips the global gradient and every
process takes the same update, or the same skip. Under tensor parallelism
(`--model_axis M`, parallel/mesh.py) W is the data width, world / M, as the
JAX CLI divides by it (spe_tpu/cli/main.py:64,162), and the data group
holds the processes of this one's model index; first, in one more flat
all-reduce over the model group (reduce_model_group_grads), the
column-parallel biases' gradients, each rank's part, are summed and the
replicated parameters' averaged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from spe_tpu_torch.config import SPEConfig
from spe_tpu_torch.ops.cam_boxes import cam_pseudo_boxes
from spe_tpu_torch.ops.postprocess import postprocess_refine
from spe_tpu_torch.parallel import dist
from spe_tpu_torch.parallel.tp import NO_TP
from spe_tpu_torch.train.criterion import (image_label_losses, mask_losses,
                                           match, repeated_num_boxes,
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
    weight["loss_mask"] = cfg.mask_loss_coef
    weight["loss_dice"] = cfg.dice_loss_coef
    return weight


def num_boxes_per_stage(targets_per_stage, ratio: int, tp=NO_TP):
    """Each stage's normaliser, max(N, W) / W (see above), W the data axis
    of the model's layout `tp` (parallel/tp.py)."""
    n = torch.stack([repeated_num_boxes(t, ratio) for t in targets_per_stage])
    W = tp.data_size
    dist.all_reduce_sum_(n, tp.data_group)
    return list((n.clamp(min=float(W)) / W).unbind())


def mask_num_boxes(gt_mask, tp=NO_TP):
    """The mask losses' normaliser, max(N, W) / W of the GT count N summed
    over the W data-parallel processes of `tp` (JAX's max(N, num_devices),
    train_step.py:136)."""
    n = gt_mask.float().sum()
    W = tp.data_size
    dist.all_reduce_sum_(n, tp.data_group)
    return n.clamp(min=float(W)) / W


def mask_branch(out, batch, cfg: SPEConfig, rows=None, tp=NO_TP):
    """The mask losses of out["pred_masks"] against batch's GT masks ->
    ({loss_mask, loss_dice}, the rows matched: stage 0's last layer
    against the raw GT set, or `rows` given, another run's)."""
    s0 = out["stages"][0]
    if rows is None:
        gt = {"boxes": batch["gt_boxes"], "labels": batch["gt_labels"],
              "mask": batch["gt_mask"]}
        rows, _ = match(s0["pred_logits"], s0["pred_boxes"], gt,
                        method=cfg.assignment, cost_class=cfg.set_cost_class,
                        cost_bbox=cfg.set_cost_bbox,
                        cost_giou=cfg.set_cost_giou)
    losses = mask_losses(out["pred_masks"], batch["gt_masks"], rows,
                         batch["gt_mask"],
                         mask_num_boxes(batch["gt_mask"], tp),
                         focal_alpha=cfg.focal_alpha,
                         focal_gamma=cfg.focal_gamma)
    return losses, rows


def compute_losses(model, batch, cfg: SPEConfig, gates: Gates, gen=None,
                   supervision=None):
    """Forward + pseudo-labels + every criterion -> (total, {name: loss},
    supervision). The supervision is the step's discrete, undifferentiated
    part: {"cam": the CAM pseudo-boxes, "refine": the refinement
    pseudo-labels, "matching": the assignment, and with the mask branch
    "mask_matching": its rows}. Given one (another run's), the step uses it
    in place of its own, so that both runs differentiate one loss. In
    training mode (`model.training`) the dropout masks and the box repeat
    draw from `gen` (a torch.Generator on the model's device); in eval mode
    there is neither. The segmentation head runs only where the mask
    losses read it: a model with `masks` and a batch with `gt_masks`."""
    training = model.training
    tp = getattr(model, "tp", NO_TP)   # its data axis: the normalisers'
    with_masks = getattr(model, "masks", False) and "gt_masks" in batch
    out = model(batch["images"], pad_mask=batch.get("pad_mask"),
                generator=gen if training else None, with_masks=with_masks)
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
        num_boxes_per_stage(tgt_list, cfg.hung_match_ratio, tp),
        [False] + [True] * len(refine_targets),
        hung_match_ratio=cfg.hung_match_ratio, box_jitter=cfg.box_jitter,
        focal_alpha=cfg.focal_alpha, focal_gamma=cfg.focal_gamma,
        cost_class=cfg.set_cost_class, cost_bbox=cfg.set_cost_bbox,
        cost_giou=cfg.set_cost_giou, assignment=cfg.assignment,
        training=training, aux_loss=cfg.aux_loss, matching=matching,
        cost_trace=cfg.log_match_cost)
    losses = dict(stage_losses[0])
    losses.update(image_label_losses(out["backbone"], batch["img_label"]))
    for k, sl in zip(refine_targets, stage_losses[1:]):
        losses.update({f"ref_{k}_{name}": v for name, v in sl.items()})
    used = {"cam": cam_targets, "refine": refine_targets,
            "matching": matching}
    if with_masks:
        ml, used["mask_matching"] = mask_branch(
            out, batch, cfg,
            None if supervision is None else supervision["mask_matching"],
            tp)
        losses.update(ml)

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
    return total, losses, used


def reduce_model_group_grads(params):
    """Under tensor parallelism (parameters marked by
    sharding_rules.shard_model), in one flat f32 all-reduce over the model
    group: the column-parallel biases' gradients (`tp_partial`: each rank's
    holds its columns' part, zero elsewhere) <- their sums, the replicated
    parameters' (`tp_replica`) <- their means. Each rank computes the
    replicated ones alike, but CUDA kernels that sum with atomics (the
    bicubic pos_embed interpolation's backward) may round them apart: the
    mean keeps every rank's update bit for bit the same. A no-op without
    tensor parallelism."""
    parts = [p for p in params if p.grad is not None and (
        hasattr(p, "tp_partial") or hasattr(p, "tp_replica"))]
    if not parts:
        return
    tp = getattr(parts[0], "tp_partial", None) or parts[0].tp_replica
    flat = torch.cat([p.grad.reshape(-1).float() for p in parts])
    tp.all_reduce_(flat)
    for p, part in zip(parts, flat.split([p.numel() for p in parts])):
        if hasattr(p, "tp_replica"):
            part = part / tp.size
        p.grad = part.view_as(p).to(p.grad.dtype)


def average_gradients(params, loss, group=None):
    """Every parameter's gradient and the loss <- their means over the
    data-parallel processes (`group`, None for every process), in one flat
    f32 bucket (one all-reduce) -> the mean loss."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [loss.reshape(1).float()])
    dist.all_reduce_mean_(flat, group)
    for p, part in zip(params, flat[:-1].split([p.numel() for p in params])):
        p.grad = part.view_as(p).to(p.dtype)
    return flat[-1]


def train_step(state: TrainState, batch, cfg: SPEConfig, gates: Gates, gen):
    """One update of state.model in training mode -> metrics {loss,
    grad_norm, bad_steps, every loss term, match_iters, match_cleanup} as
    detached tensors (bad_steps an int). In a distributed run `loss` and
    the update are the data-parallel processes' mean, the other terms this
    process's (a model group's ranks compute the same ones)."""
    state.model.train()
    state.optimizer.zero_grad()
    total, losses, _ = compute_losses(state.model, batch, cfg, gates, gen)
    total.backward()
    total = total.detach()
    reduce_model_group_grads(state.optimizer.params)
    tp = getattr(state.model, "tp", NO_TP)
    if tp.data_size > 1:
        total = average_gradients(state.optimizer.params, total,
                                  tp.data_group)
    grad_norm, finite = state.optimizer.step(total)
    if not finite:
        state.bad_steps += 1
    return {"loss": total, "grad_norm": grad_norm,
            "bad_steps": state.bad_steps,
            **{k: v.detach() for k, v in losses.items()}}
