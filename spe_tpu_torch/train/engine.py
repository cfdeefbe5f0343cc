"""Train and evaluation loops (port of spe_tpu/train/engine.py:
`train_one_epoch` :36-76, `_eval_outputs`, `evaluate_coco` :97-151,
`_flip_merge`, `evaluate_voc`; reference engine.py:93-174, engine.py
`evaluate_refinements` :616-724 and engine_loc.py `evaluate_det_voc`
:126-201).

train_one_epoch: every batch through train_step, the losses logged, the
run stopped on a non-finite loss or a skipped step; in a distributed run
the epoch's means are averaged over the processes.

evaluate_coco: one refinement stage's second-to-last decoder layer (the
aux layer; the reference's eval head), top-100, class-wise NMS, then the
numpy COCO evaluator (spe_tpu_torch.data.coco_eval) on the host; where the
batches carry GT arrays, the eval-time losses of that layer against them
(one auction launch a batch on the card). In a distributed run each
process evaluates its share of the images; their detections are merged
across the processes (pack_detections -> all_gather_array ->
unpack_detections, JAX engine.py:162-209) and the eval losses averaged
before the summary, and process 0 alone writes the eval arrays.

evaluate_voc: stage-0 final decoder layer, optional horizontal-flip TTA
batched into one forward and merged by `_flip_merge`, top-k, class-wise
NMS, then VOC mAP and CorLoc on the host (spe_tpu_torch.data.voc_eval).
It holds no collective: a distributed run calls it on process 0 alone.
"""

from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np
import torch

from spe_tpu_torch.config import SPEConfig
from spe_tpu_torch.data.coco_eval import CocoEvaluator
from spe_tpu_torch.data.voc_eval import corloc, voc_eval_all
from spe_tpu_torch.ops.nms import batched_nms
from spe_tpu_torch.ops.postprocess import postprocess_topk
from spe_tpu_torch.parallel import dist
from spe_tpu_torch.parallel.tp import NO_TP
from spe_tpu_torch.train.criterion import _layer_losses, match
from spe_tpu_torch.train.train_step import train_step

# the terms train_one_epoch logs besides the loss (JAX engine.py:60-72);
# the last two only where the step traces the matching cost
LOGGED = ("loss_ce", "loss_bbox", "loss_giou", "grad_norm", "match_iters",
          "match_cleanup", "match_subopt_mean", "match_subopt_max",
          "loss_mask", "loss_dice")
# the eval-time criterion's terms (eval_losses)
EVAL_TERMS = ("cardinality_error", "loss_bbox", "loss_ce", "loss_giou")


class NonFiniteLoss(RuntimeError):
    """A step's loss or gradients were not finite: training stops."""


def sum_over_processes(count, sums, keys, tp=NO_TP):
    """(count, {k: sums[k]}) summed over the data-parallel processes of the
    model's layout `tp` (parallel/tp.py) in one all-reduce, the keys in the
    order given (every process the same); one process: as given. (A model
    group's ranks hold the same values.)"""
    if tp.data_size == 1:
        return count, {k: sums[k] for k in keys if k in sums}
    v = torch.tensor([count] + [sums.get(k, 0.0) for k in keys],
                     dtype=torch.float64)
    dist.all_reduce_sum_(v, tp.data_group)
    return v[0].item(), dict(zip(keys, v[1:].tolist()))


# what a training step reads of a batch: the GT arrays come with --masks
# (the mask losses' targets)
TRAIN_KEYS = ("images", "pad_mask", "img_label", "gt_boxes", "gt_labels",
              "gt_mask", "gt_masks")


def train_batch(batch, device):
    return {k: torch.as_tensor(batch[k], device=device)
            for k in TRAIN_KEYS if k in batch}


def train_one_epoch(state, loader, epoch: int, cfg: SPEConfig, gates, gen,
                    device, print_freq: int = 100):
    """-> {term: mean over the epoch's steps} of the loss and LOGGED, plus
    `steps`, `seconds` (host clock) and `history` (every step's logged
    values and its step_ms, host clock from the batch on the host to the
    loss read back, which synchronises). Raises
    NonFiniteLoss on a non-finite loss or a skipped step, as the JAX engine
    stops the run (engine.py:56-60): the loss and the skip are the
    processes' own in a distributed run, so every process stops at once.
    There the means are over every process's steps, in sorted key order
    (JAX engine.py:74); `history` stays this process's."""
    sums, history = {}, []
    total = loader.steps_per_epoch()
    t0 = time.perf_counter()
    for i, batch in enumerate(loader.epoch(epoch)):
        t_step = time.perf_counter()
        m = train_step(state, train_batch(batch, device), cfg, gates, gen)
        logged = {"loss": float(m["loss"]),
                  **{k: float(m[k]) for k in LOGGED if k in m}}
        logged["step_ms"] = (time.perf_counter() - t_step) * 1e3
        if not math.isfinite(logged["loss"]) or m["bad_steps"] > 0:
            raise NonFiniteLoss(
                f"Loss is {logged['loss']} ({m['bad_steps']} non-finite steps "
                "so far), stopping training")
        for k, v in logged.items():
            sums[k] = sums.get(k, 0.0) + v
        history.append(logged)
        if i % print_freq == 0 or i + 1 == total:
            print(f"Epoch [{epoch}] [{i + 1}/{total}] " + "  ".join(
                f"{k}: {v:.4f}" for k, v in logged.items()), flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    steps, sums = sum_over_processes(len(history), sums, sorted(sums),
                                     getattr(state.model, "tp", NO_TP))
    stats = {k: v / max(steps, 1) for k, v in sums.items()}
    stats.update(steps=len(history), seconds=time.perf_counter() - t0,
                 history=history)
    return stats


def _eval_outputs(model, batch, *, refine_stage: int, use_aux_layer: bool,
                  layer: int = -1):
    """-> ({pred_logits, pred_boxes} of the evaluated layer, full output)."""
    out = model(batch["images"], pad_mask=batch.get("pad_mask"))
    st = out["stages"][refine_stage]
    if use_aux_layer:
        return {"pred_logits": st["aux_pred_logits"][layer],
                "pred_boxes": st["aux_pred_boxes"][layer]}, out
    return {"pred_logits": st["pred_logits"],
            "pred_boxes": st["pred_boxes"]}, out


def eval_losses(outs, batch, cfg: SPEConfig, device):
    """The eval-time criterion of the evaluated layer against the batch's
    GT arrays (reference engine.py:644-660, losses labels/boxes/
    cardinality): the assignment, then the layer's losses without
    refinement weights -> {loss_ce, loss_bbox, loss_giou,
    cardinality_error}."""
    targets = {"boxes": torch.as_tensor(batch["gt_boxes"], device=device),
               "labels": torch.as_tensor(batch["gt_labels"], device=device),
               "mask": torch.as_tensor(batch["gt_mask"], device=device)}
    rows, _ = match(outs["pred_logits"], outs["pred_boxes"], targets,
                    method=cfg.assignment, cost_class=cfg.set_cost_class,
                    cost_bbox=cfg.set_cost_bbox, cost_giou=cfg.set_cost_giou)
    nb = targets["mask"].float().sum().clamp(min=1.0)
    return _layer_losses(outs["pred_logits"], outs["pred_boxes"], targets,
                         rows, nb, focal_alpha=cfg.focal_alpha,
                         focal_gamma=cfg.focal_gamma, refine_weights=False)


@torch.no_grad()
def evaluate_coco(model, loader, gt_coco: Dict, cfg: SPEConfig, device,
                  refine_stage: int = 0, keep: int = 100,
                  nms_iou: float = 0.5, use_aux_layer: bool = True,
                  eval_save_path=None) -> Dict[str, float]:
    """COCO AP/AR of one refinement stage over the loader's images against
    gt_coco (a COCO-format dict). use_aux_layer=True evaluates the
    second-to-last decoder layer, as the reference's evaluate_refinements
    (engine.py:642); False the final layer (its plain `evaluate`,
    engine.py:447). One forward a batch serves the detections and, where
    the batch carries gt_boxes/gt_labels/gt_mask, the eval-time losses,
    averaged over the batches as `eval_*`. With eval_save_path the
    accumulated precision/recall arrays go there (.npz; process 0 only).
    Also returns the number of model forwards run (`forwards`, this
    process's). Collective in a distributed run: every process calls it on
    its share of the images, and every process returns the stats of
    all."""
    model.eval()
    evaluator = CocoEvaluator(gt_coco)
    sums, n_loss, forwards = {}, 0, 0
    for batch in loader.epoch(0):
        images = torch.as_tensor(batch["images"], device=device)
        pad = torch.as_tensor(batch["pad_mask"], device=device)
        outs, _ = _eval_outputs(model, {"images": images, "pad_mask": pad},
                                refine_stage=refine_stage,
                                use_aux_layer=use_aux_layer)
        forwards += 1
        res = postprocess_topk(
            outs["pred_logits"], outs["pred_boxes"],
            torch.as_tensor(batch["orig_size"], device=device).float(),
            keep_queries=keep)
        keep_mask = batched_nms(res["boxes"], res["scores"], res["labels"],
                                torch.ones_like(res["scores"],
                                                dtype=torch.bool), nms_iou)
        if "gt_boxes" in batch:
            for k, v in eval_losses(outs, batch, cfg, device).items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n_loss += 1
        evaluator.update_from_arrays(
            batch["image_id"], res["boxes"].cpu().numpy(),
            res["scores"].cpu().numpy(), res["labels"].cpu().numpy(),
            keep_mask.cpu().numpy())
    tp = getattr(model, "tp", NO_TP)
    merge_across_processes(evaluator, tp=tp)
    n_loss, sums = sum_over_processes(n_loss, sums, EVAL_TERMS, tp)
    stats = evaluator.summarize()
    if n_loss:
        stats.update({f"eval_{k}": v / n_loss for k, v in sums.items()})
    if eval_save_path is not None and dist.process_index() == 0:
        evaluator.save_eval(eval_save_path)
    stats["forwards"] = forwards
    return stats


def pack_detections(evaluator, max_dets: int = 200_000) -> np.ndarray:
    """One process's detections as a fixed-shape float plane (max_dets, 8)
    of rows [valid, image_id, category_id, x, y, w, h, score] (JAX
    engine.py:162-178)."""
    rows = []
    for (img, cat), ds in evaluator._dt.items():
        for d in ds:
            b = d["bbox"]
            rows.append([1.0, img, cat, b[0], b[1], b[2], b[3], d["score"]])
    if len(rows) > max_dets:
        print(f"merge_across_processes: truncating {len(rows)} local "
              f"detections to the {max_dets} fixed-gather cap; AP may be "
              "affected", flush=True)
    arr = np.zeros((max_dets, 8), np.float32)
    if rows:
        packed = np.asarray(rows[:max_dets], np.float32)
        arr[:len(packed)] = packed
    return arr


def unpack_detections(evaluator, gathered: np.ndarray) -> None:
    """The evaluator's detections <- the union of every process's packed
    plane, gathered (P, max_dets, 8) (JAX engine.py:181-194)."""
    for k in evaluator._dt:
        evaluator._dt[k] = []
    for plane in gathered:
        for row in plane[plane[:, 0] > 0.5]:
            evaluator.update([{
                "image_id": int(row[1]), "category_id": int(row[2]),
                "bbox": [float(row[3]), float(row[4]), float(row[5]),
                         float(row[6])],
                "score": float(row[7])}])


def merge_across_processes(evaluator, max_dets: int = 200_000,
                           tp=NO_TP) -> None:
    """Every process's evaluator <- the detections of its data group, the
    data axis of the model's layout `tp` (a fixed-shape all-gather in
    place of the reference's pickled one, coco_eval.py:178-207; under
    tensor parallelism a model group's ranks hold the same detections, so
    the data group's are all). A no-op with one data-parallel process."""
    if tp.data_size == 1:
        return
    unpack_detections(evaluator, dist.all_gather_array(
        pack_detections(evaluator, max_dets), tp.data_group))


def _flip_merge(out_n, out_f, bb_n=None, bb_f=None):
    """decouple_output (engine_loc.py:99-124): flip x back, concat the query
    sets; image-level logits are elementwise-max merged."""
    boxes_f = out_f["pred_boxes"].clone()
    boxes_f[..., 0] = 1.0 - boxes_f[..., 0]
    merged = {
        "pred_logits": torch.cat([out_n["pred_logits"], out_f["pred_logits"]], 1),
        "pred_boxes": torch.cat([out_n["pred_boxes"], boxes_f], 1),
    }
    if bb_n is not None:
        for k in ("x_logits", "x_cls_logits"):
            if k in bb_n:
                merged[k] = torch.maximum(bb_n[k], bb_f[k])
    return merged


@torch.no_grad()
def infer_voc(model, images, pad_mask, sizes, *, refine_stage=0,
              with_flip=False, keep=300, nms_iou=0.5):
    """One batch on the model's device -> (postprocessed dict, keep mask)."""
    if with_flip:
        B = images.shape[0]
        cat = {"images": torch.cat([images, images.flip(2)], 0),
               "pad_mask": torch.cat([pad_mask, pad_mask.flip(2)], 0)}
        outs2, full2 = _eval_outputs(model, cat, refine_stage=refine_stage,
                                     use_aux_layer=False)
        bb = full2["backbone"]
        outs = _flip_merge({k: v[:B] for k, v in outs2.items()},
                           {k: v[B:] for k, v in outs2.items()},
                           {k: v[:B] for k, v in bb.items()},
                           {k: v[B:] for k, v in bb.items()})
    else:
        outs, _ = _eval_outputs(model, {"images": images, "pad_mask": pad_mask},
                                refine_stage=refine_stage, use_aux_layer=False)
    res = postprocess_topk(outs["pred_logits"], outs["pred_boxes"],
                           sizes.float(), keep_queries=keep)
    keep_mask = batched_nms(res["boxes"], res["scores"], res["labels"],
                            torch.ones_like(res["scores"], dtype=torch.bool),
                            nms_iou)
    return res, keep_mask


def evaluate_voc(model, loader, dataset, cfg: SPEConfig, device,
                 refine_stage: int = 0, with_flip: bool = False,
                 keep: int = 300, nms_iou: float = 0.5,
                 use_07_metric: bool = True, results_dir=None) -> Dict[str, float]:
    """VOC mAP + CorLoc over a VOCDevkitDataset; also returns the number of
    model forwards run (`forwards`)."""
    model.eval()
    num_classes = len(dataset.classes)
    all_dets = {c + 1: [] for c in range(num_classes)}
    top_boxes = {c + 1: {} for c in range(num_classes)}
    top_scores = {c + 1: {} for c in range(num_classes)}
    forwards = 0
    for batch in loader.epoch(0):
        res, keep_mask = infer_voc(
            model, torch.as_tensor(batch["images"], device=device),
            torch.as_tensor(batch["pad_mask"], device=device),
            torch.as_tensor(batch["orig_size"], device=device),
            refine_stage=refine_stage, with_flip=with_flip, keep=keep,
            nms_iou=nms_iou)
        forwards += 1
        boxes = res["boxes"].cpu().numpy()
        scores = res["scores"].cpu().numpy()
        labels = res["labels"].cpu().numpy()
        km = keep_mask.cpu().numpy()
        for b in range(len(batch["image_id"])):
            idx = int(batch["image_id"][b])
            for i in np.where(km[b])[0]:
                c = int(labels[b][i])
                if c == 0 or c > num_classes:  # column 0 is unused
                    continue
                all_dets[c].append((idx, float(scores[b][i]), boxes[b][i].tolist()))
                if idx not in top_scores[c] or scores[b][i] > top_scores[c][idx]:
                    top_scores[c][idx] = float(scores[b][i])
                    top_boxes[c][idx] = boxes[b][i].tolist()

    if results_dir is not None:
        from spe_tpu_torch.data.voc_eval import write_voc_results_files

        write_voc_results_files(all_dets, lambda k: dataset.items[k],
                                results_dir, dataset.classes)
    gt = dataset.eval_ground_truth()
    det_stats = voc_eval_all(all_dets, gt, use_07_metric=use_07_metric)
    return {**det_stats, **corloc(top_boxes, gt), "forwards": forwards}
