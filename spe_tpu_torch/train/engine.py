"""VOC evaluation loop (port of the eval half of spe_tpu/train/engine.py:
`_eval_outputs`, `_flip_merge`, `evaluate_voc`; reference engine_loc.py
`evaluate_det_voc` :126-201).

Stage-0 final decoder layer, optional horizontal-flip TTA batched into one
forward and merged by `_flip_merge`, top-k, class-wise NMS, then VOC mAP and
CorLoc on the host with the JAX package's own evaluators
(spe_tpu.data.voc_eval). Training is not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from spe_tpu.config import SPEConfig
from spe_tpu.data.voc_eval import corloc, voc_eval_all
from spe_tpu_torch.ops.nms import batched_nms
from spe_tpu_torch.ops.postprocess import postprocess_topk


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
        from spe_tpu.data.voc_eval import write_voc_results_files

        write_voc_results_files(all_dets, lambda k: dataset.items[k],
                                results_dir, dataset.classes)
    gt = dataset.eval_ground_truth()
    det_stats = voc_eval_all(all_dets, gt, use_07_metric=use_07_metric)
    return {**det_stats, **corloc(top_boxes, gt), "forwards": forwards}
