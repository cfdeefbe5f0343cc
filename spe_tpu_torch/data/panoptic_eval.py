"""Panoptic quality (PQ) evaluation, pure numpy (the port's copy of
spe_tpu/data/panoptic_eval.py).

Replaces the reference's panopticapi dependency (datasets/panoptic_eval.py):
PQ = SQ * RQ computed from segment matches at IoU > 0.5, with the standard
VOID/ignore handling. Segments are given as integer id maps + per-segment
category/iscrowd dicts (the panopticapi in-memory format).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _segment_areas(id_map: np.ndarray) -> Dict[int, int]:
    ids, counts = np.unique(id_map, return_counts=True)
    return dict(zip(ids.tolist(), counts.tolist()))


def pq_compute_single(gt_map: np.ndarray, gt_segments: Sequence[Dict],
                      pred_map: np.ndarray, pred_segments: Sequence[Dict],
                      void_id: int = 0):
    """Per-image PQ stats: returns {category: [iou_sum, tp, fp, fn]}."""
    gt_by_id = {s["id"]: s for s in gt_segments}
    pred_by_id = {s["id"]: s for s in pred_segments}
    gt_areas = _segment_areas(gt_map)
    pred_areas = _segment_areas(pred_map)

    # joint histogram of (gt_id, pred_id) pairs
    combined = gt_map.astype(np.int64) * (2**32) + pred_map.astype(np.int64)
    ids, counts = np.unique(combined, return_counts=True)
    inter = {(int(i // 2**32), int(i % 2**32)): int(c) for i, c in zip(ids, counts)}

    stats: Dict[int, List[float]] = {}

    def _ensure(cat):
        if cat not in stats:
            stats[cat] = [0.0, 0, 0, 0]
        return stats[cat]

    matched_gt, matched_pred = set(), set()
    for (gid, pid), i in inter.items():
        if gid == void_id or pid == void_id:
            continue
        if gid not in gt_by_id or pid not in pred_by_id:
            continue
        g, p = gt_by_id[gid], pred_by_id[pid]
        if g.get("iscrowd", 0) or g["category_id"] != p["category_id"]:
            continue
        # panopticapi discounts the part of the prediction lying on GT VOID
        union = (gt_areas.get(gid, 0) + pred_areas.get(pid, 0) - i
                 - inter.get((void_id, pid), 0))
        iou = i / max(union, 1)
        if iou > 0.5:
            s = _ensure(g["category_id"])
            s[0] += iou
            s[1] += 1
            matched_gt.add(gid)
            matched_pred.add(pid)

    crowd_by_cat = {}
    for gid, g in gt_by_id.items():
        if g.get("iscrowd", 0):
            crowd_by_cat[g["category_id"]] = gid
            continue
        if gid not in matched_gt:
            _ensure(g["category_id"])[3] += 1  # FN
    for pid, p in pred_by_id.items():
        if pid in matched_pred:
            continue
        # predictions mostly covered by VOID or same-class crowd are ignored
        void_overlap = inter.get((void_id, pid), 0)
        crowd_gid = crowd_by_cat.get(p["category_id"])
        if crowd_gid is not None:
            void_overlap += inter.get((crowd_gid, pid), 0)
        if void_overlap / max(pred_areas.get(pid, 1), 1) > 0.5:
            continue
        _ensure(p["category_id"])[2] += 1  # FP
    return stats


class PanopticEvaluator:
    def __init__(self):
        self.stats: Dict[int, List[float]] = {}

    def update(self, gt_map, gt_segments, pred_map, pred_segments):
        for cat, s in pq_compute_single(gt_map, gt_segments, pred_map,
                                        pred_segments).items():
            acc = self.stats.setdefault(cat, [0.0, 0, 0, 0])
            for i in range(4):
                acc[i] += s[i]

    def summarize(self) -> Dict[str, float]:
        pq, sq, rq, n = 0.0, 0.0, 0.0, 0
        for cat, (iou_sum, tp, fp, fn) in self.stats.items():
            if tp + fp + fn == 0:
                continue
            n += 1
            sq_c = iou_sum / tp if tp else 0.0
            rq_c = tp / (tp + 0.5 * fp + 0.5 * fn)
            pq += sq_c * rq_c
            sq += sq_c
            rq += rq_c
        n = max(n, 1)
        return {"PQ": pq / n, "SQ": sq / n, "RQ": rq / n, "n": n}
