"""COCO-protocol detection mAP evaluator, pure numpy: the port's copy of
spe_tpu/data/coco_eval.py (pycocotools is not installed).

It reimplements the COCOeval bbox protocol (the thing reference
datasets/coco_eval.py wraps): IoU thresholds 0.5:0.05:0.95, 101-point
interpolated precision, area ranges all/small/medium/large, maxDets (1, 10,
100), crowd handling (crowd GTs are ignore-matched with union = det area).

`merge()` joins another evaluator's detections (the reference's pickle
all_gather, coco_eval.py:178-207, is replaced by plain arrays); the merge
across processes comes with distributed runs, which the port does not
have yet.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """pycocotools bbox IoU: crowd GT uses union = det area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx, dy, dw, dh = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
    gx, gy, gw, gh = gts[:, 0], gts[:, 1], gts[:, 2], gts[:, 3]
    x1 = np.maximum(dx[:, None], gx[None, :])
    y1 = np.maximum(dy[:, None], gy[None, :])
    x2 = np.minimum((dx + dw)[:, None], (gx + gw)[None, :])
    y2 = np.minimum((dy + dh)[:, None], (gy + gh)[None, :])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    da = (dw * dh)[:, None]
    ga = (gw * gh)[None, :]
    union = np.where(iscrowd[None, :] > 0, da, da + ga - inter)
    return inter / np.maximum(union, 1e-12)


class CocoEvaluator:
    """update() per batch with detections; summarize() -> stats dict."""

    def __init__(self, gt: Dict):
        """gt: COCO-format dict with images/annotations/categories."""
        self.cat_ids = sorted(c["id"] for c in gt["categories"])
        self.img_ids = sorted(im["id"] for im in gt["images"])
        self._gt = {(i, c): [] for i in self.img_ids for c in self.cat_ids}
        for a in gt["annotations"]:
            key = (a["image_id"], a["category_id"])
            if key in self._gt:
                self._gt[key].append(a)
        self._dt: Dict[tuple, List[dict]] = {k: [] for k in self._gt}
        self._evaluated = None

    def update(self, detections: Sequence[Dict]) -> None:
        """detections: iterable of {image_id, category_id, bbox [x,y,w,h], score}."""
        for d in detections:
            key = (d["image_id"], d["category_id"])
            if key in self._dt:
                self._dt[key].append(d)

    def update_from_arrays(self, image_ids, boxes_xyxy, scores, labels, valid=None):
        """Device-friendly entry: arrays (B, N, ...) -> update()."""
        B = len(image_ids)
        for b in range(B):
            n = boxes_xyxy[b].shape[0]
            for i in range(n):
                if valid is not None and not valid[b][i]:
                    continue
                x0, y0, x1, y1 = [float(v) for v in boxes_xyxy[b][i]]
                self.update([{
                    "image_id": int(image_ids[b]),
                    "category_id": int(labels[b][i]),
                    "bbox": [x0, y0, x1 - x0, y1 - y0],
                    "score": float(scores[b][i]),
                }])

    def merge(self, other: "CocoEvaluator") -> None:
        for k, v in other._dt.items():
            self._dt[k].extend(v)

    # ------------------------------------------------------------------
    def _evaluate_img(self, img_id, cat_id, area_rng, max_det):
        gts = self._gt[(img_id, cat_id)]
        dts = sorted(self._dt[(img_id, cat_id)], key=lambda d: -d["score"])[:max_det]
        if not gts and not dts:
            return None
        g_boxes = np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
        g_crowd = np.array([g.get("iscrowd", 0) for g in gts], np.int64)
        g_area = np.array([g.get("area", b[2] * b[3]) for g, b in zip(gts, g_boxes)])
        g_ignore = (g_crowd > 0) | (g_area < area_rng[0]) | (g_area > area_rng[1])
        # sort gts: non-ignored first (pycocotools order)
        order = np.argsort(g_ignore, kind="stable")
        g_boxes, g_crowd, g_ignore = g_boxes[order], g_crowd[order], g_ignore[order]

        d_boxes = np.array([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
        d_scores = np.array([d["score"] for d in dts], np.float64)
        d_area = d_boxes[:, 2] * d_boxes[:, 3]

        ious = _iou_xywh(d_boxes, g_boxes, g_crowd)
        T, G, D = len(IOU_THRS), len(gts), len(dts)
        gtm = -np.ones((T, G), np.int64)
        dtm = -np.ones((T, D), np.int64)
        dt_ig = np.zeros((T, D), bool)
        for ti, t in enumerate(IOU_THRS):
            for di in range(D):
                iou_best = min(t, 1 - 1e-10)
                m = -1
                for gi in range(G):
                    if gtm[ti, gi] >= 0 and g_crowd[gi] == 0:
                        continue
                    # stop at ignored gts once a real match exists
                    if m > -1 and not g_ignore[m] and g_ignore[gi]:
                        break
                    if ious[di, gi] < iou_best:
                        continue
                    iou_best = ious[di, gi]
                    m = gi
                if m == -1:
                    continue
                dt_ig[ti, di] = g_ignore[m]
                dtm[ti, di] = m
                gtm[ti, m] = di
        # unmatched dets outside the area range are ignored
        out_of_range = (d_area < area_rng[0]) | (d_area > area_rng[1])
        dt_ig = dt_ig | ((dtm == -1) & out_of_range[None, :])
        return {
            "scores": d_scores,
            "matched": dtm >= 0,
            "dt_ignore": dt_ig,
            "num_gt": int((~g_ignore).sum()),
        }

    def accumulate(self):
        K = len(self.cat_ids)
        A = len(AREA_RANGES)
        M = len(MAX_DETS)
        T, R = len(IOU_THRS), len(REC_THRS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        for ki, cat in enumerate(self.cat_ids):
            for ai, area_rng in enumerate(AREA_RANGES.values()):
                for mi, max_det in enumerate(MAX_DETS):
                    per_img = [self._evaluate_img(i, cat, area_rng, max_det)
                               for i in self.img_ids]
                    per_img = [e for e in per_img if e is not None]
                    if not per_img:
                        continue
                    scores = np.concatenate([e["scores"] for e in per_img])
                    matched = np.concatenate([e["matched"] for e in per_img], axis=1)
                    dt_ig = np.concatenate([e["dt_ignore"] for e in per_img], axis=1)
                    npig = sum(e["num_gt"] for e in per_img)
                    if npig == 0:
                        continue
                    order = np.argsort(-scores, kind="mergesort")
                    matched = matched[:, order]
                    dt_ig = dt_ig[:, order]
                    tps = matched & ~dt_ig
                    fps = ~matched & ~dt_ig
                    tp = np.cumsum(tps, axis=1).astype(np.float64)
                    fp = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(T):
                        nd = len(scores)
                        rc = tp[ti] / npig
                        pr = tp[ti] / np.maximum(tp[ti] + fp[ti], 1e-12)
                        recall[ti, ki, ai, mi] = rc[-1] if nd else 0
                        # monotone-decreasing precision envelope
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q
        self._evaluated = {"precision": precision, "recall": recall}
        return self._evaluated

    def save_eval(self, path) -> None:
        """Persist the accumulated precision/recall arrays — the analog of the
        reference's `eval.pth` artifacts (main_coco.py:398-407, which torch.saves
        coco_eval.eval per epoch). Written as .npz."""
        if self._evaluated is None:
            self.accumulate()
        np.savez_compressed(path, precision=self._evaluated["precision"],
                            recall=self._evaluated["recall"],
                            iou_thrs=IOU_THRS, rec_thrs=REC_THRS,
                            cat_ids=np.asarray(self.cat_ids))

    def summarize(self) -> Dict[str, float]:
        if self._evaluated is None:
            self.accumulate()
        p = self._evaluated["precision"]
        r = self._evaluated["recall"]

        def ap(iou=None, area="all", max_det=100):
            ai = list(AREA_RANGES).index(area)
            mi = MAX_DETS.index(max_det)
            s = p[:, :, :, ai, mi]
            if iou is not None:
                ti = int(np.argmin(np.abs(IOU_THRS - iou)))
                s = s[ti:ti + 1]
            s = s[s > -1]
            return float(s.mean()) if s.size else -1.0

        def ar(area="all", max_det=100):
            ai = list(AREA_RANGES).index(area)
            mi = MAX_DETS.index(max_det)
            s = r[:, :, ai, mi]
            s = s[s > -1]
            return float(s.mean()) if s.size else -1.0

        return {
            "AP": ap(), "AP50": ap(iou=0.5), "AP75": ap(iou=0.75),
            "APs": ap(area="small"), "APm": ap(area="medium"), "APl": ap(area="large"),
            "AR1": ar(max_det=1), "AR10": ar(max_det=10), "AR100": ar(),
            "ARs": ar(area="small"), "ARm": ar(area="medium"), "ARl": ar(area="large"),
        }
