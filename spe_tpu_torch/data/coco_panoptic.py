"""COCO-panoptic dataset (the port's copy of spe_tpu/data/coco_panoptic.py;
reference datasets/coco_panoptic.py).

Reads the panoptic annotation json + per-image PNG segment-id maps
(ids encoded as R + 256*G + 65536*B, the COCO panoptic convention) without
panopticapi. Items provide boxes/labels derived from the segment bboxes plus
the segment map for PQ evaluation (data/panoptic_eval.py), and with return_masks each segment's
binary mask (--masks training).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np
from PIL import Image


def decode_segment_map(png: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) int64 segment ids."""
    png = png.astype(np.int64)
    return png[..., 0] + 256 * png[..., 1] + 65536 * png[..., 2]


class CocoPanopticDataset:
    def __init__(self, img_folder, ann_folder, ann_file, transform=None,
                 return_masks: bool = True):
        self.img_folder = Path(img_folder)
        self.ann_folder = Path(ann_folder)
        self.transform = transform
        self.return_masks = return_masks
        with open(ann_file) as f:
            coco = json.load(f)
        self.anns = sorted(coco["annotations"], key=lambda a: a["image_id"])
        self.images = {im["id"]: im for im in coco["images"]}
        self.categories = {c["id"]: c for c in coco.get("categories", [])}

    def __len__(self):
        return len(self.anns)

    def load_segments(self, idx: int):
        ann = self.anns[idx]
        png = np.asarray(Image.open(self.ann_folder / ann["file_name"]).convert("RGB"))
        return decode_segment_map(png), ann["segments_info"]

    def get_target(self, idx: int) -> Dict:
        ann = self.anns[idx]
        info = self.images[ann["image_id"]]
        h, w = info["height"], info["width"]
        segs = ann["segments_info"]
        boxes = np.array([s["bbox"] for s in segs], np.float32).reshape(-1, 4)
        boxes[:, 2:] += boxes[:, :2]  # xywh -> xyxy
        labels = np.array([s["category_id"] for s in segs], np.int64)
        iscrowd = np.array([s.get("iscrowd", 0) for s in segs], np.int64)
        img_label = np.zeros(max(self.categories, default=0), np.float32)
        for c in labels:
            if 1 <= c <= len(img_label):
                img_label[c - 1] = 1.0
        return {
            "image_id": ann["image_id"],
            "boxes": boxes,
            "labels": labels,
            "iscrowd": iscrowd,
            "img_label": img_label,
            "orig_size": np.array([h, w], np.int64),
            "size": np.array([h, w], np.int64),
            "area": np.array([s.get("area", 0) for s in segs], np.float32),
        }

    def target_at(self, idx: int):
        return self.get_target(idx)

    def image_path(self, idx: int):
        ann = self.anns[idx]
        name = self.images[ann["image_id"]]["file_name"]
        return self.img_folder / name

    def __getitem__(self, idx: int):
        img = Image.open(self.image_path(idx)).convert("RGB")
        target = self.get_target(idx)
        if self.return_masks:
            seg_map, segments = self.load_segments(idx)
            masks = np.stack([(seg_map == s["id"]) for s in segments]) \
                if segments else np.zeros((0,) + seg_map.shape, bool)
            target["masks"] = masks
        if self.transform is not None:
            return self.transform(img, target)
        from spe_tpu_torch.data.transforms import normalize_image

        return normalize_image(img), target
