"""Synthetic detection dataset for tests/smoke runs (no real data on disk);
the port's copy of spe_tpu/data/synthetic.py; with return_masks each
rectangle's mask rides in the target (--masks training).

Generates images with solid colored rectangles on noise; the rectangle color
index is the class. Provides the same item contract as CocoFormatDataset and
can emit a COCO-format ground-truth dict for the evaluator, so the whole
train/eval stack can be exercised end-to-end without VOC/COCO downloads.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from PIL import Image

_PALETTE = np.array([
    [220, 40, 40], [40, 200, 40], [40, 80, 220], [230, 210, 40], [200, 50, 210],
    [40, 210, 210], [240, 140, 40], [120, 70, 20], [130, 220, 130], [80, 80, 80],
    [250, 250, 250], [20, 20, 90], [90, 160, 60], [170, 30, 100], [30, 100, 170],
    [210, 170, 120], [60, 30, 160], [160, 160, 30], [30, 160, 90], [100, 10, 10],
], np.uint8)


class SyntheticDetection:
    def __init__(self, num_images: int = 64, num_classes: int = 5,
                 img_size: int = 128, max_objects: int = 3, seed: int = 0,
                 transform=None, min_frac: float = 1 / 6, max_frac: float = 1 / 2,
                 return_masks: bool = False):
        assert num_classes <= len(_PALETTE)
        self.return_masks = return_masks
        self.n = num_images
        self.num_classes = num_classes
        self.img_size = img_size
        self.max_objects = max_objects
        self.seed = seed
        self.transform = transform
        self.min_frac = min_frac
        self.max_frac = max_frac
        self._items = [self._make(i) for i in range(num_images)]

    def __len__(self):
        return self.n

    def _make(self, idx: int):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        s = self.img_size
        img = rng.integers(90, 150, (s, s, 3)).astype(np.uint8)
        n_obj = int(rng.integers(1, self.max_objects + 1))
        boxes, labels = [], []
        for _ in range(n_obj):
            w = int(rng.integers(int(s * self.min_frac), int(s * self.max_frac)))
            h = int(rng.integers(int(s * self.min_frac), int(s * self.max_frac)))
            x0 = int(rng.integers(0, s - w))
            y0 = int(rng.integers(0, s - h))
            c = int(rng.integers(0, self.num_classes))
            img[y0:y0 + h, x0:x0 + w] = _PALETTE[c]
            boxes.append([x0, y0, x0 + w, y0 + h])
            labels.append(c + 1)  # 1-based category ids like COCO/VOC
        return img, np.array(boxes, np.float32), np.array(labels, np.int64)

    def get_target(self, idx: int) -> Dict:
        img, boxes, labels = self._items[idx]
        h, w = img.shape[:2]
        img_label = np.zeros(self.num_classes, np.float32)
        for c in labels:
            img_label[c - 1] = 1.0
        return {
            "image_id": idx,
            "boxes": boxes.copy(),
            "labels": labels.copy(),
            "img_label": img_label,
            "orig_size": np.array([h, w], np.int64),
            "size": np.array([h, w], np.int64),
            "area": (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]),
            "iscrowd": np.zeros(len(labels), np.int64),
            **({"masks": self._masks(boxes, h, w)} if self.return_masks else {}),
        }

    def _masks(self, boxes, h, w):
        m = np.zeros((len(boxes), h, w), np.uint8)
        for i, (x0, y0, x1, y1) in enumerate(boxes.astype(int)):
            m[i, y0:y1, x0:x1] = 1
        return m

    def target_at(self, idx: int):
        return self.get_target(idx)

    def __getitem__(self, idx: int):
        img, _, _ = self._items[idx]
        target = self.get_target(idx)
        pil = Image.fromarray(img)
        if self.transform is not None:
            return self.transform(pil, target)
        from spe_tpu_torch.data.transforms import normalize_image

        return normalize_image(pil), target

    def coco_gt(self) -> Dict:
        """COCO-format GT dict for the evaluator."""
        images, annotations = [], []
        ann_id = 1
        for i in range(self.n):
            t = self.get_target(i)
            h, w = t["orig_size"]
            images.append({"id": i, "width": int(w), "height": int(h),
                           "file_name": f"synthetic_{i}.jpg"})
            for b, l in zip(t["boxes"], t["labels"]):
                x0, y0, x1, y1 = [float(v) for v in b]
                annotations.append({
                    "id": ann_id, "image_id": i, "category_id": int(l),
                    "bbox": [x0, y0, x1 - x0, y1 - y0],
                    "area": float((x1 - x0) * (y1 - y0)), "iscrowd": 0,
                })
                ann_id += 1
        cats = [{"id": c + 1, "name": f"class_{c}"} for c in range(self.num_classes)]
        return {"images": images, "annotations": annotations, "categories": cats}
