"""COCO-format detection dataset, dependency-free (json + PIL); the port's
copy of spe_tpu/data/coco.py. With return_masks each kept annotation's
instance mask (data/masks.py: its polygons or RLE) rides in the target.

Rebuild of reference datasets/coco.py `CocoDetection` +
`ConvertCocoPolysToMask` (coco.py:164-268) without torchvision/pycocotools:
  * iscrowd annotations dropped (coco.py:217);
  * xywh -> xyxy, clamped to the image (coco.py:222-224);
  * degenerate boxes filtered (coco.py:241-243);
  * `img_label` multi-hot of (category_id - 1) — the weak supervision signal
    (coco.py:228);
  * optional removal of images without annotations
    (`_coco_remove_images_without_annotations`, coco.py:125-162).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np
from PIL import Image


class CocoFormatDataset:
    def __init__(self, img_folder, ann_file, transform=None, num_classes: int = 90,
                 remove_empty: bool = True, return_masks: bool = False):
        self.img_folder = Path(img_folder)
        self.transform = transform
        self.num_classes = num_classes
        # decode instance masks (reference ConvertCocoPolysToMask
        # return_masks, coco.py:199-210): --masks training
        self.return_masks = return_masks
        with open(ann_file) as f:
            coco = json.load(f)
        self.images = {im["id"]: im for im in coco["images"]}
        self.anns_by_img: Dict[int, List[dict]] = {i: [] for i in self.images}
        for a in coco.get("annotations", []):
            if a["image_id"] in self.anns_by_img:
                self.anns_by_img[a["image_id"]].append(a)
        self.categories = {c["id"]: c.get("name", str(c["id"]))
                           for c in coco.get("categories", [])}
        ids = sorted(self.images)
        if remove_empty:
            ids = [i for i in ids if any(
                a.get("iscrowd", 0) == 0 and a.get("bbox", [0, 0, 0, 0])[2] > 0
                and a["bbox"][3] > 0 for a in self.anns_by_img[i])]
        self.ids = ids
        # keep raw dicts for the evaluator (ground-truth side)
        self.raw = coco

    def __len__(self):
        return len(self.ids)

    def load_image(self, image_id: int) -> Image.Image:
        info = self.images[image_id]
        return Image.open(self.img_folder / info["file_name"]).convert("RGB")

    def image_path(self, idx: int):
        """File path by dataset index (native decode fast path)."""
        return self.img_folder / self.images[self.ids[idx]]["file_name"]

    def target_at(self, idx: int):
        """Target by dataset index (get_target keys by image id)."""
        return self.get_target(self.ids[idx])

    def get_target(self, image_id: int) -> Dict:
        info = self.images[image_id]
        w, h = info["width"], info["height"]
        anno = [a for a in self.anns_by_img[image_id] if a.get("iscrowd", 0) == 0]
        boxes = np.array([a["bbox"] for a in anno], np.float32).reshape(-1, 4)
        boxes[:, 2:] += boxes[:, :2]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h)
        classes = np.array([a["category_id"] for a in anno], np.int64)

        img_label = np.zeros(self.num_classes, np.float32)
        for c in classes:
            if 1 <= c <= self.num_classes:
                img_label[c - 1] = 1.0

        keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
        target = {
            "image_id": image_id,
            "boxes": boxes[keep],
            "labels": classes[keep],
            "img_label": img_label,
            "orig_size": np.array([h, w], np.int64),
            "size": np.array([h, w], np.int64),
            "area": np.array([a.get("area", 0.0) for a in anno], np.float32)[keep],
            "iscrowd": np.zeros(int(keep.sum()), np.int64),
        }
        if self.return_masks:
            from spe_tpu_torch.data.masks import ann_to_mask

            masks = [ann_to_mask(a.get("segmentation", []), h, w)
                     for a in anno]
            masks = (np.stack(masks) if masks
                     else np.zeros((0, h, w), np.uint8))
            target["masks"] = masks[keep]
        return target

    def __getitem__(self, idx: int):
        image_id = self.ids[idx]
        img = self.load_image(image_id)
        target = self.get_target(image_id)
        if self.transform is not None:
            img, target = self.transform(img, target)
        else:
            from spe_tpu_torch.data.transforms import normalize_image

            img = normalize_image(img)
        return img, target
