"""Generate miniature on-disk datasets in the REAL formats the drivers eat.

The published recipes need data this environment doesn't have (VOC/COCO
images, zero egress). These generators write byte-real stand-ins — actual
JPEG files, VOC XML annotations, ImageSets txt splits, COCO instance jsons —
so the ENTIRE data path (XML parsing, COCO json loading, the native C++
JPEG decoder, transforms, eval ground truth) is exercised end-to-end by
`scripts/run_accuracy.py rehearse` before a real data drop ever happens.

Images are the same rectangles-on-noise scheme as data/synthetic.py (the
rectangle color indexes the class), so short training runs show learnable
signal.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Tuple

import numpy as np
from PIL import Image

from spe_tpu_torch.data.synthetic import _PALETTE
from spe_tpu_torch.data.voc import VOC_CLASSES


def _class_color(c: int) -> np.ndarray:
    """The rectangle colour of class index c: the synthetic palette's for
    the first 20 classes, one drawn from a generator seeded by c past it
    (COCO's 90)."""
    if c < len(_PALETTE):
        return _PALETTE[c]
    return np.random.default_rng(c).integers(0, 256, 3).astype(np.uint8)


def _make_scene(rng, img_size: int, num_classes: int, max_objects: int = 3,
                min_frac: float = 0.25, max_frac: float = 0.5,
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (image uint8 HxWx3, boxes xyxy float, labels 1-based int).

    min/max_frac bound object side length as a fraction of img_size. The
    default 1/4 keeps objects >= ~2 patch cells at the rehearsal's 16px
    patches, the regime where the 8x8 CAM grid can localize (the dev
    convergence recipe's finding, tests/convergence_recipe.py)."""
    s = img_size
    img = rng.integers(90, 150, (s, s, 3)).astype(np.uint8)
    n_obj = int(rng.integers(1, max_objects + 1))
    boxes, labels = [], []
    for _ in range(n_obj):
        w = int(rng.integers(int(s * min_frac), int(s * max_frac)))
        h = int(rng.integers(int(s * min_frac), int(s * max_frac)))
        x0 = int(rng.integers(0, s - w))
        y0 = int(rng.integers(0, s - h))
        c = int(rng.integers(0, num_classes))
        img[y0:y0 + h, x0:x0 + w] = _class_color(c)
        boxes.append([x0, y0, x0 + w, y0 + h])
        labels.append(c + 1)
    return img, np.array(boxes, np.float32), np.array(labels, np.int64)


def _voc_xml(img_id: str, w: int, h: int, boxes, labels) -> str:
    objs = []
    for b, l in zip(boxes, labels):
        name = VOC_CLASSES[int(l) - 1]
        # VOC boxes are 1-based pixel indices (parse_voc_xml subtracts 1)
        objs.append(
            f"<object><name>{name}</name><difficult>0</difficult>"
            f"<bndbox><xmin>{int(b[0]) + 1}</xmin><ymin>{int(b[1]) + 1}</ymin>"
            f"<xmax>{int(b[2]) + 1}</xmax><ymax>{int(b[3]) + 1}</ymax>"
            f"</bndbox></object>")
    return (f"<annotation><filename>{img_id}.jpg</filename>"
            f"<size><width>{w}</width><height>{h}</height><depth>3</depth></size>"
            + "".join(objs) + "</annotation>")


def _coco_json(entries: List[dict], num_classes: int, class_names=None) -> dict:
    images, annotations = [], []
    ann_id = 1
    for e in entries:
        images.append({"id": e["id"], "width": e["w"], "height": e["h"],
                       "file_name": e["file_name"]})
        for b, l in zip(e["boxes"], e["labels"]):
            x0, y0, x1, y1 = [float(v) for v in b]
            annotations.append({
                "id": ann_id, "image_id": e["id"], "category_id": int(l),
                "bbox": [x0, y0, x1 - x0, y1 - y0],
                "area": float((x1 - x0) * (y1 - y0)), "iscrowd": 0,
            })
            ann_id += 1
    names = class_names or [f"class_{c}" for c in range(num_classes)]
    cats = [{"id": c + 1, "name": names[c]} for c in range(num_classes)]
    return {"images": images, "annotations": annotations, "categories": cats}


def make_mini_voc(root, n_trainval: int = 32, n_test: int = 16,
                  img_size: int = 128, num_classes: int = 20,
                  seed: int = 0) -> Tuple[Path, Path]:
    """Write a mini VOCdevkit + the COCO-format VOC jsons the recipe trains
    on (reference datasets/voc.py: voc_07_12_trainval.json / ...test.json).

    Returns (devkit_root, coco_root) for --test_path / --coco_path.
    """
    root = Path(root)
    devkit = root / "VOCdevkit"
    coco_root = root / "voc_coco"
    rng = np.random.default_rng(seed)
    num_classes = min(num_classes, len(VOC_CLASSES))

    train_entries, test_entries = [], []
    # split trainval across VOC2007 + VOC2012 like the real recipe
    specs = [("VOC2007", "trainval", n_trainval // 2, train_entries),
             ("VOC2012", "trainval", n_trainval - n_trainval // 2, train_entries),
             ("VOC2007", "test", n_test, test_entries)]
    counters = {}
    for year, split, n, bucket in specs:
        ydir = devkit / year
        (ydir / "JPEGImages").mkdir(parents=True, exist_ok=True)
        (ydir / "Annotations").mkdir(parents=True, exist_ok=True)
        (ydir / "ImageSets" / "Main").mkdir(parents=True, exist_ok=True)
        ids = []
        for _ in range(n):
            counters[year] = counters.get(year, 0) + 1
            img_id = f"{year[-4:]}_{counters[year]:06d}"
            img, boxes, labels = _make_scene(rng, img_size, num_classes)
            Image.fromarray(img).save(ydir / "JPEGImages" / f"{img_id}.jpg",
                                      quality=92)
            (ydir / "Annotations" / f"{img_id}.xml").write_text(
                _voc_xml(img_id, img_size, img_size, boxes, labels))
            ids.append(img_id)
            # the COCO-format side reuses the same JPEG bytes
            dest = coco_root / ("trainval" if split == "trainval" else "test")
            dest.mkdir(parents=True, exist_ok=True)
            fn = f"{img_id}.jpg"
            data = (ydir / "JPEGImages" / fn).read_bytes()
            (dest / fn).write_bytes(data)
            bucket.append({"id": len(bucket) + (10000 if split == "test" else 0),
                           "w": img_size, "h": img_size, "file_name": fn,
                           "boxes": boxes, "labels": labels})
        lst = ydir / "ImageSets" / "Main" / f"{split}.txt"
        existing = lst.read_text() if lst.exists() else ""
        lst.write_text(existing + "\n".join(ids) + "\n")

    ann = coco_root / "annotations"
    ann.mkdir(parents=True, exist_ok=True)
    (ann / "voc_07_12_trainval.json").write_text(json.dumps(
        _coco_json(train_entries, 20, list(VOC_CLASSES))))
    (ann / "voc_2007_test.json").write_text(json.dumps(
        _coco_json(test_entries, 20, list(VOC_CLASSES))))
    return devkit, coco_root


def make_mini_coco(root, n_train: int = 32, n_val: int = 16,
                   img_size: int = 128, num_classes: int = 20,
                   seed: int = 1) -> Path:
    """Write a mini COCO2017 layout (train2017/val2017 + instances jsons).
    Category ids run 1..num_classes (a subset of the real 90, or all of
    them)."""
    root = Path(root) / "coco"
    rng = np.random.default_rng(seed)
    for split, n in (("train2017", n_train), ("val2017", n_val)):
        d = root / split
        d.mkdir(parents=True, exist_ok=True)
        entries = []
        for i in range(n):
            img, boxes, labels = _make_scene(rng, img_size, num_classes)
            fn = f"{i:012d}.jpg"
            Image.fromarray(img).save(d / fn, quality=92)
            entries.append({"id": i, "w": img_size, "h": img_size,
                            "file_name": fn, "boxes": boxes, "labels": labels})
        ann = root / "annotations"
        ann.mkdir(parents=True, exist_ok=True)
        (ann / f"instances_{split}.json").write_text(
            json.dumps(_coco_json(entries, num_classes)))
    return root


def make_mini_coco_panoptic(coco_root, root=None) -> Path:
    """Write the COCO-panoptic annotations of a mini COCO2017 layout (one
    from make_mini_coco) beside it: panoptic_{split}/ PNG segment maps (id
    = R + 256 G + 65536 B) and panoptic_{split}.json, every box a thing
    segment painted in the annotation order, as the images paint their
    rectangles (a later one covers an earlier). Returns the directory for
    `--coco_panoptic_path` (default: coco_root's parent / panoptic)."""
    coco_root = Path(coco_root)
    root = Path(root) if root else coco_root.parent / "panoptic"
    for split in ("train2017", "val2017"):
        inst = json.loads((coco_root / "annotations"
                           / f"instances_{split}.json").read_text())
        seg_dir = root / f"panoptic_{split}"
        seg_dir.mkdir(parents=True, exist_ok=True)
        by_img = {im["id"]: [] for im in inst["images"]}
        for a in inst["annotations"]:
            by_img[a["image_id"]].append(a)
        annotations = []
        for im in inst["images"]:
            ids = np.zeros((im["height"], im["width"]), np.int64)
            anns = by_img[im["id"]]
            for k, a in enumerate(anns, start=1):
                x, y, w, h = (int(round(v)) for v in a["bbox"])
                ids[y:y + h, x:x + w] = k
            rgb = np.stack([ids % 256, ids // 256 % 256, ids // 65536],
                           -1).astype(np.uint8)
            fn = Path(im["file_name"]).with_suffix(".png").name
            Image.fromarray(rgb).save(seg_dir / fn)
            annotations.append({"image_id": im["id"], "file_name": fn,
                                "segments_info": [
                                    {"id": k, "category_id": a["category_id"],
                                     "bbox": a["bbox"], "iscrowd": 0,
                                     "area": int((ids == k).sum())}
                                    for k, a in enumerate(anns, start=1)]})
        cats = [{**c, "isthing": 1} for c in inst["categories"]]
        (root / f"panoptic_{split}.json").write_text(json.dumps(
            {"images": inst["images"], "annotations": annotations,
             "categories": cats}))
    return root
