"""Dataset dispatch (the port's copy of spe_tpu/data/build.py; reference
datasets/__init__.py:27-56).

dataset_file: 'coco' (90 classes), 'voc'/'voc12' (COCO-format VOC jsons,
20 classes), 'voc_voc' (raw VOCdevkit), 'coco_panoptic' (COCO images with
the panoptic PNG segment maps of `coco_panoptic_path`), 'synthetic'
(no-data smoke runs). With `--masks` the datasets that have instance masks
(coco, voc, coco_panoptic, synthetic) put them in the targets.
"""

from __future__ import annotations

from pathlib import Path

from spe_tpu_torch.config import SPEConfig
from spe_tpu_torch.data.transforms import FixedSizeTransform, MultiScaleTransform


def _transform(cfg: SPEConfig, train: bool):
    if cfg.fixed_size:
        return FixedSizeTransform(cfg.max_size, train=train)
    return MultiScaleTransform(max_size=cfg.max_size, train=train)


def build_dataset(image_set: str, dataset_file: str, cfg: SPEConfig):
    train = image_set == "train"
    tf = _transform(cfg, train)
    if dataset_file == "coco":
        from spe_tpu_torch.data.coco import CocoFormatDataset

        root = Path(cfg.coco_path)
        split = "train2017" if train else "val2017"
        return CocoFormatDataset(
            root / split, root / "annotations" / f"instances_{split}.json",
            transform=tf, num_classes=90, remove_empty=train,
            return_masks=cfg.masks)
    if dataset_file in ("voc", "voc12"):
        from spe_tpu_torch.data.coco import CocoFormatDataset

        root = Path(cfg.coco_path)
        ann = ("voc_07_12_trainval.json" if train else "voc_2007_test.json")
        img_dir = root / ("trainval" if train else "test")
        return CocoFormatDataset(img_dir, root / "annotations" / ann,
                                 transform=tf, num_classes=20,
                                 remove_empty=train, return_masks=cfg.masks)
    if dataset_file == "voc_voc":
        from spe_tpu_torch.data.voc import VOCDevkitDataset

        splits = ([("VOC2007", "trainval"), ("VOC2012", "trainval")]
                  if train else [("VOC2007", "test")])
        return VOCDevkitDataset(cfg.test_path, splits, transform=tf,
                                keep_difficult=not cfg.remove_difficult)
    if dataset_file == "coco_panoptic":
        from spe_tpu_torch.data.coco_panoptic import CocoPanopticDataset

        root = Path(cfg.coco_path)
        proot = Path(cfg.coco_panoptic_path)
        split = "train2017" if train else "val2017"
        return CocoPanopticDataset(
            root / split, proot / f"panoptic_{split}",
            proot / f"panoptic_{split}.json", transform=tf,
            return_masks=cfg.masks)
    if dataset_file == "synthetic":
        from spe_tpu_torch.data.synthetic import SyntheticDetection

        return SyntheticDetection(
            num_images=256 if train else 64, num_classes=cfg.num_classes,
            img_size=cfg.max_size, seed=0 if train else 1, transform=tf,
            return_masks=cfg.masks)
    raise ValueError(f"unknown dataset_file {dataset_file}")
