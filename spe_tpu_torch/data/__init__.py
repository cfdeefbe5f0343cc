"""The port's data side: its own copies of the JAX package's host-only data
code (spe_tpu/data: build, transforms, loader, voc, coco, voc_eval,
mini_data, synthetic), on the PIL decode path, set up for the entry points.

  train_data(cfg)       -> (train dataset, shuffled loader of this
                           process's share) for training
  eval_data(cfg)        -> (eval dataset, loader in order, with padded GT
                           arrays of cfg.max_gt_boxes) for evaluation: this
                           process's share for COCO, the whole split on
                           every process for VOC (only process 0 evaluates)
  write_mini_voc(root)  -> a small generated VOCdevkit for `--test_path`
  write_mini_coco(root) -> a small generated COCO2017 layout for
                           `--coco_path`
  write_mini_coco_panoptic(coco_root)
                        -> its COCO-panoptic annotations for
                           `--coco_panoptic_path`
"""

from __future__ import annotations

from spe_tpu_torch.config import SPEConfig
from spe_tpu_torch.data.build import build_dataset
from spe_tpu_torch.data.loader import DataLoader
from spe_tpu_torch.data.mini_data import (make_mini_coco,
                                          make_mini_coco_panoptic,
                                          make_mini_voc)
from spe_tpu_torch.parallel.tp import NO_TP


def _loader(cfg: SPEConfig, dataset, train: bool, tp=NO_TP,
            sharded: bool = True):
    """cfg.batch_size images a batch on each process (the reference's
    per-device --batch_size); sharded, each data-parallel rank of the
    model's layout `tp` (parallel/tp.py) takes its share of the split (the
    DistributedSampler replacement): under tensor parallelism the ranks of
    a model group see the same images."""
    return DataLoader(dataset, cfg.batch_size, cfg.num_classes,
                      fixed_size=cfg.max_size if cfg.fixed_size else None,
                      shuffle=train, drop_last=train, seed=cfg.seed,
                      process_index=tp.data_index if sharded else 0,
                      process_count=tp.data_size if sharded else 1,
                      use_native=False, train=train,
                      num_threads=cfg.num_workers,
                      max_gt=cfg.max_gt_boxes if cfg.masks or not train
                      else 0,
                      bucket_quantum=0 if cfg.fixed_size else cfg.bucket_quantum)


def train_data(cfg: SPEConfig, tp=NO_TP):
    """The train split of cfg.dataset_file with the train transform
    (random flip), shuffled per epoch from cfg.seed, full batches only;
    with --masks its batches carry the GT arrays and GT masks of up to
    cfg.max_gt_boxes objects an image (the mask losses' targets; the JAX
    CLI's train loader leaves them out)."""
    dataset = build_dataset("train", cfg.dataset_file, cfg)
    return dataset, _loader(cfg, dataset, train=True, tp=tp)


def eval_data(cfg: SPEConfig, tp=NO_TP):
    """The eval split of cfg.dataset_eval and its loader, in order; its
    batches carry the GT arrays (gt_boxes, gt_labels, gt_mask) of up to
    cfg.max_gt_boxes boxes an image for the eval-time losses, as
    spe_tpu/cli/main.py:82-94 builds its eval loader: COCO eval runs on
    every process over its share and merges the detections; VOC eval runs
    whole on process 0, so its loader is not sharded."""
    dataset = build_dataset("val", cfg.dataset_eval, cfg)
    return dataset, _loader(cfg, dataset, train=False, tp=tp,
                            sharded=cfg.dataset_eval != "voc_voc")


def write_mini_voc(root, n_test: int = 8, img_size: int = 128, seed: int = 0,
                   n_trainval: int = 0):
    """Write a VOCdevkit of generated images (random shapes on noise, 20 VOC
    classes) under root: `n_trainval` split over VOC2007/VOC2012 trainval
    and `n_test` in VOC2007 test -> its path."""
    devkit, _ = make_mini_voc(root, n_trainval=n_trainval, n_test=n_test,
                              img_size=img_size, seed=seed)
    return devkit


def write_mini_coco(root, n_train: int = 0, n_val: int = 8,
                    img_size: int = 128, num_classes: int = 90, seed: int = 1):
    """Write a COCO2017 layout of generated images (random shapes on noise,
    category ids drawn from 1..num_classes, COCO's 90 by default) under
    root: train2017/ and val2017/ with their instances jsons -> its path."""
    return make_mini_coco(root, n_train=n_train, n_val=n_val,
                          img_size=img_size, num_classes=num_classes,
                          seed=seed)


def write_mini_coco_panoptic(coco_root, root=None):
    """Write the COCO-panoptic annotations (PNG segment maps and jsons) of
    a generated COCO2017 layout, its boxes as thing segments -> the
    directory for `--coco_panoptic_path`."""
    return make_mini_coco_panoptic(coco_root, root)
