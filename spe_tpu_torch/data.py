"""The port's data side: the JAX package's host-only data code
(spe_tpu.data, which imports no JAX) set up for the port's entry points.

  eval_data(cfg)       -> (VOC eval dataset, loader) for `--eval`
  write_mini_voc(root) -> a small generated VOCdevkit for `--test_path`
"""

from __future__ import annotations

from spe_tpu.config import SPEConfig
from spe_tpu.data.build import build_dataset
from spe_tpu.data.loader import DataLoader
from spe_tpu.data.mini_data import make_mini_voc


def eval_data(cfg: SPEConfig):
    """The eval split of cfg.dataset_eval and its loader, in order, on the
    PIL decode path (no native library build)."""
    dataset = build_dataset("val", cfg.dataset_eval, cfg)
    loader = DataLoader(dataset, cfg.batch_size, cfg.num_classes,
                        fixed_size=cfg.max_size if cfg.fixed_size else None,
                        shuffle=False, drop_last=False, use_native=False,
                        train=False, num_threads=cfg.num_workers,
                        bucket_quantum=0 if cfg.fixed_size else cfg.bucket_quantum)
    return dataset, loader


def write_mini_voc(root, n_test: int = 8, img_size: int = 128, seed: int = 0):
    """Write a VOCdevkit of `n_test` generated test images (random shapes
    on noise, 20 VOC classes) under root -> its path."""
    devkit, _ = make_mini_voc(root, n_trainval=0, n_test=n_test,
                              img_size=img_size, seed=seed)
    return devkit
