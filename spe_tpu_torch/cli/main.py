"""Training and evaluation entry point of the port (spe_tpu/cli/main.py
:129-276 on one process and one device).

  python -m spe_tpu_torch.cli.main --preset voc0712 --dataset_file voc_voc \\
      --test_path <VOCdevkit> --output_dir <dir>                # train
  python -m spe_tpu_torch.cli.main --preset voc0712 --eval \\
      --dataset_eval voc_voc --test_path <VOCdevkit> [--resume model.pth]

Flags are the JAX package's (spe_tpu_torch.config, its copy). The model
runs on the CUDA card; `--device cpu` runs it on the CPU (the fused layers
then take their plain PyTorch versions). Without `--resume` the weights are
initialised from `--seed`. Training runs the epoch loop with its loss
gates, evaluates on the VOC test split after each epoch and, with
`--output_dir`, writes checkpoints and log.txt there. On the card the
preset trains through every fused layer's kernels, forward and backward:
the patch and class-attention blocks (`use_fused_block`,
`use_fused_ca_block`) and the encoder and decoder layers
(`use_fused_layers`); `--no_use_*` flags switch a family to its plain
PyTorch version (with `--no_use_pallas_attention` when any is off).
Not ported (they raise): distributed runs, --frozen_weights, --masks,
--backbone_weights, --log_match_cost, COCO evaluation.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import numpy as np
import torch

from spe_tpu_torch.config import config_from_args
from spe_tpu_torch.data import eval_data, train_data
from spe_tpu_torch.models.build import build_model, resolve_device
from spe_tpu_torch.models.convert import load_reference_checkpoint
from spe_tpu_torch.train import engine
from spe_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from spe_tpu_torch.train.optim import AdamW3
from spe_tpu_torch.train.train_step import Gates, TrainState


def parse_config(argv=None):
    """The JAX package's flags -> SPEConfig; refuses what is not ported."""
    cfg = config_from_args(argv)
    if cfg.dataset_eval != "voc_voc":
        raise NotImplementedError(
            f"only --dataset_eval voc_voc is ported, got {cfg.dataset_eval}")
    if cfg.eval:
        return cfg
    for flag, on in (("--world_size > 1 (distributed training)",
                      cfg.world_size > 1),
                     ("--frozen_weights", bool(cfg.frozen_weights)),
                     ("--masks", cfg.masks),
                     ("--backbone_weights", bool(cfg.backbone_weights)),
                     ("--log_match_cost", cfg.log_match_cost)):
        if on:
            raise NotImplementedError(f"{flag} is not ported to spe_tpu_torch")
    return cfg


def _eval(model, loader, ds, cfg, device, output_dir=None):
    res_dir = (output_dir / "voc_results"
               if cfg.write_voc_results and output_dir else None)
    stats = engine.evaluate_voc(model, loader, ds, cfg, device,
                                with_flip=cfg.eval, results_dir=res_dir)
    print(f"VOC mAP: {stats['mAP']:.4f}  CorLoc: {stats['CorLoc']:.4f}",
          flush=True)
    return stats


def main(argv=None):
    """--eval -> the eval stats. Training -> {"epochs": [{"train": epoch
    stats, "eval": eval stats}], "state": the TrainState}."""
    cfg = parse_config(argv)
    device = resolve_device(cfg)
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    model = build_model(cfg, device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"number of params: {n_params}", flush=True)
    ds_val, loader_val = eval_data(cfg)
    if cfg.eval:
        if cfg.resume:
            model.load_state_dict(load_reference_checkpoint(cfg.resume))
            print(f"loaded {cfg.resume}")
        return _eval(model, loader_val, ds_val, cfg, device)

    ds_train, loader_train = train_data(cfg)
    state = TrainState(model, AdamW3(model.named_parameters(), cfg,
                                     loader_train.steps_per_epoch()))
    start_epoch = cfg.start_epoch
    if cfg.resume:
        last = restore_checkpoint(cfg.resume, state)
        start_epoch = last + 1 if last >= 0 else start_epoch
        print(f"resumed from {cfg.resume} (epoch {last})", flush=True)
    output_dir = Path(cfg.output_dir) if cfg.output_dir else None
    if output_dir:
        output_dir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)

    print("Start training", flush=True)
    epochs, best = [], -1.0
    for epoch in range(start_epoch, cfg.epochs):
        gates = Gates.for_epoch(cfg, epoch)
        train_stats = engine.train_one_epoch(state, loader_train, epoch, cfg,
                                             gates, gen, device)
        eval_stats = _eval(model, loader_val, ds_val, cfg, device, output_dir)
        epochs.append({"train": train_stats, "eval": eval_stats})
        if output_dir:
            save_checkpoint(output_dir / "checkpoint.pth", state, epoch, cfg)
            save_checkpoint(output_dir / f"checkpoint{epoch:04d}.pth", state,
                            epoch, cfg)
            if eval_stats["mAP"] > best:
                best = eval_stats["mAP"]
                save_checkpoint(output_dir / "checkpoint_best.pth", state,
                                epoch, cfg)
            log = {**{f"train_{k}": v for k, v in train_stats.items()
                      if isinstance(v, (int, float))},
                   **{f"test_{k}": v for k, v in eval_stats.items()
                      if isinstance(v, (int, float))},
                   "epoch": epoch, "n_parameters": int(n_params)}
            with (output_dir / "log.txt").open("a") as f:
                f.write(json.dumps(log) + "\n")
    return {"epochs": epochs, "state": state}


if __name__ == "__main__":
    main()
