"""Training and evaluation entry point of the port (spe_tpu/cli/main.py
:22-276 without tensor parallelism).

  python -m spe_tpu_torch.cli.main --preset voc0712 --dataset_file voc_voc \\
      --test_path <VOCdevkit> --output_dir <dir>                # train
  python -m spe_tpu_torch.cli.main --preset voc0712 --eval \\
      --dataset_eval voc_voc --test_path <VOCdevkit> [--resume model.pth]
  python -m spe_tpu_torch.cli.main --preset coco17 --coco_path <COCO2017> \\
      --output_dir <dir>                                        # train
  python -m spe_tpu_torch.cli.main --preset coco17 --eval \\
      --coco_path <COCO2017> [--resume model.pth] [--output_dir <dir>]

Flags are the JAX package's (spe_tpu_torch.config, its copy). The model
runs on the CUDA card; `--device cpu` runs it on the CPU (the fused layers
then take their plain PyTorch versions). Without `--resume` the weights are
initialised from `--seed`. Training runs the epoch loop with its loss
gates, evaluates after each epoch and, with `--output_dir`, writes
checkpoints (checkpoint_best.pth by VOC mAP or COCO AP50) and log.txt
there. `--dataset_eval voc_voc` evaluates VOC mAP and CorLoc on the VOC
test split; `--dataset_eval coco` (the coco17 preset) evaluates COCO AP/AR
of every refinement stage 0..num_refines on val2017 through
engine.evaluate_coco, with the eval-time losses, and with `--output_dir`
writes each stage's precision/recall arrays to
eval/stage{s}_{epoch:03d}.npz. On the card the
preset trains through every fused layer's kernels, forward and backward:
the patch and class-attention blocks (`use_fused_block`,
`use_fused_ca_block`) and the encoder and decoder layers
(`use_fused_layers`); `--no_use_*` flags switch a family to its plain
layers, whose attentions then run through the standalone attention kernels
(`use_pallas_attention`, as the preset sets it); `--no_use_pallas_attention`
makes those plain PyTorch too.
`--backbone_weights PATH` starts the backbone from a local pretrained CaiT
checkpoint (timm's layout, {'model': sd} or bare, as spe_tpu/cli/main.py
:104-127 loads it: models/convert.py load_backbone_weights, the det branch
cloned from the tail blocks, pos_embed interpolated to the model's grid).
`--log_match_cost` also solves every step's cost matrices with the exact
host solver and logs the auction's realized-cost gap
(train_match_subopt_mean/max in log.txt).
`--masks` adds the segmentation head (models/segmentation.py) and, on a
dataset with instance masks (coco with its polygons or RLE, coco_panoptic
with its PNG segment maps, synthetic), trains it with the mask losses
(loss_mask, loss_dice): the train loader then carries the GT arrays, which
the JAX CLI's train loader leaves out (so its --masks training never
reaches its mask losses). `--frozen_weights PATH` (with --masks, as
spe_tpu/cli/main.py:133-145 asserts) starts every parameter found by name
in PATH (a port checkpoint or a reference .pth of the detector) from it
and trains the segmentation head alone: the others take a zero update.
`--pre_norm` and `--position_embedding learned` build the pre-norm
encoder and the learned position tables.

Data parallelism, one process a card (parallel/dist.py):
  torchrun --nproc_per_node 4 -m spe_tpu_torch.cli.main --world_size 4 ...
  RANK=r python -m spe_tpu_torch.cli.main --world_size 2 \
      --dist_url tcp://127.0.0.1:29500 ...                # each rank r
NCCL between the cards, gloo with `--device cpu`. `--batch_size` is per
process. The train loader is sharded over the processes, the gradients and
loss averaged in one all-reduce a step, the epoch means averaged. COCO eval
runs on every process over its share of the images and merges the
detections; VOC eval runs whole on process 0 and the others return {}.
Process 0 alone prints, writes log.txt, the checkpoints and the eval
arrays, and decides checkpoint_best (its value broadcast).

Tensor parallelism, `--model_axis M` (parallel/mesh.py, parallel/tp.py,
parallel/sharding_rules.py): the W processes form W / M data-parallel
ranks of M model ranks each; a model group splits the weights by the JAX
package's Megatron rules and each of its ranks sees the same images.
`--batch_size` is per data rank; the losses normalise over the data width
W / M (spe_tpu/cli/main.py:64,162). `--tp_attention` (with
`use_pallas_attention`) runs B4 head-sharded in the encoder and the
decoder cross-attention, the backbone on its plain attention:
  RANK=r python -m spe_tpu_torch.cli.main --world_size 2 --model_axis 2 \
      --tp_attention --no_use_fused_block --no_use_fused_layers \
      --dist_url tcp://127.0.0.1:29500 ...                # each rank r
VOC eval runs on data rank 0's model group, COCO eval on every process,
merged over the data group; the checkpoints hold whole tensors (one
process can `--eval --resume` them).

`--dataset_eval`: voc_voc evaluates VOC mAP and CorLoc; every other value
(coco, synthetic, voc, voc12, coco_panoptic) COCO AP/AR against the eval
dataset's COCO ground truth, as spe_tpu/cli/main.py:86,184 routes them.
Not ported (they raise): `--masks` under tensor parallelism,
`--backbone_weights auto` (it resolves to a download URL; pass a local
file).
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
from spe_tpu_torch.models.convert import (load_backbone_weights,
                                          load_reference_checkpoint)
from spe_tpu_torch.parallel import dist
from spe_tpu_torch.parallel.mesh import make_mesh
from spe_tpu_torch.parallel.sharding_rules import (check_tp_fused_compat,
                                                   load_full_state_dict)
from spe_tpu_torch.train import engine
from spe_tpu_torch.train.checkpoint import (load_params_lenient,
                                            restore_checkpoint,
                                            save_checkpoint)
from spe_tpu_torch.train.optim import AdamW3
from spe_tpu_torch.train.train_step import Gates, TrainState


def best_key(cfg) -> str:
    """The stat that chooses checkpoint_best: VOC mAP, else COCO AP50."""
    return "mAP" if cfg.dataset_eval == "voc_voc" else "AP50"


def parse_config(argv=None):
    """The JAX package's flags -> SPEConfig; refuses what is not ported."""
    cfg = config_from_args(argv)
    if cfg.model_axis < 1 or cfg.world_size % cfg.model_axis:
        raise ValueError(f"--model_axis {cfg.model_axis} must divide "
                         f"--world_size {cfg.world_size}")
    if cfg.masks and cfg.model_axis > 1:
        raise NotImplementedError(
            "--masks under tensor parallelism (--model_axis > 1) is not "
            "ported to spe_tpu_torch")
    check_tp_fused_compat(cfg, cfg.model_axis)   # before any process group
    weights = cfg.backbone_weights or ""
    if weights == "auto" or "://" in weights:
        raise NotImplementedError(
            f"--backbone_weights {weights}: the JAX package resolves 'auto' "
            "to a download URL (PRETRAINED_URLS in spe_tpu/models/convert.py); "
            "spe_tpu_torch reads a local file: download the checkpoint and "
            "pass its path")
    if cfg.frozen_weights and not cfg.masks:
        raise ValueError("--frozen_weights: frozen training is meant for "
                         "segmentation only (--masks)")
    return cfg


def _eval(model, loader, ds, cfg, device, output_dir=None, epoch=0):
    """The eval of cfg.dataset_eval. VOC: mAP and CorLoc (flip-TTA under
    --eval). COCO (every other dataset_eval): every refinement stage's AP/AR
    and eval losses, stage 0's unprefixed and every stage's as stage{s}_*
    (spe_tpu/cli/main.py:182-200); `forwards` sums the stages'.
    Distributed: VOC on data rank 0 alone (its model group under tensor
    parallelism; the others return {}), COCO on every process
    (collective)."""
    if cfg.dataset_eval == "voc_voc":
        if model.tp.data_index != 0:
            return {}
        res_dir = (output_dir / "voc_results" if cfg.write_voc_results and
                   output_dir and dist.process_index() == 0 else None)
        stats = engine.evaluate_voc(model, loader, ds, cfg, device,
                                    with_flip=cfg.eval, results_dir=res_dir)
        print(f"VOC mAP: {stats['mAP']:.4f}  CorLoc: {stats['CorLoc']:.4f}",
              flush=True)
        return stats
    if not hasattr(ds, "coco_gt") and not hasattr(ds, "raw"):
        # the JAX CLI reads the same two attributes (spe_tpu/cli/main.py:184)
        raise NotImplementedError(
            f"--dataset_eval {cfg.dataset_eval}: its dataset has no COCO "
            "ground truth (coco_gt() or raw) to evaluate against")
    gt = ds.coco_gt() if hasattr(ds, "coco_gt") else ds.raw
    eval_dir = None
    if output_dir:
        eval_dir = output_dir / "eval"
        if dist.process_index() == 0:
            eval_dir.mkdir(parents=True, exist_ok=True)
    stats, forwards = {}, 0
    for stage in range(cfg.num_refines + 1):
        save = eval_dir / f"stage{stage}_{epoch:03d}.npz" if eval_dir else None
        s = engine.evaluate_coco(model, loader, gt, cfg, device,
                                 refine_stage=stage, eval_save_path=save)
        forwards += s.pop("forwards")
        print(f"COCO eval (stage {stage}):",
              {k: round(v, 4) for k, v in s.items()}, flush=True)
        if stage == 0:
            stats.update(s)
        stats.update({f"stage{stage}_{k}": v for k, v in s.items()})
    stats["forwards"] = forwards
    return stats


def main(argv=None):
    """--eval -> the eval stats. Training -> {"epochs": [{"train": epoch
    stats, "eval": eval stats}], "state": the TrainState}."""
    cfg = parse_config(argv)
    # the process group before the model: each process's card
    device = dist.init_distributed(cfg.world_size, cfg.dist_url,
                                   resolve_device(cfg))
    mesh = make_mesh(dist.process_count(), cfg.model_axis)
    rank = dist.process_index()
    if dist.process_count() > 1:
        dist.setup_for_distributed(rank == 0)
    # seeded by the data rank: a model group's ranks draw the same images,
    # box repeats and dropout masks
    seed = cfg.seed + mesh.data_index
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    model = build_model(cfg, device, tp=mesh.tp)
    n_params = sum(p.numel() * (mesh.model_size if hasattr(p, "tp_shard")
                                else 1) for p in model.parameters())
    print(f"number of params: {n_params}", flush=True)
    if cfg.backbone_weights:
        load_backbone_weights(model, cfg.backbone_weights)
        print(f"initialized backbone from {cfg.backbone_weights}", flush=True)
    ds_val, loader_val = eval_data(cfg, mesh.tp)
    output_dir = Path(cfg.output_dir) if cfg.output_dir else None
    if output_dir and rank == 0:
        output_dir.mkdir(parents=True, exist_ok=True)
    if cfg.eval:
        if cfg.resume:
            load_full_state_dict(model, load_reference_checkpoint(cfg.resume))
            print(f"loaded {cfg.resume}")
        # every rank its data group's first rank's (its model index's)
        dist.broadcast_(list(model.parameters()), mesh.model_index,
                        mesh.data_group)
        stats = _eval(model, loader_val, ds_val, cfg, device, output_dir)
        dist.shutdown()
        return stats

    ds_train, loader_train = train_data(cfg, mesh.tp)
    if cfg.frozen_weights:
        kept = load_params_lenient(cfg.frozen_weights, model)
        print(f"loaded frozen detector weights from {cfg.frozen_weights} "
              f"({len(kept)} tensors kept at init)", flush=True)
    state = TrainState(model, AdamW3(model.named_parameters(), cfg,
                                     loader_train.steps_per_epoch()))
    start_epoch = cfg.start_epoch
    if cfg.resume:
        last = restore_checkpoint(cfg.resume, state)
        start_epoch = last + 1 if last >= 0 else start_epoch
        print(f"resumed from {cfg.resume} (epoch {last})", flush=True)
    dist.broadcast_(list(model.parameters()), mesh.model_index,
                    mesh.data_group)
    gen = torch.Generator(device=device).manual_seed(seed)

    print("Start training", flush=True)
    epochs, best, key = [], -1.0, best_key(cfg)
    for epoch in range(start_epoch, cfg.epochs):
        gates = Gates.for_epoch(cfg, epoch)
        train_stats = engine.train_one_epoch(state, loader_train, epoch, cfg,
                                             gates, gen, device)
        eval_stats = _eval(model, loader_val, ds_val, cfg, device, output_dir,
                           epoch)
        epochs.append({"train": train_stats, "eval": eval_stats})
        # process 0's value decides (only it has VOC's)
        val = dist.broadcast_scalar(eval_stats.get(key, -1.0))
        if output_dir:   # every process: collective under tensor parallelism
            save_checkpoint(output_dir / "checkpoint.pth", state, epoch, cfg)
            save_checkpoint(output_dir / f"checkpoint{epoch:04d}.pth", state,
                            epoch, cfg)
            if val > best:
                best = val
                save_checkpoint(output_dir / "checkpoint_best.pth", state,
                                epoch, cfg)
        if output_dir and rank == 0:
            log = {**{f"train_{k}": v for k, v in train_stats.items()
                      if isinstance(v, (int, float))},
                   **{f"test_{k}": v for k, v in eval_stats.items()
                      if isinstance(v, (int, float))},
                   "epoch": epoch, "n_parameters": int(n_params)}
            with (output_dir / "log.txt").open("a") as f:
                f.write(json.dumps(log) + "\n")
    dist.shutdown()
    return {"epochs": epochs, "state": state}


if __name__ == "__main__":
    main()
