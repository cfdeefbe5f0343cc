"""The port's training checkpoints (reference main.py:259-269 saves
{model, optimizer, lr_scheduler, epoch, args} with torch.save; the JAX
package uses orbax, spe_tpu/train/checkpoint.py).

A checkpoint is one torch.save file: {"model": state dict, "optimizer":
AdamW3 state, "epoch", "bad_steps", "config"}. `--resume` takes either that
file (training continues after its epoch) or a reference-layout .pth state
dict (weights only: models/convert.py `load_reference_checkpoint`).
`--frozen_weights` takes either too through `load_params_lenient`: the
detector it was trained as, without the segmentation head.

Under tensor parallelism the file holds whole tensors, so that one process
(`--eval --resume`) reads it: saving gathers the model's shards and the
optimizer moments' over the model group (collective: every rank calls
save_checkpoint, process 0 writes), and restoring splits them again for
the rank (parallel/sharding_rules.py).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from spe_tpu_torch.models.convert import load_reference_checkpoint
from spe_tpu_torch.parallel import dist
from spe_tpu_torch.parallel.sharding_rules import (gather_model_state,
                                                   gather_tensors,
                                                   load_full_state_dict,
                                                   shard_tensor)
from spe_tpu_torch.parallel.tp import NO_TP

_MOMENTS = ("exp_avg", "exp_avg_sq")


def whole_state(state):
    """(model state dict, optimizer state dict) of whole tensors: the
    shards gathered over the model group under tensor parallelism
    (collective), else as they are."""
    tp = getattr(state.model, "tp", NO_TP)
    opt = state.optimizer.state_dict()
    if tp.size > 1:
        names = state.optimizer.names
        opt.update({key: {g: list(gather_tensors(zip(names[g], ts),
                                                 tp).values())
                          for g, ts in opt[key].items()}
                    for key in _MOMENTS})
    return gather_model_state(state.model), opt


def save_checkpoint(path, state, epoch: int, cfg) -> None:
    """Write the checkpoint at `path` from process 0; collective under
    tensor parallelism (every rank calls it)."""
    model_sd, opt_sd = whole_state(state)
    if dist.process_index() != 0:
        return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save({"model": model_sd, "optimizer": opt_sd,
                "epoch": int(epoch), "bad_steps": int(state.bad_steps),
                "config": dataclasses.asdict(cfg)}, tmp)
    tmp.replace(path)  # a crash mid-save never leaves half a checkpoint


def restore_checkpoint(path, state) -> int:
    """Load `path` into state -> the epoch it was saved after, or -1 for a
    reference-layout .pth (weights only)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "optimizer" in ckpt and "epoch" in ckpt:
        load_full_state_dict(state.model, ckpt["model"])
        opt = ckpt["optimizer"]
        tp = getattr(state.model, "tp", NO_TP)
        if tp.size > 1:
            names = state.optimizer.names
            opt = {**opt, **{key: {
                g: [shard_tensor(n, t, tp.index, tp.size)
                    for n, t in zip(names[g], ts)]
                for g, ts in opt[key].items()} for key in _MOMENTS}}
        state.optimizer.load_state_dict(opt)
        state.bad_steps = int(ckpt["bad_steps"])
        return int(ckpt["epoch"])
    load_full_state_dict(state.model, load_reference_checkpoint(path))
    return -1


def load_params_lenient(path, model) -> list:
    """Load into `model` the parameters and buffers of the checkpoint at
    `path` (the port's, or a reference-layout .pth) that it holds under the
    same names; the model's others, absent from the checkpoint (a new
    segmentation head), keep their init (spe_tpu/train/checkpoint.py
    :59-70, reference main.py:218-220). -> the names kept at init."""
    saved = load_reference_checkpoint(path)
    ours = model.state_dict()
    for k, v in saved.items():
        if k in ours and tuple(v.shape) != tuple(ours[k].shape):
            raise ValueError(f"{path}: {k} is {tuple(v.shape)}, the model's "
                             f"{tuple(ours[k].shape)}")
    model.load_state_dict({k: saved.get(k, v) for k, v in ours.items()})
    return [k for k in ours if k not in saved]
