"""Which parameters tensor parallelism splits, and how (port of
spe_tpu/parallel/sharding_rules.py: `_COL_PARALLEL` :27, `_ROW_PARALLEL`
:35, `check_tp_fused_compat` :50, `tp_param_shardings` :102).

The JAX rules split every 2-D kernel whose parent module is in
_COL_PARALLEL by output features (column-parallel: the up-projections into
per-head q/k/v space and the FFNs' first layers) and every one in
_ROW_PARALLEL by input features (row-parallel: the projections that close
a block); everything else, biases included, is replicated. Here the same
rules read the port's state-dict names (torch Linear weights are out x
in, so "col" splits dim 0 and "row" dim 1). The encoder's packed
in-projection `self_attn.in_proj_weight` (3D, D) stands for the JAX
package's q_proj/k_proj/v_proj, each column-parallel: it splits each third
by heads, so a rank holds the q, k and v rows of the same heads. The patch
embedding's Conv2d weight (D, C, p, p) is the JAX package's 2-D Dense
kernel `patch_embed/proj` over the (py, px, c)-flattened patches, which
the rules make row-parallel: it splits along py (models/layers.py
PatchEmbed).

  param_spec(name, ndim)         "col", "row" or "replicated"
  tp_param_specs(model)          {name: spec} of every parameter
  check_tp_fused_compat(cfg, M)  the JAX refusals, in its words
  shard_state_dict(sd, i, M)     rank i's shards of a whole state dict
  gather_state_dict(parts)       the whole state dict from every rank's
  shard_model(model, tp)         split a whole model in place for rank
                                 tp.index of its model group
  gather_model_state(model)      its whole state dict (collective over the
                                 model group)
  load_full_state_dict(model, sd)  load a whole state dict into a model,
                                 split or not
"""

from __future__ import annotations

import torch

from spe_tpu_torch.parallel.tp import NO_TP, TensorParallel

_COL_PARALLEL = {"fc1", "linear1", "qkv", "q", "k", "v", "q_proj", "k_proj",
                 "v_proj", "q_linear", "k_linear",
                 # decoder self-attention projections
                 "sa_qcontent_proj", "sa_qpos_proj", "sa_kcontent_proj",
                 "sa_kpos_proj", "sa_v_proj",
                 # conditional cross-attention projections (2*d_model q/k)
                 "ca_qcontent_proj", "ca_kcontent_proj", "ca_kpos_proj",
                 "ca_v_proj", "ca_qpos_proj", "ca_qpos_sine_proj"}
_ROW_PARALLEL = {"fc2", "linear2", "proj", "out_proj"}
# torch nn.MultiheadAttention's packed q|k|v in-projection and its bias
_PACKED = {"in_proj_weight": 3}
_PACKED_BIAS = "in_proj_bias"
# a conv weight the JAX package holds as a 2-D Dense kernel: its input
# features, flattened (py, px, c), split along dim 2 (py)
_CONV_AS_DENSE = "patch_embed.proj.weight"


def param_spec(name: str, ndim: int) -> str:
    parts = name.split(".")
    if ndim == 4 and name.endswith(_CONV_AS_DENSE):
        return "row"
    if ndim != 2:
        return "replicated"
    if parts[-1] in _PACKED:
        return "col"
    if parts[-1] != "weight" or len(parts) < 2:
        return "replicated"
    if parts[-2] in _COL_PARALLEL:
        return "col"
    if parts[-2] in _ROW_PARALLEL:
        return "row"
    return "replicated"


def is_col_bias(name: str) -> bool:
    """A column-parallel product's bias: replicated, its gradient a rank's
    part (the packed in-projection's too)."""
    parts = name.split(".")
    return parts[-1] == _PACKED_BIAS or (
        parts[-1] == "bias" and len(parts) >= 2 and parts[-2] in _COL_PARALLEL)


def tp_param_specs(model) -> dict:
    return {n: param_spec(n, p.dim()) for n, p in model.named_parameters()}


def check_tp_fused_compat(cfg, num_model: int) -> None:
    """Refuse what the JAX package refuses under a model axis > 1: the
    whole-block and whole-layer fused layers (they take whole parameter
    arrays), use_pallas_attention without tp_attention (only the fused-MHA
    family, B4, runs head-sharded), and tp_attention with nheads not a
    multiple of the model axis. Raises ValueError with the JAX messages'
    flag names."""
    if num_model <= 1:
        return
    bad = [f for f in ("use_fused_block", "use_fused_layers")
           if getattr(cfg, f, False)]
    if getattr(cfg, "use_pallas_attention", False) and not getattr(
            cfg, "tp_attention", False):
        bad.append("use_pallas_attention")
    if bad:
        hint = (" — or set tp_attention=True (CLI: --tp_attention) to run "
                "the fused-MHA family head-sharded over the model group"
                if "use_pallas_attention" in bad else "")
        raise ValueError(
            f"tensor parallelism (model mesh axis = {num_model}) "
            f"is not supported with fused kernels: {', '.join(bad)} "
            f"— set {', '.join(f + '=False' for f in bad)} (CLI: "
            f"{' '.join('--no_' + f for f in bad)}) or keep the model "
            f"axis at 1. The whole-block/whole-layer kernels consume whole "
            f"param arrays in one launch, which the model group cannot "
            f"partition{hint}.")
    if getattr(cfg, "tp_attention", False) and getattr(
            cfg, "nheads", 8) % num_model:
        raise ValueError(
            f"tp_attention head-shards the fused-MHA kernels: nheads "
            f"({cfg.nheads}) must be divisible by the model mesh axis "
            f"({num_model})")


def shard_tensor(name: str, t: torch.Tensor, index: int, count: int):
    """Rank `index` of `count`'s shard of the whole parameter `name`."""
    spec = param_spec(name, t.dim())
    if spec == "row":
        return t.chunk(count, 1 if t.dim() == 2 else 2)[index].clone()
    if spec == "col":
        pieces = _PACKED.get(name.split(".")[-1], 1)
        return torch.cat([c.chunk(count, 0)[index]
                          for c in t.chunk(pieces, 0)])
    return t


def unshard_tensor(name: str, parts):
    """The whole parameter `name` from every rank's shard, in rank order."""
    spec = param_spec(name, parts[0].dim())
    if spec == "row":
        return torch.cat(list(parts), 1 if parts[0].dim() == 2 else 2)
    if spec == "col":
        pieces = _PACKED.get(name.split(".")[-1], 1)
        blocks = [p.chunk(pieces, 0) for p in parts]
        return torch.cat([b[j] for j in range(pieces) for b in blocks])
    return parts[0]


def shard_state_dict(sd: dict, index: int, count: int) -> dict:
    return {k: shard_tensor(k, v, index, count) for k, v in sd.items()}


def gather_state_dict(parts) -> dict:
    return {k: unshard_tensor(k, [p[k] for p in parts]) for k in parts[0]}


def shard_model(model, tp: TensorParallel):
    """Split the whole `model` in place for rank tp.index of its model
    group: its sharded parameters keep their shard (marked `tp_shard`), the
    column-parallel biases stay whole (marked `tp_partial`: their gradient
    is a rank's part), the others are replicated (marked `tp_replica`), and
    every layer that holds a `tp` takes this one."""
    model.tp = tp
    if tp.size == 1:
        return model
    with torch.no_grad():
        for name, p in model.named_parameters():
            if param_spec(name, p.dim()) != "replicated":
                p.data = shard_tensor(name, p.data, tp.index, tp.size)
                p.tp_shard = tp
            elif is_col_bias(name):
                p.tp_partial = tp
            else:
                p.tp_replica = tp
    for m in model.modules():
        if isinstance(getattr(type(m), "tp", None), TensorParallel):
            m.tp = tp
    return model


def gather_tensors(named, tp: TensorParallel) -> dict:
    """{name: whole tensor} from this rank's (name, tensor) pairs: the
    sharded ones all-gathered over the model group (collective)."""
    out = {}
    for name, t in named:
        if tp.size > 1 and param_spec(name, t.dim()) != "replicated":
            t = unshard_tensor(name, tp.all_gather(t.detach()))
        out[name] = t
    return out


def gather_model_state(model) -> dict:
    """The whole state dict of a model split by shard_model (collective
    over its model group); the state dict itself without TP."""
    return gather_tensors(model.state_dict().items(),
                          getattr(model, "tp", NO_TP))


def load_full_state_dict(model, sd: dict, strict: bool = True):
    """Load a whole state dict into `model`, split first for its rank when
    the model is (shard_model)."""
    tp = getattr(model, "tp", NO_TP)
    if tp.size > 1:
        sd = shard_state_dict(sd, tp.index, tp.size)
    return model.load_state_dict(sd, strict=strict)
