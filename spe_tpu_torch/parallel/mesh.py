"""The process layout: a data axis and a model axis (port of
spe_tpu/parallel/mesh.py `make_mesh` :23-29).

The JAX package lays its devices out as a (data, model) mesh, device i at
data i // M, model i % M. Here a process is a device: process r is data
rank r // M and model rank r % M. Its model group holds the M processes of
its data index (they split one model's weights: tensor parallelism,
parallel/sharding_rules.py); its data group holds the W / M processes of
its model index (they hold the same shard and see different images: data
parallelism, one gradient all-reduce a step).

  make_mesh(world_size, num_model) -> Mesh; its `tp` (the model group's
                                 TensorParallel, which also holds the data
                                 group) is what build_model puts on the
                                 model, and what the step, the engine and
                                 the loaders read the data axis from

Every process calls make_mesh with the same arguments after
parallel.dist.init_distributed: torch.distributed.new_group is collective
over every process, member or not. With one process, or num_model 1, no
group is made: the data group is every process and the model group none.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as tdist

from spe_tpu_torch.parallel import dist
from spe_tpu_torch.parallel.tp import NO_TP, TensorParallel


@dataclasses.dataclass(frozen=True)
class Mesh:
    data_index: int
    data_size: int
    model_index: int
    model_size: int
    data_group: Optional[object] = None    # None: every process (M = 1)
    tp: TensorParallel = NO_TP             # the model group's context


def make_mesh(world_size: Optional[int] = None, num_model: int = 1) -> Mesh:
    """The (data, model) layout of world_size processes (default: the
    process group's), num_model to a model group."""
    world = dist.process_count() if world_size is None else int(world_size)
    if world != dist.process_count():
        raise ValueError(f"a mesh of {world} processes, but the process "
                         f"group has {dist.process_count()}")
    if num_model < 1 or world % num_model:
        raise ValueError(f"--model_axis {num_model} must divide the "
                         f"{world} processes (--world_size)")
    rank = dist.process_index()
    n_data = world // num_model
    data_group, tp = None, NO_TP
    if num_model > 1:
        for m in range(num_model):   # (of one process at n_data 1)
            g = tdist.new_group([d * num_model + m for d in range(n_data)])
            if m == rank % num_model:
                data_group = g
        for d in range(n_data):
            g = tdist.new_group([d * num_model + m for m in range(num_model)])
            if d == rank // num_model:
                tp = TensorParallel(g, rank % num_model, num_model,
                                    data_group)
    return Mesh(rank // num_model, n_data, rank % num_model, num_model,
                data_group, tp)
