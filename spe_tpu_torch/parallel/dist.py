"""Data parallelism over torch.distributed (port of spe_tpu/parallel/mesh.py
`init_distributed` :55-90 and `warmup_collectives`/`coordination_barrier`
:93-121; reference util/misc.py:370-436).

One process a card, each with its share of the batch (the loaders shard by
the data axis, parallel/tp.py: process_index/process_count without tensor
parallelism). There is no DistributedDataParallel wrapper:
the train step all-reduces its gradients and its loss in one flat bucket
after the whole backward (train/train_step.py), as the JAX step psums once,
so a step of W processes equals one process's step on the global batch up
to the f32 summation order.

  init_distributed(world_size, dist_url, device)  the process group -> the
                                 process's device (cuda:LOCAL_RANK)
  process_index(), process_count()
  barrier(name), all_reduce_sum_(t, group), all_reduce_max_(t, group),
  all_reduce_mean_(flat, group), all_gather(t, group), ring_shift(ts, group),
  broadcast_(tensors, src, group),
  broadcast_scalar(x, src), all_gather_array(a, group)
  setup_for_distributed(is_master)  print() on the master process only
  shutdown()                     align the ends, then destroy the group

The backend follows the device: NCCL for a CUDA device, gloo for the CPU.
`backend="gloo"` with a CUDA device is the one explicit exception (two
processes that share one card, which NCCL refuses). Every collective runs
on the backend's own tensor device, the card under NCCL and the CPU under
gloo: a tensor elsewhere is copied there and back. With one process every
function here is a no-op that returns its input. `group` None is every
process; a collective over a group of one process is a no-op too.
"""

from __future__ import annotations

import builtins
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_STATE = {"device": None, "comm": None}
_builtin_print = builtins.print


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def group_size(group=None) -> int:
    """The processes of `group` (None: every process)."""
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def process_device() -> Optional[torch.device]:
    """The device init_distributed gave this process (None before)."""
    return _STATE["device"]


def _rank_from_env() -> int:
    for var in ("RANK", "PROCESS_ID", "JAX_PROCESS_ID"):
        if var in os.environ:
            return int(os.environ[var])
    raise ValueError(
        "a multi-process launch with a tcp:// address needs this process's "
        "rank: set RANK (or PROCESS_ID / JAX_PROCESS_ID), or launch with "
        "torchrun and --dist_url env://")


def init_distributed(world_size: int = 1, dist_url: str = "env://",
                     device="cuda", backend: Optional[str] = None
                     ) -> torch.device:
    """Join the process group of `world_size` processes -> this process's
    device. A no-op returning `device` at world_size <= 1.

    dist_url "env://" reads torchrun's RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT (WORLD_SIZE must equal world_size); "tcp://host:port" takes
    the rank from RANK, PROCESS_ID or JAX_PROCESS_ID. A CUDA device becomes
    cuda:LOCAL_RANK (default: the rank modulo the cards), set as the
    current device. On the card process 0 builds the kernel library before
    the first barrier, so that the others load it instead of building it
    too."""
    device = torch.device(device)
    if world_size <= 1:
        return device
    if dist_url == "env://":
        env_world = int(os.environ.get("WORLD_SIZE", "1"))
        if env_world != world_size:
            raise ValueError(f"--world_size {world_size} but the launcher's "
                             f"WORLD_SIZE is {env_world}")
        rank = int(os.environ["RANK"])
    else:
        rank = _rank_from_env()
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=dist_url,
                            world_size=world_size, rank=rank)
    _STATE["device"] = device
    _STATE["comm"] = device if backend == "nccl" else torch.device("cpu")
    if device.type == "cuda" and rank == 0:
        from spe_tpu_torch.ops import kernels

        kernels.build()
    barrier("kernels built")
    return device


def _on_comm(t: torch.Tensor, fn) -> torch.Tensor:
    """fn(t) in place on the backend's device (t copied there and back)."""
    if t.device == _STATE["comm"]:
        fn(t)
        return t
    c = t.to(_STATE["comm"])
    fn(c)
    t.copy_(c)
    return t


def barrier(name: str = "") -> None:
    """Every process waits here for the others (`name` says where, for a
    reader of the code: the wait is one all-reduce of one element)."""
    if process_count() > 1:
        dist.all_reduce(torch.zeros(1, device=_STATE["comm"]))


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """t <- the sum of the group's t, in place."""
    if group_size(group) > 1:
        _on_comm(t, lambda c: dist.all_reduce(c, group=group))
    return t


def all_reduce_max_(t: torch.Tensor, group=None) -> torch.Tensor:
    """t <- the elementwise max of the group's t, in place."""
    if group_size(group) > 1:
        _on_comm(t, lambda c: dist.all_reduce(c, op=dist.ReduceOp.MAX,
                                              group=group))
    return t


def ring_shift(tensors, group=None) -> list:
    """Each tensor sent to the group's next rank and the previous rank's
    received in its place (one batch_isend_irecv; on the backend's device,
    through the host under gloo) -> the received tensors, on the inputs'
    devices."""
    n = group_size(group)
    if n <= 1:
        return list(tensors)
    me = dist.get_rank(group)

    def rank(i):
        return i if group is None else dist.get_global_rank(group, i)

    to, frm = rank((me + 1) % n), rank((me - 1) % n)
    sent = [t.contiguous().to(_STATE["comm"]) for t in tensors]
    got = [torch.empty_like(t) for t in sent]
    ops = [op for s, g in zip(sent, got) for op in (
        dist.P2POp(dist.isend, s, to, group), dist.P2POp(dist.irecv, g, frm,
                                                         group))]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [g.to(t.device) for g, t in zip(got, tensors)]


def all_reduce_mean_(flat: torch.Tensor, group=None) -> torch.Tensor:
    """flat <- the mean of the group's flat, in place (one all-reduce)."""
    n = group_size(group)
    if n > 1:
        all_reduce_sum_(flat, group).div_(n)
    return flat


def all_gather(t: torch.Tensor, group=None) -> list:
    """The group's t (one shape and dtype) in rank order, on t's device."""
    n = group_size(group)
    if n <= 1:
        return [t]
    c = t.contiguous().to(_STATE["comm"])
    parts = [torch.empty_like(c) for _ in range(n)]
    dist.all_gather(parts, c, group=group)
    return [p.to(t.device) for p in parts]


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0,
               group=None) -> None:
    """Every tensor <- process src's (a global rank in `group`), in place:
    one broadcast a dtype, of the tensors flattened into one bucket."""
    if group_size(group) <= 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        _on_comm(flat, lambda c: dist.broadcast(c, src, group=group))
        with torch.no_grad():
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))


def broadcast_scalar(x: float, src: int = 0) -> float:
    """Process src's x on every process."""
    if process_count() <= 1:
        return float(x)
    t = torch.tensor([float(x)], dtype=torch.float64, device=_STATE["comm"])
    dist.broadcast(t, src)
    return float(t.item())


def all_gather_array(a: np.ndarray, group=None) -> np.ndarray:
    """The group's arrays of one shape and dtype -> (P, *a.shape), in
    rank order, on every process of the group."""
    a = np.ascontiguousarray(a)
    return torch.stack(all_gather(torch.from_numpy(a), group)).numpy()


def setup_for_distributed(is_master: bool) -> None:
    """print() prints on the master process only, unless given force=True
    (spe_tpu/utils/misc.py:42-53, reference util/misc.py:370-382)."""

    def print_gated(*args, force: bool = False, **kwargs):
        if is_master or force:
            _builtin_print(*args, **kwargs)

    builtins.print = print_gated


def shutdown() -> None:
    """Align the processes' ends, then leave the process group (the JAX
    CLI's sync_end, spe_tpu/cli/main.py:203-210)."""
    if dist.is_initialized():
        barrier("end of run")
        dist.destroy_process_group()
        _STATE.update(device=None, comm=None)
    builtins.print = _builtin_print
