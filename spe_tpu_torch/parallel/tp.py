"""Tensor parallelism over a model group: the Megatron operators and the
products that split a layer's weights (the port of what GSPMD does with
spe_tpu/parallel/sharding_rules.py's shardings, spelled out as
collectives).

A layer's column-parallel product (its weight split by output features)
takes a replicated input and gives this rank's columns; a row-parallel one
(split by input features) takes those columns and gives a partial sum,
which an all-reduce makes the replicated output. Four autograd operators
carry the activations across the group:

  copy     identity forward, all-reduce of the gradient backward: before a
           column-parallel product (each rank's input gradient is a part)
  reduce   all-reduce forward, identity backward: after a row-parallel one
  gather   all-gather along a dim forward, this rank's slice backward:
           where heads mix (the talking-heads patch block's qkv, the class
           attention's probabilities, the CAM source)
  scatter  this rank's slice forward, all-gather backward: a replicated
           activation into a row-parallel product

TensorParallel(group, index, size, data_group) holds the group and this
rank's place in it; at size 1 (NO_TP) every operator is the identity and
col/row are the plain products, so a model without tensor parallelism
computes exactly what it did before. It is the model's layout
(sharding_rules.shard_model puts it on the model), so it also holds the
data axis: the processes that hold the same shards and see different
images (data_group, None for every process; process r is data rank
r // size of process_count / size, parallel/mesh.py), over which the
normalisers, the gradient mean, the epoch sums and the COCO merge run.
Every collective on the group counts its calls, bytes and host seconds
(`calls`, `bytes`, `seconds`: from the call to its return, which under
gloo includes the copy to the host, and so the device work queued before
it) and runs on the backend's device (parallel.dist._on_comm: through the
host under gloo).

The biases of column-parallel products stay whole on every rank, as the
JAX rules replicate every bias (sharding_rules.py:40-48): a rank adds its
columns' part, and its gradient, zero elsewhere, is summed over the group
once a step (train/train_step.py `reduce_model_group_grads`).
"""

from __future__ import annotations

import time

import torch

from spe_tpu_torch.ops.refmath import ShardDropout, mm
from spe_tpu_torch.parallel import dist


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce_(g.clone()), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim, ctx.n = tp, dim, x.shape[dim]
        return torch.cat(tp.all_gather(x), dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.tp.index * ctx.n, ctx.n), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        n = x.shape[dim] // tp.size
        return x.narrow(dim, tp.index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(ctx.tp.all_gather(g), ctx.dim), None, None


class TensorParallel:
    """One rank's place in its model group and its data group (see the
    module docstring)."""

    def __init__(self, group, index: int, size: int, data_group=None):
        self.group, self.index, self.size = group, int(index), int(size)
        self.data_group = data_group
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0

    def __repr__(self):
        return f"TensorParallel(index={self.index}, size={self.size})"

    @property
    def data_index(self) -> int:
        return dist.process_index() // self.size

    @property
    def data_size(self) -> int:
        return dist.process_count() // self.size

    # -- collectives on the group (counted)
    def _counted(self, fn, t):
        self.calls += 1
        self.bytes += t.numel() * t.element_size()
        t0 = time.perf_counter()
        out = fn(t, self.group)
        self.seconds += time.perf_counter() - t0
        return out

    def all_reduce_(self, t):
        return self._counted(dist.all_reduce_sum_, t)

    def all_gather(self, t):
        return self._counted(dist.all_gather, t)

    # -- the operators
    def copy(self, x):
        return x if self.size == 1 else _Copy.apply(x, self)

    def reduce(self, x):
        return x if self.size == 1 else _Reduce.apply(x, self)

    def gather(self, x, dim=-1):
        return x if self.size == 1 else _Gather.apply(x, self, dim % x.dim())

    def scatter(self, x, dim=-1):
        return x if self.size == 1 else _Scatter.apply(x, self, dim % x.dim())

    # -- shards
    def part(self, n: int) -> slice:
        """This rank's part of n features split `size` ways."""
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)

    def cols(self, b, pieces: int = 1):
        """This rank's entries of a whole column-parallel bias: its part of
        each of `pieces` equal blocks (3 for a packed q|k|v bias)."""
        if self.size == 1 or b is None:
            return b
        return torch.cat([c[self.part(c.shape[0])] for c in b.chunk(pieces)])

    def col(self, x, w, b=None, pieces: int = 1):
        """A column-parallel product x w^T + b in f32 (refmath.mm) on this
        rank's rows of w; x already through `copy`."""
        return mm(x, w, self.cols(b, pieces))

    def row(self, x, w, b=None):
        """A row-parallel product: x (this rank's columns) w^T summed over
        the group in f32, then + b (whole) -> the replicated output, f32."""
        if self.size == 1:
            return mm(x, w, b)
        y = self.reduce(mm(x, w))
        return y if b is None else y + b.float()

    def shard(self, drop, dim: int):
        """A layer's refmath.Dropout for a tensor split along `dim` across
        the group (ShardDropout), or drop itself at size 1 or without
        dropout."""
        if drop is None or self.size == 1:
            return drop
        return ShardDropout(drop.gen, drop.attn, drop.proj, drop.path,
                            self.index, self.size, dim)


NO_TP = TensorParallel(None, 0, 1)
