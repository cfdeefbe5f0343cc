"""Arithmetic shared by the plain PyTorch versions of the fused layers.

The plain versions round at the same points as the TPU kernels they stand
beside: matmul operands in the working dtype (bf16 on the recipe), products
accumulated in f32, LayerNorm statistics, softmax and residual streams in
f32. With f32 inputs every rounding is a no-op and they are the f32 math.

`Dropout` is their training form: the JAX package's nn.Dropout and DropPath
(spe_tpu/models/layers.py) with masks drawn from an explicit
torch.Generator. The fused layers draw theirs from counters instead
(`CounterDropout`, `counter_keep`), which their CUDA kernels reproduce bit
for bit; `gelu_tanh_grad`, `ln_backward_reference` and `weight_grad` are
the pieces of their hand-derived backwards.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


def mm(a, w, b=None):
    """a @ w.T + b in f32, from a (already in the working dtype) and w
    rounded to a's dtype — the TPU kernels' `_dot(a, w) + b`."""
    return F.linear(a.float(), w.to(a.dtype).float(),
                    None if b is None else b.float())


def layer_norm(x, w, b, eps):
    """f32 LayerNorm of any-dtype rows (the kernels' `_ln_fwd`)."""
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def gelu_tanh_grad(u):
    """d gelu_tanh / du (the TPU kernels' `_gelu_grad`)."""
    c, a = 0.7978845608028654, 0.044715
    t = torch.tanh(c * (u + a * u * u * u))
    return 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * c * (1.0 + 3.0 * a * u * u)


def ln_backward_reference(dy, x, w, eps):
    """LayerNorm backward of f32 rows (the TPU kernels' `_ln_bwd`) ->
    (dx, dw, db) with dw, db summed over every row."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * inv
    dxhat = dy * w.float()
    dx = (dxhat - dxhat.mean(-1, keepdim=True)
          - xhat * (dxhat * xhat).mean(-1, keepdim=True)) * inv
    return dx, (dy * xhat).flatten(0, -2).sum(0), dy.flatten(0, -2).sum(0)


def weight_grad(dy, x):
    """dW of a torch-layout Linear: sum over rows of dy^T x (both already
    rounded where the kernels round), f32."""
    return dy.flatten(0, -2).float().T @ x.flatten(0, -2).float()


def key_bias(mask, B, N, device):
    """Key-padding mask (B, N) bool, True = padded -> f32 logit bias -1e9
    (None when there is no mask)."""
    if mask is None:
        return None
    return torch.where(mask.reshape(B, N), -1e9, 0.0).to(
        device=device, dtype=torch.float32)


def split_heads(x, num_heads):
    B, N, D = x.shape
    return x.reshape(B, N, num_heads, D // num_heads).transpose(1, 2)


def merge_heads(x):
    B, H, N, dh = x.shape
    return x.transpose(1, 2).reshape(B, N, H * dh)


def scale_in(dtype, value: float) -> float:
    """A python scale as the working dtype rounds it (JAX multiplies a bf16
    array by a weakly typed float in bf16)."""
    return torch.tensor(value, dtype=dtype).item()


@dataclasses.dataclass(frozen=True)
class Dropout:
    """Training-mode dropout of one layer: the rates of its sites and the
    generator its masks come from. A site keeps each value with probability
    1 - rate and scales it by 1 / (1 - rate), as flax's nn.Dropout does;
    `drop_path` keeps or drops each sample's whole branch (DropPath)."""
    gen: torch.Generator
    attn: float = 0.0   # attention probabilities, before the product with V
    proj: float = 0.0   # projection and FFN outputs
    path: float = 0.0   # DropPath on each residual branch, per sample

    def any(self) -> bool:
        return self.attn > 0.0 or self.proj > 0.0 or self.path > 0.0

    def __call__(self, x, rate: float):
        return self._drop(x, rate, x.shape)

    def drop_path(self, x):
        return self._drop(x, self.path, (x.shape[0],) + (1,) * (x.dim() - 1))

    def offset(self, n: int) -> int:
        """The index of the first of n heads or columns in the tensor the
        masks are keyed on: 0, this tensor is whole (see ShardDropout)."""
        return 0

    def _drop(self, x, rate, shape):
        if rate == 0.0:
            return x
        keep = 1.0 - rate
        mask = torch.rand(shape, generator=self.gen, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)


@dataclasses.dataclass(frozen=True)
class ShardDropout(Dropout):
    """A Dropout on one rank's shard of a tensor split `count` ways along
    `dim` (tensor parallelism): its masks are the whole tensor's, drawn
    from the generator as one process draws them, and this rank's part,
    `index`, cut out. With the same generator on every rank of the model
    group a sharded activation gets the bits it would get unsharded, and
    the generator streams stay in step. DropPath is per sample and stays
    whole."""
    index: int = 0
    count: int = 1
    dim: int = -1

    def offset(self, n: int) -> int:
        return self.index * n

    def __call__(self, x, rate: float):
        if rate == 0.0:
            return x
        dim = self.dim % x.dim()
        n = x.shape[dim]
        full = list(x.shape)
        full[dim] = n * self.count
        keep = 1.0 - rate
        mask = (torch.rand(full, generator=self.gen, device=x.device)
                < keep).narrow(dim, self.offset(n), n)
        return torch.where(mask, x / keep, 0.0)


def drop_site(drop, x, rate_name: str):
    """x through `drop`'s site `rate_name`, or x itself without dropout."""
    return x if drop is None else drop(x, getattr(drop, rate_name))


def drop_path(drop, x):
    return x if drop is None else drop.drop_path(x)


def needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


# ---- counter-based dropout (the fused layers' training form) ----
#
# A keep decision is a pure function of (seed, site, sample, head, row, col):
# a chain of 32-bit steps h <- fmix32(h ^ (v * 0x9E3779B1)) over the six
# values, fmix32 being murmur3's finaliser, and keep = (h >> 8) < thr with
# thr = round((1 - rate) * 2^24). Kept values are scaled by 1 / (1 - rate).
# The mask does not depend on how a kernel cuts the work, so the CUDA
# kernels (csrc/common.cuh `keep_bit`) and this integer-arithmetic version
# give the same bits. DropPath is one draw per (seed, site, sample):
# the chain stops after the sample.
#
# The sites and their keys. Every layer call has its own seed, as JAX draws
# one per block and per encoder/decoder layer (spe_tpu/models/cait.py
# :176-180, transformer.py:150-155, 313-318); rows count within a sample.
#   patch block       ATTN (b, g, q, k) post-mix head g; PROJ, HIDDEN, OUT
#                     (b, 0, row, col); PATH1, PATH2 (b)
#   encoder layer     ATTN (b, h, q, k); PROJ (out_proj), HIDDEN (ReLU), OUT
#                     (linear2): (b, 0, row, col)
#   decoder layer     ATTN (b, s*H + h, q, k): self-attention of query set s,
#                     q and k within the set (the JAX tag 100 + s*H + h,
#                     pallas_decoder.py:110); CROSS_ATTN (b, h, q, k) over
#                     the S*Q stacked queries and the memory keys; PROJ
#                     (self-attention out_proj), CROSS_PROJ (cross-attention
#                     out_proj), HIDDEN, OUT: (b, 0, row, col), row < S*Q
#   talking heads     TH_ATTN (b, g, q, k): the standalone talking-heads
#                     attention (ops/talking_heads.py), after the post-softmax
#                     mix, post-mix head g; one seed per call
#   fused MHA         MHA_ATTN (b, h, q, k): the standalone attention
#                     (ops/fused_mha.py) of the plain encoder layer and of the
#                     plain decoder layer's cross-attention, on the
#                     normalised probabilities; one seed per call

(SITE_ATTN, SITE_PROJ, SITE_HIDDEN, SITE_OUT, SITE_PATH1, SITE_PATH2,
 SITE_CROSS_ATTN, SITE_CROSS_PROJ, SITE_TH_ATTN, SITE_MHA_ATTN) = range(1, 11)
_M32 = 0xFFFFFFFF


def _mul32(a, c: int):
    """(a * c) mod 2^32 for int64 a in [0, 2^32) without int64 overflow."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _step(h, v):
    return _fmix32(h ^ _mul32(v, 0x9E3779B1))


def keep_threshold(rate: float) -> int:
    return int(round((1.0 - rate) * (1 << 24)))


def keep_scale(rate: float) -> float:
    return 1.0 / (1.0 - rate)


def _ar(n, device, dim, ndim):
    shape = [1] * ndim
    shape[dim] = n
    return torch.arange(n, device=device, dtype=torch.int64).reshape(shape)


def counter_keep(seed, site: int, rate: float, shape, head0: int = 0):
    """Keep mask of shape (B, H, R, C) (bool) for `site` at `rate`; seed is
    a (1,) int32 tensor and the mask lies on its device. The heads are
    keyed head0, head0 + 1, ...: a shard of heads (tensor parallelism)
    draws the unsharded tensor's bits for them."""
    B, H, R, C = shape
    dev = seed.device
    h = _step(seed.to(torch.int64).reshape(1, 1, 1, 1),
              torch.tensor(site, device=dev, dtype=torch.int64))
    for dim, n in enumerate(shape):
        h = _step(h, _ar(n, dev, dim, 4) + (head0 if dim == 1 else 0))
    return (h >> 8) < keep_threshold(rate)


def path_keep(seed, site: int, rate: float, B: int):
    """DropPath keep decisions (B,) bool, one per sample."""
    dev = seed.device
    h = _step(seed.to(torch.int64).reshape(1),
              torch.tensor(site, device=dev, dtype=torch.int64))
    h = _step(h, torch.arange(B, device=dev, dtype=torch.int64))
    return (h >> 8) < keep_threshold(rate)


def draw_seed(gen: torch.Generator, device):
    """A block's dropout seed, (1,) int32 drawn from the step's generator on
    its device (no host sync)."""
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                         device=gen.device, dtype=torch.int32).to(device)


def no_dropout(device):
    """A CounterDropout with every rate 0 (the Functions' form at eval
    rates)."""
    return CounterDropout(torch.zeros((1,), dtype=torch.int32, device=device))


@dataclasses.dataclass(frozen=True)
class CounterDropout:
    """The fused layers' training-mode dropout: the rates of the sites and
    the block's seed tensor; masks from `counter_keep`. head0 keys the
    heads of a head-dim site from head0 on (a shard's first head under
    tensor parallelism)."""
    seed: torch.Tensor
    attn: float = 0.0
    proj: float = 0.0
    path: float = 0.0
    head0: int = 0

    @property
    def rates(self):
        return (self.attn, self.proj, self.path)

    def site(self, x, site: int, rate: float, head_dim=False,
             mask_heads=None):
        """x (B, R, C), or (B, H, R, C) with head_dim, through `site`. With
        mask_heads the mask is keyed on x viewed as (-1, mask_heads, R, C):
        the decoder's self-attention folds its query sets into the batch."""
        if rate == 0.0:
            return x
        if mask_heads is not None:
            shape = (-1, mask_heads) + tuple(x.shape[-2:])
            return self.site(x.reshape(shape), site, rate,
                             head_dim=True).reshape(x.shape)
        shape = x.shape if head_dim else (x.shape[0], 1) + tuple(x.shape[1:])
        keep = counter_keep(self.seed, site, rate, shape,
                            self.head0 if head_dim else 0).reshape(x.shape)
        return torch.where(keep, x * keep_scale(rate), 0.0)

    def path_factor(self, site: int, B: int):
        """Per-sample DropPath factor (B, 1, 1) f32: 0 or 1 / (1 - rate)."""
        if self.path == 0.0:
            return torch.ones((B, 1, 1), device=self.seed.device)
        keep = path_keep(self.seed, site, self.path, B)
        return torch.where(keep, keep_scale(self.path), 0.0).reshape(B, 1, 1)
