"""Inputs, tolerances and bounds for holding each kernel against its plain
PyTorch version on the card (used by chip_smoke.py and the `cuda` tests).

`kernel_cases()` draws seeded bf16 activations and f32 weights at the
voc0712 eval widths (D=192, 4 backbone heads, 8 transformer heads,
FFN 2048); sequence lengths default to the recipe's (1024 patches, 21
class tokens, 2 query sets of 300) and may be cut for a quick check.
LayerScale gammas and LayerNorm scales are drawn near 1 so every branch
shows in the output.

`attention_cases()` draws the standalone attention kernels' inputs at the
shapes the voc0712 recipe gives them with the fused flags off: fused_mha
(B4) as the class attention (21 queries over 1045 keys, 4 heads of 48, the
probabilities returned), the encoder self-attention (1024 x 1024, 8 heads
of 24, a padded-key mask) and the decoder cross-attention (2 x 300 queries
over 1024 keys, q/k heads of 48 and v heads of 24, the mask); the
talking-heads attention (B5) over the 1024 patches (4 heads of 48, mixes
near the identity).

`cc_masks()` and `auction_problems()` draw the supervision kernels' inputs
at the recipe's training shapes (B * max_pos = 64 masks of 64 x 64; S * L *
B = 96 problems of 120 targets x 300 queries); both kernels must equal
their plain versions exactly.

`*_bound_ms()` give the least time the H100 could take for the same work:
the larger of the bytes the function must move (each input read once,
each output written once) over 3.35 TB/s and its operations over the peak
rate of their type (bf16 tensor products 989 TFLOP/s; f32 and 32-bit
integer elementwise work 67 T/s, the card's non-tensor f32 rate).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from spe_tpu_torch.ops import (fused_block, fused_ca_block, fused_decoder,
                               fused_encoder, fused_mha, talking_heads)
from spe_tpu_torch.ops.refmath import CounterDropout

# every fused layer is built from the same three sources: linear.cu
# (ln_linear), attention.cu and rowops.cu
SOURCE = "spe_tpu_torch/csrc"
# bf16 outputs are held to 4 bf16 ulps at their largest magnitude: the
# kernels sum in another order than cuBLAS and keep the softmax
# probabilities in f32 where the plain versions round them to bf16 before
# the PV product. The class-attention probabilities (f32, the CAM source)
# are held to PROBS_TOL.
ULPS = 4
PROBS_TOL = 1e-4
# A whole detector through the kernels vs the same weights through the plain
# versions (bf16 both, LayerScale 1): bf16 keeps ~2^-8 relative precision
# per rounding and the two paths sum in different orders through every
# layer, so each output is held to 5% of its own largest magnitude. Maps
# (the CAMs and the first class-attention block's probabilities) are nearly
# flat at random init, where 5% of the largest value would pass a mirrored
# map; they are held to 5% of their range (max - min) instead.
MODEL_REL_TOL = 0.05
MAP_KEYS = ("cams_cls", "ca0_probs")
# A backward kernel against `*_backward_reference` on the same inputs and
# cotangents: each gradient within 1% of its own largest magnitude. Both
# round the same operands to bf16 before each product, but sum in other
# orders, so a rounded operand may land one bf16 ulp (2^-8 relative) apart,
# and the gradients of the bf16-cast matrices and dx are themselves rounded
# to bf16 (one ulp at the largest magnitude is 0.4-0.8% of it).
GRAD_REL_TOL = 0.01
# the recipe's dropout rates: attention, projection/MLP, DropPath in the
# patch blocks; every site of the encoder and decoder layers (`dropout`)
RECIPE_RATES = (0.05, 0.07, 0.2)
TRANSFORMER_RATE = 0.1


def model_tol(key, ref):
    """Tolerance of one detector output against the plain-version model."""
    ref = ref.float()
    if key in MAP_KEYS:
        return MODEL_REL_TOL * float(ref.max() - ref.min())
    return MODEL_REL_TOL * float(ref.abs().max())


# Some bias gradients are zero in exact arithmetic: a logit bias shared by a
# whole softmax row moves no probability. These are the block's pre-softmax
# head bias, every key projection's bias (the patch blocks' k third of
# qkv.bias, class attention's, the encoder's k third of in_proj_bias, the
# decoder's content and position key projections in both attentions). Both
# sides compute rounding noise there, so each is held to 1% of the largest
# magnitude of the matching weight's gradient instead. `grad_views` names
# the thirds of the fused q|k|v tensors (the patch blocks' and the
# encoder's) `<name>[q]`, `<name>[k]`, `<name>[v]`: each third is held to
# its own scale, so a wrong q or k gradient cannot hide under the larger v
# third (a zeroed talking-heads dQ stays within 5% of the whole tensor).
ZERO_GRADS = {"attn.proj_l.bias": "attn.proj_l.weight",
              "proj_l.bias": "proj_l.weight",
              "attn.qkv.bias[k]": "attn.qkv.weight[k]",
              "attn.k.bias": "attn.k.weight",
              "self_attn.in_proj_bias[k]": "self_attn.in_proj_weight[k]",
              "sa_kcontent_proj.bias": "sa_kcontent_proj.weight",
              "sa_kpos_proj.bias": "sa_kpos_proj.weight",
              "ca_kcontent_proj.bias": "ca_kcontent_proj.weight",
              "ca_kpos_proj.bias": "ca_kpos_proj.weight"}
QKV_FUSED = ("attn.qkv.weight", "attn.qkv.bias", "self_attn.in_proj_weight",
             "self_attn.in_proj_bias")


def grad_views(grads):
    """{name: gradient} with each fused q|k|v tensor split into its thirds
    (names of any prefix: a model's full parameter names too)."""
    out = {}
    for n, t in grads.items():
        if t is not None and n.endswith(QKV_FUSED):
            for part, third in zip("qkv", t.chunk(3)):
                out[f"{n}[{part}]"] = third
        else:
            out[n] = t
    return out


def zero_grad_ref(name):
    """The gradient a zero-by-construction `name` is held against, or None
    (full names: the prefix is kept)."""
    for z, ref in ZERO_GRADS.items():
        if name == z or name.endswith("." + z):
            return name[:len(name) - len(z)] + ref
    return None


def grad_tol(ref):
    return GRAD_REL_TOL * float(ref.float().abs().max())


def grad_tols(grads):
    """{name: tolerance} for a layer's reference gradients (grad_views
    names)."""
    return {k: grad_tol(grads[zero_grad_ref(k) or k]) for k in grads}


def bf16_tol(ref, ulps=ULPS):
    """`ulps` bf16 ulps (8 significant bits) at the largest |ref|."""
    top = float(ref.float().abs().max())
    return ulps * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


HBM_BYTES_PER_MS = 3.35e12 / 1e3
BF16_TENSOR_OPS_PER_MS = 989e12 / 1e3
SCALAR_OPS_PER_MS = 67e12 / 1e3


def bound_ms(nbytes: float, work):
    """-> (least ms, "bytes" or "operations"): nbytes over the memory rate
    against the sum of ops / rate over work = [(ops, ops per ms), ...]."""
    t_bytes = nbytes / HBM_BYTES_PER_MS
    t_ops = sum(ops / rate for ops, rate in work)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _attention_work(name, args):
    """A standalone attention's work at the shapes of `args` (a
    kernel_cases / train_cases entry): per (sample, head) query-key pair
    the multiply-adds of q.k and p.v, the talking-heads mixes (H per value
    and mix), and the bytes of q, k, v, the mask and the parameters read
    and the output (and probabilities) written."""
    q, k, v = args[:3]
    H = args[3] if name == "pallas_mha" else args[4]
    B, Nq = q.shape[:2]
    Nk = k.shape[1]
    dq, dv = q.shape[-1] // H, v.shape[-1] // H
    pairs = B * H * Nq * Nk
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    io = _nbytes(*tensors) + B * Nq * H * dv * q.element_size()
    mix = 0
    if name == "pallas_attention":
        io += _nbytes(*args[3].values())
        mix = 4 * pairs * H
    elif args[6]:   # the probabilities
        io += pairs * 4
    return dict(pairs=pairs, dq=dq, dv=dv, io=io, mix=mix)


def attention_bound_ms(name, args, form="eval", cot=()):
    """The bound of fused_mha or the talking-heads attention at the shapes
    of `args`: the per-head products at the bf16 tensor rate (2 ops per
    multiply-add: q.k and p.v forward; the backward's logits recompute,
    dY.V^T, dV, dQ and dK), the talking-heads mixes and, in training, the
    masks (one integer hash chain step per value, ~12 ops) and the
    backward's row pass (~10 per value) at the f32 rate; the bytes of the
    inputs read and the outputs written once (training: the row
    log-sum-exps too; backward: the cotangent and the saved log-sum-exps
    read, the input gradients written, in f32 for the parameters)."""
    w = _attention_work(name, args)
    pairs, dq, dv = w["pairs"], w["dq"], w["dv"]
    drop = args[-2] if name == "pallas_mha" else args[-1]
    masks = 12 * pairs if drop is not None and drop.attn else 0
    lse = pairs // args[1].shape[1] * 4
    if form == "backward":
        ops = 2 * pairs * (3 * dq + 2 * dv)
        scalar = 10 * pairs + masks + (6 * w["mix"] // 4 if w["mix"] else 0)
        io = w["io"] + _nbytes(*cot) + lse
        return bound_ms(io, [(ops, BF16_TENSOR_OPS_PER_MS),
                             (scalar, SCALAR_OPS_PER_MS)])
    ops = 2 * pairs * (dq + dv)
    io = w["io"] + (lse if form == "train" else 0)
    return bound_ms(io, [(ops, BF16_TENSOR_OPS_PER_MS),
                         (w["mix"] + (masks if form == "train" else 0),
                          SCALAR_OPS_PER_MS)])


def layer_bound_ms(name, args):
    """The bound of one fused layer at the shapes of `args` (a kernel_cases
    entry): its products at the bf16 tensor rate (2 ops per multiply-add;
    the layer's own per-head attention, not the kernels' 4x wl-fold), the
    talking-heads mixes at the f32 rate; x, pos, masks and parameters read
    once, the output written once."""
    if name in ATTENTION:
        return attention_bound_ms(name, args)
    p = next(a for a in args if isinstance(a, dict))
    pbytes = _nbytes(*p.values())
    mix = 0
    if name == "pallas_block":
        x, _, H = args
        B, N, D = x.shape
        F = p["mlp.fc1.weight"].shape[0]
        ops = 2 * B * N * (4 * D * D + 2 * D * F) + 4 * B * N * N * D
        mix = 4 * B * N * N * H * H
        io = 2 * _nbytes(x)
    elif name == "pallas_ca_block":
        cls, x, _, H = args
        B, t, D = cls.shape
        N = t + x.shape[1]
        F = p["mlp.fc1.weight"].shape[0]
        ops = 2 * B * (2 * t * D * D + 2 * N * D * D + 2 * t * D * F) \
            + 4 * B * t * N * D
        io = 2 * _nbytes(cls) + _nbytes(x) + B * H * t * N * 4
    elif name == "pallas_encoder":
        x, pos, mask, _, H = args
        B, N, D = x.shape
        F = p["linear1.weight"].shape[0]
        ops = 2 * B * N * (4 * D * D + 2 * D * F) + 4 * B * N * N * D
        io = 2 * _nbytes(x) + _nbytes(pos, mask)
    else:
        tgt, mem, pos, qpos, sine, mask, _, H, S = args
        B, SQ, D = tgt.shape
        N = mem.shape[1]
        F = p["linear1.weight"].shape[0]
        # (D, D) projections on the query rows: 6 for self-attention, 3 for
        # cross-attention, +1 (ca_qpos_proj) on layer 0; 3 on memory rows
        n_q = 10 if "ca_qpos_proj.weight" in p else 9
        ops = 2 * B * (SQ * D * D * n_q + 3 * N * D * D + 2 * SQ * D * F) \
            + 4 * B * (SQ // S) * SQ * D + 2 * B * SQ * N * 3 * D
        io = 2 * _nbytes(tgt) + _nbytes(mem, pos, qpos, sine, mask)
    return bound_ms(io + pbytes, [(ops, BF16_TENSOR_OPS_PER_MS),
                                  (mix, SCALAR_OPS_PER_MS)])


def _block_linear_ops(B, N, D, F):
    return 2 * B * N * (4 * D * D + 2 * D * F)


def _transformer_work(name, args):
    """An encoder or decoder layer's work at the shapes of `args` (a
    train_cases entry): linear and per-head attention products of the
    forward and of the backward (the logits recompute, dzd, dV, dQ and dK
    of each attention) in ops (2 per multiply-add), the masked values,
    the attention rows' values, and the bytes of the inputs read and the
    output written once, of the saved tensors and of the parameters."""
    x = args[0]
    p = next(a for a in args if isinstance(a, dict))
    B, R, D = x.shape
    F = p["linear1.weight"].shape[0]
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    io = _nbytes(*tensors) + _nbytes(x)
    if name == "pallas_encoder":
        H = args[4]
        lin = 2 * B * R * (4 * D * D + 2 * D * F)
        att, att_bwd = 4 * B * R * R * D, 10 * B * R * R * D
        rows = B * H * R * R
        masks = rows + 2 * B * R * D + B * R * F
        saved = B * R * D * (2 + 4) + B * H * R * 4
    else:
        H, S = args[7], args[8]
        N = args[1].shape[1]
        n_q = 10 if "ca_qpos_proj.weight" in p else 9
        lin = 2 * B * (R * D * D * n_q + 3 * N * D * D + 2 * R * D * F)
        # self-attention: S sets of R/S queries; cross-attention: q.k at
        # 2D, V at D per query and key
        att = 4 * B * R * (R // S) * D + 6 * B * R * N * D
        att_bwd = 10 * B * R * (R // S) * D + 16 * B * R * N * D
        rows = B * H * (R * (R // S) + R * N)
        masks = rows + 3 * B * R * D + B * R * F
        saved = B * R * D * (2 + 2 + 4) + 2 * B * H * R * 4
    return dict(lin=lin, att=att, att_bwd=att_bwd, rows=rows, masks=masks,
                io=io, saved=saved, params=_nbytes(*p.values()))


def train_bound_ms(name, args):
    """The training forward's bound: the eval layer's work plus the saved
    residuals written (o, md and the row statistics of the block; o and
    the MLP output of class attention; o, h2d and the log-sum-exps of the
    encoder and decoder) and the dropout masks (one integer hash chain
    step per masked value, at the f32/int rate)."""
    if name in ATTENTION:
        return attention_bound_ms(name, args, "train")
    if name == "pallas_block":
        x, p, H, _ = args
        B, N, D = x.shape
        F = p["mlp.fc1.weight"].shape[0]
        ops = _block_linear_ops(B, N, D, F) + 4 * B * N * N * D
        scalar = 4 * B * N * N * H * H + 12 * (B * H * N * N + 2 * B * N * D
                                               + B * N * F)
        io = 2 * _nbytes(x) + B * N * D * (2 + 4) + B * H * N * 4
        return bound_ms(io + _nbytes(*p.values()),
                        [(ops, BF16_TENSOR_OPS_PER_MS),
                         (scalar, SCALAR_OPS_PER_MS)])
    if name in ("pallas_encoder", "pallas_decoder"):
        w = _transformer_work(name, args)
        return bound_ms(w["io"] + w["saved"] + w["params"],
                        [(w["lin"] + w["att"], BF16_TENSOR_OPS_PER_MS),
                         (12 * w["masks"], SCALAR_OPS_PER_MS)])
    cls, x, p, H = args
    B, t, D = cls.shape
    b, by = layer_bound_ms(name, (cls, x, p, H))
    extra = B * t * D * (2 + 4) / HBM_BYTES_PER_MS
    return (b + extra, by) if by == "bytes" else (b, by)


def bwd_bound_ms(name, args, cot):
    """The backward's bound: at the bf16 tensor rate the layer's own
    per-head attention products (block: the QK recompute, dV, dzd, dQ and
    dK, about 10 B N^2 D; class attention: dp, dV, dq and dk, 8 B t N D;
    encoder and decoder: the logits recompute, dzd, dV, dQ and dK of each
    attention) plus twice the forward's linear products; at the f32 rate
    the talking-heads mixes, softmax backward, masks and LayerNorm; bytes:
    the saved tensors and cotangents read once, the input and f32
    parameter gradients written once, the parameters read once."""
    if name in ATTENTION:
        return attention_bound_ms(name, args, "backward", cot)
    if name == "pallas_block":
        x, p, H, _ = args
        B, N, D = x.shape
        F = p["mlp.fc1.weight"].shape[0]
        ops = 10 * B * N * N * D + 2 * _block_linear_ops(B, N, D, F)
        scalar = 6 * B * N * N * H * H + 10 * B * N * N * H
        io = 2 * _nbytes(x) + B * N * D * (2 + 4) + B * H * N * 4 \
            + _nbytes(*cot)
    elif name in ("pallas_encoder", "pallas_decoder"):
        w = _transformer_work(name, args)
        p = next(a for a in args if isinstance(a, dict))
        ops = w["att_bwd"] + 2 * w["lin"]
        # the row pass (~10 per value: exp, mask, two sums), the masks, and
        # the three LayerNorm backwards (~10 per value each)
        scalar = 10 * w["rows"] + 12 * w["masks"] + 30 * args[0].numel()
        acts = [a for a in args if isinstance(a, torch.Tensor)
                and a.is_floating_point()]
        # activations read and their gradients written in f32
        io = _nbytes(*acts) + 4 * sum(a.numel() for a in acts) \
            + w["saved"] + _nbytes(*cot)
    else:
        cls, x, p, H = args
        B, t, D = cls.shape
        N = t + x.shape[1]
        F = p["mlp.fc1.weight"].shape[0]
        lin = 2 * B * (2 * t * D * D + 2 * N * D * D + 2 * t * D * F)
        ops = 8 * B * t * N * D + 2 * lin
        scalar = 6 * B * H * t * N
        io = 2 * _nbytes(cls) + 2 * _nbytes(x) + B * H * t * N * 4 \
            + B * t * D * (2 + 4) + _nbytes(*(c for c in cot if c is not None))
    pbytes = _nbytes(*p.values())
    return bound_ms(io + 2 * pbytes, [(ops, BF16_TENSOR_OPS_PER_MS),
                                      (scalar, SCALAR_OPS_PER_MS)])


# 8-neighbour min (8), the mask select (1), two run-min passes each way
# (4) and the change test (1), per pixel and sweep
CC_OPS_PER_PIXEL_SWEEP = 14
# per bidding person and object: values = benefit - price, the best and the
# second best comparisons
AUCTION_OPS_PER_BID_OBJECT = 3


def cc_bound_ms(masks, sweeps):
    """masks (N, S, S) bool in, int32 labels out; the sweeps each mask ran."""
    N, S, _ = masks.shape
    ops = float(sweeps.sum()) * S * S * CC_OPS_PER_PIXEL_SWEEP
    return bound_ms(N * S * S * (1 + 4), [(ops, SCALAR_OPS_PER_MS)])


def auction_bound_ms(benefit, bids):
    """benefit (P, T, Q) f32 and the person mask in, assignments and
    iteration counts out; `bids` the persons' bids evaluated."""
    P, T, Q = benefit.shape
    ops = float(bids.sum()) * Q * AUCTION_OPS_PER_BID_OBJECT
    return bound_ms(P * T * Q * 4 + P * T * (1 + 4) + P * 4,
                    [(ops, SCALAR_OPS_PER_MS)])


def diagonal_maze(S):
    """One 8-connected path zigzagging along the diagonals c - r = 0, 4, 8,
    ..., joined by short bridges on row 0 and the last column. Its runs are
    one pixel long, so labels move one pixel per sweep: at S = 64 it needs
    457 sweeps, past the 96-sweep cap (at S = 32, 101)."""
    m = np.zeros((S, S), bool)
    ds = list(range(0, S - 4, 4))
    for d in ds:
        r = np.arange(0, S - d)
        m[r, r + d] = True
    for k, d in enumerate(ds[:-1]):
        if k % 2 == 0:
            m[0, d:d + 5] = True
        else:
            m[S - 5 - d:S - d, S - 1] = True
    return m


def cc_masks(n=64, S=64, n_mazes=2, seed=0):
    """(n, S, S) bool: thresholded sums of random Gaussian blobs (what the
    CAM masks look like) and `n_mazes` diagonal mazes that bind the cap."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:S, 0:S]
    out = []
    for _ in range(n - n_mazes):
        cam = np.zeros((S, S))
        for _ in range(rng.integers(1, 5)):
            cy, cx = rng.uniform(0.1, 0.9, 2) * S
            sy, sx = rng.uniform(0.04, 0.25, 2) * S
            cam += rng.uniform(0.3, 1.0) * np.exp(
                -((ys - cy) ** 2 / (2 * sy ** 2) + (xs - cx) ** 2 / (2 * sx ** 2)))
        out.append(cam > rng.uniform(0.1, 0.5) * cam.max())
    for i in range(n_mazes):
        m = diagonal_maze(S)
        out.append(m if i % 2 == 0 else m[::-1].copy())
    return torch.from_numpy(np.stack(out))


def auction_problems(P=96, T=120, Q=300, K=21, seed=0, device="cpu"):
    """(benefit (P, T, Q) f32, person mask (P, T) bool) from DETR-like
    matching costs (ops/auction.py's normalisation of train/criterion.py's
    matcher_cost): random logits and boxes for Q queries against T/5 boxes
    repeated 5 times (duplicate columns), the last quarter of the target
    slots padded on half the problems, one problem with no valid target."""
    from spe_tpu_torch.ops.auction import _normalize_benefit
    from spe_tpu_torch.train.criterion import matcher_cost

    g = torch.Generator().manual_seed(seed)
    logits = torch.randn((P, Q, K), generator=g) * 2 - 3
    cxcy = torch.rand((P, Q, 2), generator=g) * 0.8 + 0.1
    wh = torch.rand((P, Q, 2), generator=g) * 0.4 + 0.05
    n_box = T // 5
    tb = torch.cat([torch.rand((P, n_box, 2), generator=g) * 0.8 + 0.1,
                    torch.rand((P, n_box, 2), generator=g) * 0.4 + 0.05], -1)
    labels = torch.randint(1, K, (P, n_box), generator=g)
    tb = tb.repeat_interleave(5, 1)
    labels = labels.repeat_interleave(5, 1)
    mask = torch.ones((P, T), dtype=torch.bool)
    mask[::2, T - T // 4:] = False
    mask[P // 2] = False
    cost = matcher_cost(logits, torch.cat([cxcy, wh], -1), labels, tb, mask)
    return (_normalize_benefit(cost, mask).to(device), mask.to(device))


def _makers(gen, device, D):
    """(param, linear, norm) drawing seeded weights into a parameter dict:
    Linear weights at fan-in^-0.5, small biases, LayerNorm scales near 1."""
    def param(shape, std, mean=0.0):
        return (mean + std * torch.randn(shape, generator=gen)).to(device)

    def linear(p, name, fin, fout):
        p[f"{name}.weight"] = param((fout, fin), fin ** -0.5)
        p[f"{name}.bias"] = param((fout,), 0.02)

    def norm(p, name):
        p[f"{name}.weight"] = param((D,), 0.1, 1.0)
        p[f"{name}.bias"] = param((D,), 0.05)

    return param, linear, norm


def _backbone_params(gen, device, D=192):
    """The patch block's and the class-attention block's parameters (4
    heads, MLP 4D), LayerScale gammas near 1."""
    param, linear, norm = _makers(gen, device, D)
    blk = {}
    norm(blk, "norm1")
    linear(blk, "attn.qkv", D, 3 * D)
    linear(blk, "attn.proj_l", 4, 4)
    linear(blk, "attn.proj_w", 4, 4)
    linear(blk, "attn.proj", D, D)
    norm(blk, "norm2")
    linear(blk, "mlp.fc1", D, 4 * D)
    linear(blk, "mlp.fc2", 4 * D, D)
    blk["gamma_1"] = param((D,), 0.1, 1.0)
    blk["gamma_2"] = param((D,), 0.1, 1.0)

    ca = {}
    norm(ca, "norm1")
    for n in ("q", "k", "v", "proj"):
        linear(ca, f"attn.{n}", D, D)
    norm(ca, "norm2")
    linear(ca, "mlp.fc1", D, 4 * D)
    linear(ca, "mlp.fc2", 4 * D, D)
    ca["gamma_1"] = param((D,), 0.1, 1.0)
    ca["gamma_2"] = param((D,), 0.1, 1.0)
    return blk, ca


def _transformer_params(gen, device, D=192, F=2048):
    """The encoder layer's and the decoder layer's parameters (8 heads),
    the decoder's as layer 0 (with ca_qpos_proj) and as a later layer."""
    param, linear, norm = _makers(gen, device, D)
    enc = {"self_attn.in_proj_weight": param((3 * D, D), D ** -0.5),
           "self_attn.in_proj_bias": param((3 * D,), 0.02)}
    linear(enc, "self_attn.out_proj", D, D)
    norm(enc, "norm1")
    linear(enc, "linear1", D, F)
    linear(enc, "linear2", F, D)
    norm(enc, "norm2")

    dec = {}
    for n in ("sa_qcontent_proj", "sa_qpos_proj", "sa_kcontent_proj",
              "sa_kpos_proj", "sa_v_proj", "self_attn.out_proj",
              "ca_qcontent_proj", "ca_kcontent_proj", "ca_v_proj",
              "ca_kpos_proj", "ca_qpos_sine_proj", "cross_attn.out_proj",
              "ca_qpos_proj"):
        linear(dec, n, D, D)
    for n in ("norm1", "norm2", "norm3"):
        norm(dec, n)
    linear(dec, "linear1", D, F)
    linear(dec, "linear2", F, D)
    dec_later = {k: v for k, v in dec.items()
                 if not k.startswith("ca_qpos_proj")}
    return enc, dec, dec_later


def _key_mask(B, N, device):
    """Padded keys on the last image (its last tenth)."""
    mask = torch.zeros((B, N), dtype=torch.bool)
    mask[-1, N - N // 10:] = True
    return mask.to(device)


def train_cases(B=2, N=1024, t=21, S=2, Q=300, device="cuda", seed=0,
                rates=RECIPE_RATES, rate=TRANSFORMER_RATE):
    """[(name, module, args, cotangents)] of the fused layers in training
    at the voc0712 widths: the patch block with the recipe's dropout rates
    and a seed tensor on `device`; the class-attention block; the encoder
    layer and the decoder layer (layer 0 and a later layer) at the recipe's
    `dropout` on every site, with a padded-key mask. bf16 activations and
    cotangents, plus a nonzero f32 cotangent on the class-attention
    probabilities."""
    D = 192
    gen = torch.Generator().manual_seed(seed + 1)
    blk, ca = _backbone_params(gen, device, D)

    def act(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen).to(dtype).to(device)

    def seed_of(v):
        return torch.tensor([v], dtype=torch.int32, device=device)

    x, cls = act(B, N, D), act(B, t, D)
    drop = CounterDropout(seed_of(20240611), *rates)
    dattn = 0.1 * act(B, 4, t, t + N, dtype=torch.float32)
    cases = [("pallas_block", fused_block, (x, blk, 4, drop), (act(B, N, D),)),
             ("pallas_ca_block", fused_ca_block, (cls, x, ca, 4),
              (act(B, t, D), dattn))]
    enc, dec, dec_later = _transformer_params(gen, device, D)
    pos, mask = act(B, N, D), _key_mask(B, N, device)
    tgt, qpos, sine = act(B, S * Q, D), act(B, S * Q, D), act(B, S * Q, D)
    tdrop = CounterDropout(seed_of(20240612), rate, rate)
    dec_args = (tgt, x, pos, qpos, sine, mask)
    return cases + [
        ("pallas_encoder", fused_encoder, (x, pos, mask, enc, 8, tdrop),
         (act(B, N, D),)),
        ("pallas_decoder", fused_decoder, (*dec_args, dec, 8, S, tdrop),
         (act(B, S * Q, D),)),
        ("pallas_decoder", fused_decoder, (*dec_args, dec_later, 8, S, tdrop),
         (act(B, S * Q, D),))]


def attention_cases(B=2, N=1024, t=21, S=2, Q=300, device="cuda", seed=0,
                    train=False):
    """[(name, replaces, module, args, cotangents, label)] of the standalone
    attention kernels at the voc0712 shapes with the fused flags off (see
    the module docstring): args as the kernel's entry point takes them,
    (q, k, v, num_heads, key_padding_mask, drop, return_attn) for fused_mha
    and (q, k, v, params, num_heads, drop) for the talking-heads attention.
    Each case carries a bf16 cotangent of its output. With `train` the
    attention dropout is the recipe's (0.1 in the encoder and the decoder
    cross-attention, 0.05 in the patch blocks; none in the class
    attention); without, every rate is 0."""
    D = 192
    gen = torch.Generator().manual_seed(seed + 2)

    def act(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16).to(device)

    def drop(rate, v):
        if not (train and rate):
            return None
        return CounterDropout(torch.tensor([v], dtype=torch.int32,
                                           device=device), attn=rate)

    def mix():
        return (torch.eye(4) + 0.3 * torch.randn((4, 4), generator=gen)).to(
            device)

    mask = _key_mask(B, N, device)
    th = {"proj_l.weight": mix(), "proj_l.bias": 0.1 * torch.randn(
        (4,), generator=gen).to(device), "proj_w.weight": mix(),
        "proj_w.bias": 0.1 * torch.randn((4,), generator=gen).to(device)}
    cases = [
        ("pallas_mha", (act(B, t, D), act(B, t + N, D), act(B, t + N, D), 4,
                        None, drop(0.0, 0), True), "class attention"),
        ("pallas_mha", (act(B, N, D), act(B, N, D), act(B, N, D), 8, mask,
                        drop(TRANSFORMER_RATE, 20240613), False),
         "encoder self-attention"),
        ("pallas_mha", (act(B, S * Q, 2 * D), act(B, N, 2 * D), act(B, N, D),
                        8, mask, drop(TRANSFORMER_RATE, 20240614), False),
         "decoder cross-attention"),
        ("pallas_attention", (act(B, N, D), act(B, N, D), act(B, N, D), th,
                              4, drop(RECIPE_RATES[0], 20240615)),
         "patch-block talking heads"),
    ]
    mods = {"pallas_mha": fused_mha, "pallas_attention": talking_heads}
    out = []
    for name, args, label in cases:
        q, v = args[0], args[2]
        H = args[3] if name == "pallas_mha" else args[4]
        cot = (act(B, q.shape[1], H * (v.shape[-1] // H)),)
        out.append((name, REPLACES[name], mods[name], args, cot, label))
    return out


# the standalone attention kernels: the TPU forward and backward each
# replaces
ATTENTION = ("pallas_mha", "pallas_attention")
REPLACES = {"pallas_mha": "spe_tpu/ops/pallas_mha.py:273",
            "pallas_attention": "spe_tpu/ops/pallas_attention.py:112"}
# per layer: (plain training forward, plain backward, the inputs whose
# gradients the backward returns, in its order)
TRAIN_API = {
    "pallas_block": ("layer_scale_block_train_reference",
                     "layer_scale_block_backward_reference", ("dx",)),
    "pallas_ca_block": ("class_attn_block_train_reference",
                        "class_attn_block_backward_reference",
                        ("dcls", "dx")),
    "pallas_encoder": ("encoder_layer_train_reference",
                       "encoder_layer_backward_reference", ("dx", "dpos")),
    "pallas_decoder": ("decoder_layer_train_reference",
                       "decoder_layer_backward_reference",
                       ("dtgt", "dmem", "dpos", "dqpos", "dsine")),
    "pallas_mha": ("fused_mha_train_reference",
                   "fused_mha_backward_reference", ("dq", "dk", "dv")),
    "pallas_attention": ("talking_heads_train_reference",
                         "talking_heads_backward_reference",
                         ("dq", "dk", "dv")),
}
# the TPU backward each replaces
BWD_REPLACES = {"pallas_block": "spe_tpu/ops/pallas_block.py:513",
                "pallas_ca_block": "spe_tpu/ops/pallas_ca_block.py:243",
                "pallas_encoder": "spe_tpu/ops/pallas_encoder.py:344",
                "pallas_decoder": "spe_tpu/ops/pallas_decoder.py:550",
                "pallas_mha": "spe_tpu/ops/pallas_mha.py:197",
                "pallas_attention": "spe_tpu/ops/pallas_attention_bwd.py:136"}


def plain_train(name, mod):
    """-> (plain training forward, plain backward) of a train_cases layer."""
    fwd, bwd, _ = TRAIN_API[name]
    return getattr(mod, fwd), getattr(mod, bwd)


def saved_outputs(name, outputs):
    """The training forward's outputs that its backward takes: all but the
    first; of fused_mha's only the last (the log-sum-exps: the
    probabilities it may also return carry no gradient)."""
    return outputs[-1:] if name == "pallas_mha" else outputs[1:]


def backward_args(args, saved, cot):
    """A backward's arguments from a train_cases entry and the training
    forward's saved outputs (`saved_outputs`): the cotangents, the inputs,
    the saved tensors, then the parameters (or the head count) and the rest
    of the forward's arguments."""
    i = next(j for j, a in enumerate(args)
             if isinstance(a, dict) or type(a) is int)
    return (*cot, *args[:i], *saved, *args[i:])


def flat_grads(name, result):
    """A backward's (input gradients..., [{name: gradient}]) -> {name:
    gradient} over the inputs and grad_views of the parameters."""
    *dins, g = result if isinstance(result[-1], dict) else (*result, {})
    return {**dict(zip(TRAIN_API[name][2], dins)), **grad_views(g)}


def kernel_cases(B=2, N=1024, t=21, S=2, Q=300, device="cuda", seed=0):
    """[(name, replaces, fused fn, plain fn, args)] for the four fused
    layers; the decoder twice, with the layer-0 (ca_qpos_proj) and the
    later-layer parameter sets."""
    D = 192
    gen = torch.Generator().manual_seed(seed)

    def act(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16).to(device)

    blk, ca = _backbone_params(gen, device, D)
    enc, dec, dec_later = _transformer_params(gen, device, D)
    mask = _key_mask(B, N, device)
    x, pos, cls = act(B, N, D), act(B, N, D), act(B, t, D)
    tgt, qpos, sine = act(B, S * Q, D), act(B, S * Q, D), act(B, S * Q, D)
    return [
        ("pallas_block", "spe_tpu/ops/pallas_block.py:548",
         fused_block.fused_layer_scale_block,
         fused_block.layer_scale_block_reference, (x, blk, 4)),
        ("pallas_ca_block", "spe_tpu/ops/pallas_ca_block.py:268",
         fused_ca_block.fused_class_attn_block,
         fused_ca_block.class_attn_block_reference, (cls, x, ca, 4)),
        ("pallas_encoder", "spe_tpu/ops/pallas_encoder.py:375",
         fused_encoder.fused_encoder_layer,
         fused_encoder.encoder_layer_reference, (x, pos, mask, enc, 8)),
        ("pallas_decoder", "spe_tpu/ops/pallas_decoder.py:599",
         fused_decoder.fused_decoder_layer,
         fused_decoder.decoder_layer_reference,
         (tgt, x, pos, qpos, sine, mask, dec, 8, S)),
        ("pallas_decoder", "spe_tpu/ops/pallas_decoder.py:599",
         fused_decoder.fused_decoder_layer,
         fused_decoder.decoder_layer_reference,
         (tgt, x, pos, qpos, sine, mask, dec_later, 8, S)),
    ]


def compare(fused, plain, args):
    """Run both on the same inputs -> (errors, tolerances, all finite)."""
    with torch.no_grad():
        got = fused(*args)
        want = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = [max_err(g, w) for g, w in zip(got, want)]
    tols = [bf16_tol(want[0])] + [PROBS_TOL] * (len(got) - 1)
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    return errs, tols, finite
