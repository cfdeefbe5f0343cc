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
their plain versions exactly. `auction_case()` draws the auction kernel's
card-test shapes (AUCTION_CASES), one or more for each of its paths.

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
              "ca_kpos_proj.bias": "ca_kpos_proj.weight",
              # the segmentation head: MHAttentionMap's softmax over
              # positions ignores a per-query constant, and a GroupNorm
              # subtracts its group's mean after each conv
              "k_linear.bias": "k_linear.weight",
              "conv_0.bias": "conv_0.weight",
              "conv_1.bias": "conv_1.weight",
              "conv_2.bias": "conv_2.weight"}
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


def auction_bound_ms(benefit, bids, person_mask):
    """The valid persons' benefit rows (P, T, Q) f32 and the person mask
    in, assignments, iteration and bid counts out: a padded person's row is
    never read. `bids` the persons' bids evaluated."""
    P, T, Q = benefit.shape
    ops = float(bids.sum()) * Q * AUCTION_OPS_PER_BID_OBJECT
    rows = int(person_mask.sum())
    return bound_ms(rows * Q * 4 + P * T * (1 + 4) + P * (4 + 4),
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


def cc_patterns(S, n, seed=0):
    """(n, S, S) bool: the CC kernel's test patterns in turn (blobs as
    cc_masks draws them, all foreground, all background, a checkerboard, a
    snake of one pixel a row, and diagonal_maze in both orientations)."""
    ii, jj = np.indices((S, S))
    snake = np.zeros((S, S), bool)
    snake[np.arange(S), (np.arange(S) * 3) % S] = True
    fixed = [np.ones((S, S), bool), np.zeros((S, S), bool),
             (ii + jj) % 2 == 0, snake, diagonal_maze(S),
             diagonal_maze(S)[::-1].copy()]
    blobs = cc_masks(n=max(1, n - len(fixed)), S=S, n_mazes=0,
                     seed=seed).numpy()
    out = [fixed[k // 2] if k % 2 and k // 2 < len(fixed) else
           blobs[k // 2 % len(blobs)] for k in range(n)]
    return torch.from_numpy(np.stack(out))


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


def auction_ties(P=5, T=12, Q=9, seed=0):
    """(benefit (P, T, Q) f32, person mask (P, T) bool) made of exact ties:
    benefits on a grid of quarters, a column and a row repeated in every
    problem, problem 0 of zeros of both signs (the float compare takes -0
    == +0) among -0.5s, masks that are not a prefix and problem 1 with
    every person padded. T >= 4, Q >= 2, P >= 2."""
    rng = np.random.default_rng(seed)
    b = rng.integers(-3, 3, size=(P, T, Q)).astype(np.float32) / 4
    b[:, :, Q - 1] = b[:, :, Q // 2]
    b[:, T - 1] = b[:, T // 2]
    b[0] = -0.5
    b[0, :, Q // 3] = -0.0
    b[0, :, (2 * Q) // 3] = 0.0
    mask = rng.uniform(size=(P, T)) > 0.3
    mask[1] = False
    return torch.from_numpy(b), torch.from_numpy(mask)


def auction_case(name):
    """-> (benefit, person mask, max_iters) on the CPU, one of AUCTION_CASES:
    the shapes the auction kernel must take, each through the path it
    exercises (rows by TMA bulk copies; by plain loads where Q * 4 is not a
    multiple of 16; from device memory past 227 KB of shared memory, Q odd
    there too; T past one thread a person)."""
    from spe_tpu_torch.ops.auction import MAX_ITERS

    if name == "random_masks":
        rng = np.random.default_rng(9)
        mask = torch.from_numpy(rng.uniform(size=(8, 120)) > 0.4)
        mask[3] = False
        return auction_problems(8, 120, 300, seed=8)[0], mask, MAX_ITERS
    if name.startswith("ties"):
        args = (6, 40, 24, 1) if name == "ties_overfull" else (6, 12, 30, 0)
        return (*auction_ties(*args), MAX_ITERS)
    shape, seed = _AUCTION_PROBLEMS[name]
    return (*auction_problems(*shape, seed=seed),
            3 if name == "cap3" else MAX_ITERS)


# auction_problems' (P, T, Q) and seed of each case drawn from it
_AUCTION_PROBLEMS = {
    "recipe": ((96, 120, 300), 0),
    "overfull": ((3, 120, 60), 1),
    "q301": ((8, 120, 301), 2),
    "q7": ((8, 40, 7), 3),
    "q1": ((8, 20, 1), 4),
    "t1100_smem": ((2, 1100, 8), 5),
    "t1030_device": ((2, 1030, 1100), 6),
    "device_memory": ((4, 120, 600), 7),
    "q301_device": ((2, 240, 301), 10),
    "cap3": ((96, 120, 300), 0),
}
AUCTION_CASES = (*_AUCTION_PROBLEMS, "random_masks", "ties", "ties_overfull")


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


def _backbone_params(gen, device, D=192, H=4):
    """The patch block's and the class-attention block's parameters (H
    heads, MLP 4D), LayerScale gammas near 1."""
    param, linear, norm = _makers(gen, device, D)
    blk = {}
    norm(blk, "norm1")
    linear(blk, "attn.qkv", D, 3 * D)
    linear(blk, "attn.proj_l", H, H)
    linear(blk, "attn.proj_w", H, H)
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
                rates=RECIPE_RATES, rate=TRANSFORMER_RATE, D=192, H=4):
    """[(name, module, args, cotangents)] of the fused layers in training
    at the voc0712 widths (or a wider backbone's D and heads H; the
    transformer's 8 heads of D / 8): the patch block with the recipe's dropout rates
    and a seed tensor on `device`; the class-attention block; the encoder
    layer and the decoder layer (layer 0 and a later layer) at the recipe's
    `dropout` on every site, with a padded-key mask. bf16 activations and
    cotangents, plus a nonzero f32 cotangent on the class-attention
    probabilities."""
    gen = torch.Generator().manual_seed(seed + 1)
    blk, ca = _backbone_params(gen, device, D, H)

    def act(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen).to(dtype).to(device)

    def seed_of(v):
        return torch.tensor([v], dtype=torch.int32, device=device)

    x, cls = act(B, N, D), act(B, t, D)
    drop = CounterDropout(seed_of(20240611), *rates)
    dattn = 0.1 * act(B, H, t, t + N, dtype=torch.float32)
    cases = [("pallas_block", fused_block, (x, blk, H, drop), (act(B, N, D),)),
             ("pallas_ca_block", fused_ca_block, (cls, x, ca, H),
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


def kernel_cases(B=2, N=1024, t=21, S=2, Q=300, device="cuda", seed=0,
                 D=192, H=4):
    """[(name, replaces, fused fn, plain fn, args)] for the four fused
    layers (at the voc0712 widths, or a wider backbone's D and heads H;
    the transformer's 8 heads of D / 8); the decoder twice, with the
    layer-0 (ca_qpos_proj) and the later-layer parameter sets."""
    gen = torch.Generator().manual_seed(seed)

    def act(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16).to(device)

    blk, ca = _backbone_params(gen, device, D, H)
    enc, dec, dec_later = _transformer_params(gen, device, D)
    mask = _key_mask(B, N, device)
    x, pos, cls = act(B, N, D), act(B, N, D), act(B, t, D)
    tgt, qpos, sine = act(B, S * Q, D), act(B, S * Q, D), act(B, S * Q, D)
    return [
        ("pallas_block", "spe_tpu/ops/pallas_block.py:548",
         fused_block.fused_layer_scale_block,
         fused_block.layer_scale_block_reference, (x, blk, H)),
        ("pallas_ca_block", "spe_tpu/ops/pallas_ca_block.py:268",
         fused_ca_block.fused_class_attn_block,
         fused_ca_block.class_attn_block_reference, (cls, x, ca, H)),
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


# ---- the toolkit's two product kernels: gemm_kernel (kernels.gemm) and
# attn_kernel (kernels.attention), each against its plain version
# (kernels.gemm_reference, kernels.attention_reference) on the same inputs

def strided_like(meta, gen, device):
    """A random tensor laid out as meta = (dtype, storage elements,
    storage offset, shape, strides) describes: the same storage size,
    offset (so the same alignment), shape and strides."""
    dtype, numel, offset, shape, stride = meta
    if dtype in (torch.bool, torch.int32):
        raise TypeError(f"no random layout copy of {dtype}")
    base = torch.randn(numel, generator=gen).to(dtype).to(device)
    return base.as_strided(shape, stride, offset)


def tensor_meta(t):
    """The layout of t as strided_like takes it."""
    return (t.dtype, t.untyped_storage().nbytes() // t.element_size(),
            t.storage_offset(), tuple(t.shape), tuple(t.stride()))


def _span_meta(dtype, sizes, strides, offset=0):
    span = 1 + sum((n - 1) * s for n, s in zip(sizes, strides))
    return dtype, offset + span, offset, (span,), (1,)


def _mat(dtype, nb, R, C, layout, off=0, aligned=True):
    """meta and (s1, s2, s_row, s_col) of nb (R, C) matrices: layout "r"
    rows contiguous, "c" columns contiguous, "g" neither; rows padded to a
    multiple of 8 elements (aligned) or by an odd 3."""
    def pad(x):
        return (-x % 8) + 8 if aligned else 3
    if layout == "r":
        sr, sc, size = C + pad(C), 1, R * (C + pad(C))
    elif layout == "c":
        sr, sc, size = 1, R + pad(R), C * (R + pad(R))
    else:
        sr, sc, size = 2 * C + 3, 2, R * (2 * C + 3)
    st = (nb[1] * size if nb[0] > 1 else 0, size if nb[1] > 1 else 0, sr, sc)
    return _span_meta(dtype, (*nb, R, C), st, off), st


GEMM_SHAPES = [
    # label, M, N, K, nb, (A layout, dtype, offset, aligned), (B ...), C dtype, extras
    ("logit planes: A bf16 k-contiguous, B bf16 k-contiguous (q . k^T), "
     "K=24 padded, alpha", 100, 77, 24, (2, 3), ("r", "bf16", 0, True),
     ("c", "bf16", 0, True), "f32", dict(alpha=0.35)),
    ("dV: A bf16 m-contiguous plane, B f32 n-contiguous", 77, 24, 130, (2, 2),
     ("c", "bf16", 0, True), ("r", "f32", 0, True), "f32", {}),
    ("dQ: A bf16 k-contiguous, B bf16 n-contiguous, column groups", 65, 48,
     200, (2, 2), ("r", "bf16", 0, True), ("r", "bf16", 0, True), "f32",
     dict(col_group=24)),
    ("dK: A bf16 m-contiguous, B bf16 n-contiguous, alpha", 130, 48, 65,
     (2, 1), ("c", "bf16", 0, True), ("r", "bf16", 0, True), "f32",
     dict(alpha=0.2)),
    ("dX: A f32 rows, B bf16 rows, dropout epilogue", 150, 70, 96, (1, 1),
     ("r", "f32", 0, True), ("r", "bf16", 0, True), "f32",
     dict(drop=(2, 0.2), rows_per_sample=50)),
    ("dX: GELU' epilogue", 150, 70, 96, (1, 1), ("r", "f32", 0, True),
     ("r", "bf16", 0, True), "f32", dict(gelu=True)),
    ("dX: ReLU mask, accumulate into f32", 150, 70, 96, (1, 1),
     ("r", "bf16", 0, True), ("r", "bf16", 0, True), "f32",
     dict(relu=True, accumulate=True)),
    ("dW: A f32 m-contiguous, B bf16 rows, split over 3 row chunks (the "
     "last short)", 70, 40, 50, (3, 1), ("c", "f32", 0, True),
     ("r", "bf16", 0, True), "f32", dict(split=130)),
    ("large tile: A bf16 k-contiguous, B bf16 k-contiguous, bf16 C", 300,
     260, 96, (16, 1), ("r", "bf16", 0, True), ("c", "bf16", 0, True),
     "bf16", {}),
    ("large tile: A f32 m-contiguous, B bf16 n-contiguous, accumulate into "
     "bf16", 300, 260, 70, (2, 8), ("c", "f32", 0, True),
     ("r", "bf16", 0, True), "bf16", dict(accumulate=True)),
    ("misaligned: A bf16 at an odd offset and row stride (scalar loads), B "
     "bf16 8-byte aligned (vector loads)", 70, 90, 45, (1, 1),
     ("r", "bf16", 1, False), ("r", "bf16", 4, True), "f32", {}),
    ("no unit stride in A or B", 33, 21, 19, (2, 1), ("g", "f32", 0, True),
     ("g", "bf16", 0, True), "f32", {}),
    ("large tile, ragged: A f32 without unit stride, B bf16 k-contiguous at "
     "a 4-byte offset", 257, 129, 33, (8, 4), ("g", "f32", 0, True),
     ("c", "bf16", 2, False), "f32", dict(alpha=-1.5)),
    ("XS24's per-head logits: K = dt = 36 padded, alpha", 100, 77, 36,
     (2, 3), ("r", "bf16", 0, True), ("c", "bf16", 0, True), "f32",
     dict(alpha=36 ** -0.5)),
    ("XS24's dQ: N = 36, A bf16 k-contiguous, B bf16 n-contiguous", 65, 36,
     200, (2, 2), ("r", "bf16", 0, True), ("r", "bf16", 0, True), "f32", {}),
    ("M's dV: N = dt = 96, A bf16 m-contiguous plane, B f32", 77, 96, 130,
     (2, 2), ("c", "bf16", 0, True), ("r", "f32", 0, True), "f32", {}),
    ("split by TMA: A f32 m-contiguous (staged, rounded in shared memory), "
     "B bf16 rows, chunks of 128 (the last short)", 130, 72, 128, (3, 1),
     ("c", "f32", 0, True), ("r", "bf16", 0, True), "f32", dict(split=300)),
    ("split by TMA, both operands f32, chunks of 64", 96, 80, 64, (4, 1),
     ("c", "f32", 0, True), ("r", "f32", 0, True), "f32", dict(split=250)),
    ("K = 48 logits, the persistent grid (more large tiles than SMs), "
     "alpha", 300, 260, 48, (4, 4), ("r", "bf16", 0, True),
     ("c", "bf16", 0, True), "f32", dict(alpha=0.2)),
    ("B 8-byte but not 16-byte aligned (registers), A by TMA, persistent "
     "64 x 64 tiles", 70, 90, 40, (8, 16), ("r", "bf16", 0, True),
     ("r", "bf16", 4, True), "f32", {}),
    ("M48's dX widths: A f32 rows, B bf16 n-contiguous, K = 3072", 130, 768,
     3072, (1, 1), ("r", "f32", 0, True), ("r", "bf16", 0, True), "f32",
     dict(gelu=True)),
    ("the talking heads' folded logits: B shared across the heads (a z2 "
     "stride of 0), K = 192", 130, 100, 192, (2, 4), ("r", "bf16", 0, True),
     ("c", "bf16", 0, True), "f32", dict(b_shared=True)),
    ("their dQ: B shared across the heads, N = 192", 130, 192, 100, (2, 4),
     ("r", "bf16", 0, True), ("r", "bf16", 0, True), "f32",
     dict(b_shared=True)),
    ("M48's dW widths: M = 768, A f32 m-contiguous, B bf16 rows, a split "
     "over chunks of 192", 768, 64, 192, (2, 1), ("c", "f32", 0, True),
     ("r", "bf16", 0, True), "f32", dict(split=300)),
]


def gemm_kernel_cases(device="cuda", seed=0):
    """[(label, case)] of `kernels.gemm` over what the port asks of it:
    every operand layout (A k- or m-contiguous, B n- or k-contiguous, no
    unit stride, B shared across a batch dim), bf16 and f32 operands and
    outputs, ragged M, N and K (none a multiple of a tile), both tile
    shapes and both grids (one block a tile, persistent), every operand
    route (TMA, F32, REG: misaligned and strided views), the row-chunked
    split (by TMA and through registers), column groups, accumulate and
    every epilogue (alpha, dropout, GELU', ReLU). A case is what gemm_run
    takes."""
    gen = torch.Generator().manual_seed(seed + 3)
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    cases = []
    for label, M, N, K, nb, al, bl, cdt, ex in GEMM_SHAPES:
        ex = dict(ex)
        split = ex.pop("split", None)
        kw = dict(M=M, N=N, K=K, nb=nb)
        if split is None:
            a_meta, kw["a_str"] = _mat(dt[al[1]], nb, M, K, al[0], al[2], al[3])
            # B shared across the z2 entries (stride 0), or one for each
            b_nb = (nb[0], 1) if ex.pop("b_shared", False) else nb
            b_meta, kw["b_str"] = _mat(dt[bl[1]], b_nb, K, N, bl[0], bl[2],
                                       bl[3])
        else:   # the chunks of one (M, split) x (split, N) product
            a_meta, (_, _, sm, sk) = _mat(dt[al[1]], (1, 1), M, split, al[0],
                                          al[2], al[3])
            b_meta, (_, _, bk, bn) = _mat(dt[bl[1]], (1, 1), split, N, bl[0],
                                          bl[2], bl[3])
            kw.update(a_str=(K * sk, 0, sm, sk), b_str=(K * bk, 0, bk, bn),
                      split_k=split)
        grp = ex.pop("col_group", None)
        ldc = (grp or N) + 8
        plane = nb[0] * nb[1] * M * ldc
        kw["c_str"] = (nb[1] * M * ldc, M * ldc, ldc, 1)
        if grp:
            kw.update(col_group=grp, col_stride=plane)
        c_meta = _span_meta(dt[cdt], (N // (grp or N), plane), (plane, 1))
        case = dict(a=strided_like(a_meta, gen, device),
                    b=strided_like(b_meta, gen, device),
                    c=strided_like(c_meta, gen, device), kw=kw)
        if ex.pop("gelu", False) or ex.get("relu"):
            aux = torch.randn((M, N), generator=gen).to(device)
            kw["relu_aux" if ex.pop("relu", False) else "gelu_aux"] = aux
        if "drop" in ex:
            kw["seed"] = torch.tensor([20240613], dtype=torch.int32,
                                      device=device)
        kw.update(ex)
        cases.append((label, case))
    return cases


def storage_of(t):
    """The whole storage under t as a 1-d tensor of t's dtype."""
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(
        t.untyped_storage())


def clone_layout(t):
    """A copy of t's whole storage, viewed with t's shape, strides and
    offset."""
    return storage_of(t).clone().as_strided(t.shape, t.stride(),
                                            t.storage_offset())


def gemm_run(fn, case):
    """fn (kernels.gemm or kernels.gemm_reference) on the case's operands
    into a fresh copy of its c -> that copy."""
    c = clone_layout(case["c"])
    fn(case["a"], case["b"], c, **case["kw"])
    return c


def gemm_check(kernel, plain, case):
    """The kernel twice and the plain version on one case -> (max abs error
    over the written elements, tolerance: GRAD_REL_TOL of their largest
    plain magnitude, the two kernel runs bit-identical, the untouched
    elements equal, all finite)."""
    from spe_tpu_torch.ops.kernels import gemm_out_view

    got, again, want = (gemm_run(kernel, case), gemm_run(kernel, case),
                        gemm_run(plain, case))
    gv, wv = (gemm_out_view(t, **case["kw"]) for t in (got, want))
    rest_g, rest_w = clone_layout(got), clone_layout(want)
    gemm_out_view(rest_g, **case["kw"]).zero_()
    gemm_out_view(rest_w, **case["kw"]).zero_()
    return (max_err(gv, wv), grad_tol(wv),
            bool(torch.equal(storage_of(got), storage_of(again))),
            bool(torch.equal(storage_of(rest_g), storage_of(rest_w))),
            bool(torch.isfinite(gv.float()).all()))


def _unique_elems(sizes, strides):
    """Elements an operand of `sizes` addresses through `strides`, a batch
    dimension of stride 0 counted once."""
    return math.prod(n for n, s in zip(sizes, strides) if s or n == 1)


def gemm_bound_ms(case):
    """The least time of one gemm call: each operand element read once (in
    its dtype; a batch stride of 0 shares it), C written once (and read
    with accumulate, the activation's aux read) against 2 M N K per batch
    entry at the bf16 tensor rate."""
    kw = case["kw"]
    M, N, K = kw["M"], kw["N"], kw["K"]
    nb1, nb2 = kw.get("nb", (1, 1))
    depth = kw.get("split_k")
    a, b, c = case["a"], case["b"], case["c"]
    if depth is None:
        na = _unique_elems((nb1, nb2, M, K), kw["a_str"])
        nbe = _unique_elems((nb1, nb2, K, N), kw["b_str"])
        flops = 2 * nb1 * nb2 * M * N * K
    else:
        na, nbe, flops = M * depth, depth * N, 2 * M * N * depth
    nc = nb1 * nb2 * M * N * (2 if kw.get("accumulate") else 1)
    aux = kw.get("gelu_aux", kw.get("relu_aux"))
    io = (na * a.element_size() + nbe * b.element_size() + nc * c.element_size()
          + (aux.numel() * 4 if aux is not None else 0))
    return bound_ms(io, [(flops, BF16_TENSOR_OPS_PER_MS)])


def gemm_library(case):
    """-> a call of torch.matmul on the case's operands as gathered bf16
    contiguous (nb1 * nb2, M, K) and (., K, N) tensors (for a split, the
    chunks as the batch): the library's time for the same product, timed
    beside the kernel and never called by the port."""
    kw = case["kw"]
    M, N, K = kw["M"], kw["N"], kw["K"]
    nb1, nb2 = kw.get("nb", (1, 1))
    a, b = case["a"], case["b"]
    depth = kw.get("split_k")
    if depth is None:
        A = a.as_strided((nb1, nb2, M, K), kw["a_str"], a.storage_offset())
        B = b.as_strided((nb1, nb2, K, N), kw["b_str"], b.storage_offset())
    else:   # zero-pad the short last chunk to a whole one
        A = a.as_strided((M, depth), kw["a_str"][2:], a.storage_offset())
        B = b.as_strided((depth, N), kw["b_str"][2:], b.storage_offset())
        A = torch.nn.functional.pad(A, (0, nb1 * K - depth)).reshape(
            M, nb1, K).transpose(0, 1)
        B = torch.nn.functional.pad(B, (0, 0, 0, nb1 * K - depth)).reshape(
            nb1, K, N)
    A = A.to(torch.bfloat16).reshape(-1, M, K).contiguous()
    B = B.to(torch.bfloat16).reshape(-1, K, N).contiguous()
    return lambda: torch.matmul(A, B)


def attention_kernel_cases(device="cuda", seed=0):
    """[(label, case)] of `kernels.attention` on ragged shapes (Nq and Nk
    not multiples of the 64-row tiles, a one-key last tile) for each of
    its four head-width templates: every option (qscale, key and head
    biases, dropout with mask_heads, probabilities, log-sum-exps, f32
    output, heads shared by a stride of 0) and K/V views whose alignment
    asks for each copy width (16, 8 and 4 bytes by cp.async, 2 by plain
    loads; the width each case should get is its "copy_bytes"). A case is
    what attention_run takes."""
    gen = torch.Generator().manual_seed(seed + 4)

    def act(B, N, cols, off=0, ld=None):
        ld = ld or cols
        meta = (torch.bfloat16, off + B * N * ld, off, (B, N, cols),
                (N * ld, ld, 1))
        return strided_like(meta, gen, device)

    def f32(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen).to(device)

    seed_t = torch.tensor([20240614], dtype=torch.int32, device=device)
    cases = []

    def add(label, B, H, Nq, Nk, dq, dv, *, q_hs=None, kv_hs=None, koff=0,
            kld=None, out_f32=False, probs=False, lse=False, drop=None,
            mask_heads=None, qscale=False, kbias=True, hbias=False, cw=16):
        q_hs = dq if q_hs is None else q_hs
        kv_hs = (dq, dv) if kv_hs is None else kv_hs
        qc = dq + (H - 1) * q_hs
        kc, vc = dq + (H - 1) * kv_hs[0], dv + (H - 1) * kv_hs[1]
        kw = dict(num_heads=H, dq=dq, dv=dv, q_hs=q_hs, k_hs=kv_hs[0],
                  v_hs=kv_hs[1], o_hs=dv, logit_scale=dq ** -0.5)
        if qscale:
            kw["qscale"] = 1.0 + 0.1 * f32(H, dq)
        if kbias:
            kb = 0.5 * f32(B, Nk)
            kb[-1, Nk - Nk // 10:] = -1e9
            kw["kbias"] = kb
        if hbias:
            kw["hbias"] = f32(H)
        if drop:
            kw.update(drop=drop, seed=seed_t, mask_heads=mask_heads)
        cases.append((label, dict(
            q=act(B, Nq, qc), k=act(B, Nk, kc, koff, kld),
            v=act(B, Nk, vc, koff, kld and kld + vc - kc), kw=kw,
            out=((B, Nq, H * dv), torch.float32 if out_f32 else torch.bfloat16),
            probs=probs, lse=lse, copy_bytes=cw)))

    add("24 x 24 (encoder): dropout, log-sum-exps", 2, 3, 100, 130, 24, 24,
        drop=(10, 0.1), lse=True)
    add("48 x 24 (cross-attention): q/k heads twice v's, dropout keyed by "
        "mask_heads", 2, 2, 70, 129, 48, 24, drop=(7, 0.1), mask_heads=1,
        lse=True)
    add("48 x 48 (class attention): qscale, probabilities", 2, 4, 21, 150,
        48, 48, qscale=True, probs=True)
    add("192 x 192 (talking heads, wl-fold): q, k, v shared by head stride "
        "0, qscale per head, head bias, f32 output", 2, 4, 90, 65, 192, 192,
        q_hs=0, kv_hs=(0, 0), qscale=True, hbias=True, out_f32=True)
    add("192 x 192: dropout, probabilities, log-sum-exps, one-key last tile",
        1, 2, 70, 65, 192, 192, drop=(1, 0.1), probs=True, lse=True,
        hbias=True)
    add("24 x 24, K/V at a 4-byte offset (8-byte copies)", 2, 2, 65, 100,
        24, 24, koff=4, kld=52, cw=8)
    add("24 x 24, K/V at a 2-element offset (4-byte copies)", 2, 2, 65, 100,
        24, 24, koff=2, kld=50, cw=4)
    add("48 x 24, K/V at an odd offset and row stride (plain loads)", 2, 2,
        33, 90, 48, 24, koff=1, kld=99, cw=2)
    # the wider backbones' forms (dt = 36, 48, 96): V padded to 40 in
    # shared memory at dv = 36, whose 72-byte rows take 8-byte copies
    add("36 x 36 (XS24 encoder): dropout, log-sum-exps", 2, 3, 100, 130, 36,
        36, drop=(10, 0.1), lse=True, cw=8)
    add("72 x 36 (XS24 cross-attention): dropout keyed by mask_heads", 2, 2,
        70, 129, 72, 36, drop=(7, 0.1), mask_heads=1, lse=True, cw=8)
    add("96 x 48 (S cross-attention): dropout keyed by mask_heads", 2, 2, 70,
        129, 96, 48, drop=(7, 0.1), mask_heads=1, lse=True)
    add("96 x 96 (M encoder): dropout, log-sum-exps", 2, 2, 100, 130, 96, 96,
        drop=(10, 0.1), lse=True)
    add("192 x 96 (M cross-attention): f32 output, one-key last tile", 2, 2,
        70, 65, 192, 96, out_f32=True)
    add("36 x 36, K/V at a 2-element offset (4-byte copies)", 2, 2, 65, 100,
        36, 36, koff=2, kld=74, cw=4)
    assert len(cases) == ATTENTION_KERNEL_CASES
    return cases


# the cases attention_kernel_cases makes (the card test's parametrisation)
ATTENTION_KERNEL_CASES = 14


def attention_args(case):
    """The case's (q, k, v, out) and keywords with fresh zeroed outputs ->
    (args, kw, {"out", and "probs", "lse" where asked})."""
    q, k, v, kw = case["q"], case["k"], case["v"], dict(case["kw"])
    B, Nq = q.shape[:2]
    Nk, H = k.shape[1], kw["num_heads"]
    outs = {"out": torch.zeros(case["out"][0], dtype=case["out"][1],
                               device=q.device)}
    if case["probs"]:
        outs["probs"] = kw["probs"] = torch.zeros((B, H, Nq, Nk),
                                                  device=q.device)
    if case["lse"]:
        outs["lse"] = kw["lse"] = torch.zeros((B, H, Nq), device=q.device)
    return (q, k, v, outs["out"]), kw, outs


def attention_run(fn, case):
    """fn (kernels.attention or kernels.attention_reference) on the case's
    inputs into fresh outputs -> {"out", and "probs", "lse" where asked}."""
    args, kw, outs = attention_args(case)
    fn(*args, **kw)
    return outs


def attention_check(kernel, plain, case):
    """The kernel twice and the plain version on one case -> ({output:
    (max abs error, tolerance)}: ULPS bf16 ulps at the largest plain
    magnitude, the probabilities PROBS_TOL; the two kernel runs
    bit-identical; all finite)."""
    got, again, want = (attention_run(kernel, case),
                        attention_run(kernel, case),
                        attention_run(plain, case))
    errs = {n: (max_err(got[n], want[n]),
                PROBS_TOL if n == "probs" else bf16_tol(want[n]))
            for n in want}
    same = all(torch.equal(got[n], again[n]) for n in got)
    finite = all(bool(torch.isfinite(t).all()) for t in got.values())
    return errs, same, finite


def attention_bound_case_ms(case):
    """The least time of one attention call: q, k, v (a head stride of 0
    read once), the biases and scales read, the output, probabilities and
    log-sum-exps written once, against 2 (dq + dv) per (sample, head,
    query, key) at the bf16 tensor rate and, with dropout, ~12 integer ops
    per pair for the keep bits."""
    q, k, v, kw = case["q"], case["k"], case["v"], case["kw"]
    B, Nq = q.shape[:2]
    Nk, H, dq, dv = k.shape[1], kw["num_heads"], kw["dq"], kw["dv"]
    pairs = B * H * Nq * Nk

    def heads(hs, d):
        return (H if hs else 1) * d

    io = 2 * (B * Nq * heads(kw["q_hs"], dq) + B * Nk * heads(kw["k_hs"], dq)
              + B * Nk * heads(kw["v_hs"], dv))
    io += B * Nq * H * dv * (4 if case["out"][1] == torch.float32 else 2)
    io += sum(_nbytes(kw[n]) for n in ("qscale", "kbias", "hbias")
              if kw.get(n) is not None)
    io += pairs * 4 * bool(case["probs"]) + B * H * Nq * 4 * bool(case["lse"])
    masks = 12 * pairs if kw.get("drop") else 0
    return bound_ms(io, [(2 * pairs * (dq + dv), BF16_TENSOR_OPS_PER_MS),
                         (masks, SCALAR_OPS_PER_MS)])


def attention_library(case):
    """-> scaled_dot_product_attention on the case's heads as contiguous
    (B, H, N, d) bf16 tensors (q pre-scaled by qscale), the key and head
    biases as a float mask, or None where no single PyTorch call computes
    the same function (probabilities, dropout): the library's time, timed
    beside the kernel and never called by the port."""
    import torch.nn.functional as F

    q, k, v, kw = case["q"], case["k"], case["v"], case["kw"]
    if case["probs"] or kw.get("drop"):
        return None
    B, Nq = q.shape[:2]
    Nk, H, dq, dv = k.shape[1], kw["num_heads"], kw["dq"], kw["dv"]

    def heads(t, hs, d):
        return t.as_strided((B, H, t.shape[1], d),
                            (t.stride(0), hs, t.stride(1), 1),
                            t.storage_offset()).contiguous()

    qh = heads(q, kw["q_hs"], dq)
    if kw.get("qscale") is not None:
        qh = (qh.float() * kw["qscale"][None, :, None, :]).to(q.dtype)
    kh, vh = heads(k, kw["k_hs"], dq), heads(v, kw["v_hs"], dv)
    bias = torch.zeros((B, H, 1, Nk), device=q.device)
    if kw.get("kbias") is not None:
        bias = bias + kw["kbias"][:, None, None, :]
    if kw.get("hbias") is not None:
        bias = bias + kw["hbias"][None, :, None, None]
    bias = bias.to(q.dtype).expand(B, H, Nq, Nk)
    scale = kw.get("logit_scale", 1.0)
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias,
                                                  scale=scale)


# ---- ln_linear (linear_kernel), th_bwd_rows (th_bwd_rows_kernel),
# th_fwd_rows (th_fwd_rows_kernel) and attention_bwd_rows
# (attn_bwd_rows_kernel), each against its plain version
# (kernels.<name>_reference) on the same inputs. A linear case is
# dict(a, w, kw, out, aux): out and aux are None or the layout (tensor_meta)
# of a preallocated output the call writes into.

LINEAR_SHAPES = [
    # label, M, N, K, (A dtype, row stride - K, storage offset), options
    ("LayerNorm, bf16 A, ragged M, N and K", 150, 70, 100, ("bf16", 4, 0),
     dict(ln=True)),
    ("LayerNorm, f32 A at an odd row stride and offset (scalar loads), "
     "GELU, aux before it, dropout", 130, 96, 76, ("f32", 3, 1),
     dict(ln=True, act="gelu", aux="pre", drop=(3, 0.2), rps=65)),
    ("a2 sum, bf16 A and a2 at an odd row stride", 70, 90, 60,
     ("bf16", 5, 0), dict(a2=True)),
    ("bf16 A at a 2-element offset (8-byte loads, registers), ReLU, "
     "dropout, aux after it", 200, 130, 72, ("bf16", 4, 2),
     dict(act="relu", drop=(3, 0.1), rps=50, aux="post")),
    ("f32 residual, gamma, DropPath, f32 out", 160, 192, 96, ("bf16", 8, 0),
     dict(res="f32", gamma=True, path=(5, 0.2), rps=40, out="f32")),
    ("bf16 residual, head-interleaved column store", 90, 48, 64,
     ("bf16", 0, 0), dict(res="bf16", col_group=12, col_stride=40)),
    ("large stream tile (128 x 128): 1550 x 1280 x 264, bf16 out", 1550,
     1280, 264, ("bf16", 8, 0), dict()),
    ("large stream tile, ragged N: 1550 x 1320 x 264, bf16 residual", 1550,
     1320, 264, ("bf16", 8, 0), dict(res="bf16")),
    ("small stream tile (64 x 64): bf16 A at an odd row stride, K=300",
     70, 90, 300, ("bf16", 3, 0), dict(act="gelu")),
    ("LayerNorm panel, several N tiles a block (8300 rows), K=24, GELU",
     8300, 700, 24, ("bf16", 8, 0), dict(ln=True, act="gelu")),
    ("f32 A panel, several N tiles a block, dropout, aux after it", 8300,
     650, 72, ("f32", 4, 0), dict(drop=(3, 0.1), rps=100, aux="post")),
    ("bf16 A by cp.async, several N tiles a block, K=256", 8300, 650, 256,
     ("bf16", 8, 0), dict(res="f32", out="f32")),
    ("deep panel (64 rows): LayerNorm over K=770, f32 A", 96, 80, 770,
     ("f32", 0, 0), dict(ln=True)),
    ("deep stream: K=2050 (W rows not 16-byte aligned: registers), f32 "
     "residual and out", 130, 70, 2050, ("bf16", 6, 0),
     dict(res="f32", out="f32")),
    ("odd N, misaligned out and residual rows (scalar epilogue)", 70, 37, 64,
     ("bf16", 0, 0), dict(res="f32", out="f32", pad=1)),
    ("K = 48, the panel by TMA", 300, 200, 48, ("bf16", 0, 0), dict()),
    ("M48's qkv: LayerNorm over K = 768, f32 A (the 64 x 128 panel)", 200,
     2304, 768, ("f32", 4, 0), dict(ln=True)),
    ("M48's fc1: LayerNorm, bf16 A, GELU, K = 768, N = 3072", 130, 3072,
     768, ("bf16", 8, 0), dict(ln=True, act="gelu")),
    ("M48's fc2: the stream at K = 3072, f32 residual and out", 130, 768,
     3072, ("bf16", 8, 0), dict(res="f32", out="f32")),
    ("a panel past K = 1024 (64 x 64 tiles): LayerNorm over K = 1400", 96,
     100, 1400, ("bf16", 8, 0), dict(ln=True)),
]


def _zeros_meta(meta, device):
    dtype, numel, offset, shape, stride = meta
    return torch.zeros(numel, dtype=dtype, device=device).as_strided(
        shape, stride, offset)


def linear_kernel_cases(device="cuda", seed=0):
    """[(label, case)] of `kernels.ln_linear` on ragged M, N and K (none a
    multiple of a tile), f32 and bf16 A at misaligned row strides and
    offsets, the three paths (K <= 256: the A panel by cp.async or built
    through registers and W's whole-K tiles, one and several N tiles a
    block, W by cp.async or through registers; a LayerNorm/f32 A deeper:
    the 64-row panel; a bf16 A deeper: the stream in both tiles) and every
    epilogue (bias, GELU,
    ReLU, dropout, aux before and after the activation, bf16 and f32
    residuals, gamma, DropPath, the column-group store, f32 out, scalar
    stores). A case is what linear_run takes."""
    gen = torch.Generator().manual_seed(seed + 6)
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}

    def f32(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(shape, generator=gen)).to(device)

    cases = []
    for label, M, N, K, (adt, pad, off), o in LINEAR_SHAPES:
        lda = K + pad
        meta = (dt[adt], off + M * lda, off, (M, K), (lda, 1))
        kw = dict(bias=f32(N))
        if o.get("a2"):
            kw["a2"] = strided_like(meta, gen, device)
        if o.get("ln"):
            kw["ln"] = (f32(K, scale=0.1, shift=1.0), f32(K, scale=0.1), 1e-6)
        if "act" in o:
            kw["act"] = o["act"]
        if "res" in o:
            ldr = N + o.get("pad", 0)
            kw["res"] = strided_like((dt[o["res"]], M * ldr, 0, (M, N),
                                      (ldr, 1)), gen, device)
        if o.get("gamma"):
            kw["gamma"] = f32(N, scale=0.5, shift=1.0)
        for k in ("drop", "path"):
            if k in o:
                kw[k] = o[k]
                kw["rows_per_sample"] = o["rps"]
                kw["seed"] = torch.tensor([20240615], dtype=torch.int32,
                                          device=device)
        out = None
        odt = dt[o.get("out", "bf16")]
        if "col_group" in o:
            grp, stride = o["col_group"], o["col_stride"]
            width = (N - 1) // grp * stride + (N - 1) % grp + 1
            ldo = width + (-width % 8)
            kw.update(col_group=grp, col_stride=stride)
            out = (odt, M * ldo, 0, (M, ldo), (ldo, 1))
        elif o.get("pad"):
            ldo = N + o["pad"]
            out = (odt, 1 + M * ldo, 1, (M, N), (ldo, 1))
        else:
            kw["out_dtype"] = odt
        aux = None
        if "aux" in o:
            aux = (torch.float32, M * N, 0, (M, N), (N, 1))
            kw["aux_pre"] = o["aux"] == "pre"
        w = (torch.randn((N, K), generator=gen) * K ** -0.5).to(
            torch.bfloat16).to(device)
        cases.append((label, dict(a=strided_like(meta, gen, device), w=w,
                                  kw=kw, out=out, aux=aux)))
    return cases


def linear_run(fn, case):
    """fn (kernels.ln_linear or ln_linear_reference) on the case's inputs
    into fresh zeroed outputs -> {"out": the whole out storage or the
    returned tensor, "aux"}."""
    kw = dict(case["kw"])
    dev = case["a"].device
    if case["out"] is not None:
        kw["out"] = _zeros_meta(case["out"], dev)
    if case["aux"] is not None:
        kw["aux"] = _zeros_meta(case["aux"], dev)
    y = fn(case["a"], case["w"], **kw)
    outs = {"out": storage_of(kw["out"]) if "out" in kw else y}
    if "aux" in kw:
        outs["aux"] = kw["aux"]
    return outs


def linear_check(kernel, plain, case):
    """The kernel twice and the plain version on one case -> ({output:
    (max abs error, tolerance ULPS bf16 ulps at its largest plain
    magnitude)}, the two kernel runs bit-identical, all finite)."""
    got, again, want = (linear_run(kernel, case), linear_run(kernel, case),
                        linear_run(plain, case))
    errs = {n: (max_err(got[n], want[n]), bf16_tol(want[n])) for n in want}
    same = all(torch.equal(got[n], again[n]) for n in got)
    finite = all(bool(torch.isfinite(t.float()).all()) for t in got.values())
    return errs, same, finite


def _linear_io(case):
    """-> (M, N, K, bytes each input read once and each output written
    once)."""
    a, w, kw = case["a"], case["w"], case["kw"]
    M, K = a.shape
    N = w.shape[0]
    io = M * K * (a.element_size() + (2 if kw.get("a2") is not None else 0))
    io += N * K * 2 + _nbytes(*(kw[n] for n in ("bias", "gamma")
                                if kw.get(n) is not None))
    if kw.get("ln") is not None:
        io += _nbytes(*kw["ln"][:2])
    if kw.get("res") is not None:
        io += M * N * kw["res"].element_size()
    odt = case["out"][0] if case["out"] is not None else kw.get(
        "out_dtype", torch.bfloat16)
    io += M * N * torch.empty((), dtype=odt).element_size()
    io += M * N * 4 * (case["aux"] is not None)
    return M, N, K, io


def linear_bound_ms(case):
    """The least time of one ln_linear call: its bytes (_linear_io) against
    2 M N K at the bf16 tensor rate and, at the f32 rate, ~12 integer ops
    per element for a dropout mask and ~10 per element for a GELU."""
    M, N, K, io = _linear_io(case)
    kw = case["kw"]
    drop = kw.get("drop")
    scalar = M * N * (12 * bool(drop and drop[1] > 0)
                      + 10 * (kw.get("act") == "gelu"))
    return bound_ms(io, [(2 * M * N * K, BF16_TENSOR_OPS_PER_MS),
                         (scalar, SCALAR_OPS_PER_MS)])


def linear_library(case):
    """-> torch.addmm(bias, A, W^T) on A after the LayerNorm and a2,
    pre-rounded to contiguous bf16, with bf16 out (torch.mm without a
    bias): the library's time for the same product, timed beside the
    kernel and never called by the port."""
    import torch.nn.functional as F

    a, w, kw = case["a"], case["w"], case["kw"]
    x = a.float()
    if kw.get("a2") is not None:
        x = x + kw["a2"].float()
    if kw.get("ln") is not None:
        g, b, eps = kw["ln"]
        x = F.layer_norm(x, (x.shape[-1],), g, b, eps)
    A = x.to(torch.bfloat16).contiguous()
    W = w.contiguous()
    if kw.get("bias") is None:
        return lambda: torch.mm(A, W.t())
    bias = kw["bias"].to(torch.bfloat16)
    return lambda: torch.addmm(bias, A, W.t())


# th_bwd_rows: (label, B, H, N, dropout rate, with wl)
TH_BWD_SHAPES = [
    ("H=4, N=130 (not a multiple of 4: scalar rows), dropout", 2, 4, 130,
     0.1, False),
    ("H=4, N=130, wl (the standalone attention), no dropout", 2, 4, 130, 0.0,
     True),
    ("H=4, N=1024 (a thread's 4 columns x 256), dropout, wl", 1, 4, 1024,
     0.05, True),
    ("H=3, N=77, dropout, wl", 2, 3, 77, 0.1, True),
    ("H=2, N=64, no dropout", 3, 2, 64, 0.0, False),
    ("the stock step's class: B=8, H=4, N=1024, dropout", 8, 4, 1024, 0.1,
     False),
    ("the standalone step's class: B=8, H=4, N=1024, wl, dropout", 8, 4,
     1024, 0.1, True),
    ("H=4, B*N=3000 (1000 blocks of 3 rows), wl", 3, 4, 1000, 0.0, True),
    ("H=1, B*N=120 (fewer blocks than threads: rows in order)", 3, 1, 40,
     0.0, False),
    ("H=1, N=33, wl, dropout", 2, 1, 33, 0.1, True),
    ("H=2, B*N=400, wl", 2, 2, 200, 0.0, True),
    ("H=8, B*N=288, dropout", 3, 8, 96, 0.1, False),
    ("H=8, B*N=128 (fewer blocks than threads), wl", 2, 8, 64, 0.0, True),
    ("H=8, B*N=1154 (577 blocks of 2 rows), wl, dropout", 2, 8, 577, 0.1,
     True),
    # the wider backbones' heads (XS24 6; M36/M48 16: csrc/th_h16.cu's
    # tensor-core kernels, 256-column chunks, a row's chunks twice) and
    # the multi-scale buckets' rows (two units of 4 columns a thread past
    # 1024 keys at H <= 8)
    ("H=6 (XS24), N=1024, dropout", 1, 6, 1024, 0.1, False),
    ("H=6, N=1024, wl, dropout", 1, 6, 1024, 0.1, True),
    ("H=16 (M36/M48), B=2, N=1024, dropout", 2, 16, 1024, 0.1, False),
    ("H=16, N=1024, wl, dropout", 1, 16, 1024, 0.1, True),
    ("H=16, N=130 (scalar rows, lanes past the row), wl", 2, 16, 130, 0.0,
     True),
    ("H=4, N=1280 (the 512 x 640 bucket), dropout", 2, 4, 1280, 0.1, False),
    ("H=4, N=1600 (the 640 x 640 bucket), wl, dropout", 1, 4, 1600, 0.1,
     True),
    ("H=4, N=2048, dropout", 1, 4, 2048, 0.1, False),
    ("H=8, N=1600, wl", 1, 8, 1600, 0.0, True),
    ("H=3, N=1025 (one key past a unit), dropout", 2, 3, 1025, 0.1, False),
    ("H=16, N=1281 (not a multiple of 4), dropout", 1, 16, 1281, 0.1, False),
    ("H=16, N=2048, wl, dropout", 1, 16, 2048, 0.1, True),
    ("H=16, B=2, N=1600 (the 640 x 640 bucket), wl, dropout", 2, 16, 1600,
     0.05, True),
    ("H=16, B*N=3 (fewer rows than blocks), N=3 (one chunk's edge)", 1, 16,
     3, 0.1, False),
]
# th_bwd_rows' classes on the main path, (B, H, N, with wl): the stock step
# (the patch blocks' wl-folded logits) and the standalone-attention step
TH_BWD_MAIN = [(8, 4, 1024, False), (8, 4, 1024, True)]


def th_bwd_case(B, H, N, rate, wl, device="cuda", seed=0, site=1):
    """th_bwd_rows' arguments at one shape: logits and dzd random, the
    mixes near the identity, lse consistent with the logits (from
    th_fwd_rows_reference) -> (args, kw)."""
    from spe_tpu_torch.ops.kernels import th_fwd_rows_reference

    # drawn where they are used: the 16-head planes at B = 8 hold 134M
    # values each
    gen = torch.Generator(device).manual_seed(seed + 7 + H * 1000 + N)

    def f32(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=device)

    eye = torch.eye(H, device=device)
    s = f32(B, H, N, N, scale=2.0)
    dzd = f32(B, H, N, N, scale=1e-3)
    ww, bw, bl = eye + f32(H, H, scale=0.2), f32(H, scale=0.1), f32(H)
    kw = dict(site=site)
    if wl:
        kw["wl"] = (eye + f32(H, H, scale=0.2)).contiguous()
    seed_t = torch.tensor([20240616], dtype=torch.int32, device=device)
    lse = th_fwd_rows_reference(s, bl, ww, bw, seed_t, rate, **kw)[0]
    return (s, lse.contiguous(), dzd, bl, ww.contiguous(), bw, seed_t,
            rate), kw


TH_BWD_NAMES = ("zd", "ds", "dww", "dbw", "dbl", "dwl")


def _rows_check(kernel, plain, args, kw, names, tol):
    """A row kernel twice and its plain version on one case -> ({output:
    (max abs error, tol(name, {name: plain output}))}, the two kernel runs
    bit-identical, all finite)."""
    got, again, want = (kernel(*args, **kw), kernel(*args, **kw),
                        plain(*args, **kw))
    ref = dict(zip(names, want))
    errs = {n: (max_err(g, w), tol(n, ref))
            for n, g, w in zip(names, got, want)}
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
    return errs, same, finite


def th_bwd_check(kernel, plain, args, kw):
    """The kernel twice and the plain version on one case -> ({output:
    (max abs error, tolerance GRAD_REL_TOL of its largest plain
    magnitude)}, the two kernel runs bit-identical, all finite). dbl is
    zero in exact arithmetic (a bias shared by a softmax row): held to the
    scale of the pre-softmax mix's gradient dwl, or without wl of dww."""
    def tol(n, ref):
        return grad_tol(ref.get("dwl", ref["dww"]) if n == "dbl" else ref[n])
    return _rows_check(kernel, plain, args, kw, TH_BWD_NAMES, tol)


def th_bwd_bound_ms(args, kw):
    """The least time of one th_bwd_rows call: s and dzd (f32) read, zd and
    ds (bf16) written, lse read: 12 bytes per plane element; against, per
    element at the f32 rate, the mixes (2 H ops each: z, dp, the
    parameter partials and with wl the logit mix, dL and dwl), ~4 for the
    exponential and ~12 for a dropout mask."""
    s, lse, rate = args[0], args[1], args[7]
    H = s.shape[1]
    wl = kw.get("wl") is not None
    io = s.numel() * (4 + 4 + 2 + 2) + lse.numel() * 4
    per = 2 * H * (3 + 3 * wl) + 4 + 12 * (rate > 0)
    return bound_ms(io, [(s.numel() * per, SCALAR_OPS_PER_MS)])


# th_fwd_rows: (label, B, H, N, dropout rate, with wl)
TH_FWD_SHAPES = [
    ("H=4, N=130 (not a multiple of 4: scalar rows), dropout", 2, 4, 130,
     0.1, False),
    ("H=3, N=77, wl, dropout", 2, 3, 77, 0.1, True),
    ("H=4, N=1024 (a thread's 4 columns x 256), dropout, wl", 1, 4, 1024,
     0.05, True),
    ("H=2, N=64, no dropout", 3, 2, 64, 0.0, False),
    ("H=6 (XS24), N=1024, dropout", 2, 6, 1024, 0.1, False),
    ("H=16 (M36/M48), N=1024, dropout", 2, 16, 1024, 0.1, False),
    ("H=16, N=1024, wl, dropout", 1, 16, 1024, 0.1, True),
    ("H=16, N=130 (scalar rows), wl", 2, 16, 130, 0.0, True),
    ("H=4, N=1280 (the 512 x 640 bucket), dropout", 2, 4, 1280, 0.1, False),
    ("H=4, N=1600 (the 640 x 640 bucket), wl", 1, 4, 1600, 0.0, True),
    ("H=6, N=1601 (not a multiple of 4), wl, dropout", 1, 6, 1601, 0.1,
     True),
    ("H=16, N=2048, dropout", 1, 16, 2048, 0.1, False),
    ("H=16, B=2, N=1600 (the 640 x 640 bucket), wl, dropout", 2, 16, 1600,
     0.05, True),
    ("H=16, N=3 (one chunk's edge), dropout", 1, 16, 3, 0.1, False),
]


def th_fwd_case(B, H, N, rate, wl, device="cuda", seed=0, site=1):
    """th_fwd_rows' arguments at one shape (th_bwd_case's logits and
    mixes) -> (args, kw)."""
    (s, _, _, bl, ww, bw, seed_t, _), kw = th_bwd_case(B, H, N, rate, wl,
                                                       device, seed, site)
    return (s, bl, ww, bw, seed_t, rate), kw


TH_FWD_NAMES = ("lse", "zd")
LSE_REL_TOL = 1e-5


def th_fwd_check(kernel, plain, args, kw):
    """The kernel twice and the plain version on one case -> ({output:
    (max abs error, tolerance)}, the two kernel runs bit-identical, all
    finite): zd within ULPS bf16 ulps of its largest plain magnitude, lse
    (f32 sums in another order) within LSE_REL_TOL of its largest."""
    def tol(n, ref):
        if n == "lse":
            return LSE_REL_TOL * float(ref["lse"].abs().max())
        return bf16_tol(ref["zd"])
    return _rows_check(kernel, plain, args, kw, TH_FWD_NAMES, tol)


def th_fwd_bound_ms(args, kw):
    """The least time of one th_fwd_rows call: s (f32) read, zd (bf16) and
    lse (f32) written: 6 bytes per plane element; against, per element at
    the f32 rate, the post-softmax mix (2 H ops; with wl the logit mix too),
    ~4 for each of the two exponentials, ~2 for the row max and sum and ~12
    for a dropout mask."""
    s, rate = args[0], args[5]
    B, H, N, _ = s.shape
    wl = kw.get("wl") is not None
    io = s.numel() * (4 + 2) + B * H * N * 4
    per = 2 * H * (1 + wl) + 8 + 2 + 12 * (rate > 0)
    return bound_ms(io, [(s.numel() * per, SCALAR_OPS_PER_MS)])


# attention_bwd_rows: (label, B, H, Nq, Nk, key bias, dropout rate,
# mask_heads or None)
ATTN_ROWS_SHAPES = [
    ("1024 x 1024 (the encoder), key bias, dropout", 1, 2, 1024, 1024, True,
     0.1, None),
    ("300 x 300 (the decoder self-attention), mask_heads 4 of 2 x 2 heads, "
     "dropout", 4, 2, 300, 300, False, 0.1, 4),
    ("600 x 1024 (the cross-attention), key bias, dropout", 1, 2, 600, 1024,
     True, 0.1, None),
    ("21 x 1045 (the class attention: scalar rows), dropout", 2, 4, 21, 1045,
     False, 0.05, None),
    ("ragged 7 x 33, key bias, no dropout", 2, 3, 7, 33, True, 0.0, None),
    ("9 x 2500 (4 warps a row), key bias, dropout", 2, 2, 9, 2500, True, 0.1,
     None),
]


def attn_rows_case(B, H, Nq, Nk, kbias, rate, mask_heads, device="cuda",
                   seed=0, site=10):
    """attention_bwd_rows' arguments at one shape: logits and dzd random,
    the last tenth of the last sample's keys masked (key bias -1e9), lse
    consistent with the logits -> (args, kw)."""
    from spe_tpu_torch.ops.refmath import key_bias

    gen = torch.Generator().manual_seed(seed + 11 + Nq * 7 + Nk)

    def f32(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(device)

    s = f32(B, H, Nq, Nk, scale=2.0)
    dzd = f32(B, H, Nq, Nk, scale=1e-3)
    kb = key_bias(_key_mask(B, Nk, "cpu"), B, Nk, device) if kbias else None
    lse = torch.logsumexp(s + (kb[:, None, None, :] if kbias else 0.0), -1)
    seed_t = torch.tensor([20240617], dtype=torch.int32, device=device)
    return ((s, dzd, lse.contiguous(), kb, seed_t, (site, rate)),
            dict(num_heads=H, mask_heads=mask_heads))


ATTN_ROWS_NAMES = ("zd", "dl")


def attn_rows_check(kernel, plain, args, kw):
    """The kernel twice and the plain version on one case -> ({output:
    (max abs error, tolerance GRAD_REL_TOL of its largest plain
    magnitude)}, the two kernel runs bit-identical, all finite)."""
    return _rows_check(kernel, plain, args, kw, ATTN_ROWS_NAMES,
                       lambda n, ref: grad_tol(ref[n]))


def attn_rows_bound_ms(args, kw):
    """The least time of one attention_bwd_rows call: s and dzd (f32) read,
    zd and dl (bf16) written, lse and the key bias read: 12 bytes per
    plane element; against, per element at the f32 rate, ~4 for the
    exponential, ~6 for the masked dp, the row sum and dl, and ~12 for a
    dropout mask."""
    s, lse, kb, drop = args[0], args[2], args[3], args[5]
    io = s.numel() * (4 + 4 + 2 + 2) + lse.numel() * 4
    if kb is not None:
        io += kb.numel() * 4
    per = 4 + 6 + 12 * (drop is not None and drop[1] > 0)
    return bound_ms(io, [(s.numel() * per, SCALAR_OPS_PER_MS)])


def bf16_rows(B, N, C, ld, offset, gen, device):
    """A (B, N, C) bf16 view of random values with row stride ld at
    storage offset `offset` (as qkv[..., a:b] of a (B, N, ld) tensor)."""
    base = torch.randn(offset + B * N * ld, generator=gen).to(torch.bfloat16)
    return base.to(device).as_strided((B, N, C), (N * ld, ld, 1), offset)


# colsum: (label, B, N, C, row stride, storage offset); the recipe's view is
# qkv[..., 2D:]
COLSUM_SHAPES = [
    ("the eval recipe: qkv[..., 2D:] of (16, 1024, 576)", 16, 1024, 192, 576,
     384),
    ("offset by one element (no 16-byte loads)", 2, 1024, 192, 576, 385),
    ("N=1", 3, 1, 192, 192, 0),
    ("B=1, N=1025 (not a multiple of the cluster's 8 blocks)", 1, 1025, 192,
     200, 0),
    ("C=13 (not a multiple of 8), N=1025", 4, 1025, 13, 16, 0),
    ("C=264 (two column strips), B=16", 16, 100, 264, 264, 0),
]
# f32 sums in any order of bf16 values: within this share of sum |v|
COLSUM_REL_TOL = 1e-5


def colsum_case(B, N, C, ld, offset=0, device="cuda", seed=0):
    """colsum's argument: bf16_rows at one shape."""
    gen = torch.Generator().manual_seed(seed + 31 * N + C)
    return bf16_rows(B, N, C, ld, offset, gen, device)


def colsum_err(got, want, v):
    """The largest |got - want| as a share of the column's sum |v|."""
    scale = v.float().abs().sum(1).clamp_min(1e-30)
    return float(((got.double() - want.double()).abs() / scale).max())


# th_fold: (label, B, H, N, D, row stride of q, storage offset); the stock
# step's q is qkv3[..., :D]
TH_FOLD_SHAPES = [
    ("the stock step: qkv3[..., :D] of (8, 1024, 576), H=4", 8, 4, 1024, 192,
     576, 0),
    ("offset by one element (no 16-byte loads)", 2, 4, 1024, 192, 576, 1),
    ("N=1, H=8, B=16", 16, 8, 1, 192, 192, 0),
    ("B=1, N=1025, H=1", 1, 1, 1025, 192, 200, 0),
    ("D=13 (not a multiple of 8), H=3", 3, 3, 50, 13, 13, 0),
    ("D=2056 (257 units of 8: more than a block's threads), H=2", 1, 2, 5,
     2056, 2056, 0),
    ("D=260 (scalar: 260 columns a row), H=4", 2, 4, 33, 260, 261, 0),
    ("XS24: qkv3[..., :D] of (2, 1024, 864), H=6", 2, 6, 1024, 288, 864, 0),
    ("M36/M48: qkv3[..., :D] of (2, 1024, 2304), H=16 (48 KB of rows)", 2,
     16, 1024, 768, 2304, 0),
]


def th_fold_case(B, H, N, D, ld, offset=0, device="cuda", seed=0):
    """th_fold's arguments: q = bf16_rows at one shape, rows (H, D) f32."""
    gen = torch.Generator().manual_seed(seed + 17 * N + D + H)
    q = bf16_rows(B, N, D, ld, offset, gen, device)
    rows = (1.0 + 0.5 * torch.randn((H, D), generator=gen)).to(device)
    return q, rows


# the card's SMs the plans are tested for (an H100 SXM: 132)
H100_SMS = 132

# colsum_f32 (bias gradients): the (M, C) classes one stock step gives it
# (chip_smoke's record: patch blocks and encoder at 8192 rows, decoder at
# 4800, class attention at 168 = 8 x 21 class tokens and 8360 = 8 x 1045)
COLSUM_F32_MAIN = [(8192, 192), (8192, 576), (8192, 768), (4800, 192),
                   (4800, 2048), (4800, 576), (168, 192), (8192, 2048),
                   (168, 768), (8360, 576)]
# (label, M, C, row stride, storage offset): every main class, then ragged
# and misaligned ones
COLSUM_F32_SHAPES = [(f"the main path's ({M}, {C})", M, C, C, 0)
                     for M, C in COLSUM_F32_MAIN] + [
    ("M = 1001 (not a multiple of the cluster's blocks), C = 200 (of the "
     "strip)", 1001, 200, 200, 0),
    ("M = 8, C = 13 (scalar path)", 8, 13, 13, 0),
    ("a view: row stride 301 (no 16-byte loads), offset 1", 333, 256, 301,
     1),
    ("a view: row stride 260, offset 4 (16-byte loads)", 2000, 100, 260, 4),
]


def colsum_f32_case(M, C, ld, offset=0, device="cuda", seed=0):
    """colsum_f32's argument: an (M, C) f32 view of random values with row
    stride ld at storage offset `offset`."""
    gen = torch.Generator().manual_seed(seed + 13 * M + C)
    base = torch.randn(offset + M * ld, generator=gen)
    return base.to(device).as_strided((M, C), (ld, 1), offset)


# ln_backward: the (M, D) classes one stock step gives it (the same record;
# every LayerNorm of the stock model is 192 wide), then those of the wider
# backbones' steps (the patch blocks, the decoder, the class attention)
LN_BWD_MAIN = [(8192, 192), (4800, 192), (168, 192), (8360, 192),
               (8192, 288), (8192, 384), (8192, 768), (4800, 768),
               (8360, 768)]
# (label, M, D, x bf16, with a residual, dx bf16): every main class with its
# types, then D = 256 and ragged ones
LN_BWD_SHAPES = [
    ("patch block norm2 (8192, 192): f32 x, residual", 8192, 192, False,
     True, False),
    ("patch block norm1 (8192, 192): bf16 x and dx, residual", 8192, 192,
     True, True, True),
    ("decoder (4800, 192): f32 x", 4800, 192, False, False, False),
    ("encoder (8192, 192): f32 x", 8192, 192, False, False, False),
    ("class attention norm2 (168, 192): f32 x, residual", 168, 192, False,
     True, False),
    ("class attention norm1 (8360, 192): bf16 x", 8360, 192, True, False,
     False),
    ("D = 256 (4800, 256): f32 x", 4800, 256, False, False, False),
    ("M = 1001 (not a multiple of the warps' runs), D = 256: bf16 x and dx, "
     "residual", 1001, 256, True, True, True),
    ("M = 9, D = 192: bf16 x, f32 dx", 9, 192, True, False, False),
    ("XS24 patch block norm1 (8192, 288): bf16 x and dx, residual", 8192,
     288, True, True, True),
    ("S24 patch block norm2 (8192, 384): f32 x, residual", 8192, 384, False,
     True, False),
    ("M48 patch block norm2 (8192, 768): f32 x, residual", 8192, 768, False,
     True, False),
    ("M48 patch block norm1 (8192, 768): bf16 x and dx, residual", 8192, 768,
     True, True, True),
    ("M = 1001, D = 288: f32 x", 1001, 288, False, False, False),
    ("M = 77, D = 768: bf16 x, f32 dx", 77, 768, True, False, False),
]


def ln_backward_case(M, D, x_bf16, res, dx_bf16, device="cuda", seed=0):
    """ln_backward's arguments at one shape -> (args, kw): dy small, x
    off-centre, the weight near 1, eps 1e-6, a residual if asked."""
    gen = torch.Generator().manual_seed(seed + 7 * M + D)

    def f32(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(shape, generator=gen)).to(device)

    dy = f32(M, D, scale=1e-2)
    x = f32(M, D, scale=2.0, shift=0.5)
    if x_bf16:
        x = x.to(torch.bfloat16)
    kw = dict(out_dtype=torch.bfloat16 if dx_bf16 else torch.float32)
    if res:
        kw["res"] = f32(M, D, scale=1e-2)
    return (dy, x, f32(D, scale=0.1, shift=1.0), 1e-6), kw


# branch_backward: the classes one stock step gives it (the patch blocks'
# two branches at (8192, 192) with val, gamma, dropout and DropPath; the
# class attention's at B * t = 168 rows with val and gamma; the encoder's
# and the decoder's dropout gradients at (8192, 192) and (4800, 192), 1024
# and 600 rows a sample) as (M, D, with val and gamma, dropout, DropPath,
# rows per sample)
BRANCH_BWD_MAIN = [(8192, 192, True, True, True, 1024),
                   (168, 192, True, False, False, 21),
                   (8192, 192, False, True, False, 1024),
                   (4800, 192, False, True, False, 600)]
# (label, M, D, with val and gamma, dropout, DropPath, rows per sample,
# storage offset of dres and val): every main class, then the widths of
# the other backbones, ragged and misaligned ones
BRANCH_BWD_SHAPES = [
    (f"the main path's ({M}, {D}){' with val' if v else ''}"
     f"{', dropout' if d else ''}{', DropPath' if p else ''}", M, D, v, d, p,
     rps, 0) for M, D, v, d, p, rps in BRANCH_BWD_MAIN] + [
    ("M = 3 rows, D = 192", 3, 192, True, True, True, 1, 0),
    ("M = 1001 (not a multiple of a block's run), D = 256", 1001, 256, True,
     True, True, 77, 0),
    ("XS24 width D = 288", 2 * 577, 288, True, True, True, 577, 0),
    ("S24/S36 width D = 384", 2 * 577, 384, True, True, True, 577, 0),
    ("M36/M48 width D = 768", 2 * 577, 768, True, True, True, 577, 0),
    ("D = 100, dropout only", 1000, 100, False, True, False, 10, 0),
    ("misaligned dres and val (scalar path), D = 192", 512, 192, True, True,
     True, 64, 1),
    ("D = 13 (scalar path)", 333, 13, True, True, False, 3, 0),
]
BRANCH_BWD_SITES = ((4, 0.05), (6, 0.2))   # (SITE_OUT, proj), (SITE_PATH2, path)


def branch_backward_case(M, D, val, drop, path, rps, offset=0, device="cuda",
                         seed=0):
    """branch_backward's arguments at one shape -> (args, kw): dres and val
    (M, D) f32, contiguous at storage offset `offset`, gamma near 1 (with
    val), the recipe's dropout and DropPath rates."""
    gen = torch.Generator().manual_seed(seed + 11 * M + D)

    def rows():
        base = torch.randn(offset + M * D, generator=gen).to(device)
        return base[offset:].view(M, D)

    dres = rows()
    v = rows() if val else None
    gamma = (1.0 + 0.1 * torch.randn(D, generator=gen)).to(device) \
        if val else None
    kw = dict(rows_per_sample=rps)
    if drop or path:
        kw["seed"] = torch.tensor([7 + seed], dtype=torch.int32, device=device)
    if drop:
        kw["drop"] = BRANCH_BWD_SITES[0]
    if path:
        kw["path"] = BRANCH_BWD_SITES[1]
    return (dres, v, gamma), kw


# th_dq: the class one stock step gives it (B=8, 4 heads, 1024 patches,
# D=192; q and dQ the first D columns of the (B, N, 3D) qkv and dqkv)
TH_DQ_MAIN = [(8, 4, 1024, 192)]
# (label, B, H, N, D, q row stride, out row stride, q offset, out offset)
TH_DQ_SHAPES = [
    (f"the main path's ({B}, {H}, {N}, {D}), views of qkv and dqkv", B, H, N,
     D, 3 * D, 3 * D, 0, 0) for B, H, N, D in TH_DQ_MAIN] + [
    ("M36/M48: H = 16, D = 768, views of qkv and dqkv", 2, 16, 100, 768,
     3 * 768, 3 * 768, 0, 0),
    ("XS24: H = 6, D = 288", 2, 6, 77, 288, 3 * 288, 3 * 288, 0, 0),
    ("S24/S36: H = 8, D = 384", 2, 8, 65, 384, 3 * 384, 3 * 384, 0, 0),
    ("3 rows", 1, 4, 3, 192, 192, 192, 0, 0),
    ("misaligned views (scalar path)", 2, 4, 33, 192, 577, 579, 1, 3),
    ("dh = 10 (chunks of one column)", 2, 3, 17, 30, 30, 30, 0, 0),
    ("D = 1100 in one head (two passes of 256 chunks)", 1, 1, 5, 1100, 1100,
     1100, 0, 0),
]


def th_dq_case(B, H, N, D, q_ld, o_ld, q_off=0, o_off=0, device="cuda",
               seed=0):
    """th_dq's arguments at one shape: dqt (B, H, N, D) f32, q a (B, N, D)
    bf16 view with row stride q_ld at offset q_off, rows (H, D) f32 near
    1, the scale dh^-0.5 and out a (B, N, D) f32 view (row stride o_ld,
    offset o_off) of a NaN-filled storage."""
    gen = torch.Generator().manual_seed(seed + 5 * B + 3 * H + N + D)
    dqt = torch.randn((B, H, N, D), generator=gen).to(device)
    qs = torch.randn(q_off + B * N * q_ld, generator=gen).to(torch.bfloat16)
    q = qs.to(device).as_strided((B, N, D), (N * q_ld, q_ld, 1), q_off)
    rows = (1.0 + 0.1 * torch.randn((H, D), generator=gen)).to(device)
    out = torch.full((o_off + B * N * o_ld,), float("nan"), device=device)
    out = out.as_strided((B, N, D), (N * o_ld, o_ld, 1), o_off)
    return dqt, q, rows, (D // H) ** -0.5, out


# layernorm: the classes the three recorded runs give it (chip_smoke's
# record, B=8) as (M, D, x bf16, f32 out, bf16 out, eps): the patch blocks'
# backward recompute of h1 (bf16 x) and h2 (f32 x), the class attention's
# (8 x 1045 and 8 x 21 rows), the encoder's two (8192 rows) and the
# decoder's (4800 rows) in the stock step; the encoder's and decoder's at
# eval (16 images with flip: 16384 and 9600 rows)
LAYERNORM_MAIN = [(8192, 192, True, False, True, 1e-6),
                  (8192, 192, False, False, True, 1e-6),
                  (8360, 192, True, False, True, 1e-6),
                  (168, 192, False, False, True, 1e-6),
                  (8192, 192, False, True, False, 1e-5),
                  (8192, 192, False, False, True, 1e-5),
                  (4800, 192, False, True, False, 1e-5),
                  (4800, 192, False, False, True, 1e-5),
                  (16384, 192, False, True, False, 1e-5),
                  (16384, 192, False, False, True, 1e-5),
                  (9600, 192, False, True, False, 1e-5),
                  (9600, 192, False, False, True, 1e-5)]
# (label, M, D, x bf16, f32 out, bf16 out, eps, row stride, storage
# offset): every main class, then the other backbones' widths, ragged rows
# and widths, strided and misaligned views, every output combination
LAYERNORM_SHAPES = [
    (f"the main path's ({M}, {D}) {'bf16' if xb else 'f32'} x"
     f"{', f32 out' if o32 else ''}{', bf16 out' if o16 else ''}, eps {e}",
     M, D, xb, o32, o16, e, D, 0)
    for M, D, xb, o32, o16, e in LAYERNORM_MAIN] + [
    ("D = 256, both outputs", 4800, 256, False, True, True, 1e-5, 256, 0),
    ("XS24 width D = 288, bf16 x, both outputs", 1154, 288, True, True, True,
     1e-6, 288, 0),
    ("S24/S36 width D = 384", 1154, 384, False, False, True, 1e-6, 384, 0),
    ("M36/M48 width D = 768, bf16 x, both outputs", 1154, 768, True, True,
     True, 1e-6, 768, 0),
    ("M = 3 rows (fewer than a warp has in flight)", 3, 192, True, True, True,
     1e-6, 192, 0),
    ("M = 1001 (not a multiple of a warp's run)", 1001, 192, False, True,
     True, 1e-5, 192, 0),
    ("a view: row stride 577, offset 1 (scalar loads), bf16 x", 333, 192,
     True, True, True, 1e-6, 577, 1),
    ("a view: row stride 260, offset 4 (16-byte loads), f32 x", 2000, 192,
     False, True, True, 1e-5, 260, 4),
    ("D = 13 (scalar loads and stores)", 257, 13, False, True, True, 1e-5, 13,
     0),
    ("D = 100 (a partial chunk row), bf16 x", 100, 100, True, True, False,
     1e-6, 100, 0),
    ("D = 700, stride 701 (scalar loads), f32 x", 50, 700, False, True, True,
     1e-5, 701, 0),
]


def layernorm_case(M, D, x_bf16, want_f32, want_bf16, eps, ld, offset=0,
                   device="cuda", seed=0):
    """layernorm's arguments at one shape -> (args, kw): x an (M, D) view
    of off-centre random rows with row stride ld at storage offset
    `offset`, the weight near 1, the bias small."""
    gen = torch.Generator().manual_seed(seed + 19 * M + D)
    base = 0.5 + 2.0 * torch.randn(offset + M * ld, generator=gen)
    if x_bf16:
        base = base.to(torch.bfloat16)
    x = base.to(device).as_strided((M, D), (ld, 1), offset)
    w = (1.0 + 0.1 * torch.randn(D, generator=gen)).to(device)
    b = (0.1 * torch.randn(D, generator=gen)).to(device)
    return (x, w, b, eps), dict(want_f32=want_f32, want_bf16=want_bf16)


def layernorm_kernel_cases(device="cuda", seed=0):
    """[(label, (args, kw))] of `kernels.layernorm` over LAYERNORM_SHAPES."""
    return [(label, layernorm_case(*shape, device=device, seed=seed))
            for label, *shape in LAYERNORM_SHAPES]


# th_mix: the class the eval forward gives it (16 images with flip, 1024
# patches, 4 heads of 48: pv (16, 1024, 4, 192)) as (B, N, H, D)
TH_MIX_MAIN = [(16, 1024, 4, 192)]
# (label, B, N, H, D): the main class, the other backbones' widths (dh =
# 48), heads up to 16, samples that end inside a thread's run
TH_MIX_SHAPES = [
    (f"the main path's ({B}, {N}, {H}, {D})", B, N, H, D)
    for B, N, H, D in TH_MIX_MAIN] + [
    ("XS24: H = 6, D = 288", 2, 100, 6, 288),
    ("S24/S36: H = 8, D = 384", 2, 100, 8, 384),
    ("M36/M48: H = 16, D = 768", 2, 100, 16, 768),
    ("H = 12, D = 576 (12 of 16 register heads)", 2, 37, 12, 576),
    ("H = 3, dh = 8", 3, 50, 3, 24),
    ("H = 1, B = 16, N = 1", 16, 1, 1, 192),
    ("B = 600, N = 7 (samples end inside a thread's run of rows)", 600, 7,
     4, 192),
]


def th_mix_case(B, N, H, D, device="cuda", seed=0):
    """th_mix's arguments at one shape: pv (B, N, H, D) f32, column sums
    (B, D) of N-row magnitude, ww (H, H) and bw (H,) random."""
    gen = torch.Generator().manual_seed(seed + 23 * B + 7 * N + 3 * H + D)
    pv = torch.randn((B, N, H, D), generator=gen).to(device)
    csum = (N ** 0.5 * torch.randn((B, D), generator=gen)).to(device)
    ww = torch.randn((H, H), generator=gen).to(device)
    bw = (0.1 * torch.randn(H, generator=gen)).to(device)
    return pv, csum, ww, bw


def th_mix_kernel_cases(device="cuda", seed=0):
    """[(label, args)] of `kernels.th_mix` over TH_MIX_SHAPES."""
    return [(label, th_mix_case(*shape, device=device, seed=seed))
            for label, *shape in TH_MIX_SHAPES]
