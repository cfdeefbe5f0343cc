"""Build, load and call the port's hand-written CUDA kernels.

The sources are `spe_tpu_torch/csrc/*.cu`, plain C entry points compiled
with nvcc for `sm_90a` into one shared library and loaded with ctypes. The
library is built at first use into `build/spe_tpu_torch/` at the root of
the checkout (listed in .gitignore): one nvcc per source, all started
together, then one link. Its file name carries a hash of the sources, so an
edited source is never served by a stale build.

Nothing here runs at import time: the CPU tests import every module of the
package, and no nvcc or card is needed until a wrapper is called on a CUDA
tensor.

Every wrapper checks device, dtype, shape and strides and raises on what the
kernel does not take; it allocates its outputs with torch.empty, launches on
torch.cuda.current_stream() and raises if the launch reports an error.

Every wrapper of one kernel has its plain PyTorch version beside it,
`<name>_reference`: the same arguments, the same values returned or
written (the supervision kernels' stand in ops/connected_components.py and
ops/auction.py, the dropout masks' is refmath.counter_keep). Nothing on the
card's main path calls them; they are the CPU tests' emulations of the
kernels and the kernels' oracle on the card. The tensor-core product
kernels, `ln_linear` (linear_kernel), `gemm` (gemm_kernel) and `attention`
(attn_kernel), the row passes over the (B, H, N, N) planes,
`th_fwd_rows`, `th_bwd_rows` and `attention_bwd_rows`, `layernorm`, `th_mix`
and `reduce_sum` count their launches (`.launches`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from spe_tpu_torch.ops.refmath import (SITE_ATTN, counter_keep,
                                       gelu_tanh_grad, keep_scale,
                                       keep_threshold, path_keep)
from spe_tpu_torch.ops.refmath import \
    ln_backward_reference as ln_backward_rows

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "spe_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libspe_kernels_{h.hexdigest()[:16]}.so"


def _run(procs):
    """Wait for every (cmd, Popen) and raise with the output of a failure
    -> the seconds each took, from the first's start to its end."""
    t0, seconds, failed = time.perf_counter(), [], []
    pending = list(procs)
    while pending:
        for cmd, proc in list(pending):
            if proc.poll() is None:
                continue
            out, err = proc.communicate()
            seconds.append((cmd, time.perf_counter() - t0))
            pending.remove((cmd, proc))
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}\n{err}")
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return seconds


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is built already:
    every source compiles in its own nvcc process, all at once (the seconds
    each took in `build.seconds`)."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        nvcc = _nvcc()
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
            objs.append(obj)
        build.seconds = {Path(cmd[-1]).name: t for cmd, t in _run(procs)}
        out = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", out, *objs]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
        os.replace(out, so)  # atomic: a concurrent build never reads half a file
    return so


build.seconds = {}


class _LinearParams(ctypes.Structure):
    _fields_ = [("a", ctypes.c_void_p), ("a2", ctypes.c_void_p),
                ("ln_g", ctypes.c_void_p), ("ln_b", ctypes.c_void_p),
                ("w", ctypes.c_void_p), ("bias", ctypes.c_void_p),
                ("res", ctypes.c_void_p), ("gamma", ctypes.c_void_p),
                ("out", ctypes.c_void_p),
                ("M", ctypes.c_longlong), ("N", ctypes.c_longlong),
                ("K", ctypes.c_longlong), ("lda", ctypes.c_longlong),
                ("ldr", ctypes.c_longlong), ("ldo", ctypes.c_longlong),
                ("a_f32", ctypes.c_int), ("res_f32", ctypes.c_int),
                ("out_f32", ctypes.c_int), ("act", ctypes.c_int),
                ("ln_eps", ctypes.c_float),
                ("ogrp", ctypes.c_int), ("ogstride", ctypes.c_int),
                ("seed", ctypes.c_void_p), ("aux", ctypes.c_void_p),
                ("ldaux", ctypes.c_longlong), ("rps", ctypes.c_longlong),
                ("drop_site", ctypes.c_int), ("drop_thr", ctypes.c_uint),
                ("drop_scale", ctypes.c_float), ("path_site", ctypes.c_int),
                ("path_thr", ctypes.c_uint), ("path_scale", ctypes.c_float),
                ("aux_pre", ctypes.c_int), ("tile", ctypes.c_int),
                ("route_a", ctypes.c_int), ("route_w", ctypes.c_int)]


class _AttnParams(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("q", "k", "v", "qscale", "kbias", "hbias", "out", "probs")]
                + [(n, ctypes.c_longlong) for n in
                   ("q_sb", "q_sn", "q_sh", "k_sb", "k_sn", "k_sh",
                    "v_sb", "v_sn", "v_sh", "o_sb", "o_sn", "o_sh", "kb_sb")]
                + [(n, ctypes.c_int) for n in ("B", "H", "Nq", "Nk")]
                + [("logit_scale", ctypes.c_float), ("out_f32", ctypes.c_int),
                   ("seed", ctypes.c_void_p), ("lse", ctypes.c_void_p),
                   ("drop_site", ctypes.c_int), ("drop_thr", ctypes.c_uint),
                   ("drop_scale", ctypes.c_float),
                   ("mask_heads", ctypes.c_int), ("head0", ctypes.c_int)])


class _LNParams(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("b", ctypes.c_void_p), ("out_f32", ctypes.c_void_p),
                ("out_bf16", ctypes.c_void_p),
                ("M", ctypes.c_longlong), ("ldx", ctypes.c_longlong),
                ("D", ctypes.c_int), ("x_f32", ctypes.c_int),
                ("eps", ctypes.c_float), ("vec", ctypes.c_int),
                ("blocks", ctypes.c_int), ("run", ctypes.c_int)]


class _ColsumParams(ctypes.Structure):
    _fields_ = [("v", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("sb", ctypes.c_longlong), ("sn", ctypes.c_longlong),
                ("B", ctypes.c_int), ("N", ctypes.c_int), ("C", ctypes.c_int)]


class _MixParams(ctypes.Structure):
    _fields_ = [("pv", ctypes.c_void_p), ("colsum", ctypes.c_void_p),
                ("ww", ctypes.c_void_p), ("bw", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("rows", ctypes.c_longlong),
                ("N", ctypes.c_int), ("H", ctypes.c_int), ("D", ctypes.c_int),
                ("blocks", ctypes.c_int), ("run", ctypes.c_int)]


class _CCParams(ctypes.Structure):
    _fields_ = [("masks", ctypes.c_void_p), ("labels", ctypes.c_void_p),
                ("sweeps", ctypes.c_void_p), ("N", ctypes.c_int),
                ("S", ctypes.c_int), ("max_sweeps", ctypes.c_int)]


class _AuctionParams(ctypes.Structure):
    _fields_ = [("benefit", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("assigned", ctypes.c_void_p), ("iters", ctypes.c_void_p),
                ("bids", ctypes.c_void_p), ("P", ctypes.c_int),
                ("T", ctypes.c_int), ("Q", ctypes.c_int),
                ("max_iters", ctypes.c_int), ("eps", ctypes.c_float)]


def _struct(*groups):
    """ctypes fields from (ctype, names) groups, in the C struct's order."""
    return [(n, ct) for ct, names in groups for n in names.split()]


_P, _LL, _I, _U, _FL = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_uint, ctypes.c_float)


class _GemmParams(ctypes.Structure):
    _fields_ = _struct(
        (_P, "a b c act_aux seed"),
        (_LL, "a_s1 a_s2 a_sm a_sk b_s1 b_s2 b_sk b_sn c_s1 c_s2 c_sm c_sn "
              "ld_aux rps kmax"),
        (_I, "M N K nb1 nb2 a_f32 b_f32 c_f32 split"), (_FL, "alpha"),
        (_I, "drop_site"), (_U, "drop_thr"), (_FL, "drop_scale"),
        (_I, "act_grad cgrp"), (_LL, "cgstride"),
        (_I, "accumulate tile route_a route_b"))


class _ReduceParams(ctypes.Structure):
    _fields_ = _struct((_P, "parts out"), (_LL, "L"), (_I, "Z round_bf16"))


class _ColsumF32Params(ctypes.Structure):
    _fields_ = _struct((_P, "x out"), (_LL, "M ld run"),
                       (_I, "C strip cluster vec"))


class _LNBwdParams(ctypes.Structure):
    _fields_ = _struct((_P, "dy x g res dx dwb ws ticket"),
                       (_LL, "M ld_dy ld_x ld_res run"),
                       (_I, "D x_f32 dx_f32 blocks cluster ws_rows"),
                       (_FL, "eps"))


class _BranchBwdParams(ctypes.Structure):
    _fields_ = _struct((_P, "dres val gamma seed d dgamma"),
                       (_LL, "M rps run"),
                       (_I, "D strip cluster vec drop_site"), (_U, "drop_thr"),
                       (_FL, "drop_scale"), (_I, "path_site"),
                       (_U, "path_thr"), (_FL, "path_scale"))


class _MaskParams(ctypes.Structure):
    _fields_ = _struct((_P, "seed out"), (_I, "B H R C site path"),
                       (_U, "thr"))


class _THFoldParams(ctypes.Structure):
    _fields_ = _struct((_P, "q rows out"), (_LL, "q_sb q_sn"),
                       (_I, "B H N D"))


class _THRowParams(ctypes.Structure):
    _fields_ = _struct((_P, "s dzd lse bl ww bw seed zd ds ws"),
                       (_I, "B H N drop"), (_U, "thr"), (_FL, "scale"),
                       (_P, "wl"), (_I, "site"), (_P, "ticket sums"),
                       (_LL, "ws_size"))


class _THDqParams(ctypes.Structure):
    _fields_ = _struct((_P, "dqt q rows dq dwl ws ticket"),
                       (_LL, "q_sb q_sn o_sb o_sn run ws_size"),
                       (_I, "B H N D group vec"), (_FL, "scale"))


class _SoftmaxBwdParams(ctypes.Structure):
    _fields_ = _struct((_P, "p dp dattn dl"), (_LL, "R"), (_I, "C"))


class _AttnRowParams(ctypes.Structure):
    _fields_ = _struct((_P, "s dzd lse kbias seed zd dl"), (_LL, "kb_sb"),
                       (_I, "Z H Nq Nk drop_site"), (_U, "drop_thr"),
                       (_FL, "drop_scale"), (_I, "mask_heads head0"))


def lib():
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(build()))
        for name, struct in (("spe_linear", _LinearParams),
                             ("spe_layernorm", _LNParams),
                             ("spe_colsum", _ColsumParams),
                             ("spe_th_mix", _MixParams),
                             ("spe_connected_components", _CCParams),
                             ("spe_auction", _AuctionParams),
                             ("spe_gemm", _GemmParams),
                             ("spe_reduce", _ReduceParams),
                             ("spe_colsum_f32", _ColsumF32Params),
                             ("spe_ln_backward", _LNBwdParams),
                             ("spe_branch_backward", _BranchBwdParams),
                             ("spe_dropout_mask", _MaskParams),
                             ("spe_th_fold", _THFoldParams),
                             ("spe_th_dq", _THDqParams),
                             ("spe_softmax_backward", _SoftmaxBwdParams),
                             ("spe_attn_bwd_rows", _AttnRowParams)):
            fn = getattr(so, name)
            fn.argtypes = [ctypes.POINTER(struct), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        so.spe_ln_backward_wave.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_int)]
        so.spe_ln_backward_wave.restype = ctypes.c_int
        so.spe_layernorm_wave.argtypes = [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]
        so.spe_layernorm_wave.restype = ctypes.c_int
        so.spe_th_mix_wave.argtypes = [ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
        so.spe_th_mix_wave.restype = ctypes.c_int
        so.spe_attention_copy_bytes.argtypes = [ctypes.POINTER(_AttnParams),
                                                ctypes.c_int, ctypes.c_int]
        so.spe_attention_copy_bytes.restype = ctypes.c_int
        for name, struct in (("spe_attention", _AttnParams),
                             ("spe_th_rows", _THRowParams)):
            fn = getattr(so, name)
            extra = [ctypes.c_int] * (2 if name == "spe_attention" else 1)
            fn.argtypes = [ctypes.POINTER(struct), *extra, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = so
    return _lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _need(t, dtype, name, ndim=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if t.dim() and t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in its last dim")


_BF16, _F32 = torch.bfloat16, torch.float32
ACTS = {"none": 0, "gelu": 1, "relu": 2}


def _site(spec):
    """(site, rate) or None -> the kernels' (site, threshold, scale); a rate
    of 0 switches the site off."""
    if spec is None or spec[1] == 0.0:
        return 0, 0, 1.0
    site, rate = spec
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    return int(site), keep_threshold(rate), keep_scale(rate)


def _need_seed(seed, used, rows_per_sample=1, M=1):
    if not used:
        return
    if seed is None:
        raise ValueError("a dropout site needs the seed tensor")
    _need(seed, torch.int32, "seed", 1)
    if seed.numel() != 1:
        raise ValueError("seed must hold one value")
    if rows_per_sample <= 0 or M % rows_per_sample:
        raise ValueError(f"{M} rows are not whole samples of {rows_per_sample}")


def as_bf16(t):
    """A weight as the kernels read it: bf16, contiguous."""
    return t.to(_BF16).contiguous()


def as_f32(t):
    """A LayerNorm/bias/scale parameter as the kernels read it."""
    return t.to(_F32).contiguous()


# ---- the product kernels' plans (csrc/wgmma.cuh, grad.cu, linear.cu) ----
# How each operand reaches the shared ring, chosen from shapes and strides
# before the launch (the C entry points refuse a TMA route that TMA's rule
# does not allow): TMA (a bf16 operand), F32 (an f32 operand by TMA into a
# staging tile, rounded to bf16 in shared memory), REG (anything else:
# through the producer warpgroup's registers).
ROUTE_TMA, ROUTE_F32, ROUTE_REG = 0, 1, 2
TMA_MAX_STRIDE = 1 << 40
# gemm_kernel's tiles; linear_kernel's (csrc/linear.cu LinearTile)
GEMM_LARGE, GEMM_SMALL = 0, 1
STREAM_128, STREAM_64, PANEL_128, PANEL_64_128, PANEL_64 = range(5)
WHOLE_KMAX = 256          # the deepest 128-row panel
PANEL_WIDE_KMAX = 1024    # the deepest 64 x 128 panel tile


def tma_ok(addr, es, strides):
    """TMA's rule for a tensor map of `es`-byte elements: a 16-byte
    aligned base address and, for each listed stride (in elements),
    a positive multiple of 16 bytes below 2^40."""
    if addr % 16:
        return False
    for st in strides:
        b = st * es
        if b <= 0 or b % 16 or b >= TMA_MAX_STRIDE:
            return False
    return True


def _operand_route(addr, f32, cont, row, k_stride, s1, s2, nb, K, split):
    """One gemm operand's route: unit stride along its contiguous index,
    TMA's rule over its row stride and the strides of its batch dims of
    more than one entry (one of stride 0, the operand shared across it, is
    left out of the map; a split product: chunks adjacent along k and a
    multiple of 64 deep, one map over the whole depth). Plain arithmetic:
    it runs on every call of `gemm`."""
    es = 4 if f32 else 2
    if cont != 1 or addr % 16 or not 0 < row * es < TMA_MAX_STRIDE \
            or row * es % 16:
        return ROUTE_REG
    if split:
        if nb[1] != 1 or K % 64 or s1 != K * k_stride:
            return ROUTE_REG
    else:
        for st, n in ((s2, nb[1]), (s1, nb[0])):
            if n > 1 and st and (st < 0 or st * es % 16
                                 or st * es >= TMA_MAX_STRIDE):
                return ROUTE_REG
    return ROUTE_F32 if f32 else ROUTE_TMA


def gemm_plan(M, N, K, nb, a_addr, a_f32, a_str, b_addr, b_f32, b_str,
              split, n_sm):
    """gemm_kernel's (tile, route of A, route of B): the 128 x 128 tile
    where M and N exceed 64 and its grid fills every SM, else 64 x 64; A
    is K-major unless m-contiguous, B K-major unless n-contiguous."""
    large = -(-M // 128) * -(-N // 128) * nb[0] * nb[1]
    tile = GEMM_LARGE if M > 64 and N > 64 and large >= n_sm else GEMM_SMALL
    s1, s2, sm, sk = a_str
    a_km = not (sm == 1 and sk != 1)
    ra = _operand_route(a_addr, a_f32, sk if a_km else sm, sm if a_km else sk,
                        sk, s1, s2, nb, K, split)
    s1, s2, sk, sn = b_str
    b_km = sn != 1
    rb = _operand_route(b_addr, b_f32, sk if b_km else sn, sn if b_km else sk,
                        sk, s1, s2, nb, K, split)
    return tile, ra, rb


def linear_plan(M, N, K, plain, a_addr, lda, w_addr, n_sm):
    """linear_kernel's (tile, route of A, route of W). K <= WHOLE_KMAX or a
    transformed A (plain False: a LayerNorm, a2 or f32 rows): the panel,
    to WHOLE_KMAX 128 x 128 (64 x 64 for N <= 384 or M <= 1024), then
    64 x 128 to PANEL_WIDE_KMAX, 64 x 64 to PANEL_KMAX; a plain bf16 A
    deeper: the stream, 128 x 128 where M and N exceed 64 and the grid
    fills every SM, else 64 x 64. A by TMA where it is plain and TMA's
    rule holds (the panel's boxes, or the ring's), W (N, K) contiguous
    likewise."""
    if K <= WHOLE_KMAX:   # 64 x 64 for the narrow and the short products
        tile = PANEL_64 if N <= 384 or M <= 1024 else PANEL_128
    elif not plain:
        tile = PANEL_64_128 if K <= PANEL_WIDE_KMAX else PANEL_64
    elif M > 64 and N > 64 and -(-M // 128) * -(-N // 128) >= n_sm:
        tile = STREAM_128
    else:
        tile = STREAM_64
    ra = ROUTE_TMA if plain and tma_ok(a_addr, 2, (lda,)) else ROUTE_REG
    rw = ROUTE_TMA if tma_ok(w_addr, 2, (K,)) else ROUTE_REG
    return tile, ra, rw


def ln_linear(a, w, bias=None, *, ln=None, a2=None, act="none", res=None,
              gamma=None, out_dtype=_BF16, out=None, col_group=None,
              col_stride=None, seed=None, drop=None, path=None,
              rows_per_sample=1, aux=None, aux_pre=False):
    """Y = drop(act(LN?(a [+ a2]) @ w.T + bias)), then `res + dp * gamma * Y`.

    a: (M, K) bf16 or f32 rows (any row stride); a2: optional bf16 of a's
    layout, added in f32 before the bf16 rounding; ln: optional
    (weight, bias, eps) LayerNorm over K applied to the input rows;
    w: (N, K) bf16 contiguous (torch Linear layout); bias/gamma: f32 (N,);
    res: optional (M, N) bf16 or f32. out: optional preallocated (M, *)
    view; with col_group/col_stride output column n lands in column
    (n // col_group) * col_stride + n % col_group of `out` (the
    head-interleaved store of the conditional cross-attention).
    The training form: seed (1,) int32 on the card; drop = (site, rate)
    masks Y, path = (site, rate) scales the residual branch by each
    sample's DropPath factor dp, samples being runs of rows_per_sample
    rows; aux: optional (M, N) f32 receiving Y before the activation
    (aux_pre) or after the dropout. A LayerNorm, a2 or f32 A is built
    into a shared-memory panel of whole rows: K <= PANEL_KMAX."""
    _need(a, (_BF16, _F32), "a", 2)
    _need(w, _BF16, "w", 2)
    M, K = a.shape
    N = w.shape[0]
    if w.shape[1] != K or not w.is_contiguous():
        raise ValueError(f"w {tuple(w.shape)} does not match a {tuple(a.shape)}")
    if a2 is not None:
        _need(a2, _BF16, "a2", 2)
        if a.dtype != _BF16 or a2.shape != a.shape or a2.stride() != a.stride():
            raise ValueError("a2 must be bf16 with a's shape and strides")
    for t, n in ((bias, "bias"), (gamma, "gamma")):
        if t is not None:
            _need(t, _F32, n, 1)
            if t.shape[0] != N:
                raise ValueError(f"{n} must have {N} entries")
    if ln is not None:
        g, b, eps = ln
        _need(g, _F32, "ln weight", 1)
        _need(b, _F32, "ln bias", 1)
        if g.shape[0] != K or b.shape[0] != K:
            raise ValueError("LayerNorm params must have K entries")
    if res is not None:
        _need(res, (_BF16, _F32), "res", 2)
        if tuple(res.shape) != (M, N):
            raise ValueError(f"res must be {(M, N)}, got {tuple(res.shape)}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}")
    if (ln is not None or a2 is not None or a.dtype == _F32) and \
            K > PANEL_KMAX:
        raise ValueError(f"a LayerNorm, a2 or f32 A takes K <= {PANEL_KMAX}, "
                         f"got {K}")
    if col_group is None:
        col_group, col_stride = N, N
    if out is None:
        out = torch.empty((M, N), device=a.device, dtype=out_dtype)
    _need(out, (_BF16, _F32), "out", 2)
    width = (N - 1) // col_group * col_stride + (N - 1) % col_group + 1
    if out.shape[0] != M or out.shape[1] < width:
        raise ValueError(f"out {tuple(out.shape)} cannot hold {M} x {width}")
    if aux is not None:
        _need(aux, _F32, "aux", 2)
        if tuple(aux.shape) != (M, N):
            raise ValueError(f"aux must be {(M, N)}, got {tuple(aux.shape)}")
    if path is not None and res is None:
        raise ValueError("DropPath scales the residual branch: pass res")
    dsite, dthr, dscale = _site(drop)
    psite, pthr, pscale = _site(path)
    _need_seed(seed, dsite or psite, rows_per_sample, M)
    tile, ra, rw = linear_plan(
        M, N, K, ln is None and a2 is None and a.dtype == _BF16, a.data_ptr(),
        a.stride(0), w.data_ptr(), sm_count(a.device))
    p = _LinearParams(
        a=a.data_ptr(), a2=_ptr(a2), ln_g=_ptr(ln[0]) if ln else None,
        ln_b=_ptr(ln[1]) if ln else None, w=w.data_ptr(), bias=_ptr(bias),
        res=_ptr(res), gamma=_ptr(gamma), out=out.data_ptr(),
        M=M, N=N, K=K, lda=a.stride(0),
        ldr=res.stride(0) if res is not None else 0, ldo=out.stride(0),
        a_f32=int(a.dtype == _F32),
        res_f32=int(res is not None and res.dtype == _F32),
        out_f32=int(out.dtype == _F32), act=ACTS[act],
        ln_eps=float(ln[2]) if ln else 0.0,
        ogrp=col_group, ogstride=col_stride, seed=_ptr(seed), aux=_ptr(aux),
        ldaux=aux.stride(0) if aux is not None else 0, rps=rows_per_sample,
        drop_site=dsite, drop_thr=dthr, drop_scale=dscale, path_site=psite,
        path_thr=pthr, path_scale=pscale, aux_pre=int(aux_pre), tile=tile,
        route_a=ra, route_w=rw)
    _check(lib().spe_linear(ctypes.byref(p), _stream()), "spe_linear")
    ln_linear.launches += 1
    return out


ln_linear.launches = 0
PANEL_KMAX = 1472   # csrc/linear.cu: the deepest A panel


def _path_factor(seed, path, M, rows_per_sample):
    """(M, 1) DropPath factors of path = (site, rate), samples of
    rows_per_sample rows."""
    keep = path_keep(seed, path[0], path[1], M // rows_per_sample)
    return torch.where(keep, keep_scale(path[1]), 0.0).repeat_interleave(
        rows_per_sample)[:, None]


def ln_linear_reference(a, w, bias=None, *, ln=None, a2=None, act="none",
                        res=None, gamma=None, out_dtype=_BF16, out=None,
                        col_group=None, col_stride=None, seed=None, drop=None,
                        path=None, rows_per_sample=1, aux=None,
                        aux_pre=False):
    """Plain PyTorch version of `ln_linear` (same arguments, same elements
    of out and aux written): A (+ a2) in f32, the LayerNorm, A rounded to
    bf16 once, the product with W in f32, then the epilogue in the
    kernel's order, the output rounded once."""
    x = a.float() + (a2.float() if a2 is not None else 0.0)
    if ln is not None:
        x = F.layer_norm(x, (x.shape[-1],), ln[0], ln[1], ln[2])
    y = x.to(_BF16).float() @ w.float().T
    if bias is not None:
        y = y + bias
    if aux is not None and aux_pre:
        aux.copy_(y)
    y = {"none": y, "gelu": F.gelu(y, approximate="tanh"),
         "relu": torch.relu(y)}[act]
    M, N = y.shape
    if drop is not None and drop[1] > 0:
        y = torch.where(row_keep(seed, drop, M, N, rows_per_sample),
                        y * keep_scale(drop[1]), 0.0)
    if aux is not None and not aux_pre:
        aux.copy_(y)
    if res is not None:
        dp = 1.0
        if path is not None and path[1] > 0:
            dp = _path_factor(seed, path, M, rows_per_sample)
        y = res.float() + dp * (gamma if gamma is not None else 1.0) * y
    if out is None:
        out = torch.empty((M, N), device=a.device, dtype=out_dtype)
    grp, stride = (col_group, col_stride) if col_group else (N, N)
    n = torch.arange(N, device=a.device)
    out[:, n // grp * stride + n % grp] = y.to(out.dtype)
    return out


# the dq x dv forms spe_attention is built for (csrc/attention.cu): the XXS
# patch blocks' wl-fold over all of D, the class attention, and at dt = D /
# 8 of each backbone (24 XXS, 36 XS, 48 S, 96 M) the encoder and decoder
# self-attention (dt x dt) and the conditional cross-attention (2dt x dt)
ATTENTION_FORMS = ((192, 192), (48, 48), (24, 24), (48, 24), (36, 36),
                   (72, 36), (96, 48), (96, 96), (192, 96))


def attention(q, k, v, out, *, num_heads, dq, dv, q_hs, k_hs, v_hs, o_hs,
              qscale=None, kbias=None, hbias=None, logit_scale=1.0,
              probs=None, seed=None, drop=None, mask_heads=None, lse=None,
              head0=0):
    """Online-softmax attention. q/k/v/out are (B, rows, cols) views, last dim
    contiguous; head h of each starts at column h * <x>_hs (0 = shared by
    every head) and is dq (q, k) or dv (v, out) wide. qscale: (H, dq) f32,
    q <- bf16(q * qscale[h]); kbias: (B, Nk) f32; hbias: (H,) f32;
    probs: optional (B, H, Nq, Nk) f32 output of the normalised
    probabilities. The training form: drop = (site, rate) masks the
    probabilities with keep bits keyed (seed, site, z // mask_heads,
    head0 + z % mask_heads, row, key) for z = b * H + h (mask_heads
    defaults to H; head0, 0 by default, is the first head's index in the
    keys: a shard of heads under tensor parallelism keys them as the
    unsharded call does); lse: optional (B, H, Nq) f32 output of each
    row's log-sum-exp."""
    p = _attn_params(q, k, v, out, num_heads=num_heads, dq=dq, dv=dv,
                     q_hs=q_hs, k_hs=k_hs, v_hs=v_hs, o_hs=o_hs,
                     qscale=qscale, kbias=kbias, hbias=hbias,
                     logit_scale=logit_scale, probs=probs, seed=seed,
                     drop=drop, mask_heads=mask_heads, lse=lse, head0=head0)
    err = lib().spe_attention(ctypes.byref(p), dq, dv, _stream())
    _check(err, f"spe_attention(dq={dq}, dv={dv})")
    attention.launches += 1
    return out


attention.launches = 0


def attention_copy_bytes(*args, **kw):
    """The bytes of each K/V copy into shared memory that the kernel picks
    for `attention(*args, **kw)`: 16 where every K and V row start is
    16-byte aligned, else 8 or 4 (narrower cp.async), else 2 (plain
    loads); at most 8 for a head width that is not a multiple of 8."""
    return lib().spe_attention_copy_bytes(
        ctypes.byref(_attn_params(*args, **kw)), kw["dq"], kw["dv"])


def _attn_params(q, k, v, out, *, num_heads, dq, dv, q_hs, k_hs, v_hs, o_hs,
                 qscale=None, kbias=None, hbias=None, logit_scale=1.0,
                 probs=None, seed=None, drop=None, mask_heads=None, lse=None,
                 head0=0):
    """`attention`'s checks -> its _AttnParams."""
    for t, n in ((q, "q"), (k, "k"), (v, "v")):
        _need(t, _BF16, n, 3)
    _need(out, (_BF16, _F32), "out", 3)
    B, Nq = q.shape[:2]
    Nk = k.shape[1]
    if k.shape[0] != B or v.shape[0] != B or v.shape[1] != Nk or \
            tuple(out.shape[:2]) != (B, Nq):
        raise ValueError("q/k/v/out batch or row counts disagree")
    H = num_heads
    for t, hs, d, n in ((q, q_hs, dq, "q"), (k, k_hs, dq, "k"),
                        (v, v_hs, dv, "v"), (out, o_hs, dv, "out")):
        if (H - 1) * hs + d > t.shape[2]:
            raise ValueError(f"{n}: {H} heads of width {d} at stride {hs} "
                             f"overrun {t.shape[2]} columns")
    if qscale is not None:
        _need(qscale, _F32, "qscale", 2)
        if tuple(qscale.shape) != (H, dq) or not qscale.is_contiguous():
            raise ValueError(f"qscale must be ({H}, {dq}) contiguous")
    if kbias is not None:
        _need(kbias, _F32, "kbias", 2)
        if tuple(kbias.shape) != (B, Nk):
            raise ValueError(f"kbias must be ({B}, {Nk})")
    if hbias is not None:
        _need(hbias, _F32, "hbias", 1)
        if hbias.shape[0] != H:
            raise ValueError(f"hbias must have {H} entries")
    if probs is not None:
        _need(probs, _F32, "probs", 4)
        if tuple(probs.shape) != (B, H, Nq, Nk) or not probs.is_contiguous():
            raise ValueError(f"probs must be ({B}, {H}, {Nq}, {Nk}) contiguous")
    if lse is not None:
        _need(lse, _F32, "lse", 3)
        if tuple(lse.shape) != (B, H, Nq) or not lse.is_contiguous():
            raise ValueError(f"lse must be ({B}, {H}, {Nq}) contiguous")
    dsite, dthr, dscale = _site(drop)
    _need_seed(seed, dsite)
    mask_heads = H if mask_heads is None else mask_heads
    if dsite and (B * H) % mask_heads:
        raise ValueError(f"{B * H} (sample, head) pairs are not whole groups "
                         f"of mask_heads {mask_heads}")
    p = _AttnParams(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), qscale=_ptr(qscale),
        kbias=_ptr(kbias), hbias=_ptr(hbias), out=out.data_ptr(),
        probs=_ptr(probs),
        q_sb=q.stride(0), q_sn=q.stride(1), q_sh=q_hs,
        k_sb=k.stride(0), k_sn=k.stride(1), k_sh=k_hs,
        v_sb=v.stride(0), v_sn=v.stride(1), v_sh=v_hs,
        o_sb=out.stride(0), o_sn=out.stride(1), o_sh=o_hs,
        kb_sb=kbias.stride(0) if kbias is not None else 0,
        B=B, H=H, Nq=Nq, Nk=Nk, logit_scale=float(logit_scale),
        out_f32=int(out.dtype == _F32), seed=_ptr(seed), lse=_ptr(lse),
        drop_site=dsite, drop_thr=dthr, drop_scale=dscale,
        mask_heads=mask_heads, head0=int(head0))
    return p


def attention_keep(seed, drop, shape, mask_heads, head0=0):
    """The keep bits (B, H, Nq, Nk) of `attention`'s dropout: keyed (seed,
    site, z // mask_heads, head0 + z % mask_heads, row, key) for z = b * H
    + h."""
    Z = shape[0] * shape[1]
    return counter_keep(seed, drop[0], drop[1],
                        (Z // mask_heads, mask_heads, *shape[2:]),
                        head0).reshape(shape)


def attention_reference(q, k, v, out, *, num_heads, dq, dv, q_hs, k_hs, v_hs,
                        o_hs, qscale=None, kbias=None, hbias=None,
                        logit_scale=1.0, probs=None, seed=None, drop=None,
                        mask_heads=None, lse=None, head0=0):
    """Plain PyTorch version of `attention` (same arguments, same outputs
    written): f32 logits logit_scale * bf16(q [* qscale]) . k^T plus the
    key and head biases, the softmax (probs and lse taken from it), the
    dropout, the probabilities rounded to bf16 before the product with V
    in f32, as the kernel's PV operand is."""
    B, H = q.shape[0], num_heads

    def heads(t, hs, d):
        return t.as_strided((B, H, t.shape[1], d),
                            (t.stride(0), hs, t.stride(1), 1),
                            t.storage_offset())

    qh = heads(q, q_hs, dq).float()
    if qscale is not None:
        qh = (qh * qscale[None, :, None, :]).to(_BF16).float()
    s = qh @ heads(k, k_hs, dq).float().transpose(-1, -2) * logit_scale
    if kbias is not None:
        s = s + kbias[:, None, None, :]
    if hbias is not None:
        s = s + hbias[None, :, None, None]
    p = torch.softmax(s, dim=-1)
    if probs is not None:
        probs.copy_(p)
    if lse is not None:
        lse.copy_(torch.logsumexp(s, dim=-1))
    if drop is not None and drop[1] > 0:
        p = torch.where(attention_keep(seed, drop, p.shape, mask_heads or H,
                                       head0),
                        p * keep_scale(drop[1]), 0.0)
    o = p.to(_BF16).float() @ heads(v, v_hs, dv).float()
    heads(out, o_hs, dv).copy_(o.to(out.dtype))
    return out


# layernorm_kernel: blocks of LAYERNORM_NT threads, one warp a row, rows of
# at most LAYERNORM_MAX_D columns (csrc/rowops.cu: LN_MAX_NC chunks of 128)
LAYERNORM_NT = 256
LAYERNORM_MAX_D = 768


def _wave(key, device, query):
    """The blocks of one wave of a kernel variant on a CUDA device:
    query(byref(n)) asks the card's occupancy; cached by (device, key),
    key = (C entry point, variant...)."""
    index = _index(device)
    if (index, key) not in _WAVES:
        n = ctypes.c_int(0)
        with torch.cuda.device(index):
            _check(query(ctypes.byref(n)), key[0])
        if n.value < 1:
            raise RuntimeError(f"{key}: no block fits the card")
        _WAVES[(index, key)] = n.value
    return _WAVES[(index, key)]


_WAVES = {}


def layernorm_wave(device, D, x_f32, vec):
    """The blocks of one wave of the layernorm_kernel variant that runs at
    width D for an f32 (x_f32) or bf16 x, with whole-chunk accesses (vec)
    or scalar ones."""
    key = (D, int(x_f32), int(vec))
    return _wave(("spe_layernorm_wave", *key), device,
                 lambda n: lib().spe_layernorm_wave(*key, n))


def layernorm_plan(M, wave):
    """layernorm_kernel's grid for M rows -> (blocks, run): warp w of the
    grid (LAYERNORM_NT // 32 a block) takes rows [w * run, (w + 1) * run),
    in at most `wave` blocks (layernorm_wave: one wave)."""
    warps = LAYERNORM_NT // 32
    run = -(-M // (wave * warps))
    return -(-(-(-M // run)) // warps), run


def layernorm(x, weight, bias, eps, *, want_f32=True, want_bf16=False):
    """Row LayerNorm of (M, D) bf16/f32 rows (any row stride, D at most
    LAYERNORM_MAX_D) -> (f32 or None, bf16 or None). The statistics and
    normalisation are linear_kernel's panel's (csrc/common.cuh), so the bf16
    output equals ln_linear's LayerNorm prologue bit for bit."""
    _need(x, (_BF16, _F32), "x", 2)
    _need(weight, _F32, "weight", 1)
    _need(bias, _F32, "bias", 1)
    M, D = x.shape
    if D > LAYERNORM_MAX_D or M > 2 ** 31 - 1:
        raise ValueError(f"layernorm takes D <= {LAYERNORM_MAX_D} and fewer "
                         f"than 2^31 rows, got {tuple(x.shape)}")
    if weight.shape != (D,) or bias.shape != (D,):
        raise ValueError(f"layernorm weight and bias must be ({D},)")
    x_f32 = x.dtype == _F32
    es = x.element_size()
    vec = D % 4 == 0 and (x.data_ptr() | x.stride(0) * es) % (4 * es) == 0 \
        and (weight.data_ptr() | bias.data_ptr()) % 16 == 0
    blocks, run = layernorm_plan(M, layernorm_wave(x.device, D, x_f32, vec))
    o32 = torch.empty((M, D), device=x.device, dtype=_F32) if want_f32 else None
    o16 = torch.empty((M, D), device=x.device, dtype=_BF16) if want_bf16 else None
    p = _LNParams(x=x.data_ptr(), g=weight.data_ptr(), b=bias.data_ptr(),
                  out_f32=_ptr(o32), out_bf16=_ptr(o16), M=M, ldx=x.stride(0),
                  D=D, x_f32=int(x_f32), eps=float(eps), vec=int(vec),
                  blocks=blocks, run=run)
    _check(lib().spe_layernorm(ctypes.byref(p), _stream()), "spe_layernorm")
    layernorm.launches += 1
    return o32, o16


layernorm.launches = 0


def layernorm_reference(x, weight, bias, eps, *, want_f32=True,
                        want_bf16=False):
    """Plain PyTorch version of `layernorm` (F.layer_norm in f32)."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight, bias, eps)
    return (y if want_f32 else None), (y.to(_BF16) if want_bf16 else None)


# colsum_kernel's grid: a cluster of 8 blocks per sample on x, strips of at
# least 32 columns on y
COLSUM_MAX_B = (2 ** 31 - 1) // 8
COLSUM_MAX_C = 65535 * 32


def colsum(v):
    """(B, N, C) bf16 view -> (B, C) f32 column sums over N, summed in a
    fixed order (two calls give the same bits)."""
    _need(v, _BF16, "v", 3)
    B, N, C = v.shape
    if B > COLSUM_MAX_B or C > COLSUM_MAX_C:
        raise ValueError(f"colsum takes at most {COLSUM_MAX_B} samples of "
                         f"{COLSUM_MAX_C} columns, got {tuple(v.shape)}")
    out = torch.empty((B, C), device=v.device, dtype=_F32)
    p = _ColsumParams(v=v.data_ptr(), out=out.data_ptr(), sb=v.stride(0),
                      sn=v.stride(1), B=B, N=N, C=C)
    _check(lib().spe_colsum(ctypes.byref(p), _stream()), "spe_colsum")
    return out


def colsum_reference(v):
    """Plain PyTorch version of `colsum`."""
    return v.float().sum(1)


# th_mix_kernel: blocks of TH_MIX_NT threads, each thread a unit of 8
# columns, at most TH_MIX_MAX_H heads
TH_MIX_NT = 256
TH_MIX_MAX_H = 16


def th_mix_wave(device, H):
    """The blocks of one wave of th_mix_kernel for H heads."""
    hb = 4 if H <= 4 else 8 if H <= 8 else 16   # its variant
    return _wave(("spe_th_mix_wave", hb), device,
                 lambda n: lib().spe_th_mix_wave(hb, n))


def th_mix_plan(rows, D, wave):
    """th_mix_kernel's grid for `rows` rows of D columns -> (blocks, run):
    thread t of the grid takes unit t % (D / 8) of rows [s * run, (s + 1) *
    run), s = t // (D / 8), in at most `wave` blocks (th_mix_wave: one
    wave) unless one row's units need more."""
    units = D // 8
    slots = max(1, wave * TH_MIX_NT // units)
    run = -(-rows // slots)
    return -(-(-(-rows // run) * units) // TH_MIX_NT), run


def th_mix(pv, csum, ww, bw):
    """Talking-heads post-softmax mix. pv: (B, N, H, D) f32 (P_g V per mixed
    head g); csum: (B, D) f32; ww: (H, H) f32 torch Linear layout; bw: (H,)
    f32 -> (B, N, D) bf16. At most TH_MIX_MAX_H heads of a multiple of 8
    columns; pv and csum 16-byte aligned."""
    _need(pv, _F32, "pv", 4)
    if not pv.is_contiguous():
        raise ValueError("pv must be contiguous")
    B, N, H, D = pv.shape
    _need(csum, _F32, "colsum", 2)
    _need(ww, _F32, "ww", 2)
    _need(bw, _F32, "bw", 1)
    if tuple(csum.shape) != (B, D) or tuple(ww.shape) != (H, H) or \
            bw.shape[0] != H or not ww.is_contiguous() or \
            not csum.is_contiguous():
        raise ValueError("th_mix operand shapes disagree")
    if H > TH_MIX_MAX_H or D % H or (D // H) % 8 or B * N > 2 ** 31 - 1:
        raise ValueError(f"th_mix takes at most {TH_MIX_MAX_H} heads of a "
                         f"multiple of 8 columns and fewer than 2^31 rows, "
                         f"got {tuple(pv.shape)}")
    if (pv.data_ptr() | csum.data_ptr()) % 16:
        raise ValueError("th_mix takes 16-byte aligned pv and colsum")
    blocks, run = th_mix_plan(B * N, D, th_mix_wave(pv.device, H))
    out = torch.empty((B, N, D), device=pv.device, dtype=_BF16)
    p = _MixParams(pv=pv.data_ptr(), colsum=csum.data_ptr(), ww=ww.data_ptr(),
                   bw=bw.data_ptr(), out=out.data_ptr(), rows=B * N, N=N, H=H,
                   D=D, blocks=blocks, run=run)
    _check(lib().spe_th_mix(ctypes.byref(p), _stream()), "spe_th_mix")
    th_mix.launches += 1
    return out


th_mix.launches = 0


def th_mix_reference(pv, csum, ww, bw):
    """Plain PyTorch version of `th_mix`: out[b, n, c] = sum_g pv[b, n, g,
    c] ww[c // dh, g] + bw[c // dh] csum[b, c]."""
    B, N, H, D = pv.shape
    dh = D // H
    mix = ww.repeat_interleave(dh, dim=0)          # (D, H): row c -> head c // dh
    out = torch.einsum("bngc,cg->bnc", pv, mix) + \
        bw.repeat_interleave(dh) * csum[:, None]
    return out.to(_BF16)


def connected_components(masks, max_sweeps):
    """8-connected min-index labels of (N, S, S) bool masks (S <= 128)
    -> (labels (N, S, S) int32, background 2**30; sweeps (N,) int32)."""
    _need(masks, torch.bool, "masks", 3)
    N, S, S2 = masks.shape
    if S != S2 or S > 128 or not masks.is_contiguous():
        raise ValueError(f"masks must be contiguous (N, S, S) with S <= 128, "
                         f"got {tuple(masks.shape)}")
    labels = torch.empty((N, S, S), device=masks.device, dtype=torch.int32)
    sweeps = torch.empty((N,), device=masks.device, dtype=torch.int32)
    p = _CCParams(masks=masks.data_ptr(), labels=labels.data_ptr(),
                  sweeps=sweeps.data_ptr(), N=N, S=S,
                  max_sweeps=int(max_sweeps))
    _check(lib().spe_connected_components(ctypes.byref(p), _stream()),
           "spe_connected_components")
    return labels, sweeps


def auction(benefit, person_mask, eps, max_iters):
    """The forward-auction phase of (P, T, Q) f32 benefits with (P, T) bool
    valid persons -> (assigned (P, T) int32: object per person, -1
    unassigned, -2 padded; iters (P,) int32; bids (P,) int32: persons'
    bids evaluated, summed over the iterations)."""
    _need(benefit, _F32, "benefit", 3)
    _need(person_mask, torch.bool, "person_mask", 2)
    P, T, Q = benefit.shape
    if tuple(person_mask.shape) != (P, T) or not benefit.is_contiguous() \
            or not person_mask.is_contiguous():
        raise ValueError("benefit (P, T, Q) and person_mask (P, T) must be "
                         "contiguous and agree")
    assigned = torch.empty((P, T), device=benefit.device, dtype=torch.int32)
    iters = torch.empty((P,), device=benefit.device, dtype=torch.int32)
    bids = torch.empty((P,), device=benefit.device, dtype=torch.int32)
    p = _AuctionParams(benefit=benefit.data_ptr(),
                       mask=person_mask.data_ptr(),
                       assigned=assigned.data_ptr(), iters=iters.data_ptr(),
                       bids=bids.data_ptr(), P=P, T=T, Q=Q,
                       max_iters=int(max_iters), eps=float(eps))
    _check(lib().spe_auction(ctypes.byref(p), _stream()), "spe_auction")
    return assigned, iters, bids


# ---- the backward toolkit (csrc/grad.cu) and talking-heads training
# (csrc/th_train.cu) ----

def _span(t, strides, sizes):
    """Raise unless every element a kernel addresses as sum(i * stride),
    i < size, lies inside t's storage past its offset."""
    top = sum((n - 1) * st for n, st in zip(sizes, strides))
    room = t.untyped_storage().nbytes() // t.element_size() - t.storage_offset()
    if min(strides) < 0 or top >= room:
        raise ValueError(f"strides {strides} x sizes {sizes} overrun the "
                         f"storage of a {tuple(t.shape)} tensor")


def gemm(a, b, c, *, M, N, K, a_str, b_str, c_str, nb=(1, 1), alpha=1.0,
         split_k=None, seed=None, drop=None, rows_per_sample=1,
         gelu_aux=None, relu_aux=None, col_group=None, col_stride=0,
         accumulate=False):
    """C(m, n) = alpha * sum_k A(m, k) B(k, n), batched over z = (z1, z2)
    < nb: A(m, k) at z1*s1 + z2*s2 + m*sm + k*sk of `a` for a_str = (s1,
    s2, sm, sk), B(k, n) likewise with b_str = (s1, s2, sk, sn), C(m, n)
    with c_str = (s1, s2, sm, sn). a and b are bf16 or f32 (rounded to
    bf16 at the load), c bf16 or f32. split_k = total depth: z1 indexes
    chunks of K (the last may be short). The epilogue masks C with drop =
    (site, rate) (samples of rows_per_sample rows), then multiplies it by
    gelu'(gelu_aux) or zeroes it where relu_aux <= 0 (either (M, N) f32).
    With col_group, column n is stored at (n // col_group) * col_stride +
    (n % col_group) * sn; with accumulate, C += the result."""
    for t, n in ((a, "a"), (b, "b"), (c, "c")):
        _need(t, (_BF16, _F32), n)
    nb1, nb2 = nb
    depth = K if split_k is None else split_k
    if split_k is not None and (nb1 - 1) * K >= split_k:
        raise ValueError(f"{nb1} chunks of {K} leave the last of a "
                         f"{split_k}-deep split empty")
    _span(a, a_str, (nb1, nb2, M, K if split_k is None else 1))
    if split_k is not None:
        _span(a, a_str[2:], (M, depth))
        _span(b, b_str[2:], (depth, N))
    else:
        _span(b, b_str, (nb1, nb2, K, N))
    grp = N if col_group is None else col_group
    _span(c, (*c_str[:3], col_stride, c_str[3]),
          (nb1, nb2, M, -(-N // grp), min(grp, N)))
    if gelu_aux is not None and relu_aux is not None:
        raise ValueError("one activation derivative per product")
    act_aux = gelu_aux if relu_aux is None else relu_aux
    if act_aux is not None:
        _need(act_aux, _F32, "act_aux", 2)
        if tuple(act_aux.shape) != (M, N) or nb1 * nb2 != 1:
            raise ValueError("the activation's aux must be (M, N) of an "
                             "unbatched product")
    dsite, dthr, dscale = _site(drop)
    _need_seed(seed, dsite, rows_per_sample, M)
    if dsite and nb1 * nb2 != 1:
        raise ValueError("the dropout epilogue takes an unbatched product")
    a_f32, b_f32 = a.dtype == _F32, b.dtype == _F32
    tile, ra, rb = gemm_plan(M, N, K, nb, a.data_ptr(), a_f32, a_str,
                             b.data_ptr(), b_f32, b_str, split_k is not None,
                             sm_count(a.device))
    p = _GemmParams(
        a=a.data_ptr(), b=b.data_ptr(), c=c.data_ptr(), act_aux=_ptr(act_aux),
        seed=_ptr(seed), a_s1=a_str[0], a_s2=a_str[1], a_sm=a_str[2],
        a_sk=a_str[3], b_s1=b_str[0], b_s2=b_str[1], b_sk=b_str[2],
        b_sn=b_str[3], c_s1=c_str[0], c_s2=c_str[1], c_sm=c_str[2],
        c_sn=c_str[3], ld_aux=act_aux.stride(0) if act_aux is not None else 0,
        rps=rows_per_sample, kmax=depth, M=M, N=N, K=K, nb1=nb1, nb2=nb2,
        a_f32=int(a_f32), b_f32=int(b_f32),
        c_f32=int(c.dtype == _F32), split=int(split_k is not None),
        alpha=float(alpha), drop_site=dsite, drop_thr=dthr, drop_scale=dscale,
        act_grad=1 if gelu_aux is not None else 2, cgrp=grp,
        cgstride=col_stride, accumulate=int(accumulate), tile=tile,
        route_a=ra, route_b=rb)
    _check(lib().spe_gemm(ctypes.byref(p), _stream()), "spe_gemm")
    gemm.launches += 1
    return c


gemm.launches = 0


def row_keep(seed, drop, M, N, rows_per_sample):
    """The keep bits (M, N) of a row-wise dropout site, drop = (site,
    rate): keyed (seed, site, m // rows_per_sample, 0, m %
    rows_per_sample, n)."""
    site, rate = drop
    rps = rows_per_sample
    return counter_keep(seed, site, rate, (M // rps, 1, rps, N)).reshape(M, N)


def gemm_out_view(c, *, M, N, c_str, nb=(1, 1), col_group=None, col_stride=0,
                  **_):
    """The elements of c that `gemm` writes, (nb1, nb2, M, N // col_group,
    col_group); the other arguments of a gemm call are ignored."""
    grp = col_group or N
    if N % grp:
        raise ValueError(f"{N} columns are not whole groups of {grp}")
    return c.as_strided((*nb, M, N // grp, grp),
                        (*c_str[:3], col_stride, c_str[3]), c.storage_offset())


def gemm_reference(a, b, c, *, M, N, K, a_str, b_str, c_str, nb=(1, 1),
                   alpha=1.0, split_k=None, seed=None, drop=None,
                   rows_per_sample=1, gelu_aux=None, relu_aux=None,
                   col_group=None, col_stride=0, accumulate=False):
    """Plain PyTorch version of `gemm` (same arguments, same elements of c
    written): the operands read through their strides and rounded to bf16,
    the product summed in f32, then the epilogue in the kernel's order."""
    def view(t, st, sizes):
        return t.as_strided(sizes, st, t.storage_offset()).float().to(
            _BF16).float()

    nb1, nb2 = nb
    if split_k is None:
        y = view(a, a_str, (nb1, nb2, M, K)) @ view(b, b_str, (nb1, nb2, K, N))
    else:
        A = view(a, a_str[2:], (M, split_k))
        Bm = view(b, b_str[2:], (split_k, N))
        y = torch.stack([A[:, z * K:(z + 1) * K] @ Bm[z * K:(z + 1) * K]
                         for z in range(nb1)])[:, None]
    y = alpha * y
    if drop is not None and drop[1] > 0:
        y = torch.where(row_keep(seed, drop, M, N, rows_per_sample),
                        y * keep_scale(drop[1]), 0.0)
    if gelu_aux is not None:
        y = y * gelu_tanh_grad(gelu_aux)
    if relu_aux is not None:
        y = torch.where(relu_aux > 0, y, 0.0)
    out = gemm_out_view(c, M=M, N=N, c_str=c_str, nb=nb, col_group=col_group,
                        col_stride=col_stride)
    y = y.reshape(out.shape)
    if accumulate:
        y = out.float() + y
    out.copy_(y.to(c.dtype))
    return c


def reduce_sum(parts, round_bf16=False):
    """(Z, ...) f32 partials -> their sum over Z in a fixed order (f32,
    rounded to bf16 values with round_bf16)."""
    _need(parts, _F32, "parts")
    if not parts.is_contiguous():
        raise ValueError("parts must be contiguous")
    Z = parts.shape[0]
    out = torch.empty(parts.shape[1:], device=parts.device, dtype=_F32)
    p = _ReduceParams(parts=parts.data_ptr(), out=out.data_ptr(),
                      L=out.numel(), Z=Z, round_bf16=int(round_bf16))
    _check(lib().spe_reduce(ctypes.byref(p), _stream()), "spe_reduce")
    reduce_sum.launches += 1
    return out


reduce_sum.launches = 0


def reduce_sum_reference(parts, round_bf16=False):
    """Plain PyTorch version of `reduce_sum`."""
    s = parts.sum(0)
    return s.to(_BF16).float() if round_bf16 else s


ROW_CHUNK = 512   # rows per partial of a weight gradient


def grad_weight_chunk(M):
    """The rows of each of grad_weight's partials: about ROW_CHUNK, a
    multiple of 64 (gemm_kernel's k tile, so that the split takes the TMA
    route)."""
    return -(-M // -(-M // ROW_CHUNK) // 64) * 64


def matmul_dx(dy, w, *, seed=None, drop=None, rows_per_sample=1,
              gelu_aux=None, relu_aux=None, out=None):
    """dY (M, N) f32/bf16 rows @ W (N, K) bf16 (torch Linear layout) ->
    (M, K) f32, through gemm's epilogue (dropout mask, GELU derivative or
    ReLU mask); with `out` ((M, K) f32 rows) the product is added to it."""
    _need(dy, (_BF16, _F32), "dy", 2)
    _need(w, _BF16, "w", 2)
    M, N = dy.shape
    if w.shape[0] != N or not w.is_contiguous():
        raise ValueError(f"w {tuple(w.shape)} does not match dy {tuple(dy.shape)}")
    K = w.shape[1]
    accumulate = out is not None
    if accumulate:
        _need(out, _F32, "out", 2)
        if tuple(out.shape) != (M, K):
            raise ValueError(f"out must be {(M, K)}, got {tuple(out.shape)}")
    else:
        out = torch.empty((M, K), device=dy.device, dtype=_F32)
    return gemm(dy, w, out, M=M, N=K, K=N, a_str=(0, 0, dy.stride(0), 1),
                b_str=(0, 0, K, 1), c_str=(0, 0, out.stride(0), 1), seed=seed,
                drop=drop, rows_per_sample=rows_per_sample, gelu_aux=gelu_aux,
                relu_aux=relu_aux, accumulate=accumulate)


def grad_weight(dy, x, round_bf16=True):
    """dW = dY^T X for dY (M, N) and X (M, K) rows (f32 or bf16, rounded to
    bf16 at the load) -> (N, K) f32, the torch Linear layout: row chunks
    of grad_weight_chunk(M) rows in one batched launch, then reduce_sum."""
    _need(dy, (_BF16, _F32), "dy", 2)
    _need(x, (_BF16, _F32), "x", 2)
    M, N = dy.shape
    K = x.shape[1]
    if x.shape[0] != M:
        raise ValueError("dy and x must have the same rows")
    chunk = grad_weight_chunk(M)
    Z = -(-M // chunk)
    parts = torch.empty((Z, N, K), device=dy.device, dtype=_F32)
    ly, lx = dy.stride(0), x.stride(0)
    gemm(dy, x, parts, M=N, N=K, K=chunk, a_str=(chunk * ly, 0, 1, ly),
         b_str=(chunk * lx, 0, lx, 1), c_str=(N * K, 0, K, 1), nb=(Z, 1),
         split_k=M)
    return reduce_sum(parts, round_bf16)


def _index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA device (the one-wave plans
    below size their grids by it)."""
    index = _index(device)
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


_SMS = {}

# colsum_f32_kernel: strips of these widths (columns), the widest whose grid
# puts a block on every SM; clusters of 8 blocks, or of 16 (the H100's
# non-portable size) where 8 would leave strips narrower than
# COLSUM_F32_MIN_STRIP columns (one 64-byte segment a row: the narrow
# classes, (8192, 192) and (4800, 192), run faster so, the wide ones with
# 8); halved while a block would sum fewer than COLSUM_F32_MIN_RUN rows
COLSUM_F32_STRIPS = (128, 64, 32, 16, 8, 4)
COLSUM_F32_CLUSTERS = (8, 16)
COLSUM_F32_MIN_STRIP = 16
COLSUM_F32_MIN_RUN = 64
# blocks of 256 threads a SM can hold at once (chip_smoke's build phase
# prints the registers): a grid of at most this many a SM is one wave
COLSUM_F32_BLOCKS_PER_SM = 4


def colsum_f32_plan(M, C, n_sm):
    """colsum_f32_kernel's grid for (M, C) rows on n_sm SMs -> (strip,
    cluster, run): one cluster of `cluster` blocks per strip of `strip`
    columns (ceil(C / strip) strips), block k of a cluster summing rows
    [k * run, (k + 1) * run). A function of the shape and the card, so
    the sums' order is fixed."""
    for most in COLSUM_F32_CLUSTERS:
        cluster = most
        while cluster > 1 and -(-M // cluster) < COLSUM_F32_MIN_RUN:
            cluster //= 2
        strip = next((s for s in COLSUM_F32_STRIPS
                      if -(-C // s) * cluster >= n_sm), COLSUM_F32_STRIPS[-1])
        if strip >= COLSUM_F32_MIN_STRIP:
            break
    return strip, cluster, -(-M // cluster)


def colsum_f32(x):
    """(M, C) f32 rows -> (C,) column sums, in one launch and a fixed order
    (two calls give the same bits)."""
    _need(x, _F32, "x", 2)
    M, C = x.shape
    if M > 2 ** 31 - 1:
        raise ValueError(f"colsum_f32 takes at most 2^31 - 1 rows, got {M}")
    strip, cluster, run = colsum_f32_plan(M, C, sm_count(x.device))
    vec = C % 4 == 0 and x.stride(0) % 4 == 0 and x.data_ptr() % 16 == 0
    out = torch.empty((C,), device=x.device, dtype=_F32)
    p = _ColsumF32Params(x=x.data_ptr(), out=out.data_ptr(), M=M,
                         ld=x.stride(0), run=run, C=C, strip=strip,
                         cluster=cluster, vec=int(vec))
    _check(lib().spe_colsum_f32(ctypes.byref(p), _stream()), "spe_colsum_f32")
    return out


def colsum_f32_reference(x):
    """Plain PyTorch version of `colsum_f32`."""
    return x.sum(0)


# ln_bwd_kernel: the widths it is built for (template instantiations: the
# backbones' 192, 288, 384 and 768, and 256), the warps of a block, the
# largest cluster
LN_BWD_WIDTHS = (192, 256, 288, 384, 768)
LN_BWD_WARPS = 8
LN_BWD_CLUSTER = 8


def ln_backward_wave(device, D):
    """The blocks of one wave of ln_bwd_kernel<D> on a CUDA device, in
    clusters of LN_BWD_CLUSTER (the card's occupancy query: the number of
    such clusters that can run at once, times their size)."""
    n = _wave(("spe_ln_backward_wave", D), device,
              lambda n: lib().spe_ln_backward_wave(D, LN_BWD_CLUSTER, n))
    if n < LN_BWD_CLUSTER:
        raise RuntimeError(f"ln_bwd_kernel<{D}>: no cluster of "
                           f"{LN_BWD_CLUSTER} blocks fits the card")
    return n


def ln_backward_plan(M, wave):
    """ln_bwd_kernel's grid for M rows -> (blocks, cluster, run): warp w of
    the grid (LN_BWD_WARPS a block) takes rows [w * run, (w + 1) * run), in
    at most `wave` blocks (a multiple of LN_BWD_CLUSTER: ln_backward_wave);
    clusters of `cluster` blocks (a power of two up to LN_BWD_CLUSTER
    dividing `blocks`). A function of the shape and the card, so the sums'
    order is fixed."""
    run = -(-M // (wave * LN_BWD_WARPS))
    blocks = -(-(-(-M // run)) // LN_BWD_WARPS)
    cluster = min(LN_BWD_CLUSTER, 1 << (blocks.bit_length() - 1))
    return -(-blocks // cluster) * cluster, cluster, run


def ln_backward_ws_rows(n_sm):
    """Rows of ln_bwd_kernel's cluster workspace: one per cluster of any
    plan on n_sm SMs (a wave holds at most 8 blocks of 256 threads a SM,
    in clusters of LN_BWD_CLUSTER, or one smaller cluster)."""
    return n_sm * 8 // LN_BWD_CLUSTER + 1


def ln_backward_scratch(device):
    """ln_bwd_kernel's per-device scratch, allocated once: the tickets (one
    int32 counter per column slice of a cluster, 0 between launches: the
    slice's last block resets it) and one (2, max(LN_BWD_WIDTHS)) f32 row
    per cluster (ln_backward_ws_rows)."""
    index = _index(device)
    if index not in _LN_SCRATCH:
        rows = ln_backward_ws_rows(sm_count(device))
        dev = torch.device("cuda", index)
        _LN_SCRATCH[index] = (
            torch.zeros(LN_BWD_CLUSTER, device=dev, dtype=torch.int32),
            torch.empty((rows, 2, max(LN_BWD_WIDTHS)), device=dev, dtype=_F32))
    return _LN_SCRATCH[index]


_LN_SCRATCH = {}


def ln_backward(dy, x, weight, eps, *, res=None, out_dtype=_F32):
    """LayerNorm backward of (M, D) rows, D in LN_BWD_WIDTHS: dy f32, x the
    LayerNorm's input (bf16/f32), weight f32 -> (dx (+ res) in out_dtype,
    dweight, dbias), in one launch; dweight and dbias summed in a fixed
    order (two calls give the same bits). Rows 16-byte aligned (8 for bf16
    x). Launches on one stream at a time: the launches share the tickets."""
    _need(dy, _F32, "dy", 2)
    _need(x, (_BF16, _F32), "x", 2)
    _need(weight, _F32, "weight", 1)
    M, D = x.shape
    if tuple(dy.shape) != (M, D) or weight.shape[0] != D:
        raise ValueError("dy, x and weight disagree")
    if D not in LN_BWD_WIDTHS:
        raise ValueError(f"ln_backward takes D in {LN_BWD_WIDTHS}, got {D}")
    if res is not None:
        _need(res, _F32, "res", 2)
        if tuple(res.shape) != (M, D):
            raise ValueError("res must match x")
    if not weight.is_contiguous():
        raise ValueError("weight must be contiguous")
    for t, n in ((dy, "dy"), (x, "x"), (res, "res")):
        align = 8 if t is not None and t.dtype == _BF16 else 16
        if t is not None and (t.data_ptr() % align or
                              t.stride(0) * t.element_size() % align):
            raise ValueError(f"ln_backward reads {n} in {align}-byte aligned "
                             "rows")
    ticket, ws = ln_backward_scratch(x.device)
    blocks, cluster, run = ln_backward_plan(M, ln_backward_wave(x.device, D))
    dx = torch.empty((M, D), device=x.device, dtype=out_dtype)
    dwb = torch.empty((2, D), device=x.device, dtype=_F32)
    p = _LNBwdParams(dy=dy.data_ptr(), x=x.data_ptr(), g=weight.data_ptr(),
                     res=_ptr(res), dx=dx.data_ptr(), dwb=dwb.data_ptr(),
                     ws=ws.data_ptr(), ticket=ticket.data_ptr(), M=M,
                     ld_dy=dy.stride(0), ld_x=x.stride(0),
                     ld_res=res.stride(0) if res is not None else 0, run=run,
                     D=D, x_f32=int(x.dtype == _F32),
                     dx_f32=int(out_dtype == _F32), blocks=blocks,
                     cluster=cluster, ws_rows=ws.shape[0], eps=float(eps))
    _check(lib().spe_ln_backward(ctypes.byref(p), _stream()), "spe_ln_backward")
    return dx, dwb[0], dwb[1]


def ln_backward_reference(dy, x, weight, eps, *, res=None, out_dtype=_F32):
    """Plain PyTorch version of `ln_backward` (refmath's LayerNorm
    backward, then the residual and the output type)."""
    dx, dw, db = ln_backward_rows(dy, x, weight, eps)
    return (dx + (res if res is not None else 0.0)).to(out_dtype), dw, db


# branch_bwd_kernel: blocks of 256 threads a SM can hold at once (chip_smoke's
# build phase prints the registers): its main classes' grids stay within
# one wave of this many
BRANCH_BWD_BLOCKS_PER_SM = 2


def branch_backward_plan(M, D, n_sm):
    """branch_bwd_kernel's grid for (M, D) rows on n_sm SMs -> (strip,
    cluster, run): colsum_f32_kernel's (colsum_f32_plan), since with val
    the kernel sums dgamma over the rows as colsum_f32 sums a bias
    gradient. A function of the shape and the card, so the sums' order is
    fixed."""
    return colsum_f32_plan(M, D, n_sm)


def branch_backward(dres, val, gamma, *, seed=None, drop=None, path=None,
                    rows_per_sample=1):
    """The residual branch `x + dp * gamma * val`, val = drop(y) (M, D) f32:
    -> (dy = drop(dres * dp * gamma) f32, dgamma = sum dres * dp * val).
    Without gamma it counts as 1; without val no dgamma is summed (None).
    One launch; dgamma summed in a fixed order (two calls give the same
    bits)."""
    _need(dres, _F32, "dres", 2)
    M, D = dres.shape
    for t, n in ((val, "val"), (gamma, "gamma")):
        if t is not None:
            _need(t, _F32, n)
    for t in (dres, val):
        if t is not None and (tuple(t.shape) != (M, D) or
                              not t.is_contiguous()):
            raise ValueError("dres and val must be contiguous (M, D)")
    if gamma is not None and (tuple(gamma.shape) != (D,) or
                              not gamma.is_contiguous()):
        raise ValueError(f"gamma must hold {D} contiguous entries")
    if M > 2 ** 31 - 1:
        raise ValueError(f"branch_backward takes at most 2^31 - 1 rows, got {M}")
    dsite, dthr, dscale = _site(drop)
    psite, pthr, pscale = _site(path)
    _need_seed(seed, dsite or psite, rows_per_sample, M)
    strip, cluster, run = branch_backward_plan(M, D, sm_count(dres.device))
    d = torch.empty((M, D), device=dres.device, dtype=_F32)
    dgamma = None if val is None else torch.empty((D,), device=dres.device,
                                                  dtype=_F32)
    vec = D % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (dres, val, d)
                             if t is not None)
    p = _BranchBwdParams(dres=dres.data_ptr(), val=_ptr(val),
                         gamma=_ptr(gamma), seed=_ptr(seed),
                         d=d.data_ptr(), dgamma=_ptr(dgamma), M=M,
                         rps=rows_per_sample, run=run, D=D, strip=strip,
                         cluster=cluster, vec=int(vec), drop_site=dsite,
                         drop_thr=dthr, drop_scale=dscale, path_site=psite,
                         path_thr=pthr, path_scale=pscale)
    _check(lib().spe_branch_backward(ctypes.byref(p), _stream()),
           "spe_branch_backward")
    return d, dgamma


def branch_backward_reference(dres, val, gamma, *, seed=None, drop=None,
                              path=None, rows_per_sample=1):
    """Plain PyTorch version of `branch_backward`."""
    M, D = dres.shape
    dp = 1.0
    if path is not None and path[1] > 0:
        dp = _path_factor(seed, path, M, rows_per_sample)
    d = dres * dp * (gamma if gamma is not None else 1.0)
    if drop is not None and drop[1] > 0:
        d = torch.where(row_keep(seed, drop, M, D, rows_per_sample),
                        d * keep_scale(drop[1]), 0.0)
    return d, None if val is None else (dres * dp * val).sum(0)


def dropout_grad(dy, seed, drop, rows_per_sample):
    """d/dy of a dropout site on (M, D) f32 rows: drop = (site, rate), the
    forward's mask and scale (samples of rows_per_sample rows)."""
    return branch_backward(dy, None, None, seed=seed, drop=drop,
                           rows_per_sample=rows_per_sample)[0]


def dropout_mask(seed, site, rate, shape):
    """The kernels' keep mask (B, H, R, C) bool of `site` at `rate`; with a
    1-d shape (B,) the DropPath decisions."""
    _need_seed(seed, True)
    path = len(shape) == 1
    B, H, R, C = (shape[0], 1, 1, 1) if path else shape
    out = torch.empty(tuple(shape), device=seed.device, dtype=torch.uint8)
    p = _MaskParams(seed=seed.data_ptr(), out=out.data_ptr(), B=B, H=H, R=R,
                    C=C, site=int(site), path=int(path),
                    thr=keep_threshold(rate))
    _check(lib().spe_dropout_mask(ctypes.byref(p), _stream()),
           "spe_dropout_mask")
    return out.bool()


# th_fold_kernel: at most 16 heads (th_train.cu FOLD_MAX_H), rows (H, D) f32
# in one block's shared memory, B * N rows counted in 32 bits
TH_FOLD_MAX_H = 16
TH_FOLD_MAX_SMEM = 232448
TH_FOLD_MAX_ROWS = 2 ** 31 - 1 - 256


def th_fold(q, rows):
    """q (B, N, D) bf16 view (last dim contiguous), rows (H, D) f32 ->
    (B, H, N, D) bf16: bf16(q * rows[g]), rounded once from the f32
    product."""
    _need(q, _BF16, "q", 3)
    _need(rows, _F32, "rows", 2)
    B, N, D = q.shape
    H = rows.shape[0]
    if rows.shape[1] != D or not rows.is_contiguous():
        raise ValueError(f"rows must be ({H}, {D}) contiguous")
    if (H > TH_FOLD_MAX_H or H * D * 4 > TH_FOLD_MAX_SMEM
            or B * N > TH_FOLD_MAX_ROWS):
        raise ValueError(
            f"th_fold takes at most {TH_FOLD_MAX_H} heads, H * D * 4 <= "
            f"{TH_FOLD_MAX_SMEM} bytes of rows and B * N <= "
            f"{TH_FOLD_MAX_ROWS}, got q {tuple(q.shape)}, rows "
            f"{tuple(rows.shape)}")
    out = torch.empty((B, H, N, D), device=q.device, dtype=_BF16)
    p = _THFoldParams(q=q.data_ptr(), rows=rows.data_ptr(), out=out.data_ptr(),
                      q_sb=q.stride(0), q_sn=q.stride(1), B=B, H=H, N=N, D=D)
    _check(lib().spe_th_fold(ctypes.byref(p), _stream()), "spe_th_fold")
    return out


def th_fold_reference(q, rows):
    """Plain PyTorch version of `th_fold`."""
    return (q.float()[:, None] * rows[None, :, None, :]).to(_BF16)


def _th_row_params(s, bl, ww, bw, seed, rate, wl, site, **kw):
    _need(s, _F32, "s", 4)
    B, H, N, N2 = s.shape
    if N != N2 or not s.is_contiguous():
        raise ValueError("s must be contiguous (B, H, N, N)")
    mats = ((bl, "bl", (H,)), (bw, "bw", (H,)), (ww, "ww", (H, H)))
    for t, n, shape in mats + (((wl, "wl", (H, H)),) if wl is not None
                               else ()):
        _need(t, _F32, n)
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{n} must be {shape} contiguous")
    dsite, thr, scale = _site((site, rate))
    _need_seed(seed, dsite)
    return dict(s=s.data_ptr(), bl=bl.data_ptr(), ww=ww.data_ptr(),
                bw=bw.data_ptr(), seed=_ptr(seed), B=B, H=H, N=N,
                drop=int(dsite != 0), thr=thr, scale=scale, wl=_ptr(wl),
                site=dsite, **kw)


TH_NT = 256        # csrc/th_rows.cuh: threads of th_fwd_rows_kernel and
TH_BLOCKS = 1024   # th_bwd_rows_kernel, units of 4 columns each; at most
                   # TH_BLOCKS blocks


TH_ROWS_MAX_N = 4 * TH_NT * 2   # two units of 4 columns a thread
                                # (csrc/th_rows.cuh TH_MAXU)
# the heads the row passes are built for (th_train.cu, th_wide.cu, th_h16.cu)
TH_ROWS_HEADS = (1, 2, 3, 4, 5, 6, 7, 8, 16)
# th_bwd_rows' sums a row: dww, dbw, dbl and dwl at the most heads
TH_BWD_MAX_WIDTH = 2 * max(TH_ROWS_HEADS) ** 2 + 2 * max(TH_ROWS_HEADS)


def _th_rows_domain(name, H, N):
    if N > TH_ROWS_MAX_N or H not in TH_ROWS_HEADS:
        raise ValueError(f"{name} takes rows of at most {TH_ROWS_MAX_N} keys "
                         f"and H in {TH_ROWS_HEADS}, got N={N}, H={H}")


def th_fwd_rows(s, bl, ww, bw, seed, rate, *, wl=None, site=SITE_ATTN):
    """Talking-heads training forward row pass over the logits s (B, H, N,
    N) f32 (without bl; with wl (H, H) each head's own logits, mixed as
    m_g = sum_h wl[g, h] s_h): -> (lse (B, H, N) f32 of the mixed logits +
    bl, zd (B, H, N, N) bf16 = drop(sum_h ww[g, h] softmax_h + bw_g)), the
    mask keyed (seed, site, b, g, row, key). Takes N <= TH_ROWS_MAX_N and H
    in TH_ROWS_HEADS."""
    B, H, N, _ = s.shape
    params = _th_row_params(s, bl, ww, bw, seed, rate, wl, site)
    _th_rows_domain("th_fwd_rows", H, N)
    lse = torch.empty((B, H, N), device=s.device, dtype=_F32)
    zd = torch.empty(s.shape, device=s.device, dtype=_BF16)
    p = _THRowParams(**params, lse=lse.data_ptr(), zd=zd.data_ptr())
    _check(lib().spe_th_rows(ctypes.byref(p), 0, _stream()), "spe_th_rows")
    th_fwd_rows.launches += 1
    return lse, zd


th_fwd_rows.launches = 0


def th_bwd_blocks(B, N, wave):
    """The blocks of th_bwd_rows_kernel for B * N rows on a card that holds
    `wave` of its blocks at once (csrc/th_train.cu th_wave: the blocks a SM
    takes x the SMs, at most TH_BLOCKS): block k over rows [k * per, (k +
    1) * per) with per = ceil(B * N / wave), each writing one row of the
    scratch. A function of the shape and the card, so the sums' order is
    fixed."""
    rows = B * N
    per = -(-rows // wave)
    return -(-rows // per)


def th_bwd_scratch(device):
    """th_bwd_rows_kernel's per-device scratch, allocated once: the ticket
    (int32, 0 between launches: the last block resets it) and a row of
    TH_BWD_MAX_WIDTH f32 sums for each of TH_BLOCKS blocks."""
    index = _index(device)
    if index not in _TH_BWD_SCRATCH:
        dev = torch.device("cuda", index)
        _TH_BWD_SCRATCH[index] = (
            torch.zeros(1, device=dev, dtype=torch.int32),
            torch.empty(TH_BLOCKS * TH_BWD_MAX_WIDTH, device=dev, dtype=_F32))
    return _TH_BWD_SCRATCH[index]


_TH_BWD_SCRATCH = {}

# csrc/th_h16.cu, the 16-head row passes (th16_fwd_rows_kernel,
# th16_bwd_rows_kernel): one wave of blocks of TH_NT threads, each over a
# run of rows; a row walked in chunks of TH16_CHUNK columns, a warp's stripe
# of 32 each, staged through the warp's own ring of shared-memory slots (16
# head rows of TH16_LD floats an array: s, and for the backward dzd), each
# row twice
TH16_CHUNK = TH_NT                    # 8 warps x 32 columns
TH16_LD = 36                          # a stripe's head row, 32 columns padded
TH16_SLOTS = {True: 3, False: 4}      # a warp's ring: backward, forward
# the blocks a SM each kernel is built for (its __launch_bounds__), by
# (backward, wl): the forward without wl at two (at most 128 registers a
# thread), the others at one
TH16_BLOCKS_PER_SM = {(False, False): 2, (False, True): 1, (True, False): 1,
                      (True, True): 1}
SMEM_PER_BLOCK = 232448               # the H100's shared memory a block
SMEM_PER_SM = 233472                  # ... and a SM's, 1 KB of it per block
                                      # reserved


def th_finish_smem(width):
    """The static shared memory of th_bwd_finish<width> (csrc/th_rows.cuh):
    TH_NT rows of its padded pass of entries, and TH_FIN_G rows of the
    pass."""
    fe = 24 if width > 4 * 40 else 40
    passes = -(-width // fe)
    eq = -(-width // passes)
    ec = -(-eq // 4) * 4 if width % 4 == 0 else eq
    return 4 * (TH_NT * (ec + 1) + 8 * ec)


def th16_plan(B, N, n_sm, *, backward, wl=False):
    """th16_fwd_rows_kernel's or th16_bwd_rows_kernel's launch for B * N
    rows of N keys on a card of n_sm SMs -> dict: the blocks a SM holds
    (`per_sm`: TH16_BLOCKS_PER_SM, where the shared memory a block takes
    allows it, `smem`: the rings (`ring`), the backward's keep bits, the
    row sums and th_bwd_finish's arrays), the grid (`blocks`, each over
    `rows_per_block` rows: a wave of per_sm x n_sm blocks at most
    TH_BLOCKS, as th_bwd_blocks), the
    chunks a row (`chunks`) and the visits a block makes of its rows'
    chunks (`visits`: two passes a row), and the backward's sums a block
    (`width`, one row of th_bwd_scratch's ws each)."""
    warps, heads = TH_NT // 32, 16
    arrays = 2 if backward else 1
    ring = warps * TH16_SLOTS[backward] * arrays * heads * TH16_LD * 4
    chunks = -(-N // TH16_CHUNK)
    width = (2 if wl else 1) * heads * heads + 2 * heads if backward else 0
    if backward:   # the keep bits, the rowsum slots, the flag (padded to
        # 16 bytes) and th_bwd_finish's arrays
        smem = (ring + warps * (TH_ROWS_MAX_N // TH16_CHUNK) * 32 * 2
                + 2 * warps * heads * 4 + 16 + th_finish_smem(width))
    else:          # the running maxima and sums' slots
        smem = ring + 2 * 2 * warps * heads * 4
    per_sm = min(TH16_BLOCKS_PER_SM[(backward, wl)],
                 SMEM_PER_SM // (smem + 1024))
    wave = min(per_sm * n_sm, TH_BLOCKS)
    blocks, per = th_bwd_blocks(B, N, wave), -(-(B * N) // wave)
    return dict(smem=smem, ring=ring, per_sm=per_sm, blocks=blocks,
                rows_per_block=per, chunks=chunks, visits=2 * chunks * per,
                width=width)


def th_bwd_rows(s, lse, dzd, bl, ww, bw, seed, rate, *, wl=None,
                site=SITE_ATTN):
    """Talking-heads backward row pass: -> (zd bf16, ds bf16 (B, H, N, N),
    dww (H, H), dbw (H,), dbl (H,) f32). With wl (see th_fwd_rows) ds holds
    dL_h = sum_g wl[g, h] dm_g, and dwl (H, H) f32 is returned last.
    Takes N <= TH_ROWS_MAX_N and H in TH_ROWS_HEADS. One launch; the
    parameter sums in a fixed order (two calls give the same bits).
    Launches on one stream at a time: the launches share the ticket."""
    B, H, N, _ = s.shape
    _need(lse, _F32, "lse", 3)
    _need(dzd, _F32, "dzd", 4)
    if tuple(lse.shape) != (B, H, N) or dzd.shape != s.shape or \
            not (lse.is_contiguous() and dzd.is_contiguous()):
        raise ValueError("lse (B, H, N) and dzd (B, H, N, N) must be contiguous")
    _th_rows_domain("th_bwd_rows", H, N)
    zd = torch.empty(s.shape, device=s.device, dtype=_BF16)
    ds = torch.empty(s.shape, device=s.device, dtype=_BF16)
    width = (2 if wl is not None else 1) * H * H + 2 * H
    sums = torch.empty(width, device=s.device, dtype=_F32)
    ticket, ws = th_bwd_scratch(s.device)
    p = _THRowParams(**_th_row_params(
        s, bl, ww, bw, seed, rate, wl, site, dzd=dzd.data_ptr(),
        lse=lse.data_ptr(), zd=zd.data_ptr(), ds=ds.data_ptr(),
        ws=ws.data_ptr(), ticket=ticket.data_ptr(), sums=sums.data_ptr(),
        ws_size=ws.numel()))
    _check(lib().spe_th_rows(ctypes.byref(p), 1, _stream()), "spe_th_rows")
    th_bwd_rows.launches += 1
    out = (zd, ds, sums[:H * H].view(H, H), sums[H * H:H * H + H],
           sums[H * H + H:H * H + 2 * H])
    return out + (sums[H * H + 2 * H:].view(H, H),) if wl is not None else out


th_bwd_rows.launches = 0


def _th_probs(s, lse, bl, ww, bw, seed, rate, wl, site):
    """The talking-heads row pass in plain PyTorch: -> (lse, p_h, keep,
    scale, zd in f32)."""
    if wl is not None:   # each head's own logits, mixed before the softmax
        s = torch.einsum("bhqk,gh->bgqk", s, wl)
    s = s + bl[None, :, None, None]
    lse = torch.logsumexp(s, -1) if lse is None else lse
    pr = torch.exp(s - lse[..., None])
    z = torch.einsum("bhqk,gh->bgqk", pr, ww) + bw[None, :, None, None]
    keep = counter_keep(seed, site, rate, s.shape) if rate > 0 else \
        torch.ones(s.shape, dtype=torch.bool, device=s.device)
    sc = keep_scale(rate)
    return lse, pr, keep, sc, torch.where(keep, z * sc, 0.0)


def th_fwd_rows_reference(s, bl, ww, bw, seed, rate, *, wl=None,
                          site=SITE_ATTN):
    """Plain PyTorch version of `th_fwd_rows`."""
    lse, _, _, _, zd = _th_probs(s, None, bl, ww, bw, seed, rate, wl, site)
    return lse, zd.to(_BF16)


def th_bwd_rows_reference(s, lse, dzd, bl, ww, bw, seed, rate, *, wl=None,
                          site=SITE_ATTN):
    """Plain PyTorch version of `th_bwd_rows` (same arguments, same
    outputs): dz = M (.) dzd / keep, dp_h = sum_g ww[g, h] dz_g, ds = p (dp
    - rowsum(dp p)), and the parameter gradients summed in f32."""
    _, pr, keep, sc, zd = _th_probs(s, lse, bl, ww, bw, seed, rate, wl, site)
    dz = torch.where(keep, dzd * sc, 0.0)
    dp = torch.einsum("bgqk,gh->bhqk", dz, ww)
    ds = pr * (dp - (dp * pr).sum(-1, keepdim=True))
    out = (zd.to(_BF16), ds.to(_BF16), torch.einsum("bhqk,bgqk->gh", pr, dz),
           dz.sum((0, 2, 3)), ds.sum((0, 2, 3)))
    if wl is None:
        return out
    dl = torch.einsum("bgqk,gh->bhqk", ds, wl).contiguous()
    return (*out[:1], dl.to(_BF16), *out[2:],
            torch.einsum("bhqk,bgqk->gh", s, ds))


# th_dq_kernel: threads of a block, the most heads (H * H <= TH_DQ_NT),
# blocks of TH_DQ_NT threads a SM in the plan's wave: three of the stock
# th_dq_kernel<4, 4> (72 registers; chip_smoke's build phase prints them)
# fit a SM, so the stock grid is one wave
TH_DQ_NT = 256
TH_DQ_MAX_H = 16
TH_DQ_BLOCKS_PER_SM = 3


def th_dq_chunk(D, H):
    """The columns of a th_dq_kernel chunk: 4 where a head's dh = D / H
    columns are whole 16-byte units, else 1 (a chunk lies in one head)."""
    return 4 if (D // H) % 4 == 0 else 1


def th_dq_plan(B, N, H, D, n_sm):
    """th_dq_kernel's grid for (B, H, N, D) on n_sm SMs -> (group, blocks,
    run): `group` threads a row (one chunk of th_dq_chunk columns each, the
    row's chunks in ceil(chunks / group) passes), TH_DQ_NT // group rows a
    block, at most TH_DQ_BLOCKS_PER_SM blocks a SM, block k over rows
    [k * run, (k + 1) * run). A function of the shape and the card, so
    dwl's order is fixed."""
    group = min(D // th_dq_chunk(D, H), TH_DQ_NT)
    rows = B * N
    slots = TH_DQ_NT // group
    run = -(-rows // min(-(-rows // slots), n_sm * TH_DQ_BLOCKS_PER_SM))
    return group, -(-rows // run), run


def th_dq_scratch(device):
    """th_dq_kernel's per-device scratch, allocated once: the ticket (int32,
    0 between launches: the last block resets it) and a row of TH_DQ_NT
    (the most H * H) f32 sums for every block of a wave."""
    index = _index(device)
    if index not in _DQ_SCRATCH:
        dev = torch.device("cuda", index)
        blocks = sm_count(device) * TH_DQ_BLOCKS_PER_SM
        _DQ_SCRATCH[index] = (
            torch.zeros(1, device=dev, dtype=torch.int32),
            torch.empty(blocks * TH_DQ_NT, device=dev, dtype=_F32))
    return _DQ_SCRATCH[index]


_DQ_SCRATCH = {}


def th_dq(dqt, q, rows, scale, out):
    """dQ = sum_g dqt[:, g] * rows[g] into `out` (B, N, D) f32 view, from
    dqt (B, H, N, D) f32; returns dwl (H, H) f32, [g, h] = scale *
    sum q_h * dqt_g[head h columns]. One launch; dwl summed in a fixed
    order (two calls give the same bits). Launches on one stream at a
    time: the launches share the ticket."""
    _need(dqt, _F32, "dqt", 4)
    _need(q, _BF16, "q", 3)
    _need(rows, _F32, "rows", 2)
    _need(out, _F32, "out", 3)
    B, H, N, D = dqt.shape
    if not dqt.is_contiguous() or not rows.is_contiguous() or \
            tuple(q.shape) != (B, N, D) or tuple(out.shape) != (B, N, D) or \
            tuple(rows.shape) != (H, D):
        raise ValueError("th_dq operand shapes disagree")
    if H > TH_DQ_MAX_H or D % H or B * N > 2 ** 31 - 1:
        raise ValueError(f"th_dq takes at most {TH_DQ_MAX_H} heads of "
                         f"D / H columns and 2^31 - 1 rows, got H={H}, "
                         f"D={D}, B*N={B * N}")
    ticket, ws = th_dq_scratch(dqt.device)
    group, blocks, run = th_dq_plan(B, N, H, D, sm_count(dqt.device))
    vec = (th_dq_chunk(D, H) == 4 and
           (dqt.data_ptr() | rows.data_ptr() | out.data_ptr()) % 16 == 0 and
           q.data_ptr() % 8 == 0 and
           all(st % 4 == 0 for st in (*q.stride()[:2], *out.stride()[:2])))
    dwl = torch.empty((H, H), device=dqt.device, dtype=_F32)
    p = _THDqParams(dqt=dqt.data_ptr(), q=q.data_ptr(), rows=rows.data_ptr(),
                    dq=out.data_ptr(), dwl=dwl.data_ptr(), ws=ws.data_ptr(),
                    ticket=ticket.data_ptr(), q_sb=q.stride(0),
                    q_sn=q.stride(1), o_sb=out.stride(0), o_sn=out.stride(1),
                    run=run, ws_size=ws.numel(), B=B, H=H, N=N, D=D,
                    group=group, vec=int(vec), scale=float(scale))
    _check(lib().spe_th_dq(ctypes.byref(p), _stream()), "spe_th_dq")
    return dwl


def th_dq_reference(dqt, q, rows, scale, out):
    """Plain PyTorch version of `th_dq` (writes `out`, returns dwl)."""
    B, H, N, D = dqt.shape
    out.copy_((dqt * rows[None, :, None, :]).sum(1))
    qdq = q.float()[:, None] * dqt
    return scale * qdq.reshape(B, H, N, H, D // H).sum((0, 2, 4))


def softmax_backward(probs, dp, dattn=None):
    """Rows of probabilities (..., C) f32 with dp (and an optional dattn
    cotangent) -> dl = p * (dp + dattn - rowsum(p * (dp + dattn))) bf16."""
    for t, n in ((probs, "probs"), (dp, "dp"), (dattn, "dattn")):
        if t is not None:
            _need(t, _F32, n)
            if t.shape != probs.shape or not t.is_contiguous():
                raise ValueError(f"{n} must be contiguous {tuple(probs.shape)}")
    C = probs.shape[-1]
    dl = torch.empty(probs.shape, device=probs.device, dtype=_BF16)
    p = _SoftmaxBwdParams(p=probs.data_ptr(), dp=dp.data_ptr(),
                          dattn=_ptr(dattn), dl=dl.data_ptr(),
                          R=probs.numel() // C, C=C)
    _check(lib().spe_softmax_backward(ctypes.byref(p), _stream()),
           "spe_softmax_backward")
    return dl


def softmax_backward_reference(probs, dp, dattn=None):
    """Plain PyTorch version of `softmax_backward`."""
    d = dp + (dattn if dattn is not None else 0.0)
    return (probs * (d - (d * probs).sum(-1, keepdim=True))).to(_BF16)


ATTN_ROWS_MAX_NK = 8192   # csrc/th_train.cu spe_attn_bwd_rows


def attention_bwd_rows(s, dzd, lse, kbias, seed, drop, *, num_heads,
                       mask_heads=None, head0=0):
    """The row pass of the standard attention backward. s: (B, H, Nq, Nk)
    f32 scaled logits without the key bias; dzd: do . V^T of that shape;
    lse: (B, H, Nq) f32 of s + kbias (the forward's); kbias: (B, Nk) f32 or
    None; drop = (site, rate) with the forward's keys (see `attention`)
    -> (zd, dl) bf16 (B, H, Nq, Nk): the dropped probabilities and
    p (dp - rowsum(dp p)) with dp the masked dzd. Takes Nk <=
    ATTN_ROWS_MAX_NK."""
    _need(s, _F32, "s", 4)
    _need(dzd, _F32, "dzd", 4)
    _need(lse, _F32, "lse", 3)
    B, H, Nq, Nk = s.shape
    if H != num_heads or dzd.shape != s.shape or \
            tuple(lse.shape) != (B, H, Nq) or not (
                s.is_contiguous() and dzd.is_contiguous() and
                lse.is_contiguous()):
        raise ValueError("s, dzd (B, H, Nq, Nk) and lse (B, H, Nq) must be "
                         "contiguous and agree")
    if kbias is not None:
        _need(kbias, _F32, "kbias", 2)
        if tuple(kbias.shape) != (B, Nk):
            raise ValueError(f"kbias must be ({B}, {Nk})")
    if Nk > ATTN_ROWS_MAX_NK:
        raise ValueError(f"attention_bwd_rows takes rows of at most "
                         f"{ATTN_ROWS_MAX_NK} keys, got {Nk}")
    dsite, dthr, dscale = _site(drop)
    _need_seed(seed, dsite)
    zd = torch.empty(s.shape, device=s.device, dtype=_BF16)
    dl = torch.empty(s.shape, device=s.device, dtype=_BF16)
    p = _AttnRowParams(s=s.data_ptr(), dzd=dzd.data_ptr(), lse=lse.data_ptr(),
                       kbias=_ptr(kbias), seed=_ptr(seed), zd=zd.data_ptr(),
                       dl=dl.data_ptr(),
                       kb_sb=kbias.stride(0) if kbias is not None else 0,
                       Z=B * H, H=H, Nq=Nq, Nk=Nk, drop_site=dsite,
                       drop_thr=dthr, drop_scale=dscale,
                       mask_heads=H if mask_heads is None else mask_heads,
                       head0=int(head0))
    _check(lib().spe_attn_bwd_rows(ctypes.byref(p), _stream()),
           "spe_attn_bwd_rows")
    attention_bwd_rows.launches += 1
    return zd, dl


attention_bwd_rows.launches = 0


def attention_bwd_rows_reference(s, dzd, lse, kbias, seed, drop, *,
                                 num_heads, mask_heads=None, head0=0):
    """Plain PyTorch version of `attention_bwd_rows` (same arguments, same
    outputs)."""
    if kbias is not None:
        s = s + kbias[:, None, None, :]
    p = torch.exp(s - lse[..., None])
    keep = torch.ones(s.shape, dtype=torch.bool, device=s.device)
    sc = 1.0
    if drop is not None and drop[1] > 0:
        keep = attention_keep(seed, drop, s.shape, mask_heads or num_heads,
                              head0)
        sc = keep_scale(drop[1])
    dp = torch.where(keep, dzd * sc, 0.0)
    return (torch.where(keep, p * sc, 0.0).to(_BF16),
            (p * (dp - (dp * p).sum(-1, keepdim=True))).to(_BF16))


def _heads(t, hs):
    """(batch, row, head) strides of a (B, rows, cols) view whose head h
    starts at column h * hs."""
    return t.stride(0), t.stride(1), hs


def attention_backward(q, k, v, do, lse, *, num_heads, dq, dv, q_hs, k_hs,
                       v_hs, do_hs, dq_out, dk_out, dv_out, dq_hs, dk_hs,
                       dv_hs, kbias=None, logit_scale=1.0, seed=None,
                       drop=None, mask_heads=None, split=None, head0=0):
    """The backward of `attention` in its training form, per (sample, head)
    by strides: the logits s = scale q . k^T and dzd = do . V^T (spe_gemm,
    f32 planes (B, H, Nq, Nk)), the row pass (zd, dl), then dV = zd^T do,
    dQ = scale dl . K, dK = scale dl^T . Q. q/k/v (bf16) and do (f32) are
    the forward's (B, rows, cols) views with head strides; the gradients
    are written into the f32 views dq_out (B, Nq, .), dk_out (B, Nk, .),
    dv_out (B, Nk, .) with head strides dq_hs, dk_hs, dv_hs. split =
    (col_group, q_plane, k_plane): dQ's and dK's columns n >= col_group of
    each head go col_group back and one plane on (the halves of the
    decoder's [content | position] heads)."""
    B, Nq = q.shape[:2]
    Nk = k.shape[1]
    H = num_heads
    dev = q.device
    plane = (H * Nq * Nk, Nq * Nk)
    qs, ks, vs, ds = (_heads(q, q_hs), _heads(k, k_hs), _heads(v, v_hs),
                      _heads(do, do_hs))
    s = torch.empty((B, H, Nq, Nk), device=dev, dtype=_F32)
    gemm(q, k, s, M=Nq, N=Nk, K=dq, nb=(B, H), alpha=logit_scale,
         a_str=(qs[0], qs[2], qs[1], 1), b_str=(ks[0], ks[2], 1, ks[1]),
         c_str=(*plane, Nk, 1))
    dzd = torch.empty((B, H, Nq, Nk), device=dev, dtype=_F32)
    gemm(do, v, dzd, M=Nq, N=Nk, K=dv, nb=(B, H),
         a_str=(ds[0], ds[2], ds[1], 1), b_str=(vs[0], vs[2], 1, vs[1]),
         c_str=(*plane, Nk, 1))
    zd, dl = attention_bwd_rows(s, dzd, lse, kbias, seed, drop, num_heads=H,
                                mask_heads=mask_heads, head0=head0)
    del s, dzd
    grp, q_plane, k_plane = split or (None, 0, 0)
    o = _heads(dv_out, dv_hs)
    gemm(zd, do, dv_out, M=Nk, N=dv, K=Nq, nb=(B, H),
         a_str=(*plane, 1, Nk), b_str=(ds[0], ds[2], ds[1], 1),
         c_str=(o[0], o[2], o[1], 1))
    del zd
    o = _heads(dq_out, dq_hs)
    gemm(dl, k, dq_out, M=Nq, N=dq, K=Nk, nb=(B, H), alpha=logit_scale,
         a_str=(*plane, Nk, 1), b_str=(ks[0], ks[2], ks[1], 1),
         c_str=(o[0], o[2], o[1], 1), col_group=grp, col_stride=q_plane)
    o = _heads(dk_out, dk_hs)
    gemm(dl, q, dk_out, M=Nk, N=dq, K=Nq, nb=(B, H), alpha=logit_scale,
         a_str=(*plane, 1, Nk), b_str=(qs[0], qs[2], qs[1], 1),
         c_str=(o[0], o[2], o[1], 1), col_group=grp, col_stride=k_plane)
