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
(attn_kernel), and the row passes over the (B, H, N, N) planes,
`th_fwd_rows`, `th_bwd_rows` and `attention_bwd_rows`, count their
launches (`.launches`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
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
    """Wait for every (cmd, Popen) and raise with the output of a failure."""
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is built already:
    every source compiles in its own nvcc process, all at once."""
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
        _run(procs)
        out = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", out, *objs]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
        os.replace(out, so)  # atomic: a concurrent build never reads half a file
    return so


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
                ("aux_pre", ctypes.c_int)]


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
                   ("mask_heads", ctypes.c_int)])


class _LNParams(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("b", ctypes.c_void_p), ("out_f32", ctypes.c_void_p),
                ("out_bf16", ctypes.c_void_p),
                ("M", ctypes.c_longlong), ("ldx", ctypes.c_longlong),
                ("D", ctypes.c_int), ("x_f32", ctypes.c_int),
                ("eps", ctypes.c_float)]


class _ColsumParams(ctypes.Structure):
    _fields_ = [("v", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("sb", ctypes.c_longlong), ("sn", ctypes.c_longlong),
                ("B", ctypes.c_int), ("N", ctypes.c_int), ("C", ctypes.c_int)]


class _MixParams(ctypes.Structure):
    _fields_ = [("pv", ctypes.c_void_p), ("colsum", ctypes.c_void_p),
                ("ww", ctypes.c_void_p), ("bw", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("rows", ctypes.c_longlong),
                ("N", ctypes.c_int), ("H", ctypes.c_int), ("D", ctypes.c_int)]


class _CCParams(ctypes.Structure):
    _fields_ = [("masks", ctypes.c_void_p), ("labels", ctypes.c_void_p),
                ("sweeps", ctypes.c_void_p), ("N", ctypes.c_int),
                ("S", ctypes.c_int), ("max_sweeps", ctypes.c_int)]


class _AuctionParams(ctypes.Structure):
    _fields_ = [("benefit", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("assigned", ctypes.c_void_p), ("iters", ctypes.c_void_p),
                ("bids", ctypes.c_void_p), ("P", ctypes.c_int),
                ("T", ctypes.c_int), ("Q", ctypes.c_int),
                ("max_iters", ctypes.c_int), ("eps", ctypes.c_float),
                ("benefit_in_smem", ctypes.c_int)]


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
        (_I, "act_grad cgrp"), (_LL, "cgstride"), (_I, "accumulate"))


class _ReduceParams(ctypes.Structure):
    _fields_ = _struct((_P, "parts out"), (_LL, "L"), (_I, "Z round_bf16"))


class _ColsumF32Params(ctypes.Structure):
    _fields_ = _struct((_P, "x parts"), (_LL, "M ld chunk"), (_I, "C Z"))


class _LNBwdParams(ctypes.Structure):
    _fields_ = _struct((_P, "dy x g res dx parts"),
                       (_LL, "M ld_dy ld_x ld_res"), (_I, "D x_f32 dx_f32"),
                       (_FL, "eps"))


class _BranchBwdParams(ctypes.Structure):
    _fields_ = _struct((_P, "dres val gamma seed d parts"), (_LL, "M rps"),
                       (_I, "D drop_site"), (_U, "drop_thr"),
                       (_FL, "drop_scale"), (_I, "path_site"),
                       (_U, "path_thr"), (_FL, "path_scale"))


class _MaskParams(ctypes.Structure):
    _fields_ = _struct((_P, "seed out"), (_I, "B H R C site path"),
                       (_U, "thr"))


class _THFoldParams(ctypes.Structure):
    _fields_ = _struct((_P, "q rows out"), (_LL, "q_sb q_sn"),
                       (_I, "B H N D"))


class _THRowParams(ctypes.Structure):
    _fields_ = _struct((_P, "s dzd lse bl ww bw seed zd ds parts"),
                       (_I, "B H N drop"), (_U, "thr"), (_FL, "scale"),
                       (_P, "wl"), (_I, "site"))


class _THDqParams(ctypes.Structure):
    _fields_ = _struct((_P, "dqt q rows dq parts"),
                       (_LL, "q_sb q_sn o_sb o_sn"), (_I, "B H N D"),
                       (_FL, "scale"))


class _SoftmaxBwdParams(ctypes.Structure):
    _fields_ = _struct((_P, "p dp dattn dl"), (_LL, "R"), (_I, "C"))


class _AttnRowParams(ctypes.Structure):
    _fields_ = _struct((_P, "s dzd lse kbias seed zd dl"), (_LL, "kb_sb"),
                       (_I, "Z H Nq Nk drop_site"), (_U, "drop_thr"),
                       (_FL, "drop_scale"), (_I, "mask_heads"))


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
        so.spe_attention_copy_bytes.argtypes = [ctypes.POINTER(_AttnParams)]
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
        path_thr=pthr, path_scale=pscale, aux_pre=int(aux_pre))
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


def attention(q, k, v, out, *, num_heads, dq, dv, q_hs, k_hs, v_hs, o_hs,
              qscale=None, kbias=None, hbias=None, logit_scale=1.0,
              probs=None, seed=None, drop=None, mask_heads=None, lse=None):
    """Online-softmax attention. q/k/v/out are (B, rows, cols) views, last dim
    contiguous; head h of each starts at column h * <x>_hs (0 = shared by
    every head) and is dq (q, k) or dv (v, out) wide. qscale: (H, dq) f32,
    q <- bf16(q * qscale[h]); kbias: (B, Nk) f32; hbias: (H,) f32;
    probs: optional (B, H, Nq, Nk) f32 output of the normalised
    probabilities. The training form: drop = (site, rate) masks the
    probabilities with keep bits keyed (seed, site, z // mask_heads,
    z % mask_heads, row, key) for z = b * H + h (mask_heads defaults to
    H); lse: optional (B, H, Nq) f32 output of each row's log-sum-exp."""
    p = _attn_params(q, k, v, out, num_heads=num_heads, dq=dq, dv=dv,
                     q_hs=q_hs, k_hs=k_hs, v_hs=v_hs, o_hs=o_hs,
                     qscale=qscale, kbias=kbias, hbias=hbias,
                     logit_scale=logit_scale, probs=probs, seed=seed,
                     drop=drop, mask_heads=mask_heads, lse=lse)
    err = lib().spe_attention(ctypes.byref(p), dq, dv, _stream())
    _check(err, f"spe_attention(dq={dq}, dv={dv})")
    attention.launches += 1
    return out


attention.launches = 0


def attention_copy_bytes(*args, **kw):
    """The bytes of each K/V copy into shared memory that the kernel picks
    for `attention(*args, **kw)`: 16 where every K and V row start is
    16-byte aligned, else 8 or 4 (narrower cp.async), else 2 (plain
    loads)."""
    return lib().spe_attention_copy_bytes(ctypes.byref(_attn_params(*args,
                                                                    **kw)))


def _attn_params(q, k, v, out, *, num_heads, dq, dv, q_hs, k_hs, v_hs, o_hs,
                 qscale=None, kbias=None, hbias=None, logit_scale=1.0,
                 probs=None, seed=None, drop=None, mask_heads=None, lse=None):
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
        mask_heads=mask_heads)
    return p


def attention_keep(seed, drop, shape, mask_heads):
    """The keep bits (B, H, Nq, Nk) of `attention`'s dropout: keyed (seed,
    site, z // mask_heads, z % mask_heads, row, key) for z = b * H + h."""
    Z = shape[0] * shape[1]
    return counter_keep(seed, drop[0], drop[1],
                        (Z // mask_heads, mask_heads, *shape[2:])).reshape(shape)


def attention_reference(q, k, v, out, *, num_heads, dq, dv, q_hs, k_hs, v_hs,
                        o_hs, qscale=None, kbias=None, hbias=None,
                        logit_scale=1.0, probs=None, seed=None, drop=None,
                        mask_heads=None, lse=None):
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
        p = torch.where(attention_keep(seed, drop, p.shape, mask_heads or H),
                        p * keep_scale(drop[1]), 0.0)
    o = p.to(_BF16).float() @ heads(v, v_hs, dv).float()
    heads(out, o_hs, dv).copy_(o.to(out.dtype))
    return out


def layernorm(x, weight, bias, eps, *, want_f32=True, want_bf16=False):
    """Row LayerNorm of (M, D) bf16/f32 rows -> (f32 or None, bf16 or None)."""
    _need(x, (_BF16, _F32), "x", 2)
    _need(weight, _F32, "weight", 1)
    _need(bias, _F32, "bias", 1)
    M, D = x.shape
    o32 = torch.empty((M, D), device=x.device, dtype=_F32) if want_f32 else None
    o16 = torch.empty((M, D), device=x.device, dtype=_BF16) if want_bf16 else None
    p = _LNParams(x=x.data_ptr(), g=weight.data_ptr(), b=bias.data_ptr(),
                  out_f32=_ptr(o32), out_bf16=_ptr(o16), M=M, ldx=x.stride(0),
                  D=D, x_f32=int(x.dtype == _F32), eps=float(eps))
    _check(lib().spe_layernorm(ctypes.byref(p), _stream()), "spe_layernorm")
    return o32, o16


def layernorm_reference(x, weight, bias, eps, *, want_f32=True,
                        want_bf16=False):
    """Plain PyTorch version of `layernorm` (F.layer_norm in f32)."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight, bias, eps)
    return (y if want_f32 else None), (y.to(_BF16) if want_bf16 else None)


def colsum(v):
    """(B, N, C) bf16 view -> (B, C) f32 column sums over N."""
    _need(v, _BF16, "v", 3)
    B, N, C = v.shape
    out = torch.empty((B, C), device=v.device, dtype=_F32)
    p = _ColsumParams(v=v.data_ptr(), out=out.data_ptr(), sb=v.stride(0),
                      sn=v.stride(1), B=B, N=N, C=C)
    _check(lib().spe_colsum(ctypes.byref(p), _stream()), "spe_colsum")
    return out


def colsum_reference(v):
    """Plain PyTorch version of `colsum`."""
    return v.float().sum(1)


def th_mix(pv, csum, ww, bw):
    """Talking-heads post-softmax mix. pv: (B, N, H, D) f32 (P_g V per mixed
    head g); csum: (B, D) f32; ww: (H, H) f32 torch Linear layout; bw: (H,)
    f32 -> (B, N, D) bf16."""
    _need(pv, _F32, "pv", 4)
    if not pv.is_contiguous():
        raise ValueError("pv must be contiguous")
    B, N, H, D = pv.shape
    _need(csum, _F32, "colsum", 2)
    _need(ww, _F32, "ww", 2)
    _need(bw, _F32, "bw", 1)
    if tuple(csum.shape) != (B, D) or tuple(ww.shape) != (H, H) or \
            bw.shape[0] != H or not ww.is_contiguous():
        raise ValueError("th_mix operand shapes disagree")
    out = torch.empty((B, N, D), device=pv.device, dtype=_BF16)
    p = _MixParams(pv=pv.data_ptr(), colsum=csum.data_ptr(), ww=ww.data_ptr(),
                   bw=bw.data_ptr(), out=out.data_ptr(), rows=B * N, N=N, H=H,
                   D=D)
    _check(lib().spe_th_mix(ctypes.byref(p), _stream()), "spe_th_mix")
    return out


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
                       max_iters=int(max_iters), eps=float(eps),
                       benefit_in_smem=0)
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
    p = _GemmParams(
        a=a.data_ptr(), b=b.data_ptr(), c=c.data_ptr(), act_aux=_ptr(act_aux),
        seed=_ptr(seed), a_s1=a_str[0], a_s2=a_str[1], a_sm=a_str[2],
        a_sk=a_str[3], b_s1=b_str[0], b_s2=b_str[1], b_sk=b_str[2],
        b_sn=b_str[3], c_s1=c_str[0], c_s2=c_str[1], c_sm=c_str[2],
        c_sn=c_str[3], ld_aux=act_aux.stride(0) if act_aux is not None else 0,
        rps=rows_per_sample, kmax=depth, M=M, N=N, K=K, nb1=nb1, nb2=nb2,
        a_f32=int(a.dtype == _F32), b_f32=int(b.dtype == _F32),
        c_f32=int(c.dtype == _F32), split=int(split_k is not None),
        alpha=float(alpha), drop_site=dsite, drop_thr=dthr, drop_scale=dscale,
        act_grad=1 if gelu_aux is not None else 2, cgrp=grp,
        cgstride=col_stride, accumulate=int(accumulate))
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
    return out


def reduce_sum_reference(parts, round_bf16=False):
    """Plain PyTorch version of `reduce_sum`."""
    s = parts.sum(0)
    return s.to(_BF16).float() if round_bf16 else s


ROW_CHUNK = 512   # rows per partial of a weight gradient


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
    of ROW_CHUNK in one batched launch, then reduce_sum."""
    _need(dy, (_BF16, _F32), "dy", 2)
    _need(x, (_BF16, _F32), "x", 2)
    M, N = dy.shape
    K = x.shape[1]
    if x.shape[0] != M:
        raise ValueError("dy and x must have the same rows")
    Z = -(-M // ROW_CHUNK)
    chunk = -(-M // Z)
    parts = torch.empty((Z, N, K), device=dy.device, dtype=_F32)
    ly, lx = dy.stride(0), x.stride(0)
    gemm(dy, x, parts, M=N, N=K, K=chunk, a_str=(chunk * ly, 0, 1, ly),
         b_str=(chunk * lx, 0, lx, 1), c_str=(N * K, 0, K, 1), nb=(Z, 1),
         split_k=M)
    return reduce_sum(parts, round_bf16)


def colsum_f32(x):
    """(M, C) f32 rows -> (C,) column sums (chunks of 256 rows, then
    reduce_sum)."""
    _need(x, _F32, "x", 2)
    M, C = x.shape
    chunk = 256
    Z = -(-M // chunk)
    parts = torch.empty((Z, C), device=x.device, dtype=_F32)
    p = _ColsumF32Params(x=x.data_ptr(), parts=parts.data_ptr(), M=M,
                         ld=x.stride(0), chunk=chunk, C=C, Z=Z)
    _check(lib().spe_colsum_f32(ctypes.byref(p), _stream()), "spe_colsum_f32")
    return reduce_sum(parts)


def colsum_f32_reference(x):
    """Plain PyTorch version of `colsum_f32`."""
    return x.sum(0)


LN_ROWS = 32   # rows per block of spe_ln_backward / spe_branch_backward


def ln_backward(dy, x, weight, eps, *, res=None, out_dtype=_F32):
    """LayerNorm backward of (M, D) rows: dy f32, x the LayerNorm's input
    (bf16/f32), weight f32 -> (dx (+ res) in out_dtype, dweight, dbias)."""
    _need(dy, _F32, "dy", 2)
    _need(x, (_BF16, _F32), "x", 2)
    _need(weight, _F32, "weight", 1)
    M, D = x.shape
    if tuple(dy.shape) != (M, D) or weight.shape[0] != D:
        raise ValueError("dy, x and weight disagree")
    if res is not None:
        _need(res, _F32, "res", 2)
        if tuple(res.shape) != (M, D):
            raise ValueError("res must match x")
    dx = torch.empty((M, D), device=x.device, dtype=out_dtype)
    blocks = -(-M // LN_ROWS)
    parts = torch.empty((blocks, 2, D), device=x.device, dtype=_F32)
    p = _LNBwdParams(dy=dy.data_ptr(), x=x.data_ptr(), g=weight.data_ptr(),
                     res=_ptr(res), dx=dx.data_ptr(), parts=parts.data_ptr(),
                     M=M, ld_dy=dy.stride(0), ld_x=x.stride(0),
                     ld_res=res.stride(0) if res is not None else 0, D=D,
                     x_f32=int(x.dtype == _F32), dx_f32=int(out_dtype == _F32),
                     eps=float(eps))
    _check(lib().spe_ln_backward(ctypes.byref(p), _stream()), "spe_ln_backward")
    dwb = reduce_sum(parts)
    return dx, dwb[0], dwb[1]


def ln_backward_reference(dy, x, weight, eps, *, res=None, out_dtype=_F32):
    """Plain PyTorch version of `ln_backward` (refmath's LayerNorm
    backward, then the residual and the output type)."""
    dx, dw, db = ln_backward_rows(dy, x, weight, eps)
    return (dx + (res if res is not None else 0.0)).to(out_dtype), dw, db


def branch_backward(dres, val, gamma, *, seed=None, drop=None, path=None,
                    rows_per_sample=1):
    """The residual branch `x + dp * gamma * val`, val = drop(y) (M, D) f32:
    -> (dy = drop(dres * dp * gamma) f32, dgamma = sum dres * dp * val).
    Without gamma it counts as 1; without val no dgamma is summed (None)."""
    _need(dres, _F32, "dres", 2)
    M, D = dres.shape
    for t, n in ((val, "val"), (gamma, "gamma")):
        if t is not None:
            _need(t, _F32, n)
    for t in (dres, val):
        if t is not None and (tuple(t.shape) != (M, D) or
                              not t.is_contiguous()):
            raise ValueError("dres and val must be contiguous (M, D)")
    if gamma is not None and tuple(gamma.shape) != (D,):
        raise ValueError(f"gamma must have {D} entries")
    dsite, dthr, dscale = _site(drop)
    psite, pthr, pscale = _site(path)
    _need_seed(seed, dsite or psite, rows_per_sample, M)
    d = torch.empty((M, D), device=dres.device, dtype=_F32)
    blocks = -(-M // LN_ROWS)
    parts = None if val is None else torch.empty((blocks, D),
                                                 device=dres.device, dtype=_F32)
    p = _BranchBwdParams(dres=dres.data_ptr(), val=_ptr(val),
                         gamma=_ptr(gamma), seed=_ptr(seed),
                         d=d.data_ptr(), parts=_ptr(parts), M=M,
                         rps=rows_per_sample, D=D, drop_site=dsite,
                         drop_thr=dthr, drop_scale=dscale, path_site=psite,
                         path_thr=pthr, path_scale=pscale)
    _check(lib().spe_branch_backward(ctypes.byref(p), _stream()),
           "spe_branch_backward")
    return d, None if parts is None else reduce_sum(parts)


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


def th_fold(q, rows):
    """q (B, N, D) bf16 view (last dim contiguous), rows (H, D) f32 ->
    (B, H, N, D) bf16: bf16(q * rows[g])."""
    _need(q, _BF16, "q", 3)
    _need(rows, _F32, "rows", 2)
    B, N, D = q.shape
    H = rows.shape[0]
    if rows.shape[1] != D or not rows.is_contiguous():
        raise ValueError(f"rows must be ({H}, {D}) contiguous")
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


TH_NT = 256        # csrc/th_train.cu: threads of th_fwd_rows_kernel and
TH_BLOCKS = 1024   # th_bwd_rows_kernel, 4 columns each; at most TH_BLOCKS
                   # blocks


def _th_rows_domain(name, N):
    if N > 4 * TH_NT:
        raise ValueError(f"{name} takes rows of at most {4 * TH_NT} keys, "
                         f"got {N}")


def th_fwd_rows(s, bl, ww, bw, seed, rate, *, wl=None, site=SITE_ATTN):
    """Talking-heads training forward row pass over the logits s (B, H, N,
    N) f32 (without bl; with wl (H, H) each head's own logits, mixed as
    m_g = sum_h wl[g, h] s_h): -> (lse (B, H, N) f32 of the mixed logits +
    bl, zd (B, H, N, N) bf16 = drop(sum_h ww[g, h] softmax_h + bw_g)), the
    mask keyed (seed, site, b, g, row, key). Takes N <= 4 * TH_NT."""
    B, H, N, _ = s.shape
    params = _th_row_params(s, bl, ww, bw, seed, rate, wl, site)
    _th_rows_domain("th_fwd_rows", N)
    lse = torch.empty((B, H, N), device=s.device, dtype=_F32)
    zd = torch.empty(s.shape, device=s.device, dtype=_BF16)
    p = _THRowParams(**params, lse=lse.data_ptr(), zd=zd.data_ptr())
    _check(lib().spe_th_rows(ctypes.byref(p), 0, _stream()), "spe_th_rows")
    th_fwd_rows.launches += 1
    return lse, zd


th_fwd_rows.launches = 0


def th_bwd_blocks(B, N):
    """The blocks of th_bwd_rows_kernel (rows of parts) for B * N rows: a
    function of the shape alone, so the partial sums' order is fixed."""
    rows = B * N
    per = -(-rows // TH_BLOCKS)
    return -(-rows // per)


def th_bwd_rows(s, lse, dzd, bl, ww, bw, seed, rate, *, wl=None,
                site=SITE_ATTN):
    """Talking-heads backward row pass: -> (zd bf16, ds bf16 (B, H, N, N),
    dww (H, H), dbw (H,), dbl (H,) f32). With wl (see th_fwd_rows) ds holds
    dL_h = sum_g wl[g, h] dm_g, and dwl (H, H) f32 is returned last.
    Takes N <= 4 * TH_NT."""
    B, H, N, _ = s.shape
    _need(lse, _F32, "lse", 3)
    _need(dzd, _F32, "dzd", 4)
    if tuple(lse.shape) != (B, H, N) or dzd.shape != s.shape or \
            not (lse.is_contiguous() and dzd.is_contiguous()):
        raise ValueError("lse (B, H, N) and dzd (B, H, N, N) must be contiguous")
    _th_rows_domain("th_bwd_rows", N)
    zd = torch.empty(s.shape, device=s.device, dtype=_BF16)
    ds = torch.empty(s.shape, device=s.device, dtype=_BF16)
    width = (2 if wl is not None else 1) * H * H + 2 * H
    parts = torch.empty((th_bwd_blocks(B, N), width), device=s.device,
                        dtype=_F32)
    p = _THRowParams(**_th_row_params(
        s, bl, ww, bw, seed, rate, wl, site, dzd=dzd.data_ptr(),
        lse=lse.data_ptr(), zd=zd.data_ptr(), ds=ds.data_ptr(),
        parts=parts.data_ptr()))
    _check(lib().spe_th_rows(ctypes.byref(p), 1, _stream()), "spe_th_rows")
    th_bwd_rows.launches += 1
    sums = reduce_sum(parts)
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


def th_dq(dqt, q, rows, scale, out):
    """dQ = sum_g dqt[:, g] * rows[g] into `out` (B, N, D) f32 view, from
    dqt (B, H, N, D) f32; returns dwl (H, H) f32, [g, h] = scale *
    sum q_h * dqt_g[head h columns]."""
    _need(dqt, _F32, "dqt", 4)
    _need(q, _BF16, "q", 3)
    _need(rows, _F32, "rows", 2)
    _need(out, _F32, "out", 3)
    B, H, N, D = dqt.shape
    if not dqt.is_contiguous() or tuple(q.shape) != (B, N, D) or \
            tuple(out.shape) != (B, N, D) or tuple(rows.shape) != (H, D):
        raise ValueError("th_dq operand shapes disagree")
    parts = torch.empty((B * N, H, H), device=dqt.device, dtype=_F32)
    p = _THDqParams(dqt=dqt.data_ptr(), q=q.data_ptr(), rows=rows.data_ptr(),
                    dq=out.data_ptr(), parts=parts.data_ptr(),
                    q_sb=q.stride(0), q_sn=q.stride(1), o_sb=out.stride(0),
                    o_sn=out.stride(1), B=B, H=H, N=N, D=D, scale=float(scale))
    _check(lib().spe_th_dq(ctypes.byref(p), _stream()), "spe_th_dq")
    return reduce_sum(parts)


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
                       mask_heads=None):
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
                       mask_heads=H if mask_heads is None else mask_heads)
    _check(lib().spe_attn_bwd_rows(ctypes.byref(p), _stream()),
           "spe_attn_bwd_rows")
    attention_bwd_rows.launches += 1
    return zd, dl


attention_bwd_rows.launches = 0


def attention_bwd_rows_reference(s, dzd, lse, kbias, seed, drop, *,
                                 num_heads, mask_heads=None):
    """Plain PyTorch version of `attention_bwd_rows` (same arguments, same
    outputs)."""
    if kbias is not None:
        s = s + kbias[:, None, None, :]
    p = torch.exp(s - lse[..., None])
    keep = torch.ones(s.shape, dtype=torch.bool, device=s.device)
    sc = 1.0
    if drop is not None and drop[1] > 0:
        keep = attention_keep(seed, drop, s.shape, mask_heads or num_heads)
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
                       drop=None, mask_heads=None, split=None):
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
                                mask_heads=mask_heads)
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
