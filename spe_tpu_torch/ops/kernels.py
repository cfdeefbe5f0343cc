"""Build, load and call the port's hand-written CUDA kernels.

The sources are `spe_tpu_torch/csrc/*.cu`, plain C entry points compiled
with nvcc for `sm_90a` into one shared library and loaded with ctypes. The
library is built at first use into `build/spe_tpu_torch/` at the root of
the checkout (listed in .gitignore); its file name carries a hash of the
sources, so an edited source is never served by a stale build.

Nothing here runs at import time: the CPU tests import every module of the
package, and no nvcc or card is needed until a wrapper is called on a CUDA
tensor.

Every wrapper checks device, dtype, shape and strides and raises on what the
kernel does not take; it allocates its outputs with torch.empty, launches on
torch.cuda.current_stream() and raises if the launch reports an error.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "spe_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

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


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is built already."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build never reads half a file
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
                ("ogrp", ctypes.c_int), ("ogstride", ctypes.c_int)]


class _AttnParams(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("q", "k", "v", "qscale", "kbias", "hbias", "out", "probs")]
                + [(n, ctypes.c_longlong) for n in
                   ("q_sb", "q_sn", "q_sh", "k_sb", "k_sn", "k_sh",
                    "v_sb", "v_sn", "v_sh", "o_sb", "o_sn", "o_sh", "kb_sb")]
                + [(n, ctypes.c_int) for n in ("B", "H", "Nq", "Nk")]
                + [("logit_scale", ctypes.c_float), ("out_f32", ctypes.c_int)])


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


def lib():
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(build()))
        for name, struct in (("spe_linear", _LinearParams),
                             ("spe_layernorm", _LNParams),
                             ("spe_colsum", _ColsumParams),
                             ("spe_th_mix", _MixParams)):
            fn = getattr(so, name)
            fn.argtypes = [ctypes.POINTER(struct), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        so.spe_attention.argtypes = [ctypes.POINTER(_AttnParams), ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
        so.spe_attention.restype = ctypes.c_int
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


def as_bf16(t):
    """A weight as the kernels read it: bf16, contiguous."""
    return t.to(_BF16).contiguous()


def as_f32(t):
    """A LayerNorm/bias/scale parameter as the kernels read it."""
    return t.to(_F32).contiguous()


def ln_linear(a, w, bias=None, *, ln=None, a2=None, act="none", res=None,
              gamma=None, out_dtype=_BF16, out=None, col_group=None,
              col_stride=None):
    """Y = act(LN?(a [+ a2]) @ w.T + bias), then `res + gamma * Y`.

    a: (M, K) bf16 or f32 rows (any row stride); a2: optional bf16 of a's
    layout, added in f32 before the bf16 rounding; ln: optional
    (weight, bias, eps) LayerNorm over K applied to the input rows;
    w: (N, K) bf16 contiguous (torch Linear layout); bias/gamma: f32 (N,);
    res: optional (M, N) bf16 or f32. out: optional preallocated (M, *)
    view; with col_group/col_stride output column n lands in column
    (n // col_group) * col_stride + n % col_group of `out` (the
    head-interleaved store of the conditional cross-attention)."""
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
    if col_group is None:
        col_group, col_stride = N, N
    if out is None:
        out = torch.empty((M, N), device=a.device, dtype=out_dtype)
    _need(out, (_BF16, _F32), "out", 2)
    width = (N - 1) // col_group * col_stride + (N - 1) % col_group + 1
    if out.shape[0] != M or out.shape[1] < width:
        raise ValueError(f"out {tuple(out.shape)} cannot hold {M} x {width}")
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
        ogrp=col_group, ogstride=col_stride)
    _check(lib().spe_linear(ctypes.byref(p), _stream()), "spe_linear")
    return out


def attention(q, k, v, out, *, num_heads, dq, dv, q_hs, k_hs, v_hs, o_hs,
              qscale=None, kbias=None, hbias=None, logit_scale=1.0,
              probs=None):
    """Online-softmax attention. q/k/v/out are (B, rows, cols) views, last dim
    contiguous; head h of each starts at column h * <x>_hs (0 = shared by
    every head) and is dq (q, k) or dv (v, out) wide. qscale: (H, dq) f32,
    q <- bf16(q * qscale[h]); kbias: (B, Nk) f32; hbias: (H,) f32;
    probs: optional (B, H, Nq, Nk) f32 output of the normalised
    probabilities."""
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
        out_f32=int(out.dtype == _F32))
    err = lib().spe_attention(ctypes.byref(p), dq, dv, _stream())
    _check(err, f"spe_attention(dq={dq}, dv={dv})")
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


def colsum(v):
    """(B, N, C) bf16 view -> (B, C) f32 column sums over N."""
    _need(v, _BF16, "v", 3)
    B, N, C = v.shape
    out = torch.empty((B, C), device=v.device, dtype=_F32)
    p = _ColsumParams(v=v.data_ptr(), out=out.data_ptr(), sb=v.stride(0),
                      sn=v.stride(1), B=B, N=N, C=C)
    _check(lib().spe_colsum(ctypes.byref(p), _stream()), "spe_colsum")
    return out


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
