"""The Python side of each fused layer's CUDA path (`_forward_cuda`: the
views, strides, head strides, head-interleaved stores and residual/LN
wiring it hands the kernels) run on the CPU against torch emulations of
the five C entry points, which follow the contract the wrappers in
spe_tpu_torch/ops/kernels.py document. This checks the wiring, not the
kernels: the kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py). Held to 2 bf16 ulps of the plain versions."""

import pytest
import torch
import torch.nn.functional as F

from spe_tpu_torch.ops import kernels as K
from spe_tpu_torch.ops.kernel_checks import bf16_tol, kernel_cases, max_err

BF16 = torch.bfloat16


def ln_linear(a, w, bias=None, *, ln=None, a2=None, act="none", res=None,
              gamma=None, out_dtype=BF16, out=None, col_group=None,
              col_stride=None):
    x = a.float() + (a2.float() if a2 is not None else 0.0)
    if ln is not None:
        x = F.layer_norm(x, (x.shape[-1],), ln[0], ln[1], ln[2])
    y = x.to(BF16).float() @ w.float().T
    if bias is not None:
        y = y + bias
    y = {"none": y, "gelu": F.gelu(y, approximate="tanh"),
         "relu": torch.relu(y)}[act]
    if res is not None:
        y = res.float() + (gamma if gamma is not None else 1.0) * y
    M, N = y.shape
    if out is None:
        out = torch.empty((M, N), dtype=out_dtype)
    grp, stride = (col_group, col_stride) if col_group else (N, N)
    n = torch.arange(N)
    out[:, n // grp * stride + n % grp] = y.to(out.dtype)
    return out


def attention(q, k, v, out, *, num_heads, dq, dv, q_hs, k_hs, v_hs, o_hs,
              qscale=None, kbias=None, hbias=None, logit_scale=1.0,
              probs=None):
    B, H = q.shape[0], num_heads

    def heads(t, hs, d):
        return t.as_strided((B, H, t.shape[1], d),
                            (t.stride(0), hs, t.stride(1), 1),
                            t.storage_offset())

    qh = heads(q, q_hs, dq).float()
    if qscale is not None:
        qh = (qh * qscale[None, :, None, :]).to(BF16).float()
    s = qh @ heads(k, k_hs, dq).float().transpose(-1, -2) * logit_scale
    if kbias is not None:
        s = s + kbias[:, None, None, :]
    if hbias is not None:
        s = s + hbias[None, :, None, None]
    p = torch.softmax(s, dim=-1)
    heads(out, o_hs, dv).copy_((p @ heads(v, v_hs, dv).float()).to(out.dtype))
    if probs is not None:
        probs.copy_(p)
    return out


def layernorm(x, weight, bias, eps, *, want_f32=True, want_bf16=False):
    y = F.layer_norm(x.float(), (x.shape[-1],), weight, bias, eps)
    return (y if want_f32 else None), (y.to(BF16) if want_bf16 else None)


def colsum(v):
    return v.float().sum(1)


def th_mix(pv, csum, ww, bw):
    B, N, H, D = pv.shape
    dh = D // H
    mix = ww.repeat_interleave(dh, dim=0)                  # (D, H): row c -> head c // dh
    out = torch.einsum("bngc,cg->bnc", pv, mix) + bw.repeat_interleave(dh) * csum[:, None]
    return out.to(BF16)


@pytest.fixture
def emulated(monkeypatch):
    for fn in (ln_linear, attention, layernorm, colsum, th_mix):
        monkeypatch.setattr(K, fn.__name__, fn)


@pytest.mark.parametrize("case", range(5))
def test_cuda_path_wiring(emulated, case):
    import importlib

    name, _, fused, plain, args = kernel_cases(B=2, N=70, Q=11,
                                               device="cpu")[case]
    mod = importlib.import_module(fused.__module__)
    with torch.no_grad():
        got = mod._forward_cuda(*args)
        want = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert max_err(got[0], want[0]) <= bf16_tol(want[0], ulps=2), name
    for g, w in zip(got[1:], want[1:]):
        assert max_err(g, w) <= 1e-5, name
