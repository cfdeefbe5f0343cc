"""The Python side of each fused layer's CUDA path (`_forward_cuda`, and
for the backbone blocks `_train_cuda`, `_backward_cuda` and the autograd
Function's save and restore: the views, strides, head strides,
head-interleaved stores, residual/LN wiring and dropout sites it hands the
kernels) run on the CPU against torch emulations of the C entry points,
which follow the contract the wrappers in spe_tpu_torch/ops/kernels.py
document. This checks the wiring, not the kernels: the kernels themselves
run only on the card (tests/test_torch_cuda.py, chip_smoke.py). Forward
outputs are held to 2 bf16 ulps of the plain versions; backward
gradients to kernel_checks.grad_tols, 1% of each gradient's largest
magnitude (the emulations round like the kernels, but sum in other
orders)."""

import pytest
import torch
import torch.nn.functional as F

from spe_tpu_torch.ops import fused_block, fused_ca_block
from spe_tpu_torch.ops import kernels as K
from spe_tpu_torch.ops.kernel_checks import (bf16_tol, grad_tol, grad_tols,
                                             kernel_cases, max_err,
                                             train_cases)
from spe_tpu_torch.ops.refmath import (counter_keep, gelu_tanh_grad,
                                       keep_scale, ln_backward_reference,
                                       path_keep)

BF16 = torch.bfloat16


def _row_keep(seed, spec, M, N, rps):
    site, rate = spec
    return counter_keep(seed, site, rate, (M // rps, 1, rps, N)).reshape(M, N)


def _path_factor(seed, spec, M, rps):
    keep = path_keep(seed, spec[0], spec[1], M // rps)
    return torch.where(keep, keep_scale(spec[1]), 0.0).repeat_interleave(
        rps)[:, None]


def ln_linear(a, w, bias=None, *, ln=None, a2=None, act="none", res=None,
              gamma=None, out_dtype=BF16, out=None, col_group=None,
              col_stride=None, seed=None, drop=None, path=None,
              rows_per_sample=1, aux=None, aux_pre=False):
    x = a.float() + (a2.float() if a2 is not None else 0.0)
    if ln is not None:
        x = F.layer_norm(x, (x.shape[-1],), ln[0], ln[1], ln[2])
    y = x.to(BF16).float() @ w.float().T
    if bias is not None:
        y = y + bias
    if aux is not None and aux_pre:
        aux.copy_(y)
    y = {"none": y, "gelu": F.gelu(y, approximate="tanh"),
         "relu": torch.relu(y)}[act]
    M, N = y.shape
    if drop is not None and drop[1] > 0:
        y = torch.where(_row_keep(seed, drop, M, N, rows_per_sample),
                        y * keep_scale(drop[1]), 0.0)
    if aux is not None and not aux_pre:
        aux.copy_(y)
    if res is not None:
        dp = 1.0
        if path is not None and path[1] > 0:
            dp = _path_factor(seed, path, M, rows_per_sample)
        y = res.float() + dp * (gamma if gamma is not None else 1.0) * y
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


def gemm(a, b, c, *, M, N, K, a_str, b_str, c_str, nb=(1, 1), alpha=1.0,
         split_k=None, seed=None, drop=None, rows_per_sample=1,
         gelu_aux=None):
    def view(t, st, sizes):
        return t.as_strided(sizes, st, t.storage_offset()).float().to(
            BF16).float()

    nb1, nb2 = nb
    if split_k is None:
        y = view(a, a_str, (nb1, nb2, M, K)) @ view(b, b_str, (nb1, nb2, K, N))
    else:
        A, Bm = view(a, a_str[2:], (M, split_k)), view(b, b_str[2:], (split_k, N))
        y = torch.stack([A[:, z * K:(z + 1) * K] @ Bm[z * K:(z + 1) * K]
                         for z in range(nb1)])[:, None]
    y = alpha * y
    if drop is not None and drop[1] > 0:
        y = torch.where(_row_keep(seed, drop, M, N, rows_per_sample),
                        y * keep_scale(drop[1]), 0.0)
    if gelu_aux is not None:
        y = y * gelu_tanh_grad(gelu_aux)
    c.as_strided((nb1, nb2, M, N), c_str, c.storage_offset()).copy_(y)
    return c


def reduce_sum(parts, round_bf16=False):
    s = parts.sum(0)
    return s.to(BF16).float() if round_bf16 else s


def colsum_f32(x):
    return x.sum(0)


def ln_backward(dy, x, weight, eps, *, res=None, out_dtype=torch.float32):
    dx, dw, db = ln_backward_reference(dy, x, weight, eps)
    return (dx + (res if res is not None else 0.0)).to(out_dtype), dw, db


def branch_backward(dres, val, gamma, *, seed=None, drop=None, path=None,
                    rows_per_sample=1):
    M, D = dres.shape
    dp = 1.0
    if path is not None and path[1] > 0:
        dp = _path_factor(seed, path, M, rows_per_sample)
    d = dres * dp * gamma
    if drop is not None and drop[1] > 0:
        d = torch.where(_row_keep(seed, drop, M, D, rows_per_sample),
                        d * keep_scale(drop[1]), 0.0)
    return d, (dres * dp * val).sum(0)


def th_fold(q, rows):
    return (q.float()[:, None] * rows[None, :, None, :]).to(BF16)


def _th_probs(s, lse, bl, ww, bw, seed, rate):
    s = s + bl[None, :, None, None]
    lse = torch.logsumexp(s, -1) if lse is None else lse
    pr = torch.exp(s - lse[..., None])
    z = torch.einsum("bhqk,gh->bgqk", pr, ww) + bw[None, :, None, None]
    keep = counter_keep(seed, 1, rate, s.shape) if rate > 0 else \
        torch.ones(s.shape, dtype=torch.bool)
    sc = keep_scale(rate)
    return lse, pr, keep, sc, torch.where(keep, z * sc, 0.0)


def th_fwd_rows(s, bl, ww, bw, seed, rate):
    lse, _, _, _, zd = _th_probs(s, None, bl, ww, bw, seed, rate)
    return lse, zd.to(BF16)


def th_bwd_rows(s, lse, dzd, bl, ww, bw, seed, rate):
    _, pr, keep, sc, zd = _th_probs(s, lse, bl, ww, bw, seed, rate)
    dz = torch.where(keep, dzd * sc, 0.0)
    dp = torch.einsum("bgqk,gh->bhqk", dz, ww)
    ds = pr * (dp - (dp * pr).sum(-1, keepdim=True))
    return (zd.to(BF16), ds.to(BF16), torch.einsum("bhqk,bgqk->gh", pr, dz),
            dz.sum((0, 2, 3)), ds.sum((0, 2, 3)))


def th_dq(dqt, q, rows, scale, out):
    B, H, N, D = dqt.shape
    out.copy_((dqt * rows[None, :, None, :]).sum(1))
    qdq = q.float()[:, None] * dqt
    return scale * qdq.reshape(B, H, N, H, D // H).sum((0, 2, 4))


def softmax_backward(probs, dp, dattn=None):
    d = dp + (dattn if dattn is not None else 0.0)
    return (probs * (d - (d * probs).sum(-1, keepdim=True))).to(BF16)


def _check_but_device(t, dtype, name, ndim=None):
    """kernels._need without the device test."""
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims")
    if t.dim() and t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in its last dim")


@pytest.fixture
def emulated(monkeypatch):
    # the wrappers built on other wrappers (matmul_dx, grad_weight) run for
    # real, their checks without the device test
    monkeypatch.setattr(K, "_need", _check_but_device)
    for fn in (ln_linear, attention, layernorm, colsum, th_mix, gemm,
               reduce_sum, colsum_f32, ln_backward, branch_backward, th_fold,
               th_fwd_rows, th_bwd_rows, th_dq, softmax_backward):
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


@pytest.mark.parametrize("case", range(2))
def test_cuda_train_path_wiring(emulated, case):
    """`_train_cuda` (block at the recipe's dropout rates; class attention)
    against the plain training forward: every output it saves too."""
    name, mod, args, _ = train_cases(B=2, N=40, t=5, device="cpu")[case]
    with torch.no_grad():
        got = mod._train_cuda(*args)
        want = getattr(mod, {"pallas_block": "layer_scale_block_train_reference",
                             "pallas_ca_block": "class_attn_block_train_reference"}[name])(*args)
    assert max_err(got[0], want[0]) <= bf16_tol(want[0], ulps=2), name
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert max_err(g, w) <= bf16_tol(w, ulps=2), name


@pytest.mark.parametrize("case", range(2))
def test_cuda_function_wiring(emulated, monkeypatch, case):
    """The autograd Function down its CUDA branch (forward, save, restore,
    backward) against `*_backward_reference` on the same cotangents, with
    the launch counters moving once per direction."""
    name, mod, args, cot = train_cases(B=2, N=40, t=5, device="cpu")[case]
    monkeypatch.setattr(mod, "_plain", lambda t: False)
    fn = {"pallas_block": fused_block.fused_layer_scale_block,
          "pallas_ca_block": fused_ca_block.fused_class_attn_block}[name]
    before = (fn.train_launches, fn.bwd_launches)
    if name == "pallas_block":
        x, p, H, drop = args
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        xt = x.clone().requires_grad_()
        out = fn(xt, leaves, H, drop)
        out.backward(cot[0])
        ref = fused_block.layer_scale_block_train_reference(x, p, H, drop)
        dx, g = fused_block.layer_scale_block_backward_reference(
            cot[0], x, *ref[1:], p, H, drop)
        pairs = [(xt.grad, dx)]
    else:
        cls, x, p, H = args
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        ct, xt = cls.clone().requires_grad_(), x.clone().requires_grad_()
        out, attn = fn(ct, xt, leaves, H)
        torch.autograd.backward([out, attn], list(cot))
        ref = fused_ca_block.class_attn_block_train_reference(cls, x, p, H)
        dcls, dx, g = fused_ca_block.class_attn_block_backward_reference(
            cot[0], cot[1], cls, x, ref[1], ref[2], ref[3], p, H)
        pairs = [(ct.grad, dcls), (xt.grad, dx)]
    assert (fn.train_launches, fn.bwd_launches) == (before[0] + 1,
                                                    before[1] + 1)
    tols = grad_tols(g)
    for got, want in pairs:
        assert got.dtype == want.dtype
        assert max_err(got, want) <= grad_tol(want), name
    for k in mod.PARAM_NAMES:
        assert max_err(leaves[k].grad, g[k]) <= tols[k], (name, k)
