"""The Python side of each fused layer's CUDA path (`_forward_cuda`,
`_train_cuda`, `_backward_cuda` and the autograd Function's save and
restore: the views, strides, head strides, head-interleaved stores and
their two-plane gradients, residual/LN wiring, in-place accumulation and
dropout sites and keys it hands the kernels) run on the CPU against torch
emulations of the C entry points,
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

from spe_tpu_torch.ops import kernels as K
from spe_tpu_torch.ops.kernels import (_path_factor, attention_keep,
                                       attention_reference, gemm_reference,
                                       ln_linear_reference, row_keep,
                                       th_bwd_rows_reference,
                                       th_fwd_rows_reference)
from spe_tpu_torch.ops.kernel_checks import (attention_cases, backward_args,
                                             bf16_tol, flat_grads, grad_tols,
                                             kernel_cases, max_err,
                                             plain_train, saved_outputs,
                                             train_cases)
from spe_tpu_torch.ops.refmath import keep_scale, ln_backward_reference

BF16 = torch.bfloat16


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
    d = dres * dp * (gamma if gamma is not None else 1.0)
    if drop is not None and drop[1] > 0:
        d = torch.where(row_keep(seed, drop, M, D, rows_per_sample),
                        d * keep_scale(drop[1]), 0.0)
    return d, None if val is None else (dres * dp * val).sum(0)


def th_fold(q, rows):
    return (q.float()[:, None] * rows[None, :, None, :]).to(BF16)


def th_dq(dqt, q, rows, scale, out):
    B, H, N, D = dqt.shape
    out.copy_((dqt * rows[None, :, None, :]).sum(1))
    qdq = q.float()[:, None] * dqt
    return scale * qdq.reshape(B, H, N, H, D // H).sum((0, 2, 4))


def softmax_backward(probs, dp, dattn=None):
    d = dp + (dattn if dattn is not None else 0.0)
    return (probs * (d - (d * probs).sum(-1, keepdim=True))).to(BF16)


def attention_bwd_rows(s, dzd, lse, kbias, seed, drop, *, num_heads,
                       mask_heads=None):
    if kbias is not None:
        s = s + kbias[:, None, None, :]
    p = torch.exp(s - lse[..., None])
    keep = torch.ones(s.shape, dtype=torch.bool)
    sc = 1.0
    if drop is not None and drop[1] > 0:
        keep = attention_keep(seed, drop, s.shape, mask_heads or num_heads)
        sc = keep_scale(drop[1])
    dp = torch.where(keep, dzd * sc, 0.0)
    return (torch.where(keep, p * sc, 0.0).to(BF16),
            (p * (dp - (dp * p).sum(-1, keepdim=True))).to(BF16))


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
    for fn in (layernorm, colsum, th_mix, reduce_sum, colsum_f32,
               ln_backward, branch_backward, th_fold, th_dq, softmax_backward,
               attention_bwd_rows):
        monkeypatch.setattr(K, fn.__name__, fn)
    # the product kernels' and th_*_rows' plain versions live beside them
    for name, fn in (("attention", attention_reference),
                     ("gemm", gemm_reference),
                     ("ln_linear", ln_linear_reference),
                     ("th_fwd_rows", th_fwd_rows_reference),
                     ("th_bwd_rows", th_bwd_rows_reference)):
        monkeypatch.setattr(K, name, fn)


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


TRAIN = dict(B=2, N=40, t=5, S=2, Q=6, device="cpu")
WRAPPERS = {"pallas_block": "fused_layer_scale_block",
            "pallas_ca_block": "fused_class_attn_block",
            "pallas_encoder": "fused_encoder_layer",
            "pallas_decoder": "fused_decoder_layer"}


@pytest.mark.parametrize("case", range(5))
def test_cuda_train_path_wiring(emulated, case):
    """`_train_cuda` (the block at the recipe's dropout rates, class
    attention, the encoder and both decoder parameter sets at the recipe's
    `dropout`) against the plain training forward: every output it saves
    too."""
    name, mod, args, _ = train_cases(**TRAIN)[case]
    with torch.no_grad():
        got = mod._train_cuda(*args)
        want = plain_train(name, mod)[0](*args)
    assert max_err(got[0], want[0]) <= bf16_tol(want[0], ulps=2), name
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert max_err(g, w) <= bf16_tol(w, ulps=2), name


def _leaf(t):
    return t.clone().requires_grad_() if t.is_floating_point() else t


@pytest.mark.parametrize("case", range(5))
def test_cuda_function_wiring(emulated, monkeypatch, case):
    """The autograd Function down its CUDA branch (forward, save, restore,
    backward) against `*_backward_reference` on the same cotangents and
    the tensors `_train_cuda` saves (a ReLU mask turns a one-ulp change of
    a saved tensor into a different gradient), with the launch counters
    moving once per direction."""
    name, mod, args, cot = train_cases(**TRAIN)[case]
    monkeypatch.setattr(mod, "_plain", lambda t: False)
    fn = getattr(mod, WRAPPERS[name])
    before = (fn.train_launches, fn.bwd_launches)
    i = next(j for j, a in enumerate(args) if isinstance(a, dict))
    inputs = [_leaf(a) if isinstance(a, torch.Tensor) else a
              for a in args[:i]]
    leaves = {k: v.clone().requires_grad_() for k, v in args[i].items()}
    out = fn(*inputs, leaves, *args[i + 1:])
    outs = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(list(outs), list(cot)[:len(outs)])
    with torch.no_grad():
        saved = saved_outputs(name, mod._train_cuda(*args))
        want = flat_grads(name, plain_train(name, mod)[1](
            *backward_args(args, saved, cot)))
    got = dict(zip(want, [t.grad for t in inputs
                          if isinstance(t, torch.Tensor) and t.requires_grad]))
    got.update(flat_grads(name, (*got.values(),
                                 {k: v.grad for k, v in leaves.items()})))
    assert (fn.train_launches, fn.bwd_launches) == (before[0] + 1,
                                                    before[1] + 1)
    tols = grad_tols(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, (name, k)
        assert max_err(got[k], w) <= tols[k], (name, k)


ATTN = dict(B=2, N=40, t=5, S=2, Q=6, device="cpu")
ATTN_WRAPPERS = {"pallas_mha": "fused_mha",
                 "pallas_attention": "talking_heads_attention"}


@pytest.mark.parametrize("case", range(4))
def test_attention_cuda_path_wiring(emulated, case):
    """The standalone attentions' `_forward_cuda` (rate 0) and
    `_train_cuda` (the recipe's rates) against their plain versions: the
    class attention with its probabilities, the encoder self-attention and
    the decoder cross-attention (q/k heads twice v's) with a padded-key
    mask, and the talking-heads attention with its mixes in f32."""
    name, _, mod, args, _, label = attention_cases(**ATTN)[case]
    plain = attention_cases(**ATTN, train=False)[case][3]
    fwd, _ = plain_train(name, mod)
    # the eval forwards take the arguments without the dropout slot
    eval_args = plain[:5] + plain[6:] if name == "pallas_mha" else plain[:-1]
    with torch.no_grad():
        got = mod._forward_cuda(*eval_args)
        want = (mod.fused_mha_reference(*plain) if name == "pallas_mha" else
                mod.talking_heads_reference(*plain))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert max_err(got[0], want[0]) <= bf16_tol(want[0], ulps=2), label
        for g, w in zip(got[1:], want[1:]):
            assert max_err(g, w) <= 1e-5, label
        got, want = mod._train_cuda(*args), fwd(*args)
    assert max_err(got[0], want[0]) <= bf16_tol(want[0], ulps=2), label
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and g.shape == w.shape, label
        assert max_err(g, w) <= 1e-5, label


@pytest.mark.parametrize("case", range(4))
def test_attention_cuda_function_wiring(emulated, monkeypatch, case):
    """MHAFn and TalkingHeadsFn down their CUDA branches (forward, save,
    restore, backward) against the hand-derived backward on the same
    cotangent and saved log-sum-exps, the launch counters moving once per
    direction."""
    name, _, mod, args, cot, label = attention_cases(**ATTN, train=True)[case]
    monkeypatch.setattr(mod, "_plain", lambda t: False)
    fn = getattr(mod, ATTN_WRAPPERS[name])
    before = (fn.train_launches, fn.bwd_launches)
    inputs = [_leaf(a) for a in args[:3]]
    params = args[3]
    if name == "pallas_attention":
        params = {k: v.clone().requires_grad_() for k, v in args[3].items()}
    out = fn(*inputs, params, *args[4:])
    out = out[0] if isinstance(out, tuple) else out
    out.backward(cot[0])
    with torch.no_grad():
        saved = saved_outputs(name, mod._train_cuda(*args))
        want = flat_grads(name, plain_train(name, mod)[1](
            *backward_args(args, saved, cot)))
    got = {"dq": inputs[0].grad, "dk": inputs[1].grad, "dv": inputs[2].grad}
    if name == "pallas_attention":
        got.update({k: v.grad for k, v in params.items()})
    assert (fn.train_launches, fn.bwd_launches) == (before[0] + 1,
                                                    before[1] + 1), label
    tols = grad_tols(want)
    assert set(got) == set(want), label
    for k, w in want.items():
        assert got[k].dtype == w.dtype, (label, k)
        assert max_err(got[k], w) <= tols[k], (label, k)
