"""The standalone attention kernels of the port on the CPU, where their
autograd Functions take the plain versions: fused_mha (B4,
spe_tpu_torch/ops/fused_mha.py) and the talking-heads attention (B5,
spe_tpu_torch/ops/talking_heads.py).

  * the plain forwards against the JAX package's kernels in interpret mode
    at rate 0, in f32 with inputs drawn by numpy from a seed: fused_mha in
    three flavours (a key-padding mask over Nk = 133 keys, not a multiple
    of the TPU's 128-key padding; q/k heads twice as wide as v heads, the
    conditional cross-attention; the probabilities as a second output, the
    class attention), talking_heads_attention (pallas_attention.py). Held
    to 1e-5 absolute (the probabilities 1e-6), the JAX package's own
    tolerance for fused_mha against its einsum (tests/test_pallas_mha.py);
  * gradients through MHAFn and TalkingHeadsFn against jax.grad through
    fused_mha and fused_talking_heads (interpret mode, rate 0): q, k, v
    and, for talking heads, wl, bl, ww and bw, at 2e-4 (the JAX package's
    fused_mha grad tolerance, test_pallas_mha.py);
  * both hand-derived backwards (the CUDA backwards' oracles) against torch
    autograd through the plain training forwards with counter masks at rate
    > 0: 1e-5 of each gradient's largest magnitude + 1e-5 (f32, two
    summation orders);
  * the new mask sites and keys, their kept share, the dispatch (no launch
    counted on the CPU) and the refusal of tensors that are neither on the
    CPU nor on the card.

Every JAX computation runs as one jitted call that is waited for before
anything else is dispatched (`_sync`). Every test runs under a time limit
of its own (LIMIT_S): past it the worker process dumps every thread's stack
and exits, so the test fails instead of holding the run.
"""

import faulthandler
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spe_tpu.ops.pallas_attention import talking_heads_attention as jax_th
from spe_tpu.ops.pallas_attention_bwd import fused_talking_heads
from spe_tpu.ops.pallas_mha import fused_mha as jax_mha
from spe_tpu_torch.ops import fused_mha, talking_heads
from spe_tpu_torch.ops.refmath import (SITE_MHA_ATTN, SITE_TH_ATTN,
                                       CounterDropout, counter_keep)

LIMIT_S = 240
B = 2


@pytest.fixture(autouse=True)
def _time_limit():
    faulthandler.dump_traceback_later(LIMIT_S, exit=True, file=sys.stderr)
    yield
    faulthandler.cancel_dump_traceback_later()


def _sync(fn, *args):
    """fn(*args) as one jitted JAX call, waited for before anything else is
    dispatched. The JAX package's Pallas kernels run in the threaded
    interpreter here, whose io_callbacks dispatch JAX work of their own;
    an eager dispatch from the test's thread while a kernel runs can
    deadlock the process (a JAX issue, ROADMAP §C)."""
    return jax.block_until_ready(jax.jit(fn)(*args))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(t):
    return t.detach().float().numpy()


def _flat(x):
    """(B, H, N, d) -> the port's (B, N, H*d)."""
    b, h, n, d = x.shape
    return np.ascontiguousarray(np.transpose(x, (0, 2, 1, 3)).reshape(b, n, h * d))


# (Nq, Nk, H, dq, dv, masked, return_attn)
MHA_FLAVOURS = {
    "key_mask": (12, 133, 2, 8, 8, True, False),
    "cross": (10, 40, 2, 16, 8, True, False),
    "probs": (5, 37, 2, 8, 8, False, True),
}


def _mha_inputs(rng, flavour):
    Nq, Nk, H, dq, dv, masked, ret = MHA_FLAVOURS[flavour]
    q = rng.normal(size=(B, H, Nq, dq)).astype(np.float32)
    k = rng.normal(size=(B, H, Nk, dq)).astype(np.float32)
    v = rng.normal(size=(B, H, Nk, dv)).astype(np.float32)
    mask = None
    if masked:   # none padded on sample 0, the last 9 keys on sample 1
        mask = np.arange(Nk)[None, :] >= np.array([[Nk], [Nk - 9]])
    return q, k, v, mask, H, ret


@pytest.mark.parametrize("flavour", sorted(MHA_FLAVOURS))
def test_mha_forward_matches_jax(rng, flavour):
    q, k, v, mask, H, ret = _mha_inputs(rng, flavour)
    want = _sync(lambda q, k, v: jax_mha(
        q, k, v, key_padding_mask=None if mask is None else jnp.asarray(mask),
        interpret=True, return_attn=ret),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = fused_mha.fused_mha_reference(
        _t(_flat(q)), _t(_flat(k)), _t(_flat(v)), H,
        None if mask is None else torch.from_numpy(mask), return_attn=ret)
    if ret:
        (want, want_p), (got, got_p) = want, got
        np.testing.assert_allclose(_np(got_p), np.asarray(want_p), atol=1e-6)
    np.testing.assert_allclose(_np(got), _flat(np.asarray(want)), atol=1e-5)


@pytest.mark.parametrize("flavour", sorted(MHA_FLAVOURS))
def test_mha_function_grads_match_jax(rng, flavour):
    """MHAFn (fused_mha with grad on) against jax.grad through the Pallas
    kernel's custom VJP; the probabilities carry no cotangent on either
    side."""
    q, k, v, mask, H, ret = _mha_inputs(rng, flavour)
    jm = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        out = jax_mha(q, k, v, key_padding_mask=jm, interpret=True,
                      return_attn=ret)
        return jnp.sum(jnp.sin(out[0] if ret else out))

    want = _sync(jax.grad(loss, argnums=(0, 1, 2)), jnp.asarray(q),
                 jnp.asarray(k), jnp.asarray(v))
    leaves = [_t(_flat(a)).requires_grad_() for a in (q, k, v)]
    before = (fused_mha.fused_mha.train_launches,
              fused_mha.fused_mha.bwd_launches)
    out = fused_mha.fused_mha(*leaves, H, None if mask is None
                              else torch.from_numpy(mask), return_attn=ret)
    if ret:
        out, probs = out
        assert not probs.requires_grad
    torch.sin(out).sum().backward()
    for name, t, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(_np(t.grad), _flat(np.asarray(w)),
                                   rtol=2e-4, atol=2e-4, err_msg=name)
    assert (fused_mha.fused_mha.train_launches,
            fused_mha.fused_mha.bwd_launches) == before


def _th_inputs(rng, N=16, H=4, dh=8):
    q, k, v = (rng.normal(size=(B, H, N, dh)).astype(np.float32)
               for _ in range(3))
    # the JAX layout (in x out); near-identity mixes keep every head visible
    wl = (np.eye(H) + 0.3 * rng.normal(size=(H, H))).astype(np.float32)
    ww = (np.eye(H) + 0.3 * rng.normal(size=(H, H))).astype(np.float32)
    bl, bw = (0.1 * rng.normal(size=(H,)).astype(np.float32)
              for _ in range(2))
    return q, k, v, wl, bl, ww, bw


def _th_params(wl, bl, ww, bw):
    """The port's parameters: the torch Linear layout (out x in)."""
    return {"proj_l.weight": _t(wl.T), "proj_l.bias": _t(bl),
            "proj_w.weight": _t(ww.T), "proj_w.bias": _t(bw)}


def test_talking_heads_forward_matches_jax(rng):
    q, k, v, wl, bl, ww, bw = _th_inputs(rng)
    H = q.shape[1]
    want = _sync(lambda *a: jax_th(*a, q_tile=8, interpret=True),
                 *(jnp.asarray(a) for a in (q, k, v, wl, bl, ww, bw)))
    got = talking_heads.talking_heads_reference(
        _t(_flat(q)), _t(_flat(k)), _t(_flat(v)), _th_params(wl, bl, ww, bw),
        H)
    np.testing.assert_allclose(_np(got), _flat(np.asarray(want)), atol=1e-5)


def test_talking_heads_function_grads_match_jax(rng):
    q, k, v, wl, bl, ww, bw = _th_inputs(rng)
    H = q.shape[1]

    def loss(q, k, v, wl, bl, ww, bw):
        y = fused_talking_heads(q, k, v, wl, bl, ww, bw, None, 8, True, 0.0)
        return jnp.sum(jnp.sin(y))

    want = _sync(jax.grad(loss, argnums=tuple(range(7))),
                 *(jnp.asarray(a) for a in (q, k, v, wl, bl, ww, bw)))
    leaves = [_t(_flat(a)).requires_grad_() for a in (q, k, v)]
    p = {n: t.requires_grad_() for n, t in _th_params(wl, bl, ww, bw).items()}
    out = talking_heads.talking_heads_attention(*leaves, p, H)
    torch.sin(out).sum().backward()
    for name, t, w in zip("qkv", leaves, want[:3]):
        np.testing.assert_allclose(_np(t.grad), _flat(np.asarray(w)),
                                   rtol=2e-4, atol=2e-4, err_msg=name)
    # the port's mixing matrices are the JAX ones transposed
    for name, w, transpose in (("proj_l.weight", want[3], True),
                               ("proj_l.bias", want[4], False),
                               ("proj_w.weight", want[5], True),
                               ("proj_w.bias", want[6], False)):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(p[name].grad), w.T if transpose else w,
                                   rtol=2e-4, atol=2e-4, err_msg=name)


def _close_rel(got, want, msg):
    tol = 1e-5 * float(want.abs().max()) + 1e-5
    assert float((got - want).abs().max()) <= tol, msg


def _seed(v=1234):
    return torch.tensor([v], dtype=torch.int32)


@pytest.mark.parametrize("flavour", sorted(MHA_FLAVOURS))
def test_mha_backward_reference_matches_autograd(rng, flavour):
    """At rate 0.1 with counter masks: the hand-derived backward against
    autograd through the plain training forward."""
    q, k, v, mask, H, ret = _mha_inputs(rng, flavour)
    mask = None if mask is None else torch.from_numpy(mask)
    drop = CounterDropout(_seed(), attn=0.1)
    leaves = [_t(_flat(a)).requires_grad_() for a in (q, k, v)]
    res = fused_mha.fused_mha_train_reference(*leaves, H, mask, drop, ret)
    out, lse = res[0], res[-1]
    dy = _t(rng.normal(size=tuple(out.shape)))
    out.backward(dy)
    got = fused_mha.fused_mha_backward_reference(
        dy, *(t.detach() for t in leaves), lse.detach(), H, mask, drop, ret)
    for name, g, t in zip("qkv", got, leaves):
        _close_rel(g, t.grad, name)


def test_talking_heads_backward_reference_matches_autograd(rng):
    q, k, v, wl, bl, ww, bw = _th_inputs(rng)
    H = q.shape[1]
    drop = CounterDropout(_seed(), attn=0.05)
    leaves = [_t(_flat(a)).requires_grad_() for a in (q, k, v)]
    p = {n: t.requires_grad_() for n, t in _th_params(wl, bl, ww, bw).items()}
    out, lse = talking_heads.talking_heads_train_reference(*leaves, p, H, drop)
    dy = _t(rng.normal(size=tuple(out.shape)))
    out.backward(dy)
    dq, dk, dv, g = talking_heads.talking_heads_backward_reference(
        dy, *(t.detach() for t in leaves), lse.detach(),
        {n: t.detach() for n, t in p.items()}, H, drop)
    for name, got, t in zip("qkv", (dq, dk, dv), leaves):
        _close_rel(got, t.grad, name)
    for name, t in p.items():
        _close_rel(g[name], t.grad, name)


def test_mask_sites_and_keys(rng):
    """B5's mask falls after the post-softmax mix, keyed (seed, TH_ATTN, b,
    g, q, k); B4's on the normalised probabilities, keyed (seed, MHA_ATTN,
    b, h, q, k). Each site draws its own bits, and the kept share is within
    4 sigma of 1 - rate."""
    seed = _seed(77)
    shape = (2, 4, 64, 96)
    th = counter_keep(seed, SITE_TH_ATTN, 0.05, shape)
    mha = counter_keep(seed, SITE_MHA_ATTN, 0.05, shape)
    assert SITE_TH_ATTN != SITE_MHA_ATTN
    assert not torch.equal(th, mha)
    for keep, rate in ((th, 0.05), (counter_keep(seed, SITE_MHA_ATTN, 0.1,
                                                  shape), 0.1)):
        share = float(keep.float().mean())
        sigma = (rate * (1 - rate) / keep.numel()) ** 0.5
        assert abs(share - (1 - rate)) <= 4 * sigma
    # a sample's and a head's bits do not depend on the rest of the call
    sub = counter_keep(seed, SITE_MHA_ATTN, 0.05, (1, 2, 64, 96))
    assert torch.equal(sub, mha[:1, :2])
    # the talking-heads forward drops exactly the masked mixed weights
    q, k, v, wl, bl, ww, bw = _th_inputs(rng, N=8, H=2, dh=4)
    p = _th_params(wl, bl, ww, bw)
    args = (_t(_flat(q)), _t(_flat(k)), _t(_flat(v)), p, 2)
    full = talking_heads.talking_heads_reference(*args)
    dropped = talking_heads.talking_heads_reference(
        *args, CounterDropout(seed, attn=0.5))
    assert not torch.allclose(full, dropped)


def test_dispatch_counts_no_launch_on_the_cpu(rng):
    q, k, v, mask, H, _ = _mha_inputs(rng, "key_mask")
    qt, kt, vt = (_t(_flat(a)) for a in (q, k, v))
    counters = [(f, (f.launches, f.train_launches, f.bwd_launches))
                for f in (fused_mha.fused_mha,
                          talking_heads.talking_heads_attention)]
    with torch.no_grad():
        got = fused_mha.fused_mha(qt, kt, vt, H, torch.from_numpy(mask))
        assert torch.equal(got, fused_mha.fused_mha_reference(
            qt, kt, vt, H, torch.from_numpy(mask)))
        dropped = fused_mha.fused_mha(qt, kt, vt, H, torch.from_numpy(mask),
                                      CounterDropout(_seed(), attn=0.1))
        assert not torch.allclose(got, dropped)
    tq, tk, tv, wl, bl, ww, bw = _th_inputs(rng, N=8, H=2, dh=4)
    with torch.no_grad():
        talking_heads.talking_heads_attention(
            _t(_flat(tq)), _t(_flat(tk)), _t(_flat(tv)),
            _th_params(wl, bl, ww, bw), 2)
    for f, before in counters:
        assert (f.launches, f.train_launches, f.bwd_launches) == before


def test_kernels_refuse_non_cpu_devices():
    """Anything not on the CPU goes to the CUDA kernels, which refuse a
    tensor that is not on the card instead of falling back."""
    x = torch.empty((1, 16, 32), dtype=torch.bfloat16, device="meta")
    p = {n: torch.empty((2, 2) if n.endswith("weight") else (2,),
                        device="meta") for n in talking_heads.PARAM_NAMES}
    counts = [(f.launches, f.train_launches)
              for f in (fused_mha.fused_mha,
                        talking_heads.talking_heads_attention)]
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA tensor"):
            fused_mha.fused_mha(x, x, x, 2)
        with pytest.raises(ValueError, match="CUDA tensor"):
            talking_heads.talking_heads_attention(x, x, x, p, 2)
        with pytest.raises(TypeError, match="bf16"):
            fused_mha.fused_mha(x.float(), x.float(), x.float(), 2)
    with pytest.raises(ValueError, match="CUDA tensor"):  # the Function
        fused_mha.fused_mha(x.requires_grad_(), x, x, 2)
    assert [(f.launches, f.train_launches)
            for f in (fused_mha.fused_mha,
                      talking_heads.talking_heads_attention)] == counts


def test_cli_trains_the_standalone_attention(tmp_path, monkeypatch):
    """`--preset voc0712 --no_use_fused_block --no_use_fused_layers` (with
    the preset's use_pallas_attention) on the CPU at a tiny size: every
    patch block's attention goes through TalkingHeadsFn, the class
    attention, the encoder and the decoder cross-attention through MHAFn,
    at the recipe's dropout; finite steps, no skipped step, weights moved,
    no CUDA launch counted, and the checkpoint reloads."""
    from spe_tpu_torch.cli.main import main, parse_config
    from spe_tpu_torch.data import write_mini_voc
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.train.checkpoint import restore_checkpoint
    from spe_tpu_torch.train.optim import AdamW3
    from spe_tpu_torch.train.train_step import TrainState

    devkit = write_mini_voc(tmp_path / "voc", n_test=2, n_trainval=4,
                            img_size=64)
    out = tmp_path / "out"
    args = ["--preset", "voc0712", "--device", "cpu", "--dataset_file",
            "voc_voc", "--test_path", str(devkit), "--backbone",
            "TSCAM_cait_tiny", "--max_size", "64", "--layer_to_det", "2",
            "--enc_layers", "1", "--dec_layers", "2", "--dim_feedforward",
            "32", "--nheads", "2", "--num_queries", "12", "--batch_size", "2",
            "--compute_dtype", "float32", "--cam_cc_size", "16",
            "--no_use_fused_block", "--no_use_fused_layers",
            "--warmup_cls_epochs", "0", "--refine_start_epoch", "0",
            "--epochs", "1", "--output_dir", str(out)]
    cfg = parse_config(args)
    assert cfg.use_pallas_attention and not cfg.use_fused_block
    calls = {"th": 0, "mha": 0}
    for key, mod, name in (("th", talking_heads, "TalkingHeadsFn"),
                           ("mha", fused_mha, "MHAFn")):
        def counted(*a, _apply=getattr(mod, name).apply, _key=key):
            calls[_key] += 1
            return _apply(*a)

        monkeypatch.setattr(getattr(mod, name), "apply", counted)
    counters = [(f, (f.launches, f.train_launches, f.bwd_launches))
                for f in (fused_mha.fused_mha,
                          talking_heads.talking_heads_attention)]
    res = main(args)
    (ep,) = res["epochs"]
    assert ep["train"]["steps"] == 2 and res["state"].bad_steps == 0
    assert all(np.isfinite(h["loss"]) for h in ep["train"]["history"])
    # per step: 4 + 2 patch blocks; 2 class-attention blocks, 1 encoder
    # and 2 decoder cross-attentions
    assert calls == {"th": 2 * 6, "mha": 2 * 5}, calls
    for f, before in counters:
        assert (f.launches, f.train_launches, f.bwd_launches) == before
    model = res["state"].model
    init = build_model(cfg, "cpu").state_dict()
    for name in ("backbone.0.body.blocks.0.attn.proj_l.weight",
                 "backbone.0.body.blocks_token_only.0.attn.q.weight",
                 "transformer.encoder.layers.0.self_attn.in_proj_weight",
                 "transformer.decoder.layers.1.ca_qcontent_proj.weight"):
        assert not torch.equal(model.state_dict()[name], init[name]), name
    fresh = build_model(cfg, "cpu")
    state = TrainState(fresh, AdamW3(fresh.named_parameters(), cfg, 1))
    assert restore_checkpoint(out / "checkpoint.pth", state) == 0
    for k, v in model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
