"""The fused encoder and decoder layers in training
(spe_tpu_torch/ops/fused_encoder.py, fused_decoder.py) on the CPU, where
their autograd Functions take the plain versions:

  * gradients through the port's Function against jax.grad through the
    Pallas kernels (interpret mode, dropout 0), in f32 at the shapes of
    tests/test_pallas_encoder.py (B=2, N=32, D=16, H=4, F=48) and
    test_pallas_decoder.py (B=2, D=16, H=4, F=40, S=2 sets of Q=8, N=24
    keys; Q a multiple of 8, so the Pallas kernel's query bias is zero),
    LayerNorm scales near 1 and a key-padding mask, with the JAX package's
    own VJP tolerances (rtol = atol = 3e-4 for the encoder, 5e-4 for the
    decoder);
  * the hand-derived `*_backward_reference` (the CUDA backward's oracle)
    against torch autograd through `*_train_reference` with the same
    counter masks: 1e-5 of each gradient's largest magnitude + 1e-5 (f32,
    two summation orders; the absolute part covers the key projections'
    bias gradients, zero in exact arithmetic, ~1e-6 here);
  * the decoder's mask keys, the dispatch (no CUDA launch counted on the
    CPU; the eval path unchanged), and the CLI training the stock preset's
    flags at a tiny size.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spe_tpu.models.transformer import (ConditionalDecoderLayer,
                                        TransformerEncoderLayer)
from spe_tpu.ops.pallas_decoder import fused_decoder_layer as jax_dec
from spe_tpu.ops.pallas_encoder import fused_encoder_layer as jax_enc
from spe_tpu_torch.models import transformer as ttr
from spe_tpu_torch.models.convert import (decoder_layer_state_dict,
                                          encoder_layer_state_dict)
from spe_tpu_torch.ops import fused_decoder, fused_encoder
from spe_tpu_torch.ops.refmath import (SITE_ATTN, SITE_CROSS_ATTN,
                                       CounterDropout, counter_keep)

B, D, H = 2, 16, 4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _sync(fn, *args):
    """fn(*args) as one jitted JAX call, waited for before anything else is
    dispatched. The JAX package's Pallas kernels run in the threaded
    interpreter here, whose io_callbacks dispatch JAX work of their own;
    an eager dispatch from the test's thread while a kernel runs can
    deadlock the process (a JAX issue, ROADMAP §C)."""
    return jax.block_until_ready(jax.jit(fn)(*args))


def _np(t):
    return t.detach().float().numpy()


def _near_one(params, rng):
    flat = flax.traverse_util.flatten_dict(params)
    for k, v in flat.items():
        if k[-1] == "scale":
            flat[k] = jnp.asarray(1.0 + 0.1 * rng.normal(size=v.shape),
                                  jnp.float32)
        elif k[-1] == "bias" and len(k) >= 2 and k[-2].startswith("norm"):
            flat[k] = jnp.asarray(0.05 * rng.normal(size=v.shape), jnp.float32)
    return flax.traverse_util.unflatten_dict(flat)


def _row(a):
    return jnp.asarray(a).reshape(1, -1)


def _mask(n):
    """Key-padding mask: none padded on image 0, the last 5 on image 1."""
    return np.arange(n)[None, :] >= np.array([[n], [n - 5]])


def _bias(mask):
    return jnp.asarray(np.where(mask, -1e9, 0.0).astype(np.float32)[:, None, :])


def _leaves(sd):
    return {k: v.detach().clone().requires_grad_() for k, v in sd.items()}


def _close(got, want, tol, msg):
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=msg)


def test_encoder_function_grads_match_jax(rng):
    N, F = 32, 48
    x, pos = (rng.normal(size=(B, N, D)).astype(np.float32) for _ in range(2))
    mask = _mask(N)
    layer = TransformerEncoderLayer(H, F, dropout=0.1)
    params = _near_one(layer.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                  jnp.asarray(pos))["params"], rng)

    def kernel_params(p):
        sa = p["self_attn"]
        return tuple(
            v for n in ("q_proj", "k_proj", "v_proj", "out_proj")
            for v in (sa[n]["kernel"], _row(sa[n]["bias"]))) + (
            _row(p["norm1"]["scale"]), _row(p["norm1"]["bias"]),
            p["linear1"]["kernel"], _row(p["linear1"]["bias"]),
            p["linear2"]["kernel"], _row(p["linear2"]["bias"]),
            _row(p["norm2"]["scale"]), _row(p["norm2"]["bias"]),
            _bias(mask), jnp.zeros((1,), jnp.float32))

    def loss(p, x, pos):
        y = jax_enc(x, pos, kernel_params(p), H, True, 0.0)
        return jnp.sum(jnp.sin(y))

    gp, gx, gpos = _sync(jax.grad(loss, argnums=(0, 1, 2)),
                         params, jnp.asarray(x), jnp.asarray(pos))
    want = encoder_layer_state_dict(jax.tree_util.tree_map(np.asarray, gp))

    sd = _leaves(encoder_layer_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    xt, pt = _t(x).requires_grad_(), _t(pos).requires_grad_()
    out = fused_encoder.fused_encoder_layer(xt, pt, torch.from_numpy(mask),
                                            sd, H)
    torch.sin(out).sum().backward()
    _close(_np(xt.grad), gx, 3e-4, "dx")
    _close(_np(pt.grad), gpos, 3e-4, "dpos")
    assert set(want) == set(fused_encoder.PARAM_NAMES)
    for k in fused_encoder.PARAM_NAMES:
        _close(_np(sd[k].grad), want[k], 3e-4, k)


def _decoder_kernel_params(p, is_first):
    def dense(n):
        return p[n]["kernel"], _row(p[n]["bias"])

    ps = [v for n in ("sa_qcontent_proj", "sa_qpos_proj", "sa_kcontent_proj",
                      "sa_kpos_proj", "sa_v_proj") for v in dense(n)]
    ps += [p["self_attn"]["out_proj"]["kernel"],
           _row(p["self_attn"]["out_proj"]["bias"]),
           _row(p["norm1"]["scale"]), _row(p["norm1"]["bias"])]
    for n in ("ca_qcontent_proj", "ca_kcontent_proj", "ca_v_proj",
              "ca_kpos_proj") + (("ca_qpos_proj",) if is_first else ()) + (
              "ca_qpos_sine_proj",):
        ps += list(dense(n))
    ps += [p["cross_attn"]["out_proj"]["kernel"],
           _row(p["cross_attn"]["out_proj"]["bias"]),
           _row(p["norm2"]["scale"]), _row(p["norm2"]["bias"]),
           *dense("linear1"), *dense("linear2"),
           _row(p["norm3"]["scale"]), _row(p["norm3"]["bias"])]
    return tuple(ps)


@pytest.mark.parametrize("is_first", [True, False])
def test_decoder_function_grads_match_jax(rng, is_first):
    S, Q, N, F = 2, 8, 24, 40
    tgt, qpos, sine = (rng.normal(size=(B, S * Q, D)).astype(np.float32)
                       for _ in range(3))
    mem, pos = (rng.normal(size=(B, N, D)).astype(np.float32) for _ in range(2))
    mask = _mask(N)
    layer = ConditionalDecoderLayer(H, F, dropout=0.1, num_sets=S)
    args = [jnp.asarray(a) for a in (tgt, mem, pos, qpos, sine)]
    params = _near_one(layer.init(jax.random.PRNGKey(0), *args,
                                  is_first=is_first)["params"], rng)
    extra = (_bias(mask), jnp.zeros((1, Q), jnp.float32),
             jnp.zeros((1,), jnp.float32))

    def loss(p, *xs):
        y = jax_dec(*xs, H, S, True, 0.0,
                    _decoder_kernel_params(p, is_first) + extra)
        return jnp.sum(jnp.sin(y))

    grads = _sync(jax.grad(loss, argnums=tuple(range(6))), params, *args)
    want = decoder_layer_state_dict(jax.tree_util.tree_map(np.asarray,
                                                           grads[0]))

    sd = _leaves(decoder_layer_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    ins = [_t(a).requires_grad_() for a in (tgt, mem, pos, qpos, sine)]
    out = fused_decoder.fused_decoder_layer(*ins, torch.from_numpy(mask), sd,
                                            H, S)
    torch.sin(out).sum().backward()
    for name, t, g in zip(("dtgt", "dmem", "dpos", "dqpos", "dsine"), ins,
                          grads[1:]):
        _close(_np(t.grad), g, 5e-4, name)
    assert set(want) == set(fused_decoder.param_names(sd))
    for k in want:
        _close(_np(sd[k].grad), want[k], 5e-4, k)


def _params(module, rng):
    out = {}
    for k, v in module.named_parameters():
        a = rng.normal(size=tuple(v.shape)).astype(np.float32)
        if k.startswith("norm") and k.endswith("weight"):
            a = 1.0 + 0.1 * a
        elif v.dim() == 2:
            a = a * v.shape[1] ** -0.5
        else:
            a = 0.05 * a
        out[k] = torch.from_numpy(a)
    return out


def _grad_tol(want):
    return 1e-5 * float(want.abs().max()) + 1e-5


def _randn(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _check_backward(ref, inputs, leaves):
    *dins, g = ref
    for d, t in zip(dins, inputs):
        assert float((d - t.grad).abs().max()) <= _grad_tol(t.grad)
    for k, v in leaves.items():
        err = float((g[k] - v.grad).abs().max())
        assert err <= _grad_tol(v.grad), (k, err)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.3])
def test_encoder_backward_reference_matches_autograd(rng, rate):
    N, F = 24, 40
    x, pos = _randn(rng, B, N, D), _randn(rng, B, N, D)
    mask = torch.from_numpy(_mask(N))
    p = _params(ttr.TransformerEncoderLayer(D, H, F), rng)
    drop = CounterDropout(torch.tensor([77], dtype=torch.int32), rate, rate)
    leaves = _leaves(p)
    xt, pt = x.clone().requires_grad_(), pos.clone().requires_grad_()
    out, o, h2d, lse = fused_encoder.encoder_layer_train_reference(
        xt, pt, mask, leaves, H, drop)
    dy = _randn(rng, *out.shape)
    out.backward(dy)
    ref = fused_encoder.encoder_layer_backward_reference(
        dy, x, pos, mask, o.detach(), h2d.detach(), lse.detach(), p, H, drop)
    _check_backward(ref, (xt, pt), leaves)


@pytest.mark.parametrize("is_first,rate", [(True, 0.1), (False, 0.0),
                                           (False, 0.3)])
def test_decoder_backward_reference_matches_autograd(rng, is_first, rate):
    S, Q, N, F = 2, 6, 20, 40
    ins = [_randn(rng, B, S * Q, D), _randn(rng, B, N, D),
           _randn(rng, B, N, D), _randn(rng, B, S * Q, D),
           _randn(rng, B, S * Q, D)]
    mask = torch.from_numpy(_mask(N))
    p = _params(ttr.ConditionalDecoderLayer(D, H, F, is_first, num_sets=S),
                rng)
    drop = CounterDropout(torch.tensor([99], dtype=torch.int32), rate, rate)
    leaves = _leaves(p)
    it = [t.clone().requires_grad_() for t in ins]
    out, *saved = fused_decoder.decoder_layer_train_reference(
        *it, mask, leaves, H, S, drop)
    dy = _randn(rng, *out.shape)
    out.backward(dy)
    ref = fused_decoder.decoder_layer_backward_reference(
        dy, *ins, mask, *(t.detach() for t in saved), p, H, S, drop)
    _check_backward(ref, it, leaves)


def test_decoder_mask_keys():
    """The decoder's self-attention of query set s, head h draws the keys
    (b, s*H + h); its cross-attention draws (b, h) on a site of its own."""
    S, Q, N = 2, 6, 10
    drop = CounterDropout(torch.tensor([5], dtype=torch.int32), attn=0.3)
    ones = torch.ones((B * S, H, Q, Q))
    got = drop.site(ones, SITE_ATTN, 0.3, mask_heads=S * H) > 0
    want = counter_keep(drop.seed, SITE_ATTN, 0.3, (B, S * H, Q, Q))
    for b in range(B):
        for s in range(S):
            for h in range(H):
                assert torch.equal(got[b * S + s, h], want[b, s * H + h])
    cross = drop.site(torch.ones((B, H, S * Q, N)), SITE_CROSS_ATTN, 0.3,
                      mask_heads=H) > 0
    assert torch.equal(cross, counter_keep(drop.seed, SITE_CROSS_ATTN, 0.3,
                                           (B, H, S * Q, N)))
    assert not torch.equal(cross, counter_keep(drop.seed, SITE_ATTN, 0.3,
                                               (B, H, S * Q, N)))


def test_dispatch_counts_no_launch_on_the_cpu(rng):
    """On the CPU the Functions and the training forwards run the plain
    versions: no CUDA counter moves, every parameter gets a gradient, and
    the eval path equals the plain eval version."""
    S, Q, N, F = 2, 4, 12, 24
    enc = _params(ttr.TransformerEncoderLayer(D, H, F), rng)
    dec = _params(ttr.ConditionalDecoderLayer(D, H, F, True, num_sets=S), rng)
    x, pos = _randn(rng, B, N, D), _randn(rng, B, N, D)
    tgt, qpos, sine = (_randn(rng, B, S * Q, D) for _ in range(3))
    drop = CounterDropout(torch.tensor([3], dtype=torch.int32), 0.1, 0.1)
    fe, fd = fused_encoder.fused_encoder_layer, fused_decoder.fused_decoder_layer
    before = [(f.launches, f.train_launches, f.bwd_launches) for f in (fe, fd)]
    le, ld = _leaves(enc), _leaves(dec)
    mem = fe(x, pos, None, le, H, drop)
    fd(tgt, mem, pos, qpos, sine, None, ld, H, S, drop).sum().backward()
    assert all(v.grad is not None for v in (*le.values(), *ld.values()))
    with torch.no_grad():
        assert torch.equal(fe(x, pos, None, enc, H),
                           fused_encoder.encoder_layer_reference(
                               x, pos, None, enc, H))
        assert torch.equal(
            fd(tgt, x, pos, qpos, sine, None, dec, H, S),
            fused_decoder.decoder_layer_reference(tgt, x, pos, qpos, sine,
                                                  None, dec, H, S))
        # dropout without grad: the training forward's output
        got = fe(x, pos, None, enc, H, drop)
        assert torch.equal(got, fused_encoder.encoder_layer_train_reference(
            x, pos, None, enc, H, drop)[0])
    assert [(f.launches, f.train_launches, f.bwd_launches)
            for f in (fe, fd)] == before


def test_cli_trains_the_stock_preset(tmp_path):
    """The stock preset's flags on the CPU at a tiny size: every fused flag
    on (the blocks', the encoder's and decoder's Functions with the
    recipe's dropout), finite steps, no skipped step, a gradient step that
    moved the encoder and decoder, and no CUDA launch counted."""
    from spe_tpu_torch.cli.main import main, parse_config
    from spe_tpu_torch.data import write_mini_voc
    from spe_tpu_torch.models.build import build_model

    devkit = write_mini_voc(tmp_path / "voc", n_test=2, n_trainval=4,
                            img_size=64)
    args = ["--preset", "voc0712", "--device", "cpu", "--dataset_file",
            "voc_voc", "--test_path", str(devkit), "--backbone",
            "TSCAM_cait_tiny", "--max_size", "64", "--layer_to_det", "2",
            "--enc_layers", "1", "--dec_layers", "2", "--dim_feedforward",
            "32", "--nheads", "2", "--num_queries", "12", "--batch_size", "2",
            "--compute_dtype", "float32", "--cam_cc_size", "16",
            "--warmup_cls_epochs", "0", "--refine_start_epoch", "0",
            "--epochs", "1", "--output_dir", str(tmp_path / "out")]
    fns = (fused_encoder.fused_encoder_layer,
           fused_decoder.fused_decoder_layer)
    before = [(f.train_launches, f.bwd_launches) for f in fns]
    res = main(args)
    (ep,) = res["epochs"]
    assert ep["train"]["steps"] == 2 and res["state"].bad_steps == 0
    assert all(np.isfinite(h["loss"]) for h in ep["train"]["history"])
    model = res["state"].model
    assert model.transformer.encoder.layers[0].use_fused
    init = build_model(parse_config(args), "cpu").state_dict()
    for name, p in model.state_dict().items():
        if name.startswith(("transformer.encoder.layers.0.linear1.",
                            "transformer.decoder.layers.1.linear2.")):
            assert not torch.equal(p, init[name]), name
    assert [(f.train_launches, f.bwd_launches) for f in fns] == before
