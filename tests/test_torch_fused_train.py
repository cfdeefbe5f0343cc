"""The fused backbone layers in training (spe_tpu_torch/ops/fused_block.py,
fused_ca_block.py) on the CPU, where their autograd Functions take the
plain versions:

  * gradients through the port's Function against jax.grad through the
    Pallas kernels (interpret mode, dropout 0; for class attention with a
    nonzero cotangent on the probabilities), in f32 at the shapes of
    tests/test_pallas_block.py and test_torch_fused_layers.py, with the JAX
    package's own VJP tolerances (rtol = atol = 2e-4 for dx, 3e-4 for the
    parameters; test_pallas_block.py, test_pallas_ca_block.py);
  * the hand-derived `*_backward_reference` (the CUDA backward's oracle)
    against torch autograd through `*_train_reference` with the same
    counter masks: 1e-5 of each gradient's largest magnitude + 1e-5 (f32,
    two summation orders; the absolute part covers the head biases'
    gradients, sums of softmax-backward rows that cancel to ~1e-6);
  * the counter masks: kept share, unbiasedness over seeds, DropPath's four
    outcomes (as test_pallas_block.py:176-193).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spe_tpu.models.cait import LayerScaleBlock, LayerScaleBlockClassAttn
from spe_tpu.ops.pallas_block import fused_layer_scale_block as jax_block
from spe_tpu.ops.pallas_ca_block import fused_class_attn_block as jax_ca
from spe_tpu_torch.models.convert import (block_state_dict,
                                          class_attn_block_state_dict)
from spe_tpu_torch.ops import fused_block, fused_ca_block
from spe_tpu_torch.ops.refmath import (SITE_ATTN, SITE_PATH1, SITE_PROJ,
                                       CounterDropout, counter_keep,
                                       keep_scale, path_keep)

RATES = (0.05, 0.07, 0.2)   # the recipe's attention, proj/MLP and DropPath


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
        if k[-1] in ("gamma_1", "gamma_2", "scale"):
            flat[k] = jnp.asarray(1.0 + 0.1 * rng.normal(size=v.shape),
                                  jnp.float32)
        elif k[-1] == "bias" and len(k) >= 2 and k[-2].startswith("norm"):
            flat[k] = jnp.asarray(0.05 * rng.normal(size=v.shape), jnp.float32)
    return flax.traverse_util.unflatten_dict(flat)


def _row(a):
    return jnp.asarray(a).reshape(1, -1)


def _block_kernel_params(p, H):
    a = p["attn"]
    return (_row(p["norm1"]["scale"]), _row(p["norm1"]["bias"]),
            a["qkv"]["kernel"], _row(a["qkv"]["bias"]), a["proj_l"],
            a["proj_l_bias"].reshape(H, 1), a["proj_w"],
            a["proj_w_bias"].reshape(H, 1), a["proj"]["kernel"],
            _row(a["proj"]["bias"]), _row(p["gamma_1"]),
            _row(p["norm2"]["scale"]), _row(p["norm2"]["bias"]),
            p["mlp"]["fc1"]["kernel"], _row(p["mlp"]["fc1"]["bias"]),
            p["mlp"]["fc2"]["kernel"], _row(p["mlp"]["fc2"]["bias"]),
            _row(p["gamma_2"]), jnp.zeros((1,), jnp.float32))


def _ca_kernel_params(p):
    a = p["attn"]
    return (_row(p["norm1"]["scale"]), _row(p["norm1"]["bias"]),
            a["q"]["kernel"], _row(a["q"]["bias"]), a["k"]["kernel"],
            _row(a["k"]["bias"]), a["v"]["kernel"], _row(a["v"]["bias"]),
            a["proj"]["kernel"], _row(a["proj"]["bias"]), _row(p["gamma_1"]),
            _row(p["norm2"]["scale"]), _row(p["norm2"]["bias"]),
            p["mlp"]["fc1"]["kernel"], _row(p["mlp"]["fc1"]["bias"]),
            p["mlp"]["fc2"]["kernel"], _row(p["mlp"]["fc2"]["bias"]),
            _row(p["gamma_2"]))


def _leaves(sd):
    return {k: v.detach().clone().requires_grad_() for k, v in sd.items()}


def _close(got, want, tol, msg):
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=msg)


def test_block_function_grads_match_jax(rng):
    B, N, D, H = 2, 32, 16, 4
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    blk = LayerScaleBlock(num_heads=H, init_scale=1.0)
    params = _near_one(blk.init(jax.random.PRNGKey(0),
                                jnp.asarray(x))["params"], rng)

    def loss(p, x):
        y = jax_block(x, _block_kernel_params(p, H), 16, True, 0.0, 0.0, 0.0)
        return jnp.sum(jnp.sin(y))

    gp, gx = _sync(jax.grad(loss, argnums=(0, 1)), params, jnp.asarray(x))
    want = block_state_dict(jax.tree_util.tree_map(np.asarray, gp))

    sd = _leaves(block_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    xt = _t(x).requires_grad_()
    torch.sin(fused_block.fused_layer_scale_block(xt, sd, H)).sum().backward()
    _close(_np(xt.grad), gx, 2e-4, "dx")
    assert set(want) == set(fused_block.PARAM_NAMES)
    for k in fused_block.PARAM_NAMES:
        _close(_np(sd[k].grad), want[k], 3e-4, k)


def test_class_attn_function_grads_match_jax(rng):
    B, D, H, t, P = 2, 32, 2, 5, 40
    x = rng.normal(size=(B, P, D)).astype(np.float32)
    cls = rng.normal(size=(B, t, D)).astype(np.float32)
    w_attn = rng.normal(size=(B, H, t, t + P)).astype(np.float32)
    blk = LayerScaleBlockClassAttn(num_heads=H, num_tokens=t, init_scale=1.0)
    params = _near_one(blk.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                jnp.asarray(cls))["params"], rng)

    def loss(p, cls, x):
        out, attn = jax_ca(cls, x, _ca_kernel_params(p), H, True)
        return jnp.sum(jnp.sin(out)) + jnp.sum(attn * w_attn)

    gp, gcls, gx = _sync(jax.grad(loss, argnums=(0, 1, 2)),
                         params, jnp.asarray(cls), jnp.asarray(x))
    want = class_attn_block_state_dict(jax.tree_util.tree_map(np.asarray, gp))

    sd = _leaves(class_attn_block_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    ct, xt = _t(cls).requires_grad_(), _t(x).requires_grad_()
    out, attn = fused_ca_block.fused_class_attn_block(ct, xt, sd, H)
    (torch.sin(out).sum() + (attn * _t(w_attn)).sum()).backward()
    _close(_np(ct.grad), gcls, 2e-4, "dcls")
    _close(_np(xt.grad), gx, 2e-4, "dx")
    for k in fused_ca_block.PARAM_NAMES:
        _close(_np(sd[k].grad), want[k], 3e-4, k)


def _block_params(rng, D, H):
    from spe_tpu_torch.models.cait import LayerScaleBlock as TBlock

    sd = dict(TBlock(D, H).named_parameters())
    out = {}
    for k, v in sd.items():
        a = rng.normal(size=tuple(v.shape)).astype(np.float32)
        if k.endswith(("gamma_1", "gamma_2")) or k.startswith("norm") and \
                k.endswith("weight"):
            a = 1.0 + 0.1 * a
        elif v.dim() == 2:
            a = a * v.shape[1] ** -0.5
        else:
            a = 0.05 * a
        out[k] = torch.from_numpy(a)
    return out


def _grad_tol(want):
    return 1e-5 * float(want.abs().max()) + 1e-5


@pytest.mark.parametrize("rates", [(0.0, 0.0, 0.0), RATES, (0.3, 0.2, 0.5)])
def test_block_backward_reference_matches_autograd(rng, rates):
    B, N, D, H = 2, 24, 16, 4
    x = torch.from_numpy(rng.normal(size=(B, N, D)).astype(np.float32))
    p = _block_params(rng, D, H)
    drop = CounterDropout(torch.tensor([1234], dtype=torch.int32), *rates)
    leaves, xt = _leaves(p), x.clone().requires_grad_()
    out, o, md, lse = fused_block.layer_scale_block_train_reference(
        xt, leaves, H, drop)
    dy = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    out.backward(dy)
    dx, g = fused_block.layer_scale_block_backward_reference(
        dy, x, o.detach(), md.detach(), lse.detach(), p, H, drop)
    assert float((dx - xt.grad).abs().max()) <= _grad_tol(xt.grad)
    for k in fused_block.PARAM_NAMES:
        err = float((g[k] - leaves[k].grad).abs().max())
        assert err <= _grad_tol(leaves[k].grad), (k, err)


@pytest.mark.parametrize("with_dattn", [False, True])
def test_class_attn_backward_reference_matches_autograd(rng, with_dattn):
    from spe_tpu_torch.models.cait import LayerScaleBlockClassAttn as TCA

    B, D, H, t, P = 2, 32, 2, 5, 40
    cls = torch.from_numpy(rng.normal(size=(B, t, D)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(B, P, D)).astype(np.float32))
    p = {k: torch.from_numpy((rng.normal(size=tuple(v.shape)) * (
        v.shape[1] ** -0.5 if v.dim() == 2 else 0.1)
        + (1.0 if k.endswith(("gamma_1", "gamma_2", "norm1.weight",
                              "norm2.weight")) else 0.0)).astype(np.float32))
         for k, v in TCA(D, H).named_parameters()}
    leaves = _leaves(p)
    ct, xt = cls.clone().requires_grad_(), x.clone().requires_grad_()
    out, attn, o, m = fused_ca_block.class_attn_block_train_reference(
        ct, xt, leaves, H)
    dy = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    dattn = torch.from_numpy(rng.normal(size=attn.shape).astype(np.float32)) \
        if with_dattn else None
    torch.autograd.backward([out, attn] if with_dattn else [out],
                            [dy, dattn] if with_dattn else [dy])
    dcls, dx, g = fused_ca_block.class_attn_block_backward_reference(
        dy, dattn, cls, x, attn.detach(), o.detach(), m.detach(), p, H)
    assert float((dcls - ct.grad).abs().max()) <= _grad_tol(ct.grad)
    assert float((dx - xt.grad).abs().max()) <= _grad_tol(xt.grad)
    for k in fused_ca_block.PARAM_NAMES:
        err = float((g[k] - leaves[k].grad).abs().max())
        assert err <= _grad_tol(leaves[k].grad), (k, err)


@pytest.mark.parametrize("rate", [0.05, 0.07, 0.2, 0.5])
def test_counter_mask_kept_share(rate):
    """Over 4 x 4 x 64 x 64 draws the kept share lies within 4 sigma of
    1 - rate, each (sample, head) row block too within 6 sigma; the same
    seed gives the same mask, another seed or site another."""
    seed = torch.tensor([987654], dtype=torch.int32)
    shape = (4, 4, 64, 64)
    keep = counter_keep(seed, SITE_ATTN, rate, shape)
    n = keep.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(float(keep.float().mean()) - (1 - rate)) < 4 * sigma
    per = keep.float().mean((2, 3))
    sig_per = (rate * (1 - rate) / (64 * 64)) ** 0.5
    assert float((per - (1 - rate)).abs().max()) < 6 * sig_per
    assert torch.equal(keep, counter_keep(seed, SITE_ATTN, rate, shape))
    for other in (counter_keep(seed + 1, SITE_ATTN, rate, shape),
                  counter_keep(seed, SITE_PROJ, rate, shape)):
        agree = float((other == keep).float().mean())
        # independent masks agree on (1-r)^2 + r^2 of the entries
        assert abs(agree - ((1 - rate) ** 2 + rate ** 2)) < 6 * sigma


def test_counter_dropout_unbiased_over_seeds():
    """The mean of drop(1) over 64 seeds is 1 within Monte-Carlo error at
    every position, and DropPath keeps about 1 - rate of the samples."""
    x = torch.ones((2, 16, 32))
    acc = torch.zeros_like(x)
    kept = 0
    S = 64
    for s in range(S):
        d = CounterDropout(torch.tensor([1000 + s], dtype=torch.int32),
                           proj=0.3, path=0.2)
        acc += d.site(x, SITE_PROJ, 0.3)
        kept += int(path_keep(d.seed, SITE_PATH1, 0.2, 512).sum())
    mean = acc / S
    # per-position std of the mean: sqrt(r / (1 - r) / S)
    assert float((mean - 1).abs().mean()) < 0.12
    assert abs(float(mean.mean()) - 1) < 0.01
    p_keep = kept / (S * 512)
    assert abs(p_keep - 0.8) < 4 * (0.16 / (S * 512)) ** 0.5
    assert keep_scale(0.3) == pytest.approx(1 / 0.7)


def test_drop_path_outcomes_are_the_four_candidates(rng):
    """At DropPath 0.5 each sample's block output is one of the four
    outcomes {branch 1 dropped / kept x 2} x {branch 2 dropped / kept x 2},
    the candidates being the rate-0 forward with gammas scaled by 0 or 2."""
    B, N, D, H = 8, 16, 16, 4
    x = torch.from_numpy(rng.normal(size=(B, N, D)).astype(np.float32))
    p = _block_params(rng, D, H)
    drop = CounterDropout(torch.tensor([77], dtype=torch.int32), path=0.5)
    with torch.no_grad():
        got = fused_block.fused_layer_scale_block(x, p, H, drop)
        cands = []
        for c1 in (0.0, 2.0):
            for c2 in (0.0, 2.0):
                q = dict(p, gamma_1=p["gamma_1"] * c1, gamma_2=p["gamma_2"] * c2)
                cands.append(fused_block.fused_layer_scale_block(x, q, H))
    seen = set()
    for b in range(B):
        d = [float((c[b] - got[b]).abs().max()) for c in cands]
        assert min(d) < 1e-5, (b, d)
        seen.add(int(np.argmin(d)))
    assert len(seen) > 1   # the draws differ between samples


def test_block_dropout_changes_output_and_is_unbiased(rng):
    """Attention and proj dropout change the output, and its mean over 24
    seeds comes back to the rate-0 output (as test_pallas_block.py:196)."""
    B, N, D, H = 2, 16, 16, 4
    x = torch.from_numpy(rng.normal(size=(B, N, D)).astype(np.float32))
    p = _block_params(rng, D, H)
    with torch.no_grad():
        det = fused_block.fused_layer_scale_block(x, p, H).double()
        acc = torch.zeros_like(det)
        S = 24
        for s in range(S):
            d = CounterDropout(torch.tensor([1000 + s], dtype=torch.int32),
                               attn=0.3)
            acc += fused_block.fused_layer_scale_block(x, p, H, d).double()
        one = fused_block.fused_layer_scale_block(
            x, p, H, CounterDropout(torch.tensor([5], dtype=torch.int32),
                                    attn=0.2, proj=0.1))
    assert not torch.allclose(one.double(), det)
    err = float((acc / S - det).abs().mean() / (det.abs().mean() + 1e-9))
    assert err < 0.08, err


def test_fused_dispatch_counts_no_launch_on_the_cpu(rng):
    """On the CPU the Function and the training forward run the plain
    versions: no CUDA counter moves, and the eval path is unchanged."""
    B, N, D, H = 1, 8, 16, 4
    x = torch.from_numpy(rng.normal(size=(B, N, D)).astype(np.float32))
    p = _block_params(rng, D, H)
    fn = fused_block.fused_layer_scale_block
    before = (fn.launches, fn.train_launches, fn.bwd_launches)
    leaves = _leaves(p)
    fn(x, leaves, H).sum().backward()
    assert all(v.grad is not None for v in leaves.values())
    with torch.no_grad():
        assert torch.equal(fn(x, p, H),
                           fused_block.layer_scale_block_reference(x, p, H))
    assert (fn.launches, fn.train_launches, fn.bwd_launches) == before


def _tiny_cli_args(devkit, out):
    return ["--preset", "voc0712", "--device", "cpu", "--dataset_file",
            "voc_voc", "--test_path", str(devkit), "--backbone",
            "TSCAM_cait_tiny", "--max_size", "64", "--layer_to_det", "2",
            "--enc_layers", "1", "--dec_layers", "2", "--dim_feedforward",
            "32", "--nheads", "2", "--num_queries", "12", "--batch_size", "2",
            "--compute_dtype", "float32", "--cam_cc_size", "16",
            "--no_use_fused_layers", "--no_use_pallas_attention",
            "--warmup_cls_epochs", "0", "--refine_start_epoch", "0",
            "--epochs", "1", "--output_dir", str(out)]


def test_cli_trains_the_fused_backbone(tmp_path):
    """The slice's flags on the CPU: the preset's use_fused_block with the
    recipe's dropout, the encoder/decoder plain; finite steps, no skipped
    step, and no CUDA launch counted."""
    from spe_tpu_torch.cli.main import main
    from spe_tpu_torch.data import write_mini_voc

    devkit = write_mini_voc(tmp_path / "voc", n_test=2, n_trainval=4,
                            img_size=64)
    fn = fused_block.fused_layer_scale_block
    before = (fn.train_launches, fn.bwd_launches)
    res = main(_tiny_cli_args(devkit, tmp_path / "out"))
    (ep,) = res["epochs"]
    assert ep["train"]["steps"] == 2 and res["state"].bad_steps == 0
    assert all(np.isfinite(h["loss"]) for h in ep["train"]["history"])
    assert res["state"].model.backbone[0].body.blocks[0].use_fused
    assert (fn.train_launches, fn.bwd_launches) == before


def test_cli_refuses_fused_encoder_training_on_the_card():
    """On the card (the default device) training takes the bare stock
    preset with every fused flag on (the encoder and decoder train through
    their kernels); what is not ported still raises while the flags are
    parsed, before anything runs."""
    from spe_tpu_torch.cli.main import parse_config

    args = ["--preset", "voc0712", "--dataset_file", "voc_voc"]
    cfg = parse_config(args)
    assert cfg.device != "cpu" and cfg.use_pallas_attention
    assert cfg.use_fused_block and cfg.use_fused_layers
    assert cfg.use_fused_ca_block == "auto"
    with pytest.raises(NotImplementedError, match="--backbone_weights auto"):
        parse_config(args + ["--backbone_weights", "auto"])
    with pytest.raises(ValueError, match="segmentation only"):
        parse_config(args + ["--frozen_weights", "x.pth"])
    assert parse_config(args + ["--frozen_weights", "x.pth", "--masks"]).masks
    assert parse_config(args + ["--world_size", "2"]).world_size == 2
