"""The port's pre-norm encoder and learned position embedding against the
JAX package on the CPU: the pre-norm encoder layer (forward and
gradients, plain and with its attention through fused_mha, which the JAX
side runs as its Pallas kernel in interpret mode), the whole pre-norm +
learned detector's forward (the port also under the stock preset's flags:
its encoder is then plain with B4's attention, never the fused layer, as
the JAX package routes it), and 3 training steps of it under the stock
flags against JAX's make_train_step. Weights come from the JAX init
through state_dict_from_jax, LayerNorm scales and biases drawn near 1 and
0 so they show.

Tolerances: the layer's output and gradients 1e-5 of their largest
magnitude (f32); the detector's outputs test_torch_detector.py's
(pred_logits 2e-4, pred_boxes 2e-5); the steps test_torch_train_step.py's
(losses 1e-4 relative, parameters 5e-6 + 1e-4 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spe_tpu.models.cait import CaiTConfig
from spe_tpu.models.detector import SPEDetector
from spe_tpu.models.transformer import \
    TransformerEncoderLayer as JEncoderLayer
from spe_tpu_torch.models import cait as tcait
from spe_tpu_torch.models import detector as tdet
from spe_tpu_torch.models.convert import (encoder_layer_state_dict,
                                          state_dict_from_jax)
from spe_tpu_torch.models.transformer import TransformerEncoderLayer
from spe_tpu_torch.ops import fused_encoder, fused_mha
from test_torch_detector import BB, KW, _near_one
from test_torch_train_step import CFG, _three_steps

D, H, FF = 32, 4, 48
STOCK = {"use_fused_block": True, "use_fused_layers": True,
         "use_pallas_attention": True}


def _sync(fn, *args):
    """fn(*args) as one jitted JAX call, waited for before anything else
    is dispatched (the threaded Pallas interpreter; ROADMAP §C)."""
    return jax.block_until_ready(jax.jit(fn)(*args))


def _close(got, want, rel=1e-5, name=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    tol = rel * max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol, (name, np.abs(got - want).max(),
                                             tol)


@pytest.mark.parametrize("pallas", [False, True])
def test_prenorm_encoder_layer_matches_jax(rng, pallas):
    B, N = 2, 12
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    pos = rng.normal(size=(B, N, D)).astype(np.float32)
    mask = np.zeros((B, N), bool)
    mask[1, -3:] = True
    cot = rng.normal(size=(B, N, D)).astype(np.float32)
    layer = JEncoderLayer(H, FF, dropout=0.0, normalize_before=True,
                          use_pallas=pallas)
    # the plain layer inits the same parameters without running the Pallas
    # kernel eagerly (see _sync)
    params = JEncoderLayer(H, FF, dropout=0.0, normalize_before=True).init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(pos))
    params = {"params": _near_one(params["params"], rng)}

    def loss(p, x, pos):
        y = layer.apply(p, x, pos, key_padding_mask=jnp.asarray(mask))
        return (y * jnp.asarray(cot)).sum(), y

    (_, want), grads = _sync(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                has_aux=True),
                             params, jnp.asarray(x), jnp.asarray(pos))
    tree = jax.tree_util.tree_map(np.asarray, params["params"])
    # use_fused asks for the fused layer: pre-norm never takes it
    port = TransformerEncoderLayer(D, H, FF, use_fused=True,
                                   use_pallas=pallas, normalize_before=True)
    assert not port.use_fused
    port.load_state_dict(encoder_layer_state_dict(tree))
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = torch.from_numpy(pos).requires_grad_(True)
    counts = (fused_encoder.fused_encoder_layer.train_launches,
              fused_mha.fused_mha.train_launches)
    got = port(xt, pt, torch.from_numpy(mask))
    assert counts == (fused_encoder.fused_encoder_layer.train_launches,
                      fused_mha.fused_mha.train_launches)   # CPU: no launch
    _close(got.detach().numpy(), want, name="out")
    got.backward(torch.from_numpy(cot))
    _close(xt.grad.numpy(), grads[1], name="dx")
    _close(pt.grad.numpy(), grads[2], name="dpos")
    gsd = encoder_layer_state_dict(jax.tree_util.tree_map(
        np.asarray, grads[0]["params"]))
    for name, p in port.named_parameters():
        _close(p.grad.numpy(), gsd[name].numpy(), name=name)


def _jax_detector(pallas):
    bb = CaiTConfig(**BB, use_pallas=pallas)
    return SPEDetector(backbone_cfg=bb, dropout=0.1, use_pallas=pallas,
                       pre_norm=True, position_embedding="learned", **KW)


@pytest.mark.parametrize("route", ["off", "attention", "stock"])
def test_prenorm_learned_detector_matches_jax(rng, route):
    """The JAX detector with its flags off, or with use_pallas (its B4/B5
    kernels in interpret mode) for the port's "attention" route; the
    port's stock route (fused backbone and decoder, pre-norm encoder with
    B4) against the JAX plain one: at eval the math is the same."""
    pallas = route == "attention"
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    pad = np.zeros((2, 64, 64), bool)
    pad[1, :, 48:] = True
    jdet = _jax_detector(pallas)
    params = _jax_detector(False).init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 64, 64, 3)))
    weights = {"params": _near_one(params["params"], rng)}
    assert set(weights["params"]) >= {"pos_embed_learned"}
    assert "encoder_norm" in weights["params"]["transformer"]
    want = _sync(lambda w, x, p: jdet.apply(w, x, pad_mask=p,
                                            deterministic=True),
                 weights, jnp.asarray(x), jnp.asarray(pad))
    fused = route == "stock"
    bb = tcait.CaiTConfig(**BB, use_fused_block=fused,
                          use_pallas=route != "off")
    model = tdet.SPEDetector(bb, use_fused_layers=fused,
                             use_pallas=route != "off", pre_norm=True,
                             position_embedding="learned", **KW).eval()
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    weights["params"]))
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    assert all(not layer.use_fused
               for layer in model.transformer.encoder.layers)
    with torch.no_grad():
        got = model(torch.from_numpy(x), pad_mask=torch.from_numpy(pad))
    for r in (0, 1):
        for k, tol in (("pred_logits", 2e-4), ("pred_boxes", 2e-5),
                       ("aux_pred_logits", 2e-4), ("aux_pred_boxes", 2e-5)):
            np.testing.assert_allclose(got["stages"][r][k].numpy(),
                                       np.asarray(want["stages"][r][k]),
                                       rtol=tol, atol=tol,
                                       err_msg=f"stage {r} {k}")
    assert "pred_masks" not in got


def test_three_train_steps_prenorm_learned_stock_flags_match_jax(rng):
    """3 steps of the pre-norm + learned detector, the port under the
    stock flags (fused backbone and decoder, the encoder plain with its
    attention through MHAFn: on the CPU the plain training forward and the
    hand-derived backward), against the same JAX fused-off step."""
    _three_steps(rng, STOCK, base={**CFG, "pre_norm": True,
                                   "position_embedding": "learned"})


def test_build_model_takes_the_variants():
    """build_model builds the stock preset's detector with pre_norm, with
    the learned embedding, with masks; an unknown embedding raises by
    name; under tensor parallelism --masks stays refused."""
    from spe_tpu_torch.cli.main import parse_config
    from spe_tpu_torch.models.build import build_model

    tiny = ["--preset", "voc0712", "--device", "cpu", "--backbone",
            "TSCAM_cait_tiny", "--max_size", "64", "--layer_to_det", "2",
            "--enc_layers", "1", "--dec_layers", "2", "--dim_feedforward",
            "32", "--nheads", "2", "--num_queries", "6"]
    for extra, names in ((["--pre_norm"], {"transformer.encoder.norm.weight"}),
                         (["--position_embedding", "learned"],
                          {"backbone.1.col_embed.weight",
                           "backbone.1.row_embed.weight"}),
                         (["--masks"], {"bbox_attention.q_linear.weight",
                                        "mask_head.conv_0.weight",
                                        "mask_head.gn_2.weight",
                                        "mask_head.out.weight"})):
        sd = build_model(parse_config(tiny + extra)).state_dict()
        assert names <= set(sd), extra
        table = sd.get("backbone.1.col_embed.weight")
        if table is not None:   # flax uniform(1.0): [0, 1)
            assert float(table.min()) >= 0 and float(table.max()) < 1
    with pytest.raises(ValueError, match="not supported"):
        build_model(parse_config(tiny + ["--position_embedding", "cosine"]))
    # under tensor parallelism the segmentation head stays refused
    # (test_torch_tp.py runs the rest in model groups)
    from spe_tpu_torch.parallel.tp import TensorParallel

    cfg = parse_config(tiny + ["--no_use_fused_block", "--no_use_fused_layers",
                               "--tp_attention"]).replace(masks=True,
                                                          model_axis=2)
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        build_model(cfg, tp=TensorParallel(None, 0, 2))


def test_learned_tables_in_the_body_group():
    """The learned position tables train at lr (the JAX package holds them
    outside its backbone: spe_tpu/train/optim.py param_group), the
    backbone body at lr_backbone."""
    from spe_tpu_torch.train.optim import param_group

    assert param_group("backbone.1.col_embed.weight") == "body"
    assert param_group("backbone.0.body.blocks.0.norm1.weight") == "backbone"
    assert param_group("backbone.0.body.blocks_token_only.0.gamma_1") == \
        "cls_head"
    assert param_group("mask_head.out.weight", frozen=True) == "body"
    assert param_group("transformer.encoder.norm.weight", frozen=True) == \
        "frozen"
