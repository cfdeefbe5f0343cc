"""The port's whole detector slice against the JAX package: a tiny
SPEDetector with the fused flags on (the JAX side runs its Pallas kernels
in interpret mode, SPE_FUSED_INTERPRET=1), with them off, and with them off
and use_pallas_attention on (the JAX side runs fused_talking_heads and
fused_mha in interpret mode; the port its talking_heads and fused_mha), the
port on the same weights carried over by state_dict_from_jax, each with
the two-branch and the single-branch backbone; plus the
weight bridge round trip and the import rule (the port never imports
jax).

Tolerances are tests/test_pallas_model_parity.py's: pred_logits 2e-4,
pred_boxes 2e-5, cams_cls 1e-5, x_logits 1e-4."""

import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spe_tpu.models.cait import CaiTConfig
from spe_tpu.models.convert import convert_detector
from spe_tpu.models.detector import SPEDetector
from spe_tpu_torch.models import cait as tcait
from spe_tpu_torch.models import detector as tdet
from spe_tpu_torch.models import transformer as ttr
from spe_tpu_torch.models.convert import state_dict_from_jax

KW = dict(num_det_classes=5, num_queries=12, num_refines=1, enc_layers=2,
          dec_layers=2, dim_feedforward=64, nheads=2)
# img_size 48 -> a 3x3 pos-embed grid re-interpolated to the 4x4 patch grid
BB = dict(img_size=48, patch_size=16, embed_dim=32, depth=3, num_heads=2,
          num_classes=4, layer_to_det=2, depth_token_only=2)


def _near_one(params, rng):
    """LayerScale gammas and LayerNorm scales near 1 so every branch shows
    (the registry's 1e-5 LayerScale would hide them). The last bbox layer
    is drawn too: at its zero init the boxes are the sigmoid of the
    reference points alone and never see the decoder."""
    flat = flax.traverse_util.flatten_dict(params)
    for k, v in flat.items():
        if k[-1] in ("gamma_1", "gamma_2", "scale"):
            flat[k] = jnp.asarray(1.0 + 0.1 * rng.normal(size=v.shape),
                                  jnp.float32)
        elif k[0].startswith("bbox_embed") and k[-1] == "kernel" \
                and not np.any(v):
            flat[k] = jnp.asarray(0.1 * rng.normal(size=v.shape), jnp.float32)
        elif k[-1] == "bias" and v.ndim == 1 and "bbox_embed" not in k[0]:
            flat[k] = jnp.asarray(0.05 * rng.normal(size=v.shape), jnp.float32)
    return flax.traverse_util.unflatten_dict(flat)


# True: every fused flag on; False: every one off; "attention": the fused
# flags off and use_pallas_attention on (the standalone kernels B4, B5)
def jax_detector(fused, two_branch=True):
    pallas = fused == "attention"
    fused = fused is True
    bb = CaiTConfig(**BB, use_fused_block=fused, use_pallas=pallas,
                    two_branch=two_branch)
    return SPEDetector(backbone_cfg=bb, dropout=0.1, use_fused_layers=fused,
                       use_pallas=pallas, **KW)


def port_detector(fused, two_branch=True):
    pallas = fused == "attention"
    fused = fused is True
    bb = tcait.CaiTConfig(**BB, use_fused_block=fused, use_pallas=pallas,
                          two_branch=two_branch)
    return tdet.SPEDetector(bb, use_fused_layers=fused, use_pallas=pallas,
                            **KW).eval()


def _weights(rng, two_branch=True):
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = jax_detector(False, two_branch).init(jax.random.PRNGKey(0), x)
    return {"params": _near_one(params["params"], rng)}


@pytest.fixture
def weights(rng):
    return _weights(rng)


# each route with the two-branch backbone and with the single-branch one
# (no det-branch stack: the det features are norm_to_det of the patch
# tokens at block index layer_to_det, the CAM the heads' mean)
@pytest.mark.parametrize("fused,two_branch", [
    pytest.param(True, True, id="True"),
    pytest.param(False, True, id="False"),
    pytest.param("attention", True, id="attention"),
    pytest.param(True, False, id="single-branch-True"),
    pytest.param(False, False, id="single-branch-False"),
    pytest.param("attention", False, id="single-branch-attention")])
def test_detector_matches_jax(rng, monkeypatch, fused, two_branch):
    monkeypatch.setenv("SPE_FUSED_INTERPRET", "1")
    weights = _weights(rng, two_branch)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    pad = np.zeros((2, 64, 64), bool)
    pad[1, :, 48:] = True
    # one jitted call, waited for: the Pallas kernels run in the threaded
    # interpreter, whose callbacks dispatch JAX work of their own, and an
    # eager dispatch from this thread while one runs can deadlock (a JAX
    # issue, ROADMAP §C)
    want = jax.block_until_ready(jax.jit(
        lambda w, x, pad: jax_detector(fused, two_branch).apply(
            w, x, pad_mask=pad, deterministic=True))(
        weights, jnp.asarray(x), jnp.asarray(pad)))
    model = port_detector(fused, two_branch)
    model.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, weights["params"])))
    with torch.no_grad():
        got = model(torch.from_numpy(x), pad_mask=torch.from_numpy(pad))
    for r in (0, 1):
        for k, tol in (("pred_logits", 2e-4), ("pred_boxes", 2e-5),
                       ("aux_pred_logits", 2e-4), ("aux_pred_boxes", 2e-5)):
            np.testing.assert_allclose(got["stages"][r][k].numpy(),
                                       np.asarray(want["stages"][r][k]),
                                       rtol=tol, atol=tol,
                                       err_msg=f"stage {r} {k}")
    for k, tol in (("cams_cls", 1e-5), ("x_logits", 1e-4),
                   ("x_cls_logits", 1e-4), ("x_patch", 1e-4)):
        np.testing.assert_allclose(got["backbone"][k].numpy(),
                                   np.asarray(want["backbone"][k]),
                                   rtol=tol, atol=tol, err_msg=k)


def test_weight_bridge_round_trip(weights):
    """Every route (fused flags on, off, off with the standalone attention
    kernels) has the same parameters under the same names on both sides."""
    p = jax.tree_util.tree_map(np.asarray, weights["params"])
    sd = state_dict_from_jax(p)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    for route in (True, False, "attention"):
        assert set(sd) == set(port_detector(route).state_dict()), route
        tree = jax.eval_shape(jax_detector(route).init, jax.random.PRNGKey(0),
                              x)["params"]
        assert jax.tree_util.tree_structure(tree) == \
            jax.tree_util.tree_structure(weights["params"]), route
    back = convert_detector({k: v.numpy() for k, v in sd.items()},
                            depth=BB["depth"], layer_to_det=BB["layer_to_det"],
                            enc_layers=KW["enc_layers"],
                            dec_layers=KW["dec_layers"],
                            num_refines=KW["num_refines"])
    want = flax.traverse_util.flatten_dict(p)
    got = flax.traverse_util.flatten_dict(back)
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))


def test_port_never_imports_jax():
    """Importing every module of the port loads no module of the JAX
    package (top-level name spe_tpu) and none of jax, jaxlib or flax."""
    code = ("import importlib, pkgutil, sys, spe_tpu_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages("
            "spe_tpu_torch.__path__, 'spe_tpu_torch.')]\n"
            "[importlib.import_module(m) for m in mods]\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('spe_tpu', 'jax', 'jaxlib', 'flax'))\n"
            "assert len(mods) >= 30, mods\n"
            "assert 'spe_tpu_torch.data.coco_eval' in mods, mods\n"
            "assert 'spe_tpu_torch.parallel.dist' in mods, mods\n"
            "assert 'spe_tpu_torch.cli.accuracy' in mods, mods\n"
            "for m in ('parallel.mesh', 'parallel.tp', "
            "'parallel.sharding_rules', 'ops.seq_parallel'):\n"
            "    assert 'spe_tpu_torch.' + m in mods, (m, mods)\n"
            "for m in ('models.segmentation', 'models.position_encoding', "
            "'data.masks', 'data.coco_panoptic', 'data.panoptic_eval', "
            "'ops.resize', 'native.build', 'data.native_io', "
            "'data.loc_eval', 'data.multilabel_ap', 'utils.visualize', "
            "'utils.misc'):\n"
            "    assert 'spe_tpu_torch.' + m in mods, (m, mods)\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("off", ["use_fused_block", "use_fused_ca_block",
                                 "use_fused_layers"])
def test_build_model_refuses_unported_attention_kernels(off):
    """use_pallas_attention with a fused flag off runs pallas_attention or
    pallas_mha in the JAX package (spe_tpu/models/build.py:38,60); the port
    builds it and routes each flavour whose fused flag is off to its
    standalone kernel: the patch blocks to talking_heads (B5), the
    class-attention blocks, the encoder and the decoder cross-attention to
    fused_mha (B4); without use_pallas_attention they keep their plain
    attention. Under tensor parallelism's tp_attention the backbone keeps
    its plain attention and B4 the encoder and cross-attention; a model
    axis > 1 needs its model group (test_torch_tp.py runs them)."""
    from spe_tpu_torch.config import SPEConfig
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.ops.fused_block import fold_attention
    from spe_tpu_torch.ops.fused_ca_block import class_attention
    from spe_tpu_torch.ops.fused_encoder import softmax_attention
    from spe_tpu_torch.ops.fused_mha import layer_attention
    from spe_tpu_torch.ops.talking_heads import block_attention

    cfg = SPEConfig(backbone="TSCAM_cait_tiny", layer_to_det=2,
                    enc_layers=1, dec_layers=1, num_queries=4, nheads=2,
                    dim_feedforward=16, device="cpu",
                    use_pallas_attention=True, use_fused_block=True,
                    use_fused_layers=True)
    build_model(cfg)  # every fused flag on: no attention kernel is reached
    cfg = cfg.replace(**({off: "off"} if off == "use_fused_ca_block"
                         else {off: False}))

    def routes(model):
        body = model.backbone[0].body
        layers = {"block": body.blocks[0], "ca": body.blocks_token_only[0],
                  "encoder": model.transformer.encoder.layers[0],
                  "decoder": model.transformer.decoder.layers[0]}
        return {k: m.attention for k, m in layers.items() if not m.use_fused}

    plain = {"block": fold_attention, "ca": class_attention,
             "encoder": softmax_attention, "decoder": softmax_attention}
    kernel = {"block": block_attention, "ca": layer_attention,
              "encoder": layer_attention, "decoder": layer_attention}
    off_layers = {"use_fused_block": {"block", "ca"},
                  "use_fused_ca_block": {"ca"},
                  "use_fused_layers": {"encoder", "decoder"}}[off]
    got = routes(build_model(cfg))
    assert set(got) == off_layers
    assert got == {k: kernel[k] for k in off_layers}
    got = routes(build_model(cfg.replace(use_pallas_attention=False)))
    assert got == {k: plain[k] for k in off_layers}
    tp_cfg = cfg.replace(use_fused_block=False, use_fused_layers=False,
                         use_fused_ca_block="auto", tp_attention=True)
    assert routes(build_model(tp_cfg)) == {
        "block": fold_attention, "ca": class_attention,
        "encoder": layer_attention, "decoder": layer_attention}
    with pytest.raises(ValueError, match="model group"):
        build_model(tp_cfg.replace(model_axis=2))


def test_fused_layers_refuse_training_on_the_card():
    """Every fused layer trains on the card: with grad or dropout it takes
    its training kernels (the autograd Function, or the training forward),
    which refuse a tensor that is neither on the CPU nor on the card before
    anything launches, instead of falling back to the plain version."""
    from spe_tpu_torch.ops import (fused_block, fused_ca_block,
                                   fused_decoder, fused_encoder)
    from spe_tpu_torch.ops.refmath import CounterDropout

    blk = dict(tcait.LayerScaleBlock(16, 2).to("meta").named_parameters())
    x = torch.empty((1, 8, 16), dtype=torch.bfloat16, device="meta")
    seed = torch.zeros((1,), dtype=torch.int32, device="meta")
    drop = CounterDropout(seed, 0.1, 0.1)
    fn = fused_block.fused_layer_scale_block
    counts = (fn.launches, fn.train_launches, fn.bwd_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(x, blk, 2)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(x, blk, 2, CounterDropout(seed, attn=0.1))
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(x, blk, 2)
    assert (fn.launches, fn.train_launches, fn.bwd_launches) == counts
    ca = dict(tcait.LayerScaleBlockClassAttn(16, 2).to("meta")
              .named_parameters())
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_ca_block.fused_class_attn_block(x[:, :3], x, ca, 2)

    enc = dict(ttr.TransformerEncoderLayer(16, 2, 32).to("meta")
               .named_parameters())
    dec = dict(ttr.ConditionalDecoderLayer(16, 2, 32, True).to("meta")
               .named_parameters())
    fe, fd = fused_encoder.fused_encoder_layer, fused_decoder.fused_decoder_layer
    counts = [(f.launches, f.train_launches, f.bwd_launches) for f in (fe, fd)]
    with pytest.raises(ValueError, match="CUDA tensor"):  # the Function
        fe(x, x, None, enc, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fd(x, x, x, x, x, None, dec, 2, 1)
    with torch.no_grad():                # dropout alone: the Function too
        with pytest.raises(ValueError, match="CUDA tensor"):
            fe(x, x, None, enc, 2, drop)
        with pytest.raises(ValueError, match="CUDA tensor"):
            fd(x, x, x, x, x, None, dec, 2, 1, drop)
    assert [(f.launches, f.train_launches, f.bwd_launches)
            for f in (fe, fd)] == counts


def test_fused_layers_refuse_non_cpu_devices():
    """The dispatch is by tensor device only: anything not on the CPU goes
    to the CUDA kernels, which refuse a tensor that is not on the card
    instead of falling back to the plain version."""
    from spe_tpu_torch.ops import fused_block

    params = dict(tcait.LayerScaleBlock(192, 4).to("meta").named_parameters())
    x = torch.empty((1, 16, 192), dtype=torch.bfloat16, device="meta")
    launches = fused_block.fused_layer_scale_block.launches
    with torch.no_grad():  # the eval forward (with grad it refuses, B1)
        with pytest.raises(ValueError, match="CUDA tensor"):
            fused_block.fused_layer_scale_block(x, params, 4)
        with pytest.raises(TypeError, match="bf16"):
            fused_block.fused_layer_scale_block(x.float(), params, 4)
    assert fused_block.fused_layer_scale_block.launches == launches
