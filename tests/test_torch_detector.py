"""The port's whole detector slice against the JAX package: a tiny
SPEDetector with the fused flags on (the JAX side runs its Pallas kernels
in interpret mode, SPE_FUSED_INTERPRET=1), the port on the same weights
carried over by state_dict_from_jax; plus the weight bridge round trip and
the import rule (the port never imports jax).

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


def jax_detector(fused):
    bb = CaiTConfig(**BB, use_fused_block=fused)
    return SPEDetector(backbone_cfg=bb, dropout=0.1, use_fused_layers=fused,
                       **KW)


def port_detector(fused):
    bb = tcait.CaiTConfig(**BB, use_fused_block=fused)
    return tdet.SPEDetector(bb, use_fused_layers=fused, **KW).eval()


@pytest.fixture
def weights(rng):
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = jax_detector(False).init(jax.random.PRNGKey(0), x)
    return {"params": _near_one(params["params"], rng)}


@pytest.mark.parametrize("fused", [True, False])
def test_detector_matches_jax(weights, rng, monkeypatch, fused):
    monkeypatch.setenv("SPE_FUSED_INTERPRET", "1")
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    pad = np.zeros((2, 64, 64), bool)
    pad[1, :, 48:] = True
    want = jax_detector(fused).apply(weights, jnp.asarray(x),
                                     pad_mask=jnp.asarray(pad),
                                     deterministic=True)
    model = port_detector(fused)
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
    p = jax.tree_util.tree_map(np.asarray, weights["params"])
    sd = state_dict_from_jax(p)
    assert set(sd) == set(port_detector(True).state_dict())
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
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("off", ["use_fused_block", "use_fused_ca_block",
                                 "use_fused_layers"])
def test_build_model_refuses_unported_attention_kernels(off):
    """use_pallas_attention with a fused flag off would run pallas_attention
    or pallas_mha in the JAX package; the port refuses it (ROADMAP B4/B5)
    rather than run plain PyTorch in their place."""
    from spe_tpu_torch.config import SPEConfig
    from spe_tpu_torch.models.build import build_model

    cfg = SPEConfig(backbone="TSCAM_cait_tiny", layer_to_det=2,
                    enc_layers=1, dec_layers=1, num_queries=4, nheads=2,
                    dim_feedforward=16, device="cpu",
                    use_pallas_attention=True, use_fused_block=True,
                    use_fused_layers=True)
    build_model(cfg)  # every fused flag on: no attention kernel is reached
    bad = cfg.replace(**({off: "off"} if off == "use_fused_ca_block"
                         else {off: False}))
    with pytest.raises(NotImplementedError, match="B4/B5"):
        build_model(bad)
    build_model(bad.replace(use_pallas_attention=False))


def test_fused_layers_refuse_training_on_the_card():
    """On a non-CPU tensor the encoder and decoder wrappers are the eval
    forward: grad on an input or parameter, or a dropout rate above 0,
    raises (ROADMAP B1b) before anything launches. The backbone blocks
    train on the card: with grad or dropout they take their training
    kernels, which refuse a tensor that is not on the card."""
    from spe_tpu_torch.ops import (fused_block, fused_ca_block,
                                   fused_decoder, fused_encoder)
    from spe_tpu_torch.ops.refmath import CounterDropout, Dropout

    blk = dict(tcait.LayerScaleBlock(16, 2).to("meta").named_parameters())
    x = torch.empty((1, 8, 16), dtype=torch.bfloat16, device="meta")
    fn = fused_block.fused_layer_scale_block
    counts = (fn.launches, fn.train_launches, fn.bwd_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fn(x, blk, 2)
    with torch.no_grad():
        seed = torch.zeros((1,), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(x, blk, 2, CounterDropout(seed, attn=0.1))
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(x, blk, 2)
    assert (fn.launches, fn.train_launches, fn.bwd_launches) == counts
    ca = dict(tcait.LayerScaleBlockClassAttn(16, 2).to("meta")
              .named_parameters())
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_ca_block.fused_class_attn_block(x[:, :3], x, ca, 2)
    enc = {k: torch.empty(0, device="meta", requires_grad=True)
           for k in fused_encoder.PARAM_NAMES}
    with pytest.raises(NotImplementedError, match="B1"):
        fused_encoder.fused_encoder_layer(x, x, None, enc, 2)
    dec = {k: torch.empty(0, device="meta") for k in fused_decoder.PARAM_NAMES}
    with pytest.raises(NotImplementedError, match="B1"):
        fused_decoder.fused_decoder_layer(
            x, x, x, x, x, None, dec, 2, 1, Dropout(torch.Generator(),
                                                    attn=0.1, proj=0.1))


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
