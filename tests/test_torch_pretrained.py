"""`--backbone_weights PATH` against the JAX package: a tiny CaiT checkpoint
in timm's layout (made with numpy: a 1000-class `head`, a pos_embed on a
5x5 grid against the model's 3x3, no det branch, and a class count that
does not match the model's in extra_cls_token and cls_head_multi_cls),
saved as {'model': sd} with `module.` prefixes, or bare with a det branch
and norm_det as a TSCAM checkpoint holds them. The JAX package loads it
(load_torch_checkpoint -> convert_backbone -> merge_pretrained_backbone
into its init) and the port loads it into the same init
(state_dict_from_jax, then models/convert.py load_backbone_weights): every
parameter equal exactly, the interpolated pos_embed within 1e-6 of its
largest magnitude, the same shape mismatches skipped. parse_config takes a path and refuses `auto`
and URLs."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spe_tpu.models.cait import CaiTConfig
from spe_tpu.models.convert import (convert_backbone, load_torch_checkpoint,
                                    merge_pretrained_backbone)
from spe_tpu.models.detector import SPEDetector
from spe_tpu_torch.cli.main import parse_config
from spe_tpu_torch.models import cait as tcait
from spe_tpu_torch.models import detector as tdet
from spe_tpu_torch.models.convert import (load_backbone_weights,
                                          state_dict_from_jax)

KW = dict(num_det_classes=5, num_queries=8, num_refines=1, enc_layers=1,
          dec_layers=2, dim_feedforward=32, nheads=2)
# img_size 48: a 3x3 pos-embed grid; the checkpoint's is 5x5
BB = dict(img_size=48, patch_size=16, embed_dim=32, depth=4, num_heads=2,
          num_classes=4, layer_to_det=2, depth_token_only=2)
D, SRC_GRID, CKPT_CLASSES = 32, 5, 7


def _block(rng, prefix, ca=False):
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    sd = {f"{prefix}.norm1.weight": 1 + 0.1 * f(D),
          f"{prefix}.norm1.bias": 0.1 * f(D),
          f"{prefix}.norm2.weight": 1 + 0.1 * f(D),
          f"{prefix}.norm2.bias": 0.1 * f(D),
          f"{prefix}.gamma_1": f(D), f"{prefix}.gamma_2": f(D),
          f"{prefix}.mlp.fc1.weight": f(4 * D, D),
          f"{prefix}.mlp.fc1.bias": f(4 * D),
          f"{prefix}.mlp.fc2.weight": f(D, 4 * D),
          f"{prefix}.mlp.fc2.bias": f(D)}
    if ca:
        for n in ("q", "k", "v", "proj"):
            sd[f"{prefix}.attn.{n}.weight"] = f(D, D)
            sd[f"{prefix}.attn.{n}.bias"] = f(D)
        return sd
    H = BB["num_heads"]
    sd.update({f"{prefix}.attn.qkv.weight": f(3 * D, D),
               f"{prefix}.attn.qkv.bias": f(3 * D),
               f"{prefix}.attn.proj.weight": f(D, D),
               f"{prefix}.attn.proj.bias": f(D),
               f"{prefix}.attn.proj_l.weight": f(H, H),
               f"{prefix}.attn.proj_l.bias": f(H),
               f"{prefix}.attn.proj_w.weight": f(H, H),
               f"{prefix}.attn.proj_w.bias": f(H)})
    return sd


def timm_state_dict(seed, det_branch=False):
    """A CaiT state dict in timm's layout (reference TSCAM names with
    det_branch: blocks_det and norm_det), from numpy draws."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    sd = {"patch_embed.proj.weight": 0.05 * f(D, 3, 16, 16),
          "patch_embed.proj.bias": f(D),
          "pos_embed": f(1, SRC_GRID * SRC_GRID, D), "cls_token": f(1, 1, D),
          "norm.weight": 1 + 0.1 * f(D), "norm.bias": 0.1 * f(D),
          "head.weight": f(1000, D), "head.bias": f(1000),
          "extra_cls_token": f(1, CKPT_CLASSES, D),
          "cls_head_multi_cls.weight": f(CKPT_CLASSES, D),
          "cls_head_multi_cls.bias": f(CKPT_CLASSES)}
    for i in range(BB["depth"]):
        sd.update(_block(rng, f"blocks.{i}"))
    for i in range(BB["depth_token_only"]):
        sd.update(_block(rng, f"blocks_token_only.{i}", ca=True))
    if det_branch:
        for i in range(BB["depth"] - BB["layer_to_det"]):
            sd.update(_block(rng, f"blocks_det.{i}"))
        sd["norm_det.weight"], sd["norm_det.bias"] = 1 + 0.1 * f(D), f(D)
    return sd


def write_checkpoint(path, sd, wrapped):
    """{'model': {'module.' + name: tensor}} (wrapped) or the bare dict."""
    if wrapped:
        obj = {"model": {f"module.{k}": torch.from_numpy(v)
                         for k, v in sd.items()}}
    else:
        obj = {k: torch.from_numpy(v) for k, v in sd.items()}
    torch.save(obj, path)


def _sync(fn, *args):
    """One jitted JAX call, finished before anything else is dispatched."""
    return jax.block_until_ready(jax.jit(fn)(*args))


def jax_init():
    model = SPEDetector(backbone_cfg=CaiTConfig(**BB), dropout=0.0, **KW)
    x = jnp.zeros((1, 48, 48, 3), jnp.float32)
    return _sync(lambda: model.init(jax.random.PRNGKey(0), x))["params"]


def jax_merged(path, init):
    """The JAX package's --backbone_weights (spe_tpu/cli/main.py:104-127)
    -> (params with the merged backbone, skipped leaf names)."""
    sd = load_torch_checkpoint(path)
    conv = convert_backbone(sd, depth=BB["depth"],
                            layer_to_det=BB["layer_to_det"],
                            depth_token_only=BB["depth_token_only"])
    flat_init = flax.traverse_util.flatten_dict(init["backbone"])
    flat_conv = flax.traverse_util.flatten_dict(conv)
    skipped = sorted("/".join(k) for k, v in flat_init.items()
                     if k in flat_conv and k != ("pos_embed",)
                     and np.shape(flat_conv[k]) != np.shape(v))
    params = dict(init)
    params["backbone"] = merge_pretrained_backbone(init["backbone"], conv,
                                                   verbose=False)
    return params, skipped


def port_merged(path, init):
    """The port's: its detector on the JAX init, then
    load_backbone_weights -> (state dict, skipped names)."""
    model = tdet.SPEDetector(tcait.CaiTConfig(**BB), **KW).eval()
    model.load_state_dict(state_dict_from_jax(init))
    skipped = load_backbone_weights(model, path, verbose=False)
    return model.state_dict(), sorted(name for name, _, _ in skipped)


@pytest.fixture(scope="module")
def init():
    return jax_init()


@pytest.mark.parametrize("det_branch,wrapped", [(False, True), (True, False)],
                         ids=["timm wrapped", "tscam bare"])
def test_backbone_weights_equal_jax(tmp_path, init, det_branch, wrapped):
    """The port's merged backbone equals the JAX package's exactly (the
    interpolated pos_embed within 1e-6 of its largest magnitude), and so
    does every other parameter
    (the checkpoint touches the backbone only)."""
    path = tmp_path / "cait.pth"
    write_checkpoint(path, timm_state_dict(3, det_branch), wrapped)
    params, _ = jax_merged(path, init)
    want = state_dict_from_jax(params)
    got, _ = port_merged(path, init)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if name.endswith("pos_embed"):   # the two frameworks' bicubic taps
            # summed in other orders: f32 rounding of the largest value
            tol = 1e-6 * max(1.0, float(w.abs().max()))
            assert float((g - w).abs().max()) <= tol, name
        else:
            assert torch.equal(g, w), name


def test_backbone_weights_skip_the_same_mismatches(tmp_path, init):
    """Both skip the entries whose shapes differ from the model's (the
    checkpoint's 7-class extra_cls_token and cls_head_multi_cls, not the
    model's 4), keeping their init, and neither takes timm's 1000-class
    head."""
    path = tmp_path / "cait.pth"
    write_checkpoint(path, timm_state_dict(4), True)
    params, jax_skipped = jax_merged(path, init)
    got, port_skipped = port_merged(path, init)
    names = {"extra_cls_token": "extra_cls_token",
             "cls_head_multi_cls/kernel": "cls_head_multi_cls.weight",
             "cls_head_multi_cls/bias": "cls_head_multi_cls.bias"}
    assert [names[n] for n in jax_skipped] == sorted(port_skipped)
    assert port_skipped == sorted(names.values())
    init_sd = state_dict_from_jax(init)
    for n in port_skipped:
        assert torch.equal(got[f"backbone.0.body.{n}"],
                           init_sd[f"backbone.0.body.{n}"])
    assert not any("head.weight" == k.split("body.")[-1] for k in got)


def test_det_branch_cloned_from_tail_blocks(tmp_path, init):
    """Without a det branch in the checkpoint, blocks_det.i is a copy of
    blocks.{layer_to_det + i} and norm_det keeps its init; the pos_embed
    is the 5x5 grid resized bicubically to 3x3."""
    sd = timm_state_dict(5)
    path = tmp_path / "cait.pth"
    write_checkpoint(path, sd, True)
    got, _ = port_merged(path, init)
    body = "backbone.0.body."
    for i in range(BB["depth"] - BB["layer_to_det"]):
        for k in ("attn.qkv.weight", "mlp.fc2.bias", "gamma_1"):
            assert np.array_equal(
                got[f"{body}blocks_det.{i}.{k}"].numpy(),
                sd[f"blocks.{BB['layer_to_det'] + i}.{k}"])
    init_sd = state_dict_from_jax(init)
    assert torch.equal(got[f"{body}norm_det.weight"],
                       init_sd[f"{body}norm_det.weight"])
    grid = torch.from_numpy(sd["pos_embed"]).reshape(1, 5, 5, D).permute(
        0, 3, 1, 2)
    want = torch.nn.functional.interpolate(grid, size=(3, 3), mode="bicubic",
                                           align_corners=False)
    assert torch.allclose(got[f"{body}pos_embed"],
                          want.permute(0, 2, 3, 1).reshape(1, 9, D),
                          atol=1e-6)


@pytest.mark.parametrize("weights,ok", [
    ("/data/S24_384.pth", True), ("auto", False),
    ("https://dl.fbaipublicfiles.com/deit/S24_384.pth", False)])
def test_parse_config_backbone_weights(weights, ok):
    """A local path is taken, in training and at eval; `auto` and URLs are
    refused with a message that says to pass a local file."""
    for extra in ([], ["--eval"]):
        argv = ["--preset", "voc0712", "--backbone_weights", weights, *extra]
        if ok:
            assert parse_config(argv).backbone_weights == weights
        else:
            with pytest.raises(NotImplementedError, match="local file"):
                parse_config(argv)
