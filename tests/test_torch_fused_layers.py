"""The port's four fused layers (spe_tpu_torch/ops/fused_*.py) against the
JAX package: each plain PyTorch version vs the Pallas kernel it stands
beside (interpret mode, dropout 0) and vs the flax module, on the same
numpy-seeded inputs and weights, in f32 at a small size with LayerScale
gammas near 1 so every branch shows. On CPU tensors the dispatcher must
take the plain version, so it is checked equal to it as well.

Tolerances are the JAX package's own kernel-parity tolerances
(tests/test_pallas_block.py, test_pallas_ca_block.py, test_pallas_encoder.py:
2e-5; test_pallas_decoder.py: 3e-5)."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spe_tpu.models.cait import LayerScaleBlock, LayerScaleBlockClassAttn
from spe_tpu.models.transformer import (ConditionalDecoderLayer,
                                        TransformerEncoderLayer)
from spe_tpu.ops.pallas_block import fused_layer_scale_block as jax_block
from spe_tpu.ops.pallas_ca_block import fused_class_attn_block as jax_ca
from spe_tpu.ops.pallas_decoder import fused_decoder_layer as jax_dec
from spe_tpu.ops.pallas_encoder import fused_encoder_layer as jax_enc
from spe_tpu_torch.models import cait as tcait
from spe_tpu_torch.models import transformer as ttr
from spe_tpu_torch.models.convert import (block_state_dict,
                                          class_attn_block_state_dict,
                                          decoder_layer_state_dict,
                                          encoder_layer_state_dict)
from spe_tpu_torch.ops import (fused_block, fused_ca_block, fused_decoder,
                               fused_encoder)

B, D, H = 2, 32, 2


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


def _near_one(params, rng, keys=("gamma_1", "gamma_2", "scale")):
    """Redraw LayerScale gammas and LayerNorm scales near 1 (and LN biases
    small) so no branch hides behind a 1e-5 scale."""
    flat = flax.traverse_util.flatten_dict(params)
    for k, v in flat.items():
        if k[-1] in keys:
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


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol, err_msg=msg)


def test_layer_scale_block(rng):
    N = 48
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    blk = LayerScaleBlock(num_heads=H, init_scale=1.0)
    pdict = blk.init(jax.random.PRNGKey(0), jnp.asarray(x))
    pdict = {"params": _near_one(pdict["params"], rng)}
    p = pdict["params"]
    a = p["attn"]
    kernel_params = (
        _row(p["norm1"]["scale"]), _row(p["norm1"]["bias"]),
        a["qkv"]["kernel"], _row(a["qkv"]["bias"]), a["proj_l"],
        a["proj_l_bias"].reshape(H, 1), a["proj_w"],
        a["proj_w_bias"].reshape(H, 1), a["proj"]["kernel"],
        _row(a["proj"]["bias"]), _row(p["gamma_1"]), _row(p["norm2"]["scale"]),
        _row(p["norm2"]["bias"]), p["mlp"]["fc1"]["kernel"],
        _row(p["mlp"]["fc1"]["bias"]), p["mlp"]["fc2"]["kernel"],
        _row(p["mlp"]["fc2"]["bias"]), _row(p["gamma_2"]),
        jnp.zeros((1,), jnp.float32))
    want_kernel = _sync(lambda x, kp: jax_block(x, kp, 16, True, 0.0, 0.0,
                                                0.0),
                        jnp.asarray(x), kernel_params)
    want_flax = blk.apply(pdict, jnp.asarray(x), True)

    sd = block_state_dict(jax.tree_util.tree_map(np.asarray, p))
    got = fused_block.layer_scale_block_reference(_t(x), sd, H)
    _close(_np(got), want_kernel, 2e-5, "plain vs Pallas kernel")
    _close(_np(got), want_flax, 2e-5, "plain vs flax block")
    assert torch.equal(fused_block.fused_layer_scale_block(_t(x), sd, H), got)

    mod = tcait.LayerScaleBlock(D, H)
    mod.load_state_dict(sd)
    _close(_np(mod(_t(x))), want_flax, 2e-5, "block module (plain path) vs flax block")


def test_class_attn_block(rng):
    t, P = 5, 40
    x = rng.normal(size=(B, P, D)).astype(np.float32)
    cls = rng.normal(size=(B, t, D)).astype(np.float32)
    blk = LayerScaleBlockClassAttn(num_heads=H, num_tokens=t, init_scale=1.0)
    pdict = blk.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(cls))
    pdict = {"params": _near_one(pdict["params"], rng)}
    p = pdict["params"]
    a = p["attn"]
    kernel_params = (
        _row(p["norm1"]["scale"]), _row(p["norm1"]["bias"]),
        a["q"]["kernel"], _row(a["q"]["bias"]), a["k"]["kernel"],
        _row(a["k"]["bias"]), a["v"]["kernel"], _row(a["v"]["bias"]),
        a["proj"]["kernel"], _row(a["proj"]["bias"]), _row(p["gamma_1"]),
        _row(p["norm2"]["scale"]), _row(p["norm2"]["bias"]),
        p["mlp"]["fc1"]["kernel"], _row(p["mlp"]["fc1"]["bias"]),
        p["mlp"]["fc2"]["kernel"], _row(p["mlp"]["fc2"]["bias"]),
        _row(p["gamma_2"]))
    k_cls, k_attn = _sync(lambda c, x, kp: jax_ca(c, x, kp, H, True),
                          jnp.asarray(cls), jnp.asarray(x), kernel_params)
    f_cls, f_attn = blk.apply(pdict, jnp.asarray(x), jnp.asarray(cls))

    sd = class_attn_block_state_dict(jax.tree_util.tree_map(np.asarray, p))
    g_cls, g_attn = fused_ca_block.class_attn_block_reference(
        _t(cls), _t(x), sd, H)
    assert g_attn.dtype == torch.float32 and g_attn.shape == (B, H, t, t + P)
    _close(_np(g_cls), k_cls, 2e-5, "cls: plain vs Pallas kernel")
    _close(_np(g_attn), k_attn, 2e-5, "attn: plain vs Pallas kernel")
    _close(_np(g_cls), f_cls, 2e-5, "cls: plain vs flax block")
    _close(_np(g_attn), f_attn, 2e-5, "attn: plain vs flax block")
    d_cls, d_attn = fused_ca_block.fused_class_attn_block(_t(cls), _t(x), sd, H)
    assert torch.equal(d_cls, g_cls) and torch.equal(d_attn, g_attn)

    mod = tcait.LayerScaleBlockClassAttn(D, H)
    mod.load_state_dict(sd)
    m_cls, m_attn = mod(_t(x), _t(cls))
    _close(_np(m_cls), f_cls, 2e-5, "cls: block module (plain path) vs flax block")
    _close(_np(m_attn), f_attn, 2e-5, "attn: block module (plain path) vs flax block")


def test_encoder_layer(rng):
    N, F = 40, 48
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    pos = rng.normal(size=(B, N, D)).astype(np.float32)
    mask = _mask(N)
    layer = TransformerEncoderLayer(H, F, dropout=0.1)
    pdict = layer.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(pos))
    pdict = {"params": _near_one(pdict["params"], rng)}
    p = pdict["params"]
    sa = p["self_attn"]
    kernel_params = tuple(
        v for n in ("q_proj", "k_proj", "v_proj", "out_proj")
        for v in (sa[n]["kernel"], _row(sa[n]["bias"]))) + (
        _row(p["norm1"]["scale"]), _row(p["norm1"]["bias"]),
        p["linear1"]["kernel"], _row(p["linear1"]["bias"]),
        p["linear2"]["kernel"], _row(p["linear2"]["bias"]),
        _row(p["norm2"]["scale"]), _row(p["norm2"]["bias"]),
        _bias(mask), jnp.zeros((1,), jnp.float32))
    want_kernel = _sync(lambda x, pos, kp: jax_enc(x, pos, kp, H, True, 0.0),
                        jnp.asarray(x), jnp.asarray(pos), kernel_params)
    want_flax = layer.apply(pdict, jnp.asarray(x), jnp.asarray(pos),
                            key_padding_mask=jnp.asarray(mask),
                            deterministic=True)

    sd = encoder_layer_state_dict(jax.tree_util.tree_map(np.asarray, p))
    tmask = torch.from_numpy(mask)
    got = fused_encoder.encoder_layer_reference(_t(x), _t(pos), tmask, sd, H)
    _close(_np(got), want_kernel, 2e-5, "plain vs Pallas kernel")
    _close(_np(got), want_flax, 2e-5, "plain vs flax layer")
    assert torch.equal(
        fused_encoder.fused_encoder_layer(_t(x), _t(pos), tmask, sd, H), got)

    mod = ttr.TransformerEncoderLayer(D, H, F)
    mod.load_state_dict(sd)
    _close(_np(mod(_t(x), _t(pos), tmask)), want_flax, 2e-5,
           "layer module (plain path) vs flax layer")


def _pad_sets(a, S, Q, Qp):
    a = a.reshape(a.shape[0], S, Q, -1)
    a = np.pad(a, ((0, 0), (0, 0), (0, Qp - Q), (0, 0)))
    return a.reshape(a.shape[0], S * Qp, -1)


@pytest.mark.parametrize("is_first", [True, False])
def test_decoder_layer(rng, is_first):
    """Two query sets of Q = 6 (not a multiple of 8: the Pallas kernel gets
    them padded to 8 with masked keys, the port computes on the 6)."""
    S, Q, N, F = 2, 6, 24, 40
    Qp = 8
    tgt, qpos, sine = (rng.normal(size=(B, S * Q, D)).astype(np.float32)
                       for _ in range(3))
    mem, pos = (rng.normal(size=(B, N, D)).astype(np.float32) for _ in range(2))
    mask = _mask(N)
    layer = ConditionalDecoderLayer(H, F, dropout=0.1, num_sets=S)
    args = [jnp.asarray(a) for a in (tgt, mem, pos, qpos, sine)]
    pdict = layer.init(jax.random.PRNGKey(0), *args, is_first=is_first)
    pdict = {"params": _near_one(pdict["params"], rng)}
    p = pdict["params"]

    def dense(n):
        return p[n]["kernel"], _row(p[n]["bias"])

    names = (["sa_qcontent_proj", "sa_qpos_proj", "sa_kcontent_proj",
              "sa_kpos_proj", "sa_v_proj"])
    ps = [v for n in names for v in dense(n)]
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
    qbias = jnp.asarray(np.where(np.arange(Qp) < Q, 0.0, -1e9)
                        .astype(np.float32).reshape(1, Qp))
    padded = [jnp.asarray(_pad_sets(a, S, Q, Qp)) for a in (tgt, qpos, sine)]
    out = _sync(lambda t, m, p, q, s, kp: jax_dec(t, m, p, q, s, H, S, True,
                                                  0.0, kp),
                padded[0], jnp.asarray(mem), jnp.asarray(pos), padded[1],
                padded[2],
                tuple(ps) + (_bias(mask), qbias, jnp.zeros((1,), jnp.float32)))
    want_kernel = np.asarray(out).reshape(B, S, Qp, D)[:, :, :Q].reshape(
        B, S * Q, D)
    want_flax = layer.apply(pdict, *args, is_first=is_first,
                            key_padding_mask=jnp.asarray(mask),
                            deterministic=True)

    sd = decoder_layer_state_dict(jax.tree_util.tree_map(np.asarray, p))
    assert ("ca_qpos_proj.weight" in sd) == is_first
    targs = [_t(a) for a in (tgt, mem, pos, qpos, sine)] + [
        torch.from_numpy(mask)]
    got = fused_decoder.decoder_layer_reference(*targs, sd, H, S)
    _close(_np(got), want_kernel, 3e-5, "plain vs Pallas kernel")
    _close(_np(got), want_flax, 3e-5, "plain vs flax layer")
    assert torch.equal(fused_decoder.fused_decoder_layer(*targs, sd, H, S), got)

    mod = ttr.ConditionalDecoderLayer(D, H, F, is_first, num_sets=S)
    mod.load_state_dict(sd)
    _close(_np(mod(*targs)), want_flax, 3e-5, "layer module (plain path) vs flax layer")
