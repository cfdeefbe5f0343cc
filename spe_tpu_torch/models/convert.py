"""Weights from the JAX package into the port: the inverse of
spe_tpu.models.convert.convert_detector.

`state_dict_from_jax(params)` takes the JAX detector's `params['params']`
tree (arrays or numpy) and returns the port's state dict under the
reference PyTorch names, so both packages compute the same thing on the
same weights:
  * flax Dense kernel (in, out) -> torch Linear weight (out, in);
  * talking-heads proj_l/proj_w mixing matrices -> their (H, H) Linear
    weights (transposed back);
  * encoder q/k/v Dense -> nn.MultiheadAttention's packed in_proj;
  * the reshaped-matmul patch-embed kernel (p*p*C, D) -> Conv2d (D, C, p, p).
Numpy only: this module does not import jax (the tests hand it numpy).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


def _arr(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _t(a):
    return _arr(np.asarray(a, dtype=np.float32).T)


def _dense(sd, prefix, tree):
    sd[f"{prefix}.weight"] = _t(tree["kernel"])
    if "bias" in tree:
        sd[f"{prefix}.bias"] = _arr(tree["bias"])


def _ln(sd, prefix, tree):
    sd[f"{prefix}.weight"] = _arr(tree["scale"])
    sd[f"{prefix}.bias"] = _arr(tree["bias"])


def _mlp(sd, prefix, tree):
    _dense(sd, f"{prefix}.fc1", tree["fc1"])
    _dense(sd, f"{prefix}.fc2", tree["fc2"])


def _prefixed(prefix, d):
    return OrderedDict((f"{prefix}{k}", v) for k, v in d.items())


def block_state_dict(tree):
    """flax LayerScaleBlock params -> {'norm1.weight': ..., 'attn.qkv.weight': ...}."""
    sd = OrderedDict()
    _ln(sd, "norm1", tree["norm1"])
    a = tree["attn"]
    _dense(sd, "attn.qkv", a["qkv"])
    sd["attn.proj_l.weight"] = _t(a["proj_l"])
    sd["attn.proj_l.bias"] = _arr(a["proj_l_bias"])
    sd["attn.proj_w.weight"] = _t(a["proj_w"])
    sd["attn.proj_w.bias"] = _arr(a["proj_w_bias"])
    _dense(sd, "attn.proj", a["proj"])
    sd["gamma_1"] = _arr(tree["gamma_1"])
    _ln(sd, "norm2", tree["norm2"])
    _mlp(sd, "mlp", tree["mlp"])
    sd["gamma_2"] = _arr(tree["gamma_2"])
    return sd


def class_attn_block_state_dict(tree):
    sd = OrderedDict()
    _ln(sd, "norm1", tree["norm1"])
    for n in ("q", "k", "v", "proj"):
        _dense(sd, f"attn.{n}", tree["attn"][n])
    sd["gamma_1"] = _arr(tree["gamma_1"])
    _ln(sd, "norm2", tree["norm2"])
    _mlp(sd, "mlp", tree["mlp"])
    sd["gamma_2"] = _arr(tree["gamma_2"])
    return sd


def encoder_layer_state_dict(tree):
    sd = OrderedDict()
    a = tree["self_attn"]
    sd["self_attn.in_proj_weight"] = torch.cat(
        [_t(a[n]["kernel"]) for n in ("q_proj", "k_proj", "v_proj")])
    sd["self_attn.in_proj_bias"] = torch.cat(
        [_arr(a[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")])
    _dense(sd, "self_attn.out_proj", a["out_proj"])
    for n in ("linear1", "linear2"):
        _dense(sd, n, tree[n])
    for n in ("norm1", "norm2"):
        _ln(sd, n, tree[n])
    return sd


_DEC_DENSE = ("sa_qcontent_proj", "sa_qpos_proj", "sa_kcontent_proj",
              "sa_kpos_proj", "sa_v_proj", "ca_qcontent_proj", "ca_qpos_proj",
              "ca_kcontent_proj", "ca_kpos_proj", "ca_v_proj",
              "ca_qpos_sine_proj", "linear1", "linear2")


def decoder_layer_state_dict(tree):
    sd = OrderedDict()
    for n in _DEC_DENSE:
        if n in tree:  # ca_qpos_proj: first layer only
            _dense(sd, n, tree[n])
    _dense(sd, "self_attn.out_proj", tree["self_attn"]["out_proj"])
    _dense(sd, "cross_attn.out_proj", tree["cross_attn"]["out_proj"])
    for n in ("norm1", "norm2", "norm3"):
        _ln(sd, n, tree[n])
    return sd


def _count(tree, prefix):
    n = 0
    while f"{prefix}{n}" in tree:
        n += 1
    return n


def _mlp_layers(sd, prefix, tree):
    for i in range(_count(tree, "layers_")):
        _dense(sd, f"{prefix}.layers.{i}", tree[f"layers_{i}"])


def backbone_state_dict(tree):
    """CaiTTwoBranch params -> the body's state dict (relative names)."""
    sd = OrderedDict()
    k = np.asarray(tree["patch_embed"]["proj"]["kernel"], np.float32)
    D = k.shape[1]
    p = int(round((k.shape[0] // 3) ** 0.5))
    sd["patch_embed.proj.weight"] = _arr(
        k.reshape(p, p, 3, D).transpose(3, 2, 0, 1))
    sd["patch_embed.proj.bias"] = _arr(tree["patch_embed"]["proj"]["bias"])
    for n in ("pos_embed", "cls_token", "extra_cls_token"):
        sd[n] = _arr(tree[n])
    for stack in ("blocks_", "blocks_det_"):
        for i in range(_count(tree, stack)):
            sd.update(_prefixed(f"{stack[:-1]}.{i}.",
                                block_state_dict(tree[f"{stack}{i}"])))
    for n in ("norm_det", "norm_to_det"):
        if n in tree:
            _ln(sd, n, tree[n])
    for i in range(_count(tree, "blocks_token_only_")):
        sd.update(_prefixed(f"blocks_token_only.{i}.",
                            class_attn_block_state_dict(
                                tree[f"blocks_token_only_{i}"])))
    _ln(sd, "norm", tree["norm"])
    _dense(sd, "cls_head", tree["cls_head"])
    _dense(sd, "cls_head_multi_cls", tree["cls_head_multi_cls"])
    return sd


def state_dict_from_jax(params, cfg=None):
    """JAX SPEDetector params['params'] -> the port's SPEDetector state dict.
    With an SPEConfig, its layer and refinement counts are checked against
    the tree."""
    tr = params["transformer"]
    dec = tr["decoder"]
    n_enc = _count(tr, "encoder_layers_")
    n_dec = _count(dec, "layers_")
    n_ref = _count(tr, "query_embed_refine_")
    if cfg is not None and (cfg.enc_layers, cfg.dec_layers, cfg.num_refines) \
            != (n_enc, n_dec, n_ref):
        raise ValueError(f"params hold {n_enc} encoder / {n_dec} decoder "
                         f"layers and {n_ref} refinements; cfg says "
                         f"{cfg.enc_layers}/{cfg.dec_layers}/{cfg.num_refines}")
    sd = _prefixed("backbone.0.body.", backbone_state_dict(params["backbone"]))
    for i in range(n_enc):
        sd.update(_prefixed(f"transformer.encoder.layers.{i}.",
                            encoder_layer_state_dict(tr[f"encoder_layers_{i}"])))
    for i in range(n_dec):
        sd.update(_prefixed(f"transformer.decoder.layers.{i}.",
                            decoder_layer_state_dict(dec[f"layers_{i}"])))
    _ln(sd, "transformer.decoder.norm", dec["norm"])
    _mlp_layers(sd, "transformer.decoder.query_scale", dec["query_scale"])
    _mlp_layers(sd, "transformer.decoder.ref_point_head", dec["ref_point_head"])
    sd["query_embed.weight"] = _arr(tr["query_embed"])
    for r in range(n_ref):
        sd[f"queries_embed_refine.{r}.weight"] = _arr(tr[f"query_embed_refine_{r}"])
    for r in range(n_ref + 1):
        _dense(sd, f"class_embed.{r}", params[f"class_embed_{r}"])
        _mlp_layers(sd, f"bbox_embed.{r}", params[f"bbox_embed_{r}"])
    return sd


def load_reference_checkpoint(path):
    """A reference-layout .pth ({'model': state_dict} or a bare state dict,
    the files spe_tpu.models.convert.load_torch_checkpoint reads) -> state
    dict of tensors."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return OrderedDict((k[len("module."):] if k.startswith("module.") else k,
                        torch.as_tensor(v)) for k, v in sd.items())
