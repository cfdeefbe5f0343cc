"""Weights into the port: from the JAX package (the inverse of
spe_tpu.models.convert.convert_detector) and from a pretrained CaiT
checkpoint (`--backbone_weights PATH`, the port's copy of the JAX
package's convert_backbone and merge_pretrained_backbone).

`state_dict_from_jax(params)` takes the JAX detector's `params['params']`
tree (arrays or numpy) and returns the port's state dict under the
reference PyTorch names, so both packages compute the same thing on the
same weights:
  * flax Dense kernel (in, out) -> torch Linear weight (out, in);
  * talking-heads proj_l/proj_w mixing matrices -> their (H, H) Linear
    weights (transposed back);
  * encoder q/k/v Dense -> nn.MultiheadAttention's packed in_proj;
  * the reshaped-matmul patch-embed kernel (p*p*C, D) -> Conv2d (D, C, p, p);
  * the segmentation head `segm_head/{bbox_attention, mask_head}` ->
    `bbox_attention.{q,k}_linear` (DETR's names) and `mask_head.{feat_proj,
    conv_i, gn_i, out}` (the JAX package's: its mask head is not DETR's),
    flax Conv kernels HWIO -> OIHW, GroupNorm scale -> weight;
  * the learned position tables `pos_embed_learned/{col,row}_embed` ->
    `backbone.1.{col,row}_embed.weight` (DETR's Joiner, nn.Embedding(50,
    D/2)), and the pre-norm encoder's `transformer/encoder_norm` ->
    `transformer.encoder.norm` (DETR's name).
A pretrained backbone (`convert_backbone`, `merge_pretrained_backbone`):
a timm CaiT state dict (or a reference TSCAM one) becomes the backbone
body's state dict as the reference's timm `pretrained=True` and
finetune_det build it (reference models/cait.py:724-742, 1676-1700), with
spe_tpu/models/convert.py:96-143, 235-288's semantics.
Numpy only: this module does not import jax (the tests hand it numpy).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from spe_tpu_torch.models.layers import interpolate_pos_embed
from spe_tpu_torch.parallel.sharding_rules import (gather_tensors,
                                                   shard_state_dict)
from spe_tpu_torch.parallel.tp import NO_TP


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


def _conv(sd, prefix, tree):
    sd[f"{prefix}.weight"] = _arr(np.asarray(tree["kernel"], np.float32)
                                  .transpose(3, 2, 0, 1))
    sd[f"{prefix}.bias"] = _arr(tree["bias"])


def segm_head_state_dict(tree):
    """flax SegmentationHead params -> {'bbox_attention.q_linear.weight':
    ..., 'mask_head.conv_0.weight': ...}."""
    sd = OrderedDict()
    for n in ("q_linear", "k_linear"):
        _dense(sd, f"bbox_attention.{n}", tree["bbox_attention"][n])
    mh = tree["mask_head"]
    _dense(sd, "mask_head.feat_proj", mh["feat_proj"])
    for i in range(_count(mh, "conv_")):
        _conv(sd, f"mask_head.conv_{i}", mh[f"conv_{i}"])
        _ln(sd, f"mask_head.gn_{i}", mh[f"gn_{i}"])
    _conv(sd, "mask_head.out", mh["out"])
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
    if "encoder_norm" in tr:
        _ln(sd, "transformer.encoder.norm", tr["encoder_norm"])
    _ln(sd, "transformer.decoder.norm", dec["norm"])
    _mlp_layers(sd, "transformer.decoder.query_scale", dec["query_scale"])
    _mlp_layers(sd, "transformer.decoder.ref_point_head", dec["ref_point_head"])
    sd["query_embed.weight"] = _arr(tr["query_embed"])
    for r in range(n_ref):
        sd[f"queries_embed_refine.{r}.weight"] = _arr(tr[f"query_embed_refine_{r}"])
    for r in range(n_ref + 1):
        _dense(sd, f"class_embed.{r}", params[f"class_embed_{r}"])
        _mlp_layers(sd, f"bbox_embed.{r}", params[f"bbox_embed_{r}"])
    if "pos_embed_learned" in params:
        for n in ("col_embed", "row_embed"):
            sd[f"backbone.1.{n}.weight"] = _arr(params["pos_embed_learned"][n])
    if "segm_head" in params:
        sd.update(segm_head_state_dict(params["segm_head"]))
    return sd


def load_reference_checkpoint(path):
    """A reference-layout .pth ({'model': state_dict} or a bare state dict,
    the files spe_tpu.models.convert.load_torch_checkpoint reads) -> state
    dict of tensors."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return OrderedDict((k[len("module."):] if k.startswith("module.") else k,
                        torch.as_tensor(v)) for k, v in sd.items())


# the parameters of a LayerScale block and of a class-attention block, as
# the JAX package's converter reads them (spe_tpu/models/convert.py:57-82);
# a missing bias of a Linear is the only key it allows to be absent
_BLOCK_KEYS = ("norm1.weight", "norm1.bias", "attn.qkv.weight",
               "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias",
               "attn.proj_l.weight", "attn.proj_l.bias", "attn.proj_w.weight",
               "attn.proj_w.bias", "gamma_1", "norm2.weight", "norm2.bias",
               "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight",
               "mlp.fc2.bias", "gamma_2")
_CA_BLOCK_KEYS = ("norm1.weight", "norm1.bias",
                  *(f"attn.{n}.{w}" for n in ("q", "k", "v", "proj")
                    for w in ("weight", "bias")),
                  "gamma_1", "norm2.weight", "norm2.bias", "mlp.fc1.weight",
                  "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias", "gamma_2")
_LINEAR_BIASES = ("attn.qkv.bias", "attn.proj.bias", "mlp.fc1.bias",
                  "mlp.fc2.bias", "attn.q.bias", "attn.k.bias", "attn.v.bias",
                  "attn.proj.bias")


def _copy_block(sd, out, src, dst, keys):
    for k in keys:
        if f"{src}.{k}" in sd or k not in _LINEAR_BIASES:
            out[f"{dst}.{k}"] = sd[f"{src}.{k}"]


def _copy_present(sd, out, names):
    for n in names:
        if n in sd:
            out[n] = sd[n]


def convert_backbone(sd, depth, layer_to_det, depth_token_only=2,
                     two_branch=True):
    """A timm CaiT (or reference TSCAM) state dict -> the backbone body's
    state dict (relative names), as spe_tpu.models.convert.convert_backbone
    builds its tree: `module.` prefixes stripped; the patch embedding,
    pos_embed, cls_token, norm and `depth` blocks copied; the det branch's
    depth - layer_to_det blocks copied from `blocks_det.i`, or cloned from
    `blocks.{layer_to_det + i}` where the checkpoint has no det branch
    (reference init_blocks_det_weight, cait.py:724-726); norm_det copied
    where present (else it keeps its init); a single-branch model's
    norm_to_det copied, else seeded from norm; the class-attention blocks,
    extra_cls_token and the two heads where present (a classification
    checkpoint's 1000-class `head` has no place in the port)."""
    sd = {k[len("module."):] if k.startswith("module.") else k:
          torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    out = OrderedDict()
    for n in ("patch_embed.proj.weight", "pos_embed", "cls_token",
              "norm.weight", "norm.bias"):
        out[n] = sd[n]
    _copy_present(sd, out, ("patch_embed.proj.bias",))
    for i in range(depth):
        _copy_block(sd, out, f"blocks.{i}", f"blocks.{i}", _BLOCK_KEYS)
    for i in range(depth - layer_to_det if two_branch else 0):
        src = (f"blocks_det.{i}" if f"blocks_det.{i}.norm1.weight" in sd
               else f"blocks.{layer_to_det + i}")
        _copy_block(sd, out, src, f"blocks_det.{i}", _BLOCK_KEYS)
    if two_branch:
        _copy_present(sd, out, ("norm_det.weight", "norm_det.bias"))
    elif "norm_to_det.weight" in sd:
        _copy_present(sd, out, ("norm_to_det.weight", "norm_to_det.bias"))
    else:
        out["norm_to_det.weight"], out["norm_to_det.bias"] = (
            sd["norm.weight"], sd["norm.bias"])
    for i in range(depth_token_only):
        if f"blocks_token_only.{i}.norm1.weight" in sd:
            _copy_block(sd, out, f"blocks_token_only.{i}",
                        f"blocks_token_only.{i}", _CA_BLOCK_KEYS)
    _copy_present(sd, out, ("extra_cls_token", "cls_head.weight",
                            "cls_head.bias", "cls_head_multi_cls.weight",
                            "cls_head_multi_cls.bias"))
    return out


def merge_pretrained_backbone(init, converted, verbose=True):
    """A converted backbone (convert_backbone) merged into the body's
    initial state dict, as spe_tpu.models.convert.merge_pretrained_backbone
    merges its trees: every entry both have is copied (in the init's
    dtype); pos_embed on another grid is interpolated bicubically
    (models/layers.py interpolate_pos_embed, square grids); every other
    shape mismatch keeps the init and is listed; what the checkpoint lacks
    keeps the init. -> (merged state dict, [(name, checkpoint shape, init
    shape)] skipped)."""
    merged, copied, skipped = OrderedDict(), 0, []
    for name, v in init.items():
        if name not in converted:
            merged[name] = v
            continue
        cand = converted[name]
        if tuple(cand.shape) == tuple(v.shape):
            merged[name] = cand.to(v.dtype)
            copied += 1
        elif name == "pos_embed":
            n_src = int(round(cand.shape[1] ** 0.5))
            n_dst = int(round(v.shape[1] ** 0.5))
            merged[name] = interpolate_pos_embed(
                cand.float(), (n_src, n_src), (n_dst, n_dst)).to(
                v.dtype).reshape(v.shape)
            copied += 1
        else:
            merged[name] = v
            skipped.append((name, tuple(cand.shape), tuple(v.shape)))
    if verbose:
        print(f"pretrained backbone: copied {copied}/{len(init)} entries"
              + (f", skipped shape-mismatched {skipped}" if skipped else ""),
              flush=True)
    return merged, skipped


def load_backbone_weights(model, path, verbose=True):
    """`--backbone_weights PATH`: the local checkpoint at path
    (load_reference_checkpoint: {'model': sd} or bare, `module.` stripped)
    converted and merged into model's backbone body in place -> the
    skipped shape mismatches. A model split for tensor parallelism is
    merged whole (its shards gathered over the model group, collective)
    and keeps its shards of the merge."""
    body = model.backbone[0].body
    c = body.cfg
    converted = convert_backbone(load_reference_checkpoint(path), c.depth,
                                 c.layer_to_det, c.depth_token_only,
                                 c.two_branch)
    tp = getattr(model, "tp", NO_TP)
    init = OrderedDict((k, v.detach().cpu()) for k, v in
                       gather_tensors(body.state_dict().items(), tp).items())
    merged, skipped = merge_pretrained_backbone(init, converted, verbose)
    if tp.size > 1:   # tensor parallelism: this rank's shards of the merge
        merged = shard_state_dict(merged, tp.index, tp.size)
    body.load_state_dict(merged)
    return skipped
