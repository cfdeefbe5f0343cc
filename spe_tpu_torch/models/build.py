"""Model factory (port of spe_tpu/models/build.py): SPEConfig -> SPEDetector
on a device, initialised from a seed the way the JAX package's flax
initialisers draw (truncated normal 0.02 in the backbone, LeCun normal in
the transformer and the segmentation head's dense and conv kernels, the
focal prior on the class bias, a zero last bbox layer, LayerScale at the
backbone's init_scale, the learned position tables uniform in [0, 1)).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn

from spe_tpu_torch.config import SPEConfig
from spe_tpu_torch.models.cait import build_cait_config
from spe_tpu_torch.models.detector import SPEDetector
from spe_tpu_torch.models.layers import lecun_normal_, trunc_normal_
from spe_tpu_torch.ops import kernels
from spe_tpu_torch.parallel import dist
from spe_tpu_torch.parallel.sharding_rules import (check_tp_fused_compat,
                                                   shard_model)
from spe_tpu_torch.parallel.tp import NO_TP


def resolve_device(cfg: SPEConfig) -> torch.device:
    """`--device cpu` runs on the CPU; anything else (SPEConfig's default
    "tpu", "cuda", "gpu") means the CUDA card: in a distributed run the
    process's own, cuda:LOCAL_RANK (parallel.dist.init_distributed)."""
    if cfg.device == "cpu":
        return torch.device("cpu")
    if cfg.device in ("tpu", "gpu", "cuda"):
        own = dist.process_device()
        return own if own is not None else torch.device("cuda")
    return torch.device(cfg.device)


def init_weights(model: SPEDetector, seed: int) -> SPEDetector:
    gen = torch.Generator().manual_seed(seed)
    body = model.backbone[0].body
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, nn.Linear):
                if name.startswith("backbone."):
                    trunc_normal_(mod.weight, generator=gen)
                else:
                    lecun_normal_(mod.weight, generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Conv2d) and not name.startswith(
                    "backbone."):   # flax Conv: LeCun normal over kh kw cin
                lecun_normal_(mod.weight.view(mod.weight.shape[0], -1),
                              generator=gen)
                mod.bias.zero_()
        lecun_normal_(body.patch_embed.proj.weight.view(
            body.patch_embed.proj.weight.shape[0], -1), generator=gen)
        body.patch_embed.proj.bias.zero_()
        for p in (body.pos_embed, body.cls_token, body.extra_cls_token):
            trunc_normal_(p, generator=gen)
        for name, p in model.named_parameters():
            if name.endswith(("gamma_1", "gamma_2")):
                p.fill_(body.cfg.init_scale)
        for layer in model.transformer.encoder.layers:
            D = layer.self_attn.in_proj_weight.shape[1]
            for i in range(3):
                lecun_normal_(layer.self_attn.in_proj_weight[i * D:(i + 1) * D],
                              generator=gen)
            layer.self_attn.in_proj_bias.zero_()
        for emb in [model.query_embed, *model.queries_embed_refine]:
            emb.weight.normal_(0.0, 1.0, generator=gen)
        for emb in model.backbone[1:]:   # PositionEmbeddingLearned
            emb.col_embed.weight.uniform_(0.0, 1.0, generator=gen)
            emb.row_embed.weight.uniform_(0.0, 1.0, generator=gen)
        prior = -math.log((1 - 0.01) / 0.01)
        for head in model.class_embed:
            head.bias.fill_(prior)
        for mlp in model.bbox_embed:
            mlp.layers[-1].weight.zero_()
            mlp.layers[-1].bias.zero_()
    return model


def training_patches(cfg: SPEConfig, patch_size: int) -> int:
    """The most patches a training image of cfg gives: max_size (rounded
    up to bucket_quantum, or to the loader's 16, unless fixed_size) over
    the patch size, squared."""
    side = cfg.max_size
    if not cfg.fixed_size:
        q = cfg.bucket_quantum if cfg.bucket_quantum > 0 else 16
        side = -(-side // q) * q
    return (side // patch_size) ** 2


def kernel_domain_errors(cfg: SPEConfig) -> list:
    """What of cfg's model lies outside the shapes the card's kernels
    take, when a fused flag or use_pallas_attention routes it through them
    (nothing with all of them off: plain PyTorch takes any shape). The
    kernels' declared domains: spe_attention's dq x dv forms
    (kernels.ATTENTION_FORMS) for the class attention (dh x dh), the
    encoder self-attention (dt x dt, dt = D / nheads) and the decoder
    cross-attention (2 dt x dt), and for the XXS patch blocks' eval wl-fold
    (D x D; a wider block evaluates through its training kernels at rate
    0); ln_backward's widths (kernels.LN_BWD_WIDTHS); the talking-heads row
    passes' heads (kernels.TH_ROWS_HEADS) and keys (kernels.TH_ROWS_MAX_N,
    against the most patches of a training image); head widths dh of a
    multiple of 8 (the talking-heads mix and the gemm tiles' rows). Under
    tensor parallelism (model_axis > 1) the backbone runs plain
    (build_model) and only the encoder and cross attention reach the
    kernel (with `tp_attention`), on nheads / model_axis heads of the same
    widths."""
    if not (cfg.use_fused_block or cfg.use_fused_layers or
            cfg.use_pallas_attention or cfg.use_fused_ca_block == "on"):
        return []
    bb = build_cait_config(cfg.backbone, num_classes=cfg.num_classes,
                           layer_to_det=cfg.layer_to_det)
    D, H = bb.embed_dim, bb.num_heads
    dh, dt = D // H, D // cfg.nheads
    forms = (("class", dh, dh), ("encoder", dt, dt), ("cross", 2 * dt, dt))
    errors = [f"attention {name} {dq} x {dv}" for name, dq, dv in forms
              if (dq, dv) not in kernels.ATTENTION_FORMS and
              not (cfg.model_axis > 1 and name == "class")]
    if cfg.model_axis > 1:
        return errors
    if D not in kernels.LN_BWD_WIDTHS:
        errors.append(f"ln_backward D={D} (takes {kernels.LN_BWD_WIDTHS})")
    if H not in kernels.TH_ROWS_HEADS:
        errors.append(f"talking heads H={H} (takes {kernels.TH_ROWS_HEADS})")
    if dh % 8:
        errors.append(f"talking heads mix dh={dh} (a multiple of 8)")
    n = training_patches(cfg, bb.patch_size)
    if n > kernels.TH_ROWS_MAX_N:
        errors.append(f"{n} training patches (at most "
                      f"{kernels.TH_ROWS_MAX_N})")
    return errors


def build_model(cfg: SPEConfig, device=None, tp=None) -> SPEDetector:
    """The detector of `cfg` on `device` (default: resolve_device(cfg)),
    initialised from cfg.seed, in eval mode: the post-norm or pre-norm
    (`pre_norm`) encoder, the sine or learned (`position_embedding`)
    position embedding, with `masks` the segmentation head. With
    `use_pallas_attention`, a layer whose fused flag is off runs its
    attention through the standalone kernels (talking_heads B5 in the
    patch blocks, fused_mha B4 in the class attention, the encoder and the
    decoder cross-attention), as spe_tpu/models/build.py:38,60 routes
    them. On a CUDA device a configuration outside the kernels' shapes
    (kernel_domain_errors) is refused by name. With `remat` the patch and
    det-branch blocks run under torch.utils.checkpoint in training
    (models/cait.LayerScaleBlock), as spe_tpu/models/build.py:42 sets it.

    Tensor parallelism (`--model_axis M`): tp is this process's model
    group (parallel/mesh.make_mesh(...).tp, of size M); every rank draws
    the whole model from the seed and keeps its shards
    (parallel/sharding_rules.shard_model). check_tp_fused_compat refuses
    what the JAX package refuses; with `--masks` the segmentation head's
    MHAttentionMap runs this rank's heads (nheads divisible by M). Under
    TP the fused class attention is off: its kernel takes whole heads, so
    the block runs its plain version on this rank's heads with the
    Megatron collectives (the JAX package computes it through GSPMD). With `tp_attention` the backbone also leaves its
    kernels for its plain attention, as the JAX package builds it
    (spe_tpu/models/build.py:15-42): the talking heads mix every head; B4
    runs head-sharded in the encoder and the decoder cross-attention."""
    tp = NO_TP if tp is None else tp
    if cfg.model_axis != tp.size:
        raise ValueError(
            f"--model_axis {cfg.model_axis}: build the model with its model "
            f"group of {cfg.model_axis} processes (build_model(cfg, device, "
            f"tp=parallel.mesh.make_mesh(world_size, {cfg.model_axis}).tp)),"
            f" not one of {tp.size}")
    check_tp_fused_compat(cfg, tp.size)
    if cfg.masks and cfg.nheads % tp.size:
        raise ValueError(
            f"--masks under tensor parallelism shards the segmentation "
            f"head's MHAttentionMap by heads: nheads ({cfg.nheads}) must be "
            f"divisible by the model axis ({tp.size})")
    device = resolve_device(cfg) if device is None else torch.device(device)
    errors = kernel_domain_errors(cfg) if device.type == "cuda" else []
    if errors:
        raise NotImplementedError(
            f"{cfg.backbone} with the fused flags or use_pallas_attention on "
            f"lies outside the CUDA kernels' shapes: {'; '.join(errors)}. "
            "--no_use_fused_block --no_use_fused_layers "
            "--no_use_pallas_attention runs it in plain PyTorch")
    backbone_cfg = build_cait_config(
        cfg.backbone, num_classes=cfg.num_classes,
        layer_to_det=cfg.layer_to_det, use_fused_block=cfg.use_fused_block,
        use_fused_ca=(False if tp.size > 1 else
                      {"auto": None, "on": True, "off": False}[
                          cfg.use_fused_ca_block]),
        drop_rate=cfg.backbone_drop_rate, attn_drop_rate=cfg.drop_attn_rate,
        drop_path_rate=cfg.drop_path_rate,
        use_pallas=cfg.use_pallas_attention and not cfg.tp_attention,
        remat=cfg.remat)
    if cfg.init_scale:
        backbone_cfg = dataclasses.replace(backbone_cfg,
                                           init_scale=cfg.init_scale)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    model = SPEDetector(backbone_cfg, cfg.num_det_classes,
                        num_queries=cfg.num_queries,
                        num_refines=cfg.num_refines,
                        enc_layers=cfg.enc_layers, dec_layers=cfg.dec_layers,
                        dim_feedforward=cfg.dim_feedforward,
                        nheads=cfg.nheads,
                        use_fused_layers=cfg.use_fused_layers,
                        dropout=cfg.dropout, dtype=dtype,
                        use_pallas=cfg.use_pallas_attention,
                        pre_norm=cfg.pre_norm,
                        position_embedding=cfg.position_embedding,
                        masks=cfg.masks)
    model = init_weights(model, cfg.seed).to(device)
    return shard_model(model, tp).eval()
