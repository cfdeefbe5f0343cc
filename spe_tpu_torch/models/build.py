"""Model factory (port of spe_tpu/models/build.py): SPEConfig -> SPEDetector
on a device, initialised from a seed the way the JAX package's flax
initialisers draw (truncated normal 0.02 in the backbone, LeCun normal in
the transformer, the focal prior on the class bias, a zero last bbox layer,
LayerScale at the backbone's init_scale).
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


def resolve_device(cfg: SPEConfig) -> torch.device:
    """`--device cpu` runs on the CPU; anything else (SPEConfig's default
    "tpu", "cuda", "gpu") means the CUDA card."""
    if cfg.device == "cpu":
        return torch.device("cpu")
    if cfg.device in ("tpu", "gpu", "cuda"):
        return torch.device("cuda")
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
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
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
    (kernels.ATTENTION_FORMS) for the patch blocks' wl-fold (D x D), the
    class attention (dh x dh), the encoder self-attention (dt x dt, dt =
    D / nheads) and the decoder cross-attention (2 dt x dt); ln_backward's
    widths (kernels.LN_BWD_WIDTHS); the talking-heads row passes' heads
    (kernels.TH_ROWS_MAX_H) and keys (kernels.TH_ROWS_MAX_N, against the
    most patches of a training image); th_mix's heads of a multiple of 8
    columns."""
    if not (cfg.use_fused_block or cfg.use_fused_layers or
            cfg.use_pallas_attention or cfg.use_fused_ca_block == "on"):
        return []
    bb = build_cait_config(cfg.backbone, num_classes=cfg.num_classes,
                           layer_to_det=cfg.layer_to_det)
    D, H = bb.embed_dim, bb.num_heads
    dh, dt = D // H, D // cfg.nheads
    errors = [f"attention {name} {dq} x {dv}" for name, dq, dv in (
        ("wl-fold", D, D), ("class", dh, dh), ("encoder", dt, dt),
        ("cross", 2 * dt, dt)) if (dq, dv) not in kernels.ATTENTION_FORMS]
    if D not in kernels.LN_BWD_WIDTHS:
        errors.append(f"ln_backward D={D} (takes {kernels.LN_BWD_WIDTHS})")
    if H > kernels.TH_ROWS_MAX_H:
        errors.append(f"talking heads H={H} (at most {kernels.TH_ROWS_MAX_H})")
    if dh % 8:
        errors.append(f"talking heads mix dh={dh} (a multiple of 8)")
    n = training_patches(cfg, bb.patch_size)
    if n > kernels.TH_ROWS_MAX_N:
        errors.append(f"{n} training patches (at most "
                      f"{kernels.TH_ROWS_MAX_N})")
    return errors


def build_model(cfg: SPEConfig, device=None) -> SPEDetector:
    """The detector of `cfg` on `device` (default: resolve_device(cfg)),
    initialised from cfg.seed, in eval mode. Post-norm encoder and sine
    position embedding only: pre-norm, learned position embeddings,
    segmentation heads and tensor parallelism are not ported yet. With
    `use_pallas_attention`, a layer whose fused flag is off runs its
    attention through the standalone kernels (talking_heads B5 in the
    patch blocks, fused_mha B4 in the class attention, the encoder and the
    decoder cross-attention), as spe_tpu/models/build.py:38,60 routes
    them. On a CUDA device a configuration outside the kernels' shapes
    (kernel_domain_errors) is refused by name."""
    if cfg.pre_norm or cfg.masks or cfg.position_embedding not in ("sine", "v2"):
        raise NotImplementedError(
            "spe_tpu_torch ports the post-norm, sine-embedding detector "
            "without segmentation heads")
    if cfg.tp_attention or cfg.model_axis > 1:
        raise NotImplementedError("tensor parallelism is not ported to "
                                  "spe_tpu_torch")
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
        use_fused_ca={"auto": None, "on": True, "off": False}[
            cfg.use_fused_ca_block],
        drop_rate=cfg.backbone_drop_rate, attn_drop_rate=cfg.drop_attn_rate,
        drop_path_rate=cfg.drop_path_rate,
        use_pallas=cfg.use_pallas_attention)
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
                        use_pallas=cfg.use_pallas_attention)
    return init_weights(model, cfg.seed).to(device).eval()
