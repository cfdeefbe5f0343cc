"""SPE detector: CaiT two-branch backbone + Conditional DETR with refinement
query sets (port of spe_tpu/models/detector.py; reference
models/conditional_detr.py:33-124 `ConditionalDETR_Refine`).

forward(images (B, H, W, 3), pad_mask (B, H, W) True on padded pixels,
        generator: the torch.Generator of the dropout masks in training
        mode, on the images' device, with_masks) ->
  {"backbone": {x_logits, x_cls_logits, cams_cls, x_patch},
   "stages": {r: {pred_logits (B, Q, K), pred_boxes (B, Q, 4) sigmoid cxcywh,
                  aux_pred_logits (L-1, B, Q, K), aux_pred_boxes}},
   "pred_masks": (B, Q, 4 gh, 4 gw) mask logits, with `masks` and
                 with_masks only}
as the JAX package returns it (JAX detector.py:128-136). With `masks` the
segmentation head (models/segmentation.py) runs on stage 0's last decoder
states and the f32 patch grid, with the grid's pad mask, but only when the
caller asks for it (with_masks: the mask losses): under jit the JAX
package drops it wherever nothing reads it, and its activations at the
recipe's 2400 queries of 128^2 are tens of GB, so eval forwards never
compute it. `position_embedding` is the sine embedding ('sine'/'v2') or
the learned one ('learned'/'v3', models/position_encoding.py); `pre_norm`
the pre-norm encoder. State-dict names are the reference's:
`backbone.0.body.*`, `backbone.1.{row,col}_embed` (learned positions, as
DETR's Joiner holds them), `transformer.*`, `query_embed`,
`queries_embed_refine.{r}`, `class_embed.{r}`, `bbox_embed.{r}.layers.{i}`,
`bbox_attention.*`, `mask_head.*`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from spe_tpu_torch.models.cait import CaiTConfig, CaiTTwoBranch
from spe_tpu_torch.models.layers import Linear
from spe_tpu_torch.models.position_encoding import build_position_encoding
from spe_tpu_torch.models.segmentation import (MaskHead, MHAttentionMap,
                                               segmentation_head)
from spe_tpu_torch.models.transformer import MLP, ConditionalTransformer
from spe_tpu_torch.ops.embeds import inverse_sigmoid, position_embedding_sine


class Backbone(nn.Module):
    """Holds the CaiT body under the reference's `backbone.0.body` prefix."""

    def __init__(self, cfg: CaiTConfig):
        super().__init__()
        self.body = CaiTTwoBranch(cfg)


def grid_mask(pad_mask, gh: int, gw: int):
    """Nearest-neighbour downsample of a (B, H, W) pixel padding mask to the
    patch grid, sampling at half-pixel centres like jax.image.resize."""
    B, H, W = pad_mask.shape
    ys = ((torch.arange(gh, device=pad_mask.device) + 0.5) * (H / gh)).long()
    xs = ((torch.arange(gw, device=pad_mask.device) + 0.5) * (W / gw)).long()
    return pad_mask[:, ys.clamp(max=H - 1)][:, :, xs.clamp(max=W - 1)]


class SPEDetector(nn.Module):
    def __init__(self, backbone_cfg: CaiTConfig, num_det_classes: int,
                 num_queries: int = 300, num_refines: int = 1,
                 enc_layers: int = 6, dec_layers: int = 6,
                 dim_feedforward: int = 2048, nheads: int = 8,
                 use_fused_layers: bool = False, dropout: float = 0.0,
                 dtype=torch.float32, use_pallas: bool = False,
                 pre_norm: bool = False, position_embedding: str = "sine",
                 masks: bool = False):
        super().__init__()
        D = backbone_cfg.embed_dim
        self.dtype = dtype
        self.num_refines = num_refines
        self.masks = masks
        learned = build_position_encoding(D, position_embedding)
        self.backbone = nn.ModuleList([Backbone(backbone_cfg)]
                                      + ([learned] if learned else []))
        self.transformer = ConditionalTransformer(
            D, nheads, enc_layers, dec_layers, dim_feedforward,
            num_sets=num_refines + 1, use_fused_layers=use_fused_layers,
            dropout=dropout, use_pallas=use_pallas,
            normalize_before=pre_norm)
        self.query_embed = nn.Embedding(num_queries, D)
        self.queries_embed_refine = nn.ModuleList(
            nn.Embedding(num_queries, D) for _ in range(num_refines))
        self.class_embed = nn.ModuleList(
            Linear(D, num_det_classes) for _ in range(num_refines + 1))
        self.bbox_embed = nn.ModuleList(
            MLP(D, D, 4, 3) for _ in range(num_refines + 1))
        if masks:
            self.bbox_attention = MHAttentionMap(D, nheads)
            self.mask_head = MaskHead(D, nheads)

    def forward(self, images, pad_mask=None, generator=None,
                with_masks=False):
        body = self.backbone[0].body
        bb = body(images.to(self.dtype), generator)
        feat = bb["x_patch"]
        B, gh, gw, D = feat.shape
        if pad_mask is None:
            gmask = torch.zeros((B, gh, gw), dtype=torch.bool,
                                device=feat.device)
        else:
            gmask = grid_mask(pad_mask.to(feat.device), gh, gw)
        if len(self.backbone) > 1:
            pos = self.backbone[1](B, gh, gw)
        else:
            pos = position_embedding_sine(gmask, num_pos_feats=D // 2)
        src = feat.reshape(B, gh * gw, D)
        pos = pos.reshape(B, gh * gw, D).to(src.dtype)
        key_padding = gmask.reshape(B, gh * gw) if pad_mask is not None else None
        hs_all, ref_all = self.transformer(
            src, pos, [self.query_embed.weight]
            + [e.weight for e in self.queries_embed_refine], key_padding,
            generator)

        stages = {}
        for r in range(self.num_refines + 1):
            hs = hs_all[r].float()                       # (L, B, Q, D)
            ref = inverse_sigmoid(ref_all[r].float())    # (B, Q, 2)
            cls = self.class_embed[r](hs)
            tmp = self.bbox_embed[r](hs)
            tmp = torch.cat([tmp[..., :2] + ref[None], tmp[..., 2:]], dim=-1)
            coords = tmp.sigmoid()
            stages[r] = {"pred_logits": cls[-1], "pred_boxes": coords[-1],
                         "aux_pred_logits": cls[:-1],
                         "aux_pred_boxes": coords[:-1]}
        out = {"backbone": bb, "stages": stages}
        if with_masks:
            if not self.masks:
                raise ValueError("with_masks: the model has no segmentation "
                                 "head (--masks)")
            out["pred_masks"] = segmentation_head(
                self.bbox_attention, self.mask_head, hs_all[0][-1].float(),
                feat.float(), key_padding)
        return out
