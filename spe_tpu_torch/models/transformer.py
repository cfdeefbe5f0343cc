"""Conditional DETR transformer (port of spe_tpu/models/transformer.py;
reference models/transformer.py encoder :253-310, conditional decoder layer
:313-466, decoder :192-250, forward_refine :122-160).

One post-norm encoder pass over the patch sequence, then the decoder over
all query sets (base + refinements) stacked along the query axis: they
share the encoder memory, and self-attention keeps each set to itself.
Each encoder and decoder layer runs as its fused layer
(ops/fused_encoder.py, ops/fused_decoder.py) with `use_fused_layers`, and
as that layer's plain version without; both run on the real Q queries of
each set (no padding). Parameter names are the reference state-dict names.

In training mode (`.train()`, a torch.Generator passed to forward) every
encoder and decoder layer applies the JAX package's dropouts at `dropout`
(transformer.py:117-131, 234-271). The plain layers draw their masks with
torch.rand from the generator; the fused layers draw one seed per layer
call from it and use counter masks (refmath.counter_keep), as JAX draws
one seed per fused layer (transformer.py:150-155, 313-318).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from spe_tpu_torch.models.attention import (MultiheadAttention,
                                            ProjectionFreeAttention)
from spe_tpu_torch.models.layers import LayerNorm, Linear, dropout_for
from spe_tpu_torch.ops.embeds import gen_sineembed_for_position
from spe_tpu_torch.ops.fused_decoder import (decoder_layer_reference,
                                             fused_decoder_layer)
from spe_tpu_torch.ops.fused_encoder import (encoder_layer_reference,
                                             fused_encoder_layer)
from spe_tpu_torch.ops.refmath import CounterDropout, draw_seed


def _dropout(module, gen, device):
    """The layer's training-mode dropout: a refmath.Dropout for the plain
    layer, a CounterDropout with a seed drawn from `gen` for the fused one,
    or None in eval mode or at rate 0."""
    drop = dropout_for(module, gen, attn=module.dropout, proj=module.dropout)
    if drop is None or not module.use_fused:
        return drop
    return CounterDropout(draw_seed(gen, device), drop.attn, drop.proj)


class MLP(nn.Module):
    """num_layers-deep ReLU MLP (reference transformer.py:21-33)."""

    def __init__(self, input_dim, hidden_dim, output_dim, num_layers):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        outs = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(Linear(i, o) for i, o in zip(dims, outs))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer with additive positional q/k."""

    def __init__(self, d_model, nhead, dim_feedforward, use_fused=False,
                 dropout=0.0):
        super().__init__()
        self.nhead = nhead
        self.use_fused = use_fused
        self.dropout = dropout
        self.self_attn = MultiheadAttention(d_model)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, src, pos, key_padding_mask=None, gen=None):
        fn = fused_encoder_layer if self.use_fused else encoder_layer_reference
        return fn(src, pos, key_padding_mask, dict(self.named_parameters()),
                  self.nhead, _dropout(self, gen, src.device))


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers, *args, **kw):
        super().__init__()
        self.layers = nn.ModuleList(TransformerEncoderLayer(*args, **kw)
                                    for _ in range(num_layers))

    def forward(self, src, pos, key_padding_mask=None, gen=None):
        for layer in self.layers:
            src = layer(src, pos, key_padding_mask, gen)
        return src


class ConditionalDecoderLayer(nn.Module):
    """Content/pos-projected self-attention + conditional cross-attention at
    2*d_model + FFN. `ca_qpos_proj` exists on the first layer only
    (reference transformer.py:203-204)."""

    def __init__(self, d_model, nhead, dim_feedforward, is_first,
                 num_sets=1, use_fused=False, dropout=0.0):
        super().__init__()
        self.nhead = nhead
        self.num_sets = num_sets
        self.use_fused = use_fused
        self.dropout = dropout
        D = d_model
        for name in ("sa_qcontent_proj", "sa_qpos_proj", "sa_kcontent_proj",
                     "sa_kpos_proj", "sa_v_proj", "ca_qcontent_proj",
                     "ca_kcontent_proj", "ca_kpos_proj", "ca_v_proj",
                     "ca_qpos_sine_proj"):
            setattr(self, name, Linear(D, D))
        if is_first:
            self.ca_qpos_proj = Linear(D, D)
        self.self_attn = ProjectionFreeAttention(D)
        self.cross_attn = ProjectionFreeAttention(D)
        self.linear1 = Linear(D, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, D)
        self.norm1 = LayerNorm(D)
        self.norm2 = LayerNorm(D)
        self.norm3 = LayerNorm(D)

    def forward(self, tgt, memory, pos, query_pos, query_sine_embed,
                key_padding_mask=None, gen=None):
        fn = fused_decoder_layer if self.use_fused else decoder_layer_reference
        return fn(tgt, memory, pos, query_pos, query_sine_embed,
                  key_padding_mask, dict(self.named_parameters()), self.nhead,
                  self.num_sets, _dropout(self, gen, tgt.device))


class ConditionalDecoder(nn.Module):
    """Decoder stack: per-layer normed states + reference points
    (reference TransformerDecoder, transformer.py:192-250)."""

    def __init__(self, num_layers, d_model, nhead, dim_feedforward,
                 num_sets=1, use_fused=False, dropout=0.0):
        super().__init__()
        self.d_model = d_model
        self.layers = nn.ModuleList(
            ConditionalDecoderLayer(d_model, nhead, dim_feedforward, i == 0,
                                    num_sets, use_fused, dropout)
            for i in range(num_layers))
        self.norm = LayerNorm(d_model)
        self.query_scale = MLP(d_model, d_model, d_model, 2)
        self.ref_point_head = MLP(d_model, d_model, 2, 2)

    def forward(self, tgt, memory, pos, query_pos, key_padding_mask=None,
                gen=None):
        """-> (hs (L, B, S*Q, D), reference points (B, S*Q, 2))."""
        reference_points = self.ref_point_head(query_pos).sigmoid()
        sine_base = gen_sineembed_for_position(reference_points, self.d_model)
        output = tgt
        intermediate = []
        for i, layer in enumerate(self.layers):
            sine = sine_base.to(output.dtype)
            if i > 0:  # identity transformation on layer 0 (:222-226)
                sine = sine * self.query_scale(output)
            output = layer(output, memory, pos, query_pos, sine,
                           key_padding_mask, gen)
            intermediate.append(self.norm(output))
        return torch.stack(intermediate), reference_points


class ConditionalTransformer(nn.Module):
    """Encoder once + decoder over the stacked query sets (reference
    forward_refine, transformer.py:122-160)."""

    def __init__(self, d_model, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, num_sets=2,
                 use_fused_layers=False, dropout=0.0):
        super().__init__()
        self.num_sets = num_sets
        self.encoder = TransformerEncoder(num_encoder_layers, d_model, nhead,
                                          dim_feedforward,
                                          use_fused=use_fused_layers,
                                          dropout=dropout)
        self.decoder = ConditionalDecoder(num_decoder_layers, d_model, nhead,
                                          dim_feedforward, num_sets,
                                          use_fused_layers, dropout)

    def forward(self, src, pos_embed, query_embeds, key_padding_mask=None,
                gen=None):
        """src/pos_embed (B, HW, D); query_embeds: S tensors (Q, D).
        Returns (hs list of (L, B, Q, D), references list of (B, Q, 2))."""
        B = src.shape[0]
        memory = self.encoder(src, pos_embed, key_padding_mask, gen)
        qe = torch.cat(list(query_embeds), dim=0)
        query_pos = qe[None].expand(B, -1, -1).to(src.dtype)
        tgt = torch.zeros_like(query_pos)
        hs, refs = self.decoder(tgt, memory, pos_embed, query_pos,
                                key_padding_mask, gen)
        Q = query_embeds[0].shape[0]
        S = len(query_embeds)
        return ([hs[:, :, s * Q:(s + 1) * Q] for s in range(S)],
                [refs[:, s * Q:(s + 1) * Q] for s in range(S)])
