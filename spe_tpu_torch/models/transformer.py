"""Conditional DETR transformer (port of spe_tpu/models/transformer.py;
reference models/transformer.py encoder :253-310, conditional decoder layer
:313-466, decoder :192-250, forward_refine :122-160).

One encoder pass over the patch sequence, then the decoder over
all query sets (base + refinements) stacked along the query axis: they
share the encoder memory, and self-attention keeps each set to itself.
Each encoder and decoder layer runs as its fused layer
(ops/fused_encoder.py, ops/fused_decoder.py) with `use_fused_layers`, and
as that layer's plain version without; both run on the real Q queries of
each set (no padding). With `use_pallas` and the fused layers off, the
plain layers' encoder self-attention and decoder cross-attention run
through the standalone attention kernel fused_mha (B4), as the JAX
package's flax layers call it (models/attention.py:235-243, 281-289); the
decoder self-attention stays plain (transformer.py:183-185). Parameter
names are the reference state-dict names.

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
from spe_tpu_torch.ops.fused_encoder import (EPS, encoder_layer_reference,
                                             fused_encoder_layer,
                                             softmax_attention)
from spe_tpu_torch.ops.fused_mha import layer_attention
from spe_tpu_torch.ops.refmath import (CounterDropout, draw_seed, drop_site,
                                       layer_norm, mm)
from spe_tpu_torch.ops.seq_parallel import kv_shard_attention
from spe_tpu_torch.parallel.tp import NO_TP


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


def encoder_layer_prenorm(x, pos, key_padding_mask, p, num_heads, drop=None,
                          attention=softmax_attention, tp=NO_TP):
    """The pre-norm encoder layer (JAX transformer.py:117-135):

        s   = x + drop(out_proj(MHA(q=k=LN1(x)+pos, v=LN1(x))))
        out = s + drop(linear2(drop(relu(linear1(LN2(s))))))

    in plain PyTorch, rounding where the flax layer in the working dtype
    rounds, with the post-norm layer's parameter names and dropout sites
    (encoder_layer_reference: `attn` on the probabilities, `proj` on the
    attention output, the ReLU and the second linear's output, drawn in
    that order). attention(q, k, v, num_heads, key_padding_mask, drop):
    softmax_attention, or fused_mha.layer_attention (B4) with
    use_pallas_attention. Training differentiates it with autograd, through
    B4's autograd Function where the attention is B4's. Under tensor
    parallelism p holds this rank's shards, as encoder_layer_reference
    takes them."""
    dt = x.dtype
    w, b = p["self_attn.in_proj_weight"], p["self_attn.in_proj_bias"]
    D = w.shape[0] // 3
    b = tp.cols(b, 3)
    s2 = layer_norm(x, p["norm1.weight"], p["norm1.bias"], EPS).to(dt)
    qk_in = tp.copy((s2.float() + pos.float()).to(dt))
    q = mm(qk_in, w[:D], b[:D]).to(dt)
    k = mm(qk_in, w[D:2 * D], b[D:2 * D]).to(dt)
    v = mm(tp.copy(s2), w[2 * D:], b[2 * D:]).to(dt)
    o = attention(q, k, v, num_heads // tp.size, key_padding_mask,
                  tp.shard(drop, 1)).to(dt)
    h = drop_site(drop, tp.row(o, p["self_attn.out_proj.weight"],
                               p["self_attn.out_proj.bias"]).to(dt), "proj")
    x = x + h.to(dt)
    s2 = layer_norm(x, p["norm2.weight"], p["norm2.bias"], EPS).to(dt)
    u = torch.relu(tp.col(tp.copy(s2), p["linear1.weight"],
                          p["linear1.bias"]).to(dt))
    u = drop_site(tp.shard(drop, -1), u, "proj")
    h2 = drop_site(drop, tp.row(u.to(dt), p["linear2.weight"],
                                p["linear2.bias"]).to(dt), "proj")
    return x + h2.to(dt)


class TransformerEncoderLayer(nn.Module):
    """Encoder layer with additive positional q/k: post-norm, or pre-norm
    with normalize_before (never fused then, as in the JAX package).
    kv_shard_group: a process group the self-attention's keys and values
    are sharded over along the sequence (ops/seq_parallel.
    kv_shard_attention; the JAX MultiheadAttention's kv_shard_axis, which
    takes precedence over use_pallas): the layer runs plain then."""

    tp = NO_TP   # tensor parallelism (parallel/sharding_rules.shard_model)

    def __init__(self, d_model, nhead, dim_feedforward, use_fused=False,
                 dropout=0.0, use_pallas=False, normalize_before=False,
                 kv_shard_group=None):
        super().__init__()
        self.nhead = nhead
        self.normalize_before = normalize_before
        self.use_fused = (use_fused and not normalize_before
                          and kv_shard_group is None)
        self.dropout = dropout
        self.attention = (kv_shard_attention(kv_shard_group)
                          if kv_shard_group is not None else
                          layer_attention if use_pallas else
                          softmax_attention)
        self.self_attn = MultiheadAttention(d_model)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, src, pos, key_padding_mask=None, gen=None):
        args = (src, pos, key_padding_mask, dict(self.named_parameters()),
                self.nhead, _dropout(self, gen, src.device))
        if self.use_fused:
            return fused_encoder_layer(*args)
        if self.normalize_before:
            return encoder_layer_prenorm(*args, self.attention, self.tp)
        return encoder_layer_reference(*args, self.attention, self.tp)


class TransformerEncoder(nn.Module):
    """The encoder layers, and after them the final LayerNorm `norm` of a
    pre-norm encoder (DETR's name; JAX `encoder_norm`)."""

    def __init__(self, num_layers, d_model, *args, normalize_before=False,
                 **kw):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, *args,
                                    normalize_before=normalize_before, **kw)
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model) if normalize_before else None

    def forward(self, src, pos, key_padding_mask=None, gen=None):
        for layer in self.layers:
            src = layer(src, pos, key_padding_mask, gen)
        return src if self.norm is None else self.norm(src)


class ConditionalDecoderLayer(nn.Module):
    """Content/pos-projected self-attention + conditional cross-attention at
    2*d_model + FFN. `ca_qpos_proj` exists on the first layer only
    (reference transformer.py:203-204)."""

    tp = NO_TP

    def __init__(self, d_model, nhead, dim_feedforward, is_first,
                 num_sets=1, use_fused=False, dropout=0.0, use_pallas=False):
        super().__init__()
        self.nhead = nhead
        self.num_sets = num_sets
        self.use_fused = use_fused
        self.dropout = dropout
        self.attention = layer_attention if use_pallas else softmax_attention
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
        args = (tgt, memory, pos, query_pos, query_sine_embed,
                key_padding_mask, dict(self.named_parameters()), self.nhead,
                self.num_sets, _dropout(self, gen, tgt.device))
        if self.use_fused:
            return fused_decoder_layer(*args)
        return decoder_layer_reference(*args, self.attention, self.tp)


class ConditionalDecoder(nn.Module):
    """Decoder stack: per-layer normed states + reference points
    (reference TransformerDecoder, transformer.py:192-250)."""

    def __init__(self, num_layers, d_model, nhead, dim_feedforward,
                 num_sets=1, use_fused=False, dropout=0.0, use_pallas=False):
        super().__init__()
        self.d_model = d_model
        self.layers = nn.ModuleList(
            ConditionalDecoderLayer(d_model, nhead, dim_feedforward, i == 0,
                                    num_sets, use_fused, dropout, use_pallas)
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
                 use_fused_layers=False, dropout=0.0, use_pallas=False,
                 normalize_before=False):
        super().__init__()
        self.num_sets = num_sets
        self.encoder = TransformerEncoder(num_encoder_layers, d_model, nhead,
                                          dim_feedforward,
                                          use_fused=use_fused_layers,
                                          dropout=dropout,
                                          use_pallas=use_pallas,
                                          normalize_before=normalize_before)
        self.decoder = ConditionalDecoder(num_decoder_layers, d_model, nhead,
                                          dim_feedforward, num_sets,
                                          use_fused_layers, dropout,
                                          use_pallas)

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
