"""Sequence-parallel (sharded-KV) attention over a process group (port of
spe_tpu/ops/seq_parallel.py: `kv_sharded_attention` :47,
`ring_kv_attention` :78).

Each process of the group holds a shard of the keys and values (and of
their padding mask); the queries are the same on every process. The
softmax merges across the shards exactly (flash/ring style):

  per shard s:  L_s = scale q K_s^T + bias_s
                m_s = rowmax(L_s);  e_s = exp(L_s - m_s)
                l_s = rowsum(e_s);  o_s = e_s V_s
  global:       m = max_s m_s,  l = sum_s l_s exp(m_s - m),
                o = sum_s o_s exp(m_s - m),  out = o / l

kv_sharded_attention merges with three all-reduces (max of m, sums of l
and o); ring_kv_attention passes the K/V shards around the group instead
(one batch_isend_irecv a step, parallel.dist.ring_shift) and rescales
(m, l, o) online. Both are autograd Functions with one backward: from the
merged log-sum-exp each process rebuilds its keys' probabilities, and

  dV_s = P_s^T dO,  dL_s = P_s (dO V_s^T - rowsum(dO out)),
  dK_s = scale dL_s^T q (local),  dq = scale sum_s dL_s K_s (all-reduced)

The JAX package computes these with einsums outside any Pallas kernel, so
this is plain PyTorch (f32 products). The full (Nq, Nk) logits never
exist on one process. With a group of one process both are plain
attention.

kv_shard_attention(group) is the encoder self-attention on that path
(models/transformer.py TransformerEncoderLayer(kv_shard_group=), the JAX
MultiheadAttention's kv_shard_axis): no dropout, since the merged softmax
spans processes, refused as the JAX module refuses it.
"""

from __future__ import annotations

from typing import Optional

import torch

from spe_tpu_torch.ops.refmath import merge_heads, split_heads
from spe_tpu_torch.parallel import dist
from spe_tpu_torch.parallel.tp import TensorParallel

_NEG = -1e9


def _logits(qs, k, mask):
    s = qs @ k.float().transpose(-1, -2)
    if mask is not None:
        s = s.masked_fill(mask[:, None, None, :], _NEG)
    return s


class _ShardedKV(torch.autograd.Function):
    """forward(q, k, v, mask, group, scale, ring) -> out in q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, mask, group, scale, ring):
        qs = q.float() * scale
        if ring:
            out, lse = _ring_forward(qs, k, v, mask, group)
        else:
            s = _logits(qs, k, mask)
            m = dist.all_reduce_max_(s.amax(-1, keepdim=True), group)
            e = torch.exp(s - m)
            lo = torch.cat([e @ v.float(), e.sum(-1, keepdim=True)], -1)
            dist.all_reduce_sum_(lo, group)    # o and l in one all-reduce
            l = lo[..., -1:].clamp(min=1e-30)
            out, lse = lo[..., :-1] / l, m + torch.log(l)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.group, ctx.scale = group, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        qs = q.float() * ctx.scale
        p = torch.exp(_logits(qs, k, mask) - lse)
        do = dout.float()
        dv = p.transpose(-1, -2) @ do
        dl = p * (do @ v.float().transpose(-1, -2)
                  - (do * out).sum(-1, keepdim=True))
        dk = ctx.scale * (dl.transpose(-1, -2) @ q.float())
        dq = dist.all_reduce_sum_(ctx.scale * (dl @ k.float()), ctx.group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def _ring_forward(qs, k, v, mask, group):
    """The online merge over the group's shards as they pass around the
    ring -> (out, lse) f32."""
    n = dist.group_size(group)
    m = l = o = None
    cur = [k, v] + ([] if mask is None else [mask.to(torch.uint8)])
    for step in range(n):
        kc, vc = cur[0], cur[1]
        mc = cur[2].bool() if mask is not None else None
        s = _logits(qs, kc, mc)
        mb = s.amax(-1, keepdim=True)
        e = torch.exp(s - mb)
        lb, ob = e.sum(-1, keepdim=True), e @ vc.float()
        if m is None:
            m, l, o = mb, lb, ob
        else:
            mn = torch.maximum(m, mb)
            a, b = torch.exp(m - mn), torch.exp(mb - mn)
            m, l, o = mn, l * a + lb * b, o * a + ob * b
        if step + 1 < n:
            cur = dist.ring_shift(cur, group)
    l = l.clamp(min=1e-30)
    return o / l, m + torch.log(l)


def kv_sharded_attention(q, k_local, v_local, *, group=None,
                         key_padding_mask_local: Optional[torch.Tensor] = None,
                         already_scaled: bool = False):
    """Exact attention with K/V sharded over `group`. q: (B, H, Nq, Dh),
    the same on every process; k_local/v_local: (B, H, Nk_local, Dh|Dv)
    this process's keys and values; key_padding_mask_local: (B, Nk_local)
    bool, True = padded. -> (B, H, Nq, Dv) in q's dtype, the same on every
    process. Scaled by Dh^-0.5 unless already_scaled."""
    scale = 1.0 if already_scaled else q.shape[-1] ** -0.5
    return _ShardedKV.apply(q, k_local, v_local, key_padding_mask_local,
                            group, scale, False)


def ring_kv_attention(q, k_local, v_local, *, group=None,
                      key_padding_mask_local: Optional[torch.Tensor] = None):
    """The ring variant: the same result, the K/V shards (and masks) passed
    around the group instead of o and l all-reduced."""
    return _ShardedKV.apply(q, k_local, v_local, key_padding_mask_local,
                            group, q.shape[-1] ** -0.5, True)


def kv_shard_attention(group):
    """The encoder self-attention, in fused_encoder.softmax_attention's
    form attention(q, k, v, num_heads, key_padding_mask, drop) on q/k/v
    (B, N, H * d) whole on every process, with the keys and values sharded
    over `group` along the sequence: each process keeps its N / P keys,
    values and mask entries (their gradients all-gathered in the backward,
    so the layer's gradients are the unsharded layer's on every process)
    and kv_sharded_attention merges the softmax. Attention dropout is
    refused (spe_tpu/models/attention.py:225-229)."""
    def attention(q, k, v, num_heads, key_padding_mask=None, drop=None):
        if drop is not None and drop.attn > 0.0:
            raise ValueError(
                "kv_shard_axis does not support attention dropout "
                f"(dropout={drop.attn}); set dropout=0 for "
                "sequence-parallel training")
        kv = TensorParallel(group, torch.distributed.get_rank(group),
                            dist.group_size(group))
        mask = (None if key_padding_mask is None
                else key_padding_mask[:, kv.part(k.shape[1])])
        H = num_heads
        o = kv_sharded_attention(
            split_heads(q, H), split_heads(kv.scatter(k, 1), H),
            split_heads(kv.scatter(v, 1), H), group=group,
            key_padding_mask_local=mask)
        return merge_heads(o).to(v.dtype)
    return attention
