"""The Conditional-DETR decoder layer, fused for Hopper (kernel 4).

    self-attention (q/k = content + pos projections, each query set alone)
    -> LN1 -> conditional cross-attention at 2*dh per head
    (softmax((qc.kc + sine.kpos) * (2 dh)^-0.5 + key bias) v) -> LN2
    -> ReLU FFN -> LN3                                   (LN eps 1e-5)
    layer 0 adds ca_qpos_proj(query_pos) to qc and kpos to kc.

Replaces the TPU kernel spe_tpu/ops/pallas_decoder.py:599
`fused_decoder_layer` (forward `_fwd_call` :511, `pallas_call` :526, body
`_dec_fwd_kernel` :206), forward only, dropout 0 (eval).

The TPU wrapper pads each query set from Q = 300 to 304 rows and masks the
padded keys (a sublane-tiling artifact); here the kernels run on the 300
real queries of each set, and self-attention treats the S stacked sets as
S separate batches, so sets never see each other.

The content and spatial halves of the cross-attention are written by the
projection kernels straight into head-interleaved (rows, 2*D) buffers
[qc_h | sine_h] and [kc_h | kpos_h], so one attention launch with a 48-wide
q.k and a 24-wide v computes the TPU kernel's two half-dots as one dot.

Launches per layer: 4 ln_linear for self-attention q/k/v, attention,
ln_linear (out_proj + residual), layernorm, 5 (layer 0: 7) ln_linear for the
cross-attention operands, attention, ln_linear (out_proj + residual),
layernorm, 2 ln_linear for the FFN, layernorm. What bounds it on the H100:
the cross-attention (S*Q x N x (48 + 24) MACs per head) and the FFN, on the
CUDA cores in this first version.

`fused_decoder_layer` chooses by device only: CPU tensors go to
`decoder_layer_reference`, CUDA tensors to the kernels (bf16 only; with
grad enabled on a parameter or input, or a dropout rate above 0, they
raise: ROADMAP B1b).
`fused_decoder_layer.launches` counts the CUDA launches.
"""

from __future__ import annotations

import torch

from spe_tpu_torch.ops import kernels as K
from spe_tpu_torch.ops.kernels import as_bf16 as _bf, as_f32 as _f
from spe_tpu_torch.ops.refmath import (drop_site, key_bias, layer_norm,
                                       merge_heads, mm, refuse_training,
                                       split_heads)

EPS = 1e-5
PARAM_NAMES = (
    "sa_qcontent_proj.weight", "sa_qcontent_proj.bias",
    "sa_qpos_proj.weight", "sa_qpos_proj.bias",
    "sa_kcontent_proj.weight", "sa_kcontent_proj.bias",
    "sa_kpos_proj.weight", "sa_kpos_proj.bias",
    "sa_v_proj.weight", "sa_v_proj.bias",
    "self_attn.out_proj.weight", "self_attn.out_proj.bias",
    "norm1.weight", "norm1.bias",
    "ca_qcontent_proj.weight", "ca_qcontent_proj.bias",
    "ca_kcontent_proj.weight", "ca_kcontent_proj.bias",
    "ca_v_proj.weight", "ca_v_proj.bias",
    "ca_kpos_proj.weight", "ca_kpos_proj.bias",
    "ca_qpos_sine_proj.weight", "ca_qpos_sine_proj.bias",
    "cross_attn.out_proj.weight", "cross_attn.out_proj.bias",
    "norm2.weight", "norm2.bias", "linear1.weight", "linear1.bias",
    "linear2.weight", "linear2.bias", "norm3.weight", "norm3.bias")
FIRST_LAYER_NAMES = ("ca_qpos_proj.weight", "ca_qpos_proj.bias")


def _attend(q, k, v, H, scale, bias=None, drop=None):
    """softmax(q k^T * scale + bias) v per head, f32 logits, bf16-rounded
    probabilities into the PV product (after `drop`'s attention dropout).
    q/k: (B, Nq|Nk, H*dq)."""
    dt = v.dtype
    logits = (split_heads(q, H).float()
              @ split_heads(k, H).float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias[:, None, None, :]
    attn = drop_site(drop, torch.softmax(logits, dim=-1), "attn")
    return merge_heads(attn.to(dt).float() @ split_heads(v, H).float())


def _interleave(a, b, H):
    """(B, N, H*d) x2 -> (B, N, H*2d): head h is [a_h | b_h]."""
    B, N, D = a.shape
    return torch.cat([a.reshape(B, N, H, D // H), b.reshape(B, N, H, D // H)],
                     dim=-1).reshape(B, N, 2 * D)


def decoder_layer_reference(tgt, memory, pos, query_pos, sine,
                            key_padding_mask, p, num_heads, num_sets,
                            drop=None):
    """Plain PyTorch version. tgt/query_pos/sine: (B, S*Q, D) with S query
    sets stacked along the query axis; memory/pos: (B, N, D);
    key_padding_mask: (B, N) bool or None. Layer 0 is recognised by
    `ca_qpos_proj.weight` in p. drop: a refmath.Dropout for the training
    forward at the JAX flax layer's six sites (transformer.py:234-271):
    `attn` on both attentions' probabilities, `proj` on both attention
    outputs, the ReLU and the second linear's output."""
    dt = tgt.dtype
    B, SQ, D = tgt.shape
    N = memory.shape[1]
    H, S = num_heads, num_sets
    dh = D // H
    q = (mm(tgt, p["sa_qcontent_proj.weight"], p["sa_qcontent_proj.bias"])
         + mm(query_pos, p["sa_qpos_proj.weight"], p["sa_qpos_proj.bias"]))
    k = (mm(tgt, p["sa_kcontent_proj.weight"], p["sa_kcontent_proj.bias"])
         + mm(query_pos, p["sa_kpos_proj.weight"], p["sa_kpos_proj.bias"]))
    v = mm(tgt, p["sa_v_proj.weight"], p["sa_v_proj.bias"])

    def fold(a):  # each query set attends alone
        return a.to(dt).reshape(B * S, SQ // S, D)

    o = _attend(fold(q), fold(k), fold(v), H, dh ** -0.5,
                drop=drop).reshape(B, SQ, D)
    h = drop_site(drop, mm(o.to(dt), p["self_attn.out_proj.weight"],
                           p["self_attn.out_proj.bias"]), "proj")
    t1 = layer_norm(tgt.float() + h, p["norm1.weight"], p["norm1.bias"], EPS)
    qc = mm(t1.to(dt), p["ca_qcontent_proj.weight"], p["ca_qcontent_proj.bias"])
    kc = mm(memory, p["ca_kcontent_proj.weight"], p["ca_kcontent_proj.bias"])
    vv = mm(memory, p["ca_v_proj.weight"], p["ca_v_proj.bias"]).to(dt)
    kpos = mm(pos, p["ca_kpos_proj.weight"], p["ca_kpos_proj.bias"])
    if "ca_qpos_proj.weight" in p:
        qc = qc + mm(query_pos, p["ca_qpos_proj.weight"],
                     p["ca_qpos_proj.bias"])
        kc = kc + kpos
    sp = mm(sine, p["ca_qpos_sine_proj.weight"], p["ca_qpos_sine_proj.bias"])
    qq = _interleave(qc.to(dt), sp.to(dt), H)
    kk = _interleave(kc.to(dt), kpos.to(dt), H)
    o = _attend(qq, kk, vv, H, (2 * dh) ** -0.5,
                key_bias(key_padding_mask, B, N, tgt.device), drop)
    h = drop_site(drop, mm(o.to(dt), p["cross_attn.out_proj.weight"],
                           p["cross_attn.out_proj.bias"]), "proj")
    t2 = layer_norm(t1 + h, p["norm2.weight"], p["norm2.bias"], EPS)
    u = torch.relu(mm(t2.to(dt), p["linear1.weight"], p["linear1.bias"]))
    u = drop_site(drop, u, "proj")
    h2 = drop_site(drop, mm(u.to(dt), p["linear2.weight"], p["linear2.bias"]),
                   "proj")
    return layer_norm(t2 + h2, p["norm3.weight"], p["norm3.bias"],
                      EPS).to(dt)


def _forward_cuda(tgt, memory, pos, query_pos, sine, key_padding_mask, p,
                  num_heads, num_sets):
    for t in (tgt, memory, pos, query_pos, sine):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the fused decoder kernels take bf16, got {t.dtype}")
    B, SQ, D = tgt.shape
    N = memory.shape[1]
    H, S = num_heads, num_sets
    Q = SQ // S
    dh = D // H
    dev = tgt.device
    t2d = tgt.reshape(B * SQ, D)
    qp2 = query_pos.reshape(B * SQ, D)
    mem2 = memory.reshape(B * N, D)
    pos2 = pos.reshape(B * N, D)

    def w(name):
        return _bf(p[f"{name}.weight"])

    def b(name):
        return _f(p[f"{name}.bias"])

    def wcat(*names):
        return _bf(torch.cat([p[f"{n}.weight"] for n in names]))

    def bcat(*names):
        return _f(torch.cat([p[f"{n}.bias"] for n in names]))

    # ---- self-attention, each query set on its own ----
    qk_pos = K.ln_linear(qp2, wcat("sa_qpos_proj", "sa_kpos_proj"),
                         bcat("sa_qpos_proj", "sa_kpos_proj"),
                         out_dtype=torch.float32)
    qk = K.ln_linear(t2d, wcat("sa_qcontent_proj", "sa_kcontent_proj"),
                     bcat("sa_qcontent_proj", "sa_kcontent_proj"),
                     res=qk_pos).view(B * S, Q, 2 * D)
    v = K.ln_linear(t2d, w("sa_v_proj"), b("sa_v_proj")).view(B * S, Q, D)
    o_sa = torch.empty((B * S, Q, D), device=dev, dtype=torch.bfloat16)
    K.attention(qk[..., :D], qk[..., D:], v, o_sa, num_heads=H, dq=dh, dv=dh,
                q_hs=dh, k_hs=dh, v_hs=dh, o_hs=dh, logit_scale=dh ** -0.5)
    y = K.ln_linear(o_sa.view(B * SQ, D), w("self_attn.out_proj"),
                    b("self_attn.out_proj"), res=t2d, out_dtype=torch.float32)
    t1, _ = K.layernorm(y, _f(p["norm1.weight"]), _f(p["norm1.bias"]), EPS)

    # ---- conditional cross-attention operands, head-interleaved ----
    qq = torch.empty((B * SQ, 2 * D), device=dev, dtype=torch.bfloat16)
    kk = torch.empty((B * N, 2 * D), device=dev, dtype=torch.bfloat16)
    il = dict(col_group=dh, col_stride=2 * dh)
    first = "ca_qpos_proj.weight" in p
    qres = kres = None
    if first:
        qres = K.ln_linear(qp2, w("ca_qpos_proj"), b("ca_qpos_proj"),
                           out_dtype=torch.float32)
        kres = K.ln_linear(pos2, w("ca_kpos_proj"), b("ca_kpos_proj"),
                           out_dtype=torch.float32)
    K.ln_linear(t1, w("ca_qcontent_proj"), b("ca_qcontent_proj"), res=qres,
                out=qq, **il)
    K.ln_linear(sine.reshape(B * SQ, D), w("ca_qpos_sine_proj"),
                b("ca_qpos_sine_proj"), out=qq[:, dh:], **il)
    K.ln_linear(mem2, w("ca_kcontent_proj"), b("ca_kcontent_proj"), res=kres,
                out=kk, **il)
    K.ln_linear(pos2, w("ca_kpos_proj"), b("ca_kpos_proj"), out=kk[:, dh:],
                **il)
    vv = K.ln_linear(mem2, w("ca_v_proj"), b("ca_v_proj")).view(B, N, D)
    o_ca = torch.empty((B, SQ, D), device=dev, dtype=torch.bfloat16)
    K.attention(qq.view(B, SQ, 2 * D), kk.view(B, N, 2 * D), vv, o_ca,
                num_heads=H, dq=2 * dh, dv=dh, q_hs=2 * dh, k_hs=2 * dh,
                v_hs=dh, o_hs=dh,
                kbias=key_bias(key_padding_mask, B, N, dev),
                logit_scale=(2 * dh) ** -0.5)
    y = K.ln_linear(o_ca.view(B * SQ, D), w("cross_attn.out_proj"),
                    b("cross_attn.out_proj"), res=t1, out_dtype=torch.float32)
    t2, _ = K.layernorm(y, _f(p["norm2.weight"]), _f(p["norm2.bias"]), EPS)

    # ---- FFN ----
    u = K.ln_linear(t2, w("linear1"), b("linear1"), act="relu")
    y = K.ln_linear(u, w("linear2"), b("linear2"), res=t2,
                    out_dtype=torch.float32)
    _, out = K.layernorm(y, _f(p["norm3.weight"]), _f(p["norm3.bias"]), EPS,
                         want_f32=False, want_bf16=True)
    return out.view(B, SQ, D)


def fused_decoder_layer(tgt, memory, pos, query_pos, sine, key_padding_mask,
                        params, num_heads, num_sets, drop=None):
    """One conditional decoder layer over `num_sets` stacked query sets
    -> (B, S*Q, D). On the card: the eval forward only."""
    if tgt.device.type == "cpu":
        return decoder_layer_reference(tgt, memory, pos, query_pos, sine,
                                       key_padding_mask, params, num_heads,
                                       num_sets, drop)
    refuse_training("fused_decoder_layer",
                    [tgt, memory, pos, query_pos, sine, *params.values()],
                    drop)
    out = _forward_cuda(tgt, memory, pos, query_pos, sine, key_padding_mask,
                        params, num_heads, num_sets)
    fused_decoder_layer.launches += 1
    return out


fused_decoder_layer.launches = 0
