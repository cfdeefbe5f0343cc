"""The Conditional-DETR decoder layer, fused for Hopper (kernel 4).

    self-attention (q/k = content + pos projections, each query set alone)
    -> LN1 -> conditional cross-attention at 2*dh per head
    (softmax((qc.kc + sine.kpos) * (2 dh)^-0.5 + key bias) v) -> LN2
    -> ReLU FFN -> LN3                                   (LN eps 1e-5)
    layer 0 adds ca_qpos_proj(query_pos) to qc and kpos to kc.

Replaces the TPU kernels spe_tpu/ops/pallas_decoder.py:599
`fused_decoder_layer`: the forward (`_fwd_call` :511, `pallas_call` :526,
body `_dec_fwd_kernel` :206) in its eval and training forms, and the
backward (`_bwd_call` :550, `pallas_call` :570, body `_dec_bwd_kernel`
:292).

The TPU wrapper pads each query set from Q = 300 to 304 rows and masks the
padded keys (a sublane-tiling artifact); here the kernels run on the 300
real queries of each set, and self-attention treats the S stacked sets as
S separate batches, so sets never see each other.

The content and spatial halves of the cross-attention are written by the
projection kernels straight into head-interleaved (rows, 2*D) buffers
[qc_h | sine_h] and [kc_h | kpos_h], so one attention launch with a 48-wide
q.k and a 24-wide v computes the TPU kernel's two half-dots as one dot.

**Eval** launches per layer: 4 ln_linear for self-attention q/k/v,
attention, ln_linear (out_proj + residual), layernorm, 5 (layer 0: 7)
ln_linear for the cross-attention operands, attention, ln_linear (out_proj
+ residual), layernorm, 2 ln_linear for the FFN, layernorm.

**Training.** The same launches carry the six dropout sites (counter masks
keyed as refmath's comment block says: the self-attention's per set and
head, the cross-attention's and its projection's on sites of their own).
Both attentions drop inside their online softmax and write each row's
log-sum-exp. The forward saves the inputs, o_sa and o_ca (bf16), the
post-dropout FFN output h2d (f32) and the two log-sum-exps, as the TPU
kernel's `save_residuals` form saves o_sa, o_ca and h2, and linear1's
pre-activation u (bf16), whose sign is the backward's ReLU mask: a
backward on the same saved tensors takes the forward's ReLU decisions
whatever its own recompute rounds. The backward recomputes the other
linear parts and follows _dec_bwd_kernel :398-490 step by step; both attention backwards run through kernels.attention_backward
(spe_gemm products on f32 planes, the attn_bwd_rows pass). For the
cross-attention the products keep the interleaved layout: dl . KK gives
[dqc_h | dsine_h] and dl^T . QQ gives [dkc_h | dkp_h] in one product each,
their halves stored into two planes. Every parameter gradient is a sum of
partials reduced in a fixed order (deterministic). What bounds it on the
H100: the cross-attention (S*Q x N x (48 + 24) multiply-adds per head and
direction) and the FFN: the attentions and every backward product run on
the tensor cores (attention.cu, grad.cu), the forward's linear products
still on the CUDA cores (linear.cu).

Dispatch is by tensor device only: CPU tensors take the plain versions
(`decoder_layer_reference` at eval, `decoder_layer_train_reference` and
`decoder_layer_backward_reference` in training), CUDA tensors the kernels
(bf16 only; anything else raises). `fused_decoder_layer` counts its CUDA
launches: `.launches` (eval), `.train_launches` (training forward) and
`.bwd_launches` (backward).
"""

from __future__ import annotations

import torch

from spe_tpu_torch.ops import kernels as K
from spe_tpu_torch.ops.kernels import as_bf16 as _bf, as_f32 as _f
from spe_tpu_torch.ops.fused_encoder import (attend_backward, attend_train,
                                             softmax_attention)
from spe_tpu_torch.ops.refmath import (SITE_ATTN, SITE_CROSS_ATTN,
                                       SITE_CROSS_PROJ, SITE_HIDDEN, SITE_OUT,
                                       SITE_PROJ, CounterDropout, drop_site,
                                       key_bias, layer_norm,
                                       ln_backward_reference, mm, needs_grad,
                                       no_dropout, weight_grad)

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
# every weight matrix: the kernels read them in the working dtype, and their
# gradients come back rounded to it, as JAX's `_fused_dec_bwd` casts them
# (pallas_decoder.py:643)
ROUNDED = tuple(n for n in PARAM_NAMES + FIRST_LAYER_NAMES
                if n.endswith(".weight") and not n.startswith("norm"))


def _interleave(a, b, H):
    """(B, N, H*d) x2 -> (B, N, H*2d): head h is [a_h | b_h]."""
    B, N, D = a.shape
    return torch.cat([a.reshape(B, N, H, D // H), b.reshape(B, N, H, D // H)],
                     dim=-1).reshape(B, N, 2 * D)


def decoder_layer_reference(tgt, memory, pos, query_pos, sine,
                            key_padding_mask, p, num_heads, num_sets,
                            drop=None, attention=softmax_attention):
    """Plain PyTorch version. tgt/query_pos/sine: (B, S*Q, D) with S query
    sets stacked along the query axis; memory/pos: (B, N, D);
    key_padding_mask: (B, N) bool or None. Layer 0 is recognised by
    `ca_qpos_proj.weight` in p. drop: a refmath.Dropout for the training
    forward at the JAX flax layer's six sites (transformer.py:234-271):
    `attn` on both attentions' probabilities, `proj` on both attention
    outputs, the ReLU and the second linear's output. attention(q, k, v,
    num_heads, key_padding_mask, drop): the cross-attention, by default
    `softmax_attention` (`fused_mha.layer_attention` with
    use_pallas_attention); the self-attention is always
    `softmax_attention`, as the JAX package keeps it on its einsum path
    (transformer.py:183-185)."""
    dt = tgt.dtype
    B, SQ, D = tgt.shape
    H, S = num_heads, num_sets
    q = (mm(tgt, p["sa_qcontent_proj.weight"], p["sa_qcontent_proj.bias"])
         + mm(query_pos, p["sa_qpos_proj.weight"], p["sa_qpos_proj.bias"]))
    k = (mm(tgt, p["sa_kcontent_proj.weight"], p["sa_kcontent_proj.bias"])
         + mm(query_pos, p["sa_kpos_proj.weight"], p["sa_kpos_proj.bias"]))
    v = mm(tgt, p["sa_v_proj.weight"], p["sa_v_proj.bias"])

    def fold(a):  # each query set attends alone
        return a.to(dt).reshape(B * S, SQ // S, D)

    o = softmax_attention(fold(q), fold(k), fold(v), H,
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
    o = attention(qq, kk, vv, H, key_padding_mask, drop)
    h = drop_site(drop, mm(o.to(dt), p["cross_attn.out_proj.weight"],
                           p["cross_attn.out_proj.bias"]), "proj")
    t2 = layer_norm(t1 + h, p["norm2.weight"], p["norm2.bias"], EPS)
    u = torch.relu(mm(t2.to(dt), p["linear1.weight"], p["linear1.bias"]))
    u = drop_site(drop, u, "proj")
    h2 = drop_site(drop, mm(u.to(dt), p["linear2.weight"], p["linear2.bias"]),
                   "proj")
    return layer_norm(t2 + h2, p["norm3.weight"], p["norm3.bias"],
                      EPS).to(dt)


def _deinterleave(a, H):
    """(B, N, H*2d) head-interleaved -> its halves (B, N, H*d) x2."""
    B, N, D2 = a.shape
    a = a.reshape(B, N, H, 2, D2 // (2 * H))
    return a[..., 0, :].reshape(B, N, D2 // 2), a[..., 1, :].reshape(B, N, D2 // 2)


def _train_chain(tgt, memory, pos, query_pos, sine, mask, p, H, S, drop,
                 saved=None):
    """The training forward's intermediates, as the kernels compute them
    (a dict). With `saved` = (o_sa, o_ca, lse_sa, lse_ca), the backward's
    form, the attention outputs are the saved ones and the probabilities
    are rebuilt from the log-sum-exps."""
    dt = tgt.dtype
    B, SQ, D = tgt.shape
    N = memory.shape[1]
    dh = D // H
    o_sa, o_ca, lse_sa, lse_ca = saved or (None,) * 4
    r = {}

    def lin(a, name):
        return mm(a, p[f"{name}.weight"], p[f"{name}.bias"])

    def fold(a):  # each query set attends alone
        return a.to(dt).reshape(B * S, SQ // S, D)

    r["q"] = fold(lin(tgt, "sa_qcontent_proj") + lin(query_pos, "sa_qpos_proj"))
    r["k"] = fold(lin(tgt, "sa_kcontent_proj") + lin(query_pos, "sa_kpos_proj"))
    r["v"] = fold(lin(tgt, "sa_v_proj"))
    o, r["probs_sa"], r["zd_sa"], r["lse_sa"] = attend_train(
        r["q"], r["k"], r["v"], H, dh ** -0.5, None, drop, SITE_ATTN, S * H,
        lse_sa)
    r["o_sa"] = o.reshape(B, SQ, D).to(dt) if o_sa is None else o_sa
    r["y_sa"] = tgt.float() + drop.site(lin(r["o_sa"], "self_attn.out_proj"),
                                        SITE_PROJ, drop.proj)
    r["t1"] = layer_norm(r["y_sa"], p["norm1.weight"], p["norm1.bias"], EPS)
    qc = lin(r["t1"].to(dt), "ca_qcontent_proj")
    kc = lin(memory, "ca_kcontent_proj")
    r["vv"] = lin(memory, "ca_v_proj").to(dt)
    kpos = lin(pos, "ca_kpos_proj")
    if "ca_qpos_proj.weight" in p:
        qc = qc + lin(query_pos, "ca_qpos_proj")
        kc = kc + kpos
    sp = lin(sine, "ca_qpos_sine_proj")
    r["qq"] = _interleave(qc.to(dt), sp.to(dt), H)
    r["kk"] = _interleave(kc.to(dt), kpos.to(dt), H)
    o, r["probs_ca"], r["zd_ca"], r["lse_ca"] = attend_train(
        r["qq"], r["kk"], r["vv"], H, (2 * dh) ** -0.5,
        key_bias(mask, B, N, tgt.device), drop, SITE_CROSS_ATTN, H, lse_ca)
    r["o_ca"] = o.to(dt) if o_ca is None else o_ca
    r["y_ca"] = r["t1"] + drop.site(lin(r["o_ca"], "cross_attn.out_proj"),
                                    SITE_CROSS_PROJ, drop.proj)
    r["t2"] = layer_norm(r["y_ca"], p["norm2.weight"], p["norm2.bias"], EPS)
    r["u"] = lin(r["t2"].to(dt), "linear1")
    r["urd"] = drop.site(torch.relu(r["u"]), SITE_HIDDEN, drop.proj).to(dt)
    return r


def decoder_layer_train_reference(tgt, memory, pos, query_pos, sine,
                                  key_padding_mask, p, num_heads, num_sets,
                                  drop=None):
    """Plain training forward with the counter masks (refmath.CounterDropout;
    None: every rate 0) -> (out, o_sa, o_ca (B, S*Q, D) in tgt's dtype: the
    two attention outputs, h2d (B, S*Q, D) f32: the FFN output after its
    dropout, lse_sa (B*S, H, Q), lse_ca (B, H, S*Q) f32: the attention
    rows' log-sum-exps, u (B, S*Q, F) in tgt's dtype: linear1's
    pre-activation, whose sign is the backward's ReLU mask)."""
    drop = drop or no_dropout(tgt.device)
    r = _train_chain(tgt, memory, pos, query_pos, sine, key_padding_mask, p,
                     num_heads, num_sets, drop)
    h2d = drop.site(mm(r["urd"], p["linear2.weight"], p["linear2.bias"]),
                    SITE_OUT, drop.proj)
    out = layer_norm(r["t2"] + h2d, p["norm3.weight"], p["norm3.bias"], EPS)
    return (out.to(tgt.dtype), r["o_sa"], r["o_ca"], h2d, r["lse_sa"],
            r["lse_ca"], r["u"].to(tgt.dtype))


def decoder_layer_backward_reference(dy, tgt, memory, pos, query_pos, sine,
                                     key_padding_mask, o_sa, o_ca, h2d,
                                     lse_sa, lse_ca, u, p, num_heads,
                                     num_sets, drop=None):
    """Plain, hand-derived backward mirroring `_dec_bwd_kernel`
    (pallas_decoder.py:398-490) step by step, rounding where it rounds
    (every product's operands to the working dtype, f32 sums). -> (dtgt,
    dmem, dpos, dqpos, dsine in their inputs' dtypes, {name: f32
    gradient}); the ROUNDED matrices' gradients come back rounded to the
    working dtype."""
    drop = drop or no_dropout(tgt.device)
    dt = tgt.dtype
    B, SQ, D = tgt.shape
    H, S = num_heads, num_sets
    dh = D // H

    def c(t):   # the working-dtype rounding before a product
        return t.to(dt).float()

    def w(name):
        return c(p[f"{name}.weight"])

    r = _train_chain(tgt, memory, pos, query_pos, sine, key_padding_mask, p,
                     H, S, drop, saved=(o_sa, o_ca, lse_sa, lse_ca))
    g = {}

    def dense(name, d, x):   # a Dense layer's parameter gradients
        g[f"{name}.weight"] = weight_grad(c(d), x)
        g[f"{name}.bias"] = d.sum((0, 1))

    dy3, g["norm3.weight"], g["norm3.bias"] = ln_backward_reference(
        dy.float(), r["t2"] + h2d, p["norm3.weight"], EPS)
    dh2 = drop.site(dy3, SITE_OUT, drop.proj)
    dense("linear2", dh2, r["urd"])
    du = torch.where(u > 0, drop.site(c(dh2) @ w("linear2"), SITE_HIDDEN,
                                      drop.proj), 0.0)
    dense("linear1", du, c(r["t2"]))
    dt2 = dy3 + c(du) @ w("linear1")
    dy2, g["norm2.weight"], g["norm2.bias"] = ln_backward_reference(
        dt2, r["y_ca"], p["norm2.weight"], EPS)

    # cross-attention branch
    dca = drop.site(dy2, SITE_CROSS_PROJ, drop.proj)
    dense("cross_attn.out_proj", dca, o_ca)
    do_ca = c(dca) @ w("cross_attn.out_proj")
    dqq, dkk, dvv = attend_backward(do_ca, r["qq"], r["kk"], r["vv"],
                                    r["probs_ca"], r["zd_ca"], H,
                                    (2 * dh) ** -0.5, drop, SITE_CROSS_ATTN, H)
    dqc, dsp = _deinterleave(dqq, H)
    dkc, dkp = _deinterleave(dkk, H)
    dense("ca_qpos_sine_proj", dsp, sine)
    dsine = c(dsp) @ w("ca_qpos_sine_proj")
    dqpos = 0.0
    if "ca_qpos_proj.weight" in p:
        # qc = qc0 + qpos Wcaqp; kc = kc0 + kpos (kpos also in the concat)
        dense("ca_qpos_proj", dqc, query_pos)
        dqpos = c(dqc) @ w("ca_qpos_proj")
        dkp = dkp + dkc
    dense("ca_qcontent_proj", dqc, c(r["t1"]))
    dt1 = dy2 + c(dqc) @ w("ca_qcontent_proj")
    dense("ca_kcontent_proj", dkc, memory)
    dense("ca_v_proj", dvv, memory)
    dmem = c(dkc) @ w("ca_kcontent_proj") + c(dvv) @ w("ca_v_proj")
    dense("ca_kpos_proj", dkp, pos)
    dpos = c(dkp) @ w("ca_kpos_proj")

    # self-attention branch
    dy1, g["norm1.weight"], g["norm1.bias"] = ln_backward_reference(
        dt1, r["y_sa"], p["norm1.weight"], EPS)
    dsa = drop.site(dy1, SITE_PROJ, drop.proj)
    dense("self_attn.out_proj", dsa, o_sa)
    do_sa = (c(dsa) @ w("self_attn.out_proj")).reshape(B * S, SQ // S, D)
    dq, dk, dv = (a.reshape(B, SQ, D) for a in attend_backward(
        do_sa, r["q"], r["k"], r["v"], r["probs_sa"], r["zd_sa"], H,
        dh ** -0.5, drop, SITE_ATTN, S * H))
    dense("sa_qcontent_proj", dq, tgt)
    dense("sa_qpos_proj", dq, query_pos)
    dense("sa_kcontent_proj", dk, tgt)
    dense("sa_kpos_proj", dk, query_pos)
    dense("sa_v_proj", dv, tgt)
    dtgt = (dy1 + c(dq) @ w("sa_qcontent_proj") + c(dk) @ w("sa_kcontent_proj")
            + c(dv) @ w("sa_v_proj"))
    dqpos = dqpos + c(dq) @ w("sa_qpos_proj") + c(dk) @ w("sa_kpos_proj")
    for name in ROUNDED:
        if name in g:
            g[name] = c(g[name])
    return (dtgt.to(tgt.dtype), dmem.to(memory.dtype), dpos.to(pos.dtype),
            dqpos.to(query_pos.dtype), dsine.to(sine.dtype), g)


def param_names(p):
    """The layer's parameter names in `p`: PARAM_NAMES, and on layer 0
    FIRST_LAYER_NAMES after them."""
    return PARAM_NAMES + (FIRST_LAYER_NAMES if "ca_qpos_proj.weight" in p
                          else ())


def _need_bf16(*ts):
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the fused decoder kernels take bf16, got {t.dtype}")


class _Weights:
    """The layer's matrices in bf16 and biases in f32, as the kernels read
    them; `cat` stacks several layers' rows into one launch."""

    def __init__(self, p):
        self.p = p

    def w(self, *names):
        return _bf(torch.cat([self.p[f"{n}.weight"] for n in names]))

    def b(self, *names):
        return _f(torch.cat([self.p[f"{n}.bias"] for n in names]))

    def f(self, name):
        return _f(self.p[name])


def _self_qkv_cuda(t2d, qp2, P, shape):
    """-> (q|k (B*S, Q, 2D), v (B*S, Q, D)) bf16: q = tgt Wq + qpos Wqp and
    k likewise, summed in f32 and rounded once."""
    BS, Q, D = shape
    qk_pos = K.ln_linear(qp2, P.w("sa_qpos_proj", "sa_kpos_proj"),
                         P.b("sa_qpos_proj", "sa_kpos_proj"),
                         out_dtype=torch.float32)
    qk = K.ln_linear(t2d, P.w("sa_qcontent_proj", "sa_kcontent_proj"),
                     P.b("sa_qcontent_proj", "sa_kcontent_proj"), res=qk_pos)
    v = K.ln_linear(t2d, P.w("sa_v_proj"), P.b("sa_v_proj"))
    return qk.view(BS, Q, 2 * D), v.view(BS, Q, D)


def _cross_operands_cuda(t1, qp2, sine2, mem2, pos2, P, H, first):
    """-> (qq (B*SQ, 2D) [qc_h | sine_h], kk (B*N, 2D) [kc_h | kpos_h], vv
    (B*N, D)) bf16, each half written by its projection launch."""
    M, D = t1.shape
    dh = D // H
    qq = torch.empty((M, 2 * D), device=t1.device, dtype=torch.bfloat16)
    kk = torch.empty((mem2.shape[0], 2 * D), device=t1.device,
                     dtype=torch.bfloat16)
    il = dict(col_group=dh, col_stride=2 * dh)
    qres = kres = None
    if first:
        qres = K.ln_linear(qp2, P.w("ca_qpos_proj"), P.b("ca_qpos_proj"),
                           out_dtype=torch.float32)
        kres = K.ln_linear(pos2, P.w("ca_kpos_proj"), P.b("ca_kpos_proj"),
                           out_dtype=torch.float32)
    K.ln_linear(t1, P.w("ca_qcontent_proj"), P.b("ca_qcontent_proj"),
                res=qres, out=qq, **il)
    K.ln_linear(sine2, P.w("ca_qpos_sine_proj"), P.b("ca_qpos_sine_proj"),
                out=qq[:, dh:], **il)
    K.ln_linear(mem2, P.w("ca_kcontent_proj"), P.b("ca_kcontent_proj"),
                res=kres, out=kk, **il)
    K.ln_linear(pos2, P.w("ca_kpos_proj"), P.b("ca_kpos_proj"),
                out=kk[:, dh:], **il)
    vv = K.ln_linear(mem2, P.w("ca_v_proj"), P.b("ca_v_proj"))
    return qq, kk, vv


def _self_args(D, H):
    dh = D // H
    return dict(num_heads=H, dq=dh, dv=dh, q_hs=dh, k_hs=dh, v_hs=dh,
                logit_scale=dh ** -0.5)


def _cross_args(mask, B, N, D, H, device):
    dh = D // H
    return dict(num_heads=H, dq=2 * dh, dv=dh, q_hs=2 * dh, k_hs=2 * dh,
                v_hs=dh, kbias=key_bias(mask, B, N, device),
                logit_scale=(2 * dh) ** -0.5)


def _rows(tgt, memory, pos, query_pos, sine):
    """The inputs as (rows, D) bf16 matrices."""
    D = tgt.shape[-1]
    return [t.reshape(-1, D) for t in (tgt, query_pos, sine, memory, pos)]


def _layer_cuda(tgt, memory, pos, query_pos, sine, key_padding_mask, p,
                num_heads, num_sets, drop=None):
    """The kernels' forward: eval without `drop`, else the training form
    -> (out, o_sa, o_ca, h2d, lse_sa, lse_ca, u) (the last four None at
    eval)."""
    _need_bf16(tgt, memory, pos, query_pos, sine)
    B, SQ, D = tgt.shape
    N = memory.shape[1]
    H, S = num_heads, num_sets
    Q = SQ // S
    dev = tgt.device
    t2d, qp2, sine2, mem2, pos2 = _rows(tgt, memory, pos, query_pos, sine)
    P = _Weights(p)
    lse_sa = lse_ca = h2d = u32 = None
    tr_sa = tr_ca = {}
    if drop is not None:
        u32 = torch.empty((B * SQ, p["linear1.weight"].shape[0]), device=dev,
                          dtype=torch.float32)
        lse_sa = torch.empty((B * S, H, Q), device=dev, dtype=torch.float32)
        lse_ca = torch.empty((B, H, SQ), device=dev, dtype=torch.float32)
        h2d = torch.empty((B * SQ, D), device=dev, dtype=torch.float32)
        tr_sa = dict(seed=drop.seed, drop=(SITE_ATTN, drop.attn),
                     mask_heads=S * H, lse=lse_sa)
        tr_ca = dict(seed=drop.seed, drop=(SITE_CROSS_ATTN, drop.attn),
                     lse=lse_ca)

    def site(s, **kw):   # a projection's dropout site in training
        return {} if drop is None else dict(
            seed=drop.seed, drop=(s, drop.proj), rows_per_sample=SQ, **kw)

    # ---- self-attention, each query set on its own ----
    qk, v = _self_qkv_cuda(t2d, qp2, P, (B * S, Q, D))
    o_sa = torch.empty((B * S, Q, D), device=dev, dtype=torch.bfloat16)
    K.attention(qk[..., :D], qk[..., D:], v, o_sa, o_hs=D // H,
                **_self_args(D, H), **tr_sa)
    y = K.ln_linear(o_sa.view(B * SQ, D), P.w("self_attn.out_proj"),
                    P.b("self_attn.out_proj"), res=t2d,
                    out_dtype=torch.float32, **site(SITE_PROJ))
    t1, _ = K.layernorm(y, P.f("norm1.weight"), P.f("norm1.bias"), EPS)

    # ---- conditional cross-attention, head-interleaved operands ----
    qq, kk, vv = _cross_operands_cuda(t1, qp2, sine2, mem2, pos2, P, H,
                                      "ca_qpos_proj.weight" in p)
    o_ca = torch.empty((B, SQ, D), device=dev, dtype=torch.bfloat16)
    K.attention(qq.view(B, SQ, 2 * D), kk.view(B, N, 2 * D),
                vv.view(B, N, D), o_ca, o_hs=D // H,
                **_cross_args(key_padding_mask, B, N, D, H, dev), **tr_ca)
    y = K.ln_linear(o_ca.view(B * SQ, D), P.w("cross_attn.out_proj"),
                    P.b("cross_attn.out_proj"), res=t1,
                    out_dtype=torch.float32, **site(SITE_CROSS_PROJ))
    t2, _ = K.layernorm(y, P.f("norm2.weight"), P.f("norm2.bias"), EPS)

    # ---- FFN ----
    urd = K.ln_linear(t2, P.w("linear1"), P.b("linear1"), act="relu",
                      **site(SITE_HIDDEN, aux=u32, aux_pre=True))
    y = K.ln_linear(urd, P.w("linear2"), P.b("linear2"), res=t2,
                    out_dtype=torch.float32, **site(SITE_OUT, aux=h2d))
    _, out = K.layernorm(y, P.f("norm3.weight"), P.f("norm3.bias"), EPS,
                         want_f32=False, want_bf16=True)
    if drop is None:
        return (out.view(B, SQ, D), o_sa.view(B, SQ, D), o_ca, None, None,
                None, None)
    return (out.view(B, SQ, D), o_sa.view(B, SQ, D), o_ca, h2d.view(B, SQ, D),
            lse_sa, lse_ca, u32.to(torch.bfloat16).view(B, SQ, -1))


def _forward_cuda(tgt, memory, pos, query_pos, sine, key_padding_mask, p,
                  num_heads, num_sets):
    return _layer_cuda(tgt, memory, pos, query_pos, sine, key_padding_mask,
                       p, num_heads, num_sets)[0]


def _train_cuda(tgt, memory, pos, query_pos, sine, key_padding_mask, p,
                num_heads, num_sets, drop):
    """The kernels' training forward -> (out, o_sa, o_ca, h2d, lse_sa,
    lse_ca, u) as the plain version returns them."""
    return _layer_cuda(tgt, memory, pos, query_pos, sine, key_padding_mask,
                       p, num_heads, num_sets, drop)


def _backward_cuda(dy, tgt, memory, pos, query_pos, sine, key_padding_mask,
                   o_sa, o_ca, h2d, lse_sa, lse_ca, u, p, num_heads, num_sets,
                   drop):
    """The kernels' backward -> (dtgt, dmem, dpos, dqpos, dsine f32, {name:
    gradient}) as the plain version returns them (the input gradients
    before the cast to the inputs' dtypes)."""
    _need_bf16(tgt, memory, pos, query_pos, sine, o_sa, o_ca)
    B, SQ, D = tgt.shape
    N = memory.shape[1]
    H, S = num_heads, num_sets
    Q = SQ // S
    dh = D // H
    M = B * SQ
    dev = tgt.device
    F32 = torch.float32
    seed = drop.seed
    first = "ca_qpos_proj.weight" in p
    t2d, qp2, sine2, mem2, pos2 = _rows(tgt, memory, pos, query_pos, sine)
    o_sa2, o_ca2 = o_sa.reshape(M, D), o_ca.reshape(M, D)
    P = _Weights(p)
    g = {}

    def site(s):
        return dict(seed=seed, drop=(s, drop.proj), rows_per_sample=SQ)

    def dense(name, d, x):   # a Dense layer's parameter gradients
        g[f"{name}.weight"] = K.grad_weight(d, x)
        g[f"{name}.bias"] = K.colsum_f32(d)

    # recompute the linear parts (the forward's launches, same bits)
    qk, v = _self_qkv_cuda(t2d, qp2, P, (B * S, Q, D))
    y_sa = K.ln_linear(o_sa2, P.w("self_attn.out_proj"),
                       P.b("self_attn.out_proj"), res=t2d, out_dtype=F32,
                       **site(SITE_PROJ))
    t1, _ = K.layernorm(y_sa, P.f("norm1.weight"), P.f("norm1.bias"), EPS)
    qq, kk, vv = _cross_operands_cuda(t1, qp2, sine2, mem2, pos2, P, H, first)
    y_ca = K.ln_linear(o_ca2, P.w("cross_attn.out_proj"),
                       P.b("cross_attn.out_proj"), res=t1, out_dtype=F32,
                       **site(SITE_CROSS_PROJ))
    t2, _ = K.layernorm(y_ca, P.f("norm2.weight"), P.f("norm2.bias"), EPS)
    urd = K.ln_linear(t2, P.w("linear1"), P.b("linear1"), act="relu",
                      **site(SITE_HIDDEN))
    u = u.reshape(M, -1).float()   # the forward's ReLU decisions

    # FFN; dt2 accumulates dy3 + du . W1 in place
    dt2, g["norm3.weight"], g["norm3.bias"] = K.ln_backward(
        dy.reshape(M, D).float(), t2 + h2d.reshape(M, D),
        P.f("norm3.weight"), EPS)
    dh2 = K.dropout_grad(dt2, seed, (SITE_OUT, drop.proj), SQ)
    dense("linear2", dh2, urd)
    du = K.matmul_dx(dh2, P.w("linear2"), relu_aux=u, **site(SITE_HIDDEN))
    dense("linear1", du, t2)
    K.matmul_dx(du, P.w("linear1"), out=dt2)
    dy2, g["norm2.weight"], g["norm2.bias"] = K.ln_backward(
        dt2, y_ca, P.f("norm2.weight"), EPS)

    # cross-attention: [dqc | dsine_p] and [dkc | dkp] in two planes each
    dca = K.dropout_grad(dy2, seed, (SITE_CROSS_PROJ, drop.proj), SQ)
    dense("cross_attn.out_proj", dca, o_ca2)
    do_ca = K.matmul_dx(dca, P.w("cross_attn.out_proj"))
    dqq = torch.empty((2, B, SQ, D), device=dev, dtype=F32)
    dkk = torch.empty((2, B, N, D), device=dev, dtype=F32)
    dvv = torch.empty((B, N, D), device=dev, dtype=F32)
    K.attention_backward(
        qq.view(B, SQ, 2 * D), kk.view(B, N, 2 * D), vv.view(B, N, D),
        do_ca.view(B, SQ, D), lse_ca, do_hs=dh, dq_out=dqq[0],
        dk_out=dkk[0], dv_out=dvv, dq_hs=dh, dk_hs=dh, dv_hs=dh, seed=seed,
        drop=(SITE_CROSS_ATTN, drop.attn),
        split=(dh, dqq.stride(0), dkk.stride(0)),
        **_cross_args(key_padding_mask, B, N, D, H, dev))
    dqc, dsp = dqq.view(2, M, D)
    dkc, dkp = dkk.view(2, B * N, D)
    dvv = dvv.view(B * N, D)
    dense("ca_qpos_sine_proj", dsp, sine2)
    dsine = K.matmul_dx(dsp, P.w("ca_qpos_sine_proj"))
    dqpos = None
    if first:
        # qc = qc0 + qpos Wcaqp; kc = kc0 + kpos (kpos also in the concat)
        dense("ca_qpos_proj", dqc, qp2)
        dqpos = K.matmul_dx(dqc, P.w("ca_qpos_proj"))
        dkp += dkc
    dense("ca_qcontent_proj", dqc, t1)
    K.matmul_dx(dqc, P.w("ca_qcontent_proj"), out=dy2)       # dt1, in place
    dense("ca_kcontent_proj", dkc, mem2)
    dense("ca_v_proj", dvv, mem2)
    dmem = K.matmul_dx(dkc, P.w("ca_kcontent_proj"))
    K.matmul_dx(dvv, P.w("ca_v_proj"), out=dmem)
    dense("ca_kpos_proj", dkp, pos2)
    dpos = K.matmul_dx(dkp, P.w("ca_kpos_proj"))

    # self-attention, each query set on its own
    dy1, g["norm1.weight"], g["norm1.bias"] = K.ln_backward(
        dy2, y_sa, P.f("norm1.weight"), EPS)
    dsa = K.dropout_grad(dy1, seed, (SITE_PROJ, drop.proj), SQ)
    dense("self_attn.out_proj", dsa, o_sa2)
    do_sa = K.matmul_dx(dsa, P.w("self_attn.out_proj"))
    dqkv = torch.empty((B * S, Q, 3 * D), device=dev, dtype=F32)
    K.attention_backward(
        qk[..., :D], qk[..., D:], v, do_sa.view(B * S, Q, D), lse_sa,
        do_hs=dh, dq_out=dqkv[..., :D], dk_out=dqkv[..., D:2 * D],
        dv_out=dqkv[..., 2 * D:], dq_hs=dh, dk_hs=dh, dv_hs=dh, seed=seed,
        drop=(SITE_ATTN, drop.attn), mask_heads=S * H, **_self_args(D, H))
    dqkv2 = dqkv.view(M, 3 * D)
    dqk = dqkv2[:, :2 * D]
    content = K.grad_weight(dqk, t2d)
    position = K.grad_weight(dqk, qp2)
    cs = K.colsum_f32(dqkv2)
    for i, (c_name, p_name) in enumerate(
            (("sa_qcontent_proj", "sa_qpos_proj"),
             ("sa_kcontent_proj", "sa_kpos_proj"))):
        g[f"{c_name}.weight"] = content[i * D:(i + 1) * D]
        g[f"{p_name}.weight"] = position[i * D:(i + 1) * D]
        g[f"{c_name}.bias"] = cs[i * D:(i + 1) * D]
        g[f"{p_name}.bias"] = cs[i * D:(i + 1) * D].clone()
    g["sa_v_proj.weight"] = K.grad_weight(dqkv2[:, 2 * D:], t2d)
    g["sa_v_proj.bias"] = cs[2 * D:]
    K.matmul_dx(dqkv2, P.w("sa_qcontent_proj", "sa_kcontent_proj",
                           "sa_v_proj"), out=dy1)             # dtgt, in place
    w_pos = P.w("sa_qpos_proj", "sa_kpos_proj")
    if dqpos is None:
        dqpos = K.matmul_dx(dqk, w_pos)
    else:
        K.matmul_dx(dqk, w_pos, out=dqpos)
    return (dy1.view(B, SQ, D), dmem.view(B, N, D), dpos.view(B, N, D),
            dqpos.view(B, SQ, D), dsine.view(B, SQ, D), g)


def _plain(t):
    """The device dispatch: CPU tensors take the plain versions."""
    return t.device.type == "cpu"


class DecoderLayerFn(torch.autograd.Function):
    """The decoder layer in training: forward and backward each dispatched
    by the device of tgt (CPU: the plain versions; CUDA: the kernels).
    Gradients flow to tgt, memory, pos, query_pos, sine and the
    parameters."""

    @staticmethod
    def forward(ctx, tgt, memory, pos, query_pos, sine, key_padding_mask,
                seed, rates, num_heads, num_sets, names, *params):
        p = dict(zip(names, params))
        drop = CounterDropout(seed, *rates)
        args = (tgt, memory, pos, query_pos, sine, key_padding_mask, p,
                num_heads, num_sets, drop)
        if _plain(tgt):
            out, *saved = decoder_layer_train_reference(*args)
        else:
            out, *saved = _train_cuda(*args)
            fused_decoder_layer.train_launches += 1
        ctx.save_for_backward(tgt, memory, pos, query_pos, sine,
                              key_padding_mask, seed, *saved, *params)
        ctx.rates, ctx.num_heads, ctx.num_sets = rates, num_heads, num_sets
        ctx.names = names
        return out

    @staticmethod
    def backward(ctx, dy):
        inputs, (mask, seed), saved, params = (
            ctx.saved_tensors[:5], ctx.saved_tensors[5:7],
            ctx.saved_tensors[7:13], ctx.saved_tensors[13:])
        p = dict(zip(ctx.names, params))
        args = (dy, *inputs, mask, *saved, p, ctx.num_heads, ctx.num_sets,
                CounterDropout(seed, *ctx.rates))
        if _plain(inputs[0]):
            *dins, g = decoder_layer_backward_reference(*args)
        else:
            *dins, g = _backward_cuda(*args)
            fused_decoder_layer.bwd_launches += 1
        need = ctx.needs_input_grad
        dins = [d.to(t.dtype) if need[i] else None
                for i, (d, t) in enumerate(zip(dins, inputs))]
        grads = [g[n].to(t.dtype) if need[11 + i] else None
                 for i, (n, t) in enumerate(zip(ctx.names, params))]
        return (*dins, None, None, None, None, None, None, *grads)


def fused_decoder_layer(tgt, memory, pos, query_pos, sine, key_padding_mask,
                        params, num_heads, num_sets, drop=None):
    """One conditional decoder layer over `num_sets` stacked query sets
    -> (B, S*Q, D). drop: a refmath.CounterDropout in training, or None.
    With grad needed on an input or a parameter, or any dropout rate: the
    autograd Function; otherwise the eval forward."""
    names = param_names(params)
    p = {n: params[n] for n in names}
    args = (tgt, memory, pos, query_pos, sine, key_padding_mask)
    if needs_grad([tgt, memory, pos, query_pos, sine, *p.values()]) or (
            drop is not None and (drop.attn or drop.proj)):
        drop = drop or no_dropout(tgt.device)
        return DecoderLayerFn.apply(*args, drop.seed, (drop.attn, drop.proj),
                                    num_heads, num_sets, names, *p.values())
    if _plain(tgt):
        return decoder_layer_reference(*args, p, num_heads, num_sets)
    out = _forward_cuda(*args, p, num_heads, num_sets)
    fused_decoder_layer.launches += 1
    return out


fused_decoder_layer.launches = 0
fused_decoder_layer.train_launches = 0
fused_decoder_layer.bwd_launches = 0
