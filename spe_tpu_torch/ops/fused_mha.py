"""Standalone multi-head attention for Hopper (B4).

    P = softmax(dq^-0.5 q . k^T + kbias)        (f32 logits; kbias -1e9
    out = drop(P) . v                            on padded keys)

Replaces the TPU kernels spe_tpu/ops/pallas_mha.py:273 `fused_mha`: the
forward (`_fwd_call` :152, `pallas_call` :165, body `_fwd_kernel` :45) and
the backward (`_bwd_call` :197, `pallas_call` :201, body `_bwd_kernel` :86,
`_core_bwd` :258). With `use_pallas_attention` and the fused layers off
they serve three attentions of the JAX package (spe_tpu/models/attention.py
:166-172, 235-243, 281-289): the class attention with its probabilities as
a second output (the CAM source, no dropout), the encoder self-attention
with the key-padding mask, and the decoder's conditional cross-attention,
whose q/k heads (2 dh: content and position halves) are twice as wide as
its v heads. The layer around each stays plain.

q, k and v are the port's (B, N, H*d) head-strided views (any row stride,
the last dim contiguous), which the plain layers already hold: no head
transpose is copied. The scale dq^-0.5 multiplies the f32 logits, as
`_fwd_kernel` does; the einsum path instead pre-scales q in the input
dtype. Masked keys get -1e9. Dropout (counter masks keyed (seed, MHA_ATTN,
b, h, q, k), one seed per call) falls on the normalised probabilities; the
optional probabilities output is taken before it. Under tensor parallelism
(`--tp_attention`) each rank calls it on its H/M heads, as the JAX
package's shard_map runs the kernel on its head shard (pallas_mha.py
:317-361): the arithmetic is the same, and the mask keys take the rank's
first global head (the dropout's `head0`), so the shards draw the bits of
the unsharded call. The TPU wrapper pads Nq
to a multiple of 8 and Nk to one of 128 (padded keys at -1e9); here the
kernels mask their ragged edge tiles instead.

On the card the forward is the port's online-softmax attention kernel
(csrc/attention.cu, `kernels.attention`) with its training form: dropout
inside the online softmax, each row's log-sum-exp written for the backward,
the probabilities in a second pass when asked. Nothing of size N^2 reaches
device memory in the forward. The backward is `kernels.attention_backward`
(spe_gemm products on f32 (B, H, Nq, Nk) planes of the logits and dY . V^T,
the attn_bwd_rows pass writing zd and dl = p (dp - rowsum(dp p)) in bf16,
then dV, dQ and dK), which follows `_bwd_kernel` step by step; dK and dV
sum in f32 and come back in the inputs' dtypes. The probabilities'
cotangent is dropped (:261-264): the CAM is read without a gradient. What
bounds it on the H100: the QK^T and PV products (compute) at N = 1024, run
on the tensor cores (mma.sync, csrc/attention.cu and csrc/grad.cu).

Dispatch is by tensor device only: CPU tensors take the plain versions
(`fused_mha_reference`, `fused_mha_train_reference`,
`fused_mha_backward_reference`), CUDA tensors the kernels (bf16 only;
anything else raises). `fused_mha` counts its CUDA launches: `.launches`
(no grad, no dropout), `.train_launches` (the autograd Function's forward)
and `.bwd_launches`.
"""

from __future__ import annotations

import torch

from spe_tpu_torch.ops import kernels as K
from spe_tpu_torch.ops.fused_encoder import attend_backward, attend_train
from spe_tpu_torch.ops.refmath import (SITE_MHA_ATTN, CounterDropout,
                                       draw_seed, key_bias, needs_grad,
                                       no_dropout)


def _scale(q, H):
    return (q.shape[-1] // H) ** -0.5


def _bias(q, k, mask):
    return key_bias(mask, k.shape[0], k.shape[1], q.device)


def fused_mha_train_reference(q, k, v, num_heads, key_padding_mask=None,
                              drop=None, return_attn=False):
    """Plain PyTorch version of `_fwd_kernel` (pallas_mha.py:45-83) as the
    kernels compute it in training. q: (B, Nq, H*dq); k: (B, Nk, H*dq); v:
    (B, Nk, H*dv); key_padding_mask: (B, Nk) bool, True = padded, or None;
    drop: a refmath.CounterDropout (its attention rate) or None -> (out
    (B, Nq, H*dv) in q's dtype, lse (B, H, Nq) f32: each row's
    log-sum-exp, saved for the backward), or (out, probs, lse) with
    return_attn, the probabilities (B, H, Nq, Nk) f32 before dropout."""
    drop = drop or no_dropout(q.device)
    o, probs, _, lse = attend_train(q, k, v, num_heads, _scale(q, num_heads),
                                    _bias(q, k, key_padding_mask), drop,
                                    SITE_MHA_ATTN, num_heads)
    out = o.to(q.dtype)
    return (out, probs, lse) if return_attn else (out, lse)


def _drop_lse(res, return_attn):
    """A training forward's result without its lse, as the eval forward
    returns it: out, or (out, probs) with return_attn."""
    return res[:-1] if return_attn else res[0]


def fused_mha_reference(q, k, v, num_heads, key_padding_mask=None, drop=None,
                        return_attn=False):
    """The plain eval forward: `fused_mha_train_reference` without the lse
    -> out, or (out, probs) with return_attn."""
    return _drop_lse(fused_mha_train_reference(
        q, k, v, num_heads, key_padding_mask, drop, return_attn), return_attn)


def fused_mha_backward_reference(dy, q, k, v, lse, num_heads,
                                 key_padding_mask=None, drop=None,
                                 return_attn=False):
    """Plain, hand-derived backward mirroring `_bwd_kernel` (pallas_mha.py
    :86-137) step by step: p rebuilt from the logits and lse, dV = zd^T dY,
    dp = drop(dY . V^T), dL = p (dp - rowsum(dp p)) rounded to the input
    dtype, dQ = scale dL . K, dK = scale dL^T . Q; the probabilities'
    cotangent is dropped (return_attn changes nothing). -> (dq, dk, dv) in
    the inputs' dtypes."""
    drop = drop or no_dropout(q.device)
    H = num_heads
    scale = _scale(q, H)
    _, probs, zd, _ = attend_train(q, k, v, H, scale,
                                   _bias(q, k, key_padding_mask), drop,
                                   SITE_MHA_ATTN, H, lse)
    dq, dk, dv = attend_backward(dy, q, k, v, probs, zd, H, scale, drop,
                                 SITE_MHA_ATTN, H)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _dims(q, k, v, H):
    for t, n in ((q, "q"), (k, "k"), (v, "v")):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the fused MHA kernels take bf16, got {n} "
                            f"{t.dtype}")
        if t.shape[-1] % H:
            raise ValueError(f"{n}: {t.shape[-1]} columns are not {H} heads")
    if q.shape[-1] != k.shape[-1]:
        raise ValueError("q and k must have the same head width")
    return q.shape[-1] // H, v.shape[-1] // H


def _train_cuda(q, k, v, num_heads, key_padding_mask=None, drop=None,
                return_attn=False):
    """The kernels' training forward -> (out, lse) or (out, probs, lse) as
    the plain version returns them."""
    drop = drop or no_dropout(q.device)
    H = num_heads
    dq, dv = _dims(q, k, v, H)
    B, Nq = q.shape[:2]
    Nk = k.shape[1]
    out = torch.empty((B, Nq, H * dv), device=q.device, dtype=q.dtype)
    lse = torch.empty((B, H, Nq), device=q.device, dtype=torch.float32)
    probs = torch.empty((B, H, Nq, Nk), device=q.device,
                        dtype=torch.float32) if return_attn else None
    K.attention(q, k, v, out, num_heads=H, dq=dq, dv=dv, q_hs=dq, k_hs=dq,
                v_hs=dv, o_hs=dv, kbias=_bias(q, k, key_padding_mask),
                logit_scale=dq ** -0.5, probs=probs, seed=drop.seed,
                drop=(SITE_MHA_ATTN, drop.attn), lse=lse, head0=drop.head0)
    return (out, probs, lse) if return_attn else (out, lse)


def _forward_cuda(q, k, v, num_heads, key_padding_mask=None,
                  return_attn=False):
    """The kernels' eval forward: the training form at rate 0."""
    return _drop_lse(_train_cuda(q, k, v, num_heads, key_padding_mask,
                                 return_attn=return_attn), return_attn)


def _backward_cuda(dy, q, k, v, lse, num_heads, key_padding_mask=None,
                   drop=None, return_attn=False):
    """The kernels' backward -> (dq, dk, dv) as the plain version returns
    them."""
    drop = drop or no_dropout(q.device)
    H = num_heads
    dq, dv = _dims(q, k, v, H)
    grads = [torch.empty(t.shape, device=q.device, dtype=torch.float32)
             for t in (q, k, v)]
    K.attention_backward(
        q, k, v, dy.to(q.dtype).contiguous(), lse, num_heads=H, dq=dq, dv=dv,
        q_hs=dq, k_hs=dq, v_hs=dv, do_hs=dv, dq_out=grads[0],
        dk_out=grads[1], dv_out=grads[2], dq_hs=dq, dk_hs=dq, dv_hs=dv,
        kbias=_bias(q, k, key_padding_mask), logit_scale=dq ** -0.5,
        seed=drop.seed, drop=(SITE_MHA_ATTN, drop.attn), head0=drop.head0)
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))


def _plain(t):
    """The device dispatch: CPU tensors take the plain versions."""
    return t.device.type == "cpu"


class MHAFn(torch.autograd.Function):
    """The attention in training: forward and backward each dispatched by
    the device of q (CPU: the plain versions; CUDA: the kernels). With
    return_attn the probabilities are a second, non-differentiable
    output."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, seed, rate, num_heads,
                return_attn, head0=0):
        drop = CounterDropout(seed, attn=rate, head0=head0)
        args = (q, k, v, num_heads, key_padding_mask, drop, return_attn)
        if _plain(q):
            res = fused_mha_train_reference(*args)
        else:
            res = _train_cuda(*args)
            fused_mha.train_launches += 1
        ctx.save_for_backward(q, k, v, key_padding_mask, seed, res[-1])
        ctx.rate, ctx.num_heads, ctx.head0 = rate, num_heads, head0
        if not return_attn:
            return res[0]
        ctx.mark_non_differentiable(res[1])
        return res[0], res[1]

    @staticmethod
    def backward(ctx, dy, *_):
        q, k, v, mask, seed, lse = ctx.saved_tensors
        args = (dy, q, k, v, lse, ctx.num_heads, mask,
                CounterDropout(seed, attn=ctx.rate, head0=ctx.head0))
        if _plain(q):
            grads = fused_mha_backward_reference(*args)
        else:
            grads = _backward_cuda(*args)
            fused_mha.bwd_launches += 1
        need = ctx.needs_input_grad
        return (*(g if n else None for g, n in zip(grads, need)), None, None,
                None, None, None, None)


def fused_mha(q, k, v, num_heads, key_padding_mask=None, drop=None,
              return_attn=False):
    """The standalone attention. q: (B, Nq, H*dq), k: (B, Nk, H*dq), v:
    (B, Nk, H*dv) views; key_padding_mask (B, Nk) bool or None; drop: a
    refmath.CounterDropout (its `attn` rate) or None -> out (B, Nq, H*dv)
    in q's dtype, and with return_attn the probabilities (B, H, Nq, Nk)
    f32. With grad needed or a dropout rate: the autograd Function;
    otherwise the eval forward."""
    if needs_grad([q, k, v]) or (drop is not None and drop.attn):
        drop = drop or no_dropout(q.device)
        return MHAFn.apply(q, k, v, key_padding_mask, drop.seed, drop.attn,
                           num_heads, return_attn, drop.head0)
    if _plain(q):
        return fused_mha_reference(q, k, v, num_heads, key_padding_mask,
                                   return_attn=return_attn)
    out = _forward_cuda(q, k, v, num_heads, key_padding_mask, return_attn)
    fused_mha.launches += 1
    return out


fused_mha.launches = 0
fused_mha.train_launches = 0
fused_mha.bwd_launches = 0


def layer_attention(q, k, v, num_heads, key_padding_mask=None, drop=None,
                    return_attn=False):
    """This kernel as the plain layers call their attention (the class
    attention, the encoder self-attention, the decoder cross-attention):
    drop is the plain layer's refmath.Dropout or None; one seed per call is
    drawn from its generator when the attention rate is on, as JAX draws
    one per fused_mha call (attention.py:206-211, 284-288). Under tensor
    parallelism q, k and v hold the rank's heads and drop is the layer's
    refmath.ShardDropout over them: its seed is every rank's, and the mask
    keys start at the rank's first global head."""
    cd = None
    if drop is not None and drop.attn > 0.0:
        cd = CounterDropout(draw_seed(drop.gen, q.device), attn=drop.attn,
                            head0=drop.offset(num_heads))
    return fused_mha(q, k, v, num_heads, key_padding_mask, cd, return_attn)
