"""Inputs and tolerances for holding each fused-layer kernel against its
plain PyTorch version on the card (used by chip_smoke.py and the `cuda`
tests).

`kernel_cases()` draws seeded bf16 activations and f32 weights at the
voc0712 eval widths (D=192, 4 backbone heads, 8 transformer heads,
FFN 2048); sequence lengths default to the recipe's (1024 patches, 21
class tokens, 2 query sets of 300) and may be cut for a quick check.
LayerScale gammas and LayerNorm scales are drawn near 1 so every branch
shows in the output.
"""

from __future__ import annotations

import math

import torch

from spe_tpu_torch.ops import (fused_block, fused_ca_block, fused_decoder,
                               fused_encoder)

# every fused layer is built from the same three sources: linear.cu
# (ln_linear), attention.cu and rowops.cu
SOURCE = "spe_tpu_torch/csrc"
# bf16 outputs are held to 4 bf16 ulps at their largest magnitude: the
# kernels sum in another order than cuBLAS and keep the softmax
# probabilities in f32 where the plain versions round them to bf16 before
# the PV product. The class-attention probabilities (f32, the CAM source)
# are held to PROBS_TOL.
ULPS = 4
PROBS_TOL = 1e-4
# A whole detector through the kernels vs the same weights through the plain
# versions (bf16 both, LayerScale 1): bf16 keeps ~2^-8 relative precision
# per rounding and the two paths sum in different orders through every
# layer, so each output is held to 5% of its own largest magnitude. Maps
# (the CAMs and the first class-attention block's probabilities) are nearly
# flat at random init, where 5% of the largest value would pass a mirrored
# map; they are held to 5% of their range (max - min) instead.
MODEL_REL_TOL = 0.05
MAP_KEYS = ("cams_cls", "ca0_probs")


def model_tol(key, ref):
    """Tolerance of one detector output against the plain-version model."""
    ref = ref.float()
    if key in MAP_KEYS:
        return MODEL_REL_TOL * float(ref.max() - ref.min())
    return MODEL_REL_TOL * float(ref.abs().max())


def bf16_tol(ref, ulps=ULPS):
    """`ulps` bf16 ulps (8 significant bits) at the largest |ref|."""
    top = float(ref.float().abs().max())
    return ulps * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def kernel_cases(B=2, N=1024, t=21, S=2, Q=300, device="cuda", seed=0):
    """[(name, replaces, fused fn, plain fn, args)] for the four kernels;
    the decoder twice, with the layer-0 (ca_qpos_proj) and the later-layer
    parameter sets."""
    D, F = 192, 2048
    gen = torch.Generator().manual_seed(seed)

    def param(shape, std, mean=0.0):
        return (mean + std * torch.randn(shape, generator=gen)).to(device)

    def linear(p, name, fin, fout):
        p[f"{name}.weight"] = param((fout, fin), fin ** -0.5)
        p[f"{name}.bias"] = param((fout,), 0.02)

    def norm(p, name):
        p[f"{name}.weight"] = param((D,), 0.1, 1.0)
        p[f"{name}.bias"] = param((D,), 0.05)

    def act(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16).to(device)

    blk = {}
    norm(blk, "norm1")
    linear(blk, "attn.qkv", D, 3 * D)
    linear(blk, "attn.proj_l", 4, 4)
    linear(blk, "attn.proj_w", 4, 4)
    linear(blk, "attn.proj", D, D)
    norm(blk, "norm2")
    linear(blk, "mlp.fc1", D, 4 * D)
    linear(blk, "mlp.fc2", 4 * D, D)
    blk["gamma_1"] = param((D,), 0.1, 1.0)
    blk["gamma_2"] = param((D,), 0.1, 1.0)

    ca = {}
    norm(ca, "norm1")
    for n in ("q", "k", "v", "proj"):
        linear(ca, f"attn.{n}", D, D)
    norm(ca, "norm2")
    linear(ca, "mlp.fc1", D, 4 * D)
    linear(ca, "mlp.fc2", 4 * D, D)
    ca["gamma_1"] = param((D,), 0.1, 1.0)
    ca["gamma_2"] = param((D,), 0.1, 1.0)

    enc = {"self_attn.in_proj_weight": param((3 * D, D), D ** -0.5),
           "self_attn.in_proj_bias": param((3 * D,), 0.02)}
    linear(enc, "self_attn.out_proj", D, D)
    norm(enc, "norm1")
    linear(enc, "linear1", D, F)
    linear(enc, "linear2", F, D)
    norm(enc, "norm2")

    dec = {}
    for n in ("sa_qcontent_proj", "sa_qpos_proj", "sa_kcontent_proj",
              "sa_kpos_proj", "sa_v_proj", "self_attn.out_proj",
              "ca_qcontent_proj", "ca_kcontent_proj", "ca_v_proj",
              "ca_kpos_proj", "ca_qpos_sine_proj", "cross_attn.out_proj",
              "ca_qpos_proj"):
        linear(dec, n, D, D)
    for n in ("norm1", "norm2", "norm3"):
        norm(dec, n)
    linear(dec, "linear1", D, F)
    linear(dec, "linear2", F, D)
    dec_later = {k: v for k, v in dec.items()
                 if not k.startswith("ca_qpos_proj")}

    mask = torch.zeros((B, N), dtype=torch.bool)
    mask[-1, N - N // 10:] = True  # padded keys on the last image
    mask = mask.to(device)
    x, pos, cls = act(B, N, D), act(B, N, D), act(B, t, D)
    tgt, qpos, sine = act(B, S * Q, D), act(B, S * Q, D), act(B, S * Q, D)
    return [
        ("pallas_block", "spe_tpu/ops/pallas_block.py:548",
         fused_block.fused_layer_scale_block,
         fused_block.layer_scale_block_reference, (x, blk, 4)),
        ("pallas_ca_block", "spe_tpu/ops/pallas_ca_block.py:268",
         fused_ca_block.fused_class_attn_block,
         fused_ca_block.class_attn_block_reference, (cls, x, ca, 4)),
        ("pallas_encoder", "spe_tpu/ops/pallas_encoder.py:375",
         fused_encoder.fused_encoder_layer,
         fused_encoder.encoder_layer_reference, (x, pos, mask, enc, 8)),
        ("pallas_decoder", "spe_tpu/ops/pallas_decoder.py:599",
         fused_decoder.fused_decoder_layer,
         fused_decoder.decoder_layer_reference,
         (tgt, x, pos, qpos, sine, mask, dec, 8, S)),
        ("pallas_decoder", "spe_tpu/ops/pallas_decoder.py:599",
         fused_decoder.fused_decoder_layer,
         fused_decoder.decoder_layer_reference,
         (tgt, x, pos, qpos, sine, mask, dec_later, 8, S)),
    ]


def compare(fused, plain, args):
    """Run both on the same inputs -> (errors, tolerances, all finite)."""
    with torch.no_grad():
        got = fused(*args)
        want = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = [max_err(g, w) for g, w in zip(got, want)]
    tols = [bf16_tol(want[0])] + [PROBS_TOL] * (len(got) - 1)
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    return errs, tols, finite
