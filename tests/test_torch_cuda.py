"""The hand-written CUDA kernels on the card (marker `cuda`): each fused
layer against its plain PyTorch version at the recipe widths with cut
sequence lengths, and a small full-width detector through the kernels
against the same weights through the plain versions. The kernels have no CPU
mode, so without a card these tests skip.

Run on a machine with the card:  python -m pytest tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", range(5))
def test_kernel_matches_plain(card, case):
    """Ragged lengths: N=100 keys (not a multiple of the 64-key tile),
    t=21 class tokens, Q=30 queries per set, a padded-key mask."""
    from spe_tpu_torch.ops.kernel_checks import compare, kernel_cases

    name, _, fused, plain, args = kernel_cases(B=2, N=100, Q=30)[case]
    before = fused.launches
    errs, tols, finite = compare(fused, plain, args)
    torch.cuda.synchronize()
    assert finite, name
    assert all(e <= t for e, t in zip(errs, tols)), (name, errs, tols)
    assert fused.launches == before + 1


def test_small_detector_through_kernels(card):
    """Full width (D=192, 4/8 heads), cut depth: 2 + 1 patch blocks, 2
    class-attention blocks, 1 encoder and 2 decoder layers, 2 x 12
    queries, on a 64 px image with one padded column band."""
    from spe_tpu_torch.models.build import init_weights
    from spe_tpu_torch.models.cait import CaiTConfig
    from spe_tpu_torch.models.detector import SPEDetector
    from spe_tpu_torch.ops import fused_block, fused_decoder
    from spe_tpu_torch.ops.kernel_checks import max_err, model_tol

    def build(fused):
        bb = CaiTConfig(img_size=64, depth=2, layer_to_det=1,
                        init_scale=1.0, use_fused_block=fused)
        m = SPEDetector(bb, 21, num_queries=12, enc_layers=1, dec_layers=2,
                        use_fused_layers=fused, dtype=torch.bfloat16)
        init_weights(m, 0)
        # the last bbox layer is zero at init, which leaves the boxes blind
        # to the decoder; both models draw the same random one
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for head in m.bbox_embed:
                head.layers[-1].weight.normal_(0.0, 0.02, generator=gen)
        return m.to(card).eval()

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 64, 64, 3), generator=gen).to(card)
    pad = torch.zeros((2, 64, 64), dtype=torch.bool, device=card)
    pad[1, :, 48:] = True
    blocks, layers = fused_block.fused_layer_scale_block.launches, \
        fused_decoder.fused_decoder_layer.launches
    with torch.no_grad():
        got = build(True)(x, pad_mask=pad)
        want = build(False)(x, pad_mask=pad)
    assert fused_block.fused_layer_scale_block.launches == blocks + 3
    assert fused_decoder.fused_decoder_layer.launches == layers + 2
    pairs = {k: (got["stages"][0][k], want["stages"][0][k])
             for k in ("pred_logits", "pred_boxes")}
    pairs["cams_cls"] = (got["backbone"]["cams_cls"],
                         want["backbone"]["cams_cls"])
    for k, (g, w) in pairs.items():
        assert torch.isfinite(g).all(), k
        assert max_err(g, w) <= model_tol(k, w), k
