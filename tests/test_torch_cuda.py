"""The hand-written CUDA kernels on the card (marker `cuda`): each fused
layer against its plain PyTorch version at the recipe widths with cut
sequence lengths, every fused layer's training forward and backward
kernels and their dropout masks likewise, a small full-width detector
through the kernels against the same weights through the plain versions,
the two supervision kernels (connected components, auction) against
their plain versions at the recipe's training shapes, and the standalone
attention kernels (fused_mha in its three flavours, the talking-heads
attention) forward and backward against their plain versions with cut
sequence lengths, and the two tensor-core product kernels (gemm_kernel,
attn_kernel) against kernels.gemm_reference / attention_reference on
ragged shapes, every layout and option, misaligned operands, likewise
linear_kernel against ln_linear_reference, th_bwd_rows_kernel against
th_bwd_rows_reference, th_fwd_rows_kernel against th_fwd_rows_reference
and attn_bwd_rows_kernel against attention_bwd_rows_reference. The
kernels have no CPU mode, so without a card these tests skip.

Run on a machine with the card:  python -m pytest tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

from spe_tpu_torch.ops.kernel_checks import (ATTN_ROWS_SHAPES, GEMM_SHAPES,
                                             LINEAR_SHAPES, TH_BWD_SHAPES,
                                             TH_FWD_SHAPES)

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


def test_connected_components_kernel_equals_plain(card):
    """Kernel 5 at the recipe's shapes (64 masks of 64 x 64: blobs and two
    mazes that bind the 96-sweep cap): labels exactly equal."""
    from spe_tpu_torch.ops import connected_components as cc
    from spe_tpu_torch.ops.kernel_checks import cc_masks

    masks = cc_masks().to(card)
    before = cc.connected_components.launches
    got = cc.connected_components(masks)
    want = cc.connected_components_reference(masks)
    torch.cuda.synchronize()
    assert cc.connected_components.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(96, 120, 300), (3, 120, 60)])
def test_auction_kernel_equals_plain(card, shape):
    """Kernel 6 on DETR-like costs: the recipe's 96 problems of 120 x 300,
    and an overfull shape (more targets than queries): assignments,
    iteration counts and bid counts exactly equal."""
    from spe_tpu_torch.ops import auction
    from spe_tpu_torch.ops.kernel_checks import auction_problems

    P, T, Q = shape
    benefit, mask = auction_problems(P, T, Q, device=card)
    before = auction.auction_phase.launches
    got = auction.auction_phase(benefit, mask)
    want = auction.auction_phase_reference(benefit, mask)
    torch.cuda.synchronize()
    assert auction.auction_phase.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_dropout_masks_equal_torch(card):
    """The kernels' counter masks equal refmath's torch formula bit for
    bit, for a head-split attention shape, a row shape and DropPath."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.refmath import counter_keep, path_keep

    seed = torch.tensor([31337], dtype=torch.int32, device=card)
    for site, rate, shape in ((1, 0.05, (2, 4, 100, 100)),
                              (3, 0.07, (2, 1, 100, 768)), (5, 0.2, (64,)),
                              (7, 0.1, (2, 8, 60, 100)),
                              (8, 0.1, (2, 1, 60, 192)),
                              (9, 0.05, (2, 4, 100, 100)),
                              (10, 0.1, (2, 8, 60, 100))):
        got = K.dropout_mask(seed, site, rate, shape)
        want = (path_keep(seed, site, rate, shape[0]) if len(shape) == 1
                else counter_keep(seed, site, rate, shape))
        torch.cuda.synchronize()
        assert torch.equal(got, want), (site, shape)


@pytest.mark.parametrize("case", range(5))
def test_train_kernels_match_plain(card, case):
    """The patch block (recipe dropout), the class-attention block (with a
    CAM cotangent), the encoder layer and the decoder layer (layer 0 and a
    later layer; the recipe's dropout 0.1) at N=100 keys, t=21, Q=30
    queries per set: the training forward within 4 bf16 ulps (the CAM
    probabilities within PROBS_TOL), every gradient of the backward within
    kernel_checks.grad_tols of the plain backward on the same saved
    tensors, and two backward runs bit-identical."""
    from spe_tpu_torch.ops.kernel_checks import (PROBS_TOL, backward_args,
                                                 bf16_tol, flat_grads,
                                                 grad_tols, max_err,
                                                 plain_train, train_cases)

    name, mod, args, cot = train_cases(B=2, N=100, Q=30)[case]
    plain_fwd, plain_bwd = plain_train(name, mod)
    with torch.no_grad():
        got = mod._train_cuda(*args)
        want = plain_fwd(*args)
        for i, (g, w) in enumerate(zip(got, want)):
            probs = name == "pallas_ca_block" and i == 1
            assert max_err(g, w) <= (PROBS_TOL if probs else bf16_tol(w)), \
                (name, i)
        saved = backward_args(args, got[1:], cot)
        r1, r2, ref = (flat_grads(name, f(*saved)) for f in
                       (mod._backward_cuda, mod._backward_cuda, plain_bwd))
        torch.cuda.synchronize()
    tols = grad_tols(ref)
    for k, w in ref.items():
        assert max_err(r1[k], w) <= tols[k], (name, k)
        assert torch.equal(r1[k], r2[k]), (name, k)


def test_fused_backbone_function_counts_launches(card):
    """One patch block through the autograd Function on the card: one
    training-forward and one backward launch, finite gradients."""
    from spe_tpu_torch.ops import fused_block
    from spe_tpu_torch.ops.kernel_checks import train_cases

    _, _, (x, p, H, drop), (dy,) = train_cases(B=1, N=64)[0]
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    fn = fused_block.fused_layer_scale_block
    before = (fn.train_launches, fn.bwd_launches)
    xt = x.clone().requires_grad_()
    fn(xt, leaves, H, drop).backward(dy)
    torch.cuda.synchronize()
    assert (fn.train_launches, fn.bwd_launches) == (before[0] + 1,
                                                    before[1] + 1)
    assert torch.isfinite(xt.grad.float()).all()
    assert all(torch.isfinite(v.grad).all() for v in leaves.values())


def test_transformer_functions_count_launches(card):
    """One encoder and one decoder layer through their autograd Functions
    on the card: one training-forward and one backward launch each, finite
    gradients on every input and parameter."""
    from spe_tpu_torch.ops import fused_decoder, fused_encoder
    from spe_tpu_torch.ops.kernel_checks import train_cases

    cases = train_cases(B=1, N=64, Q=16)
    _, _, (x, pos, mask, enc, H, drop), (dy,) = cases[2]
    _, _, (tgt, _, _, qpos, sine, _, dec, _, S, _), (dt,) = cases[3]
    fe, fd = fused_encoder.fused_encoder_layer, fused_decoder.fused_decoder_layer
    before = [(f.train_launches, f.bwd_launches) for f in (fe, fd)]
    le = {k: v.clone().requires_grad_() for k, v in enc.items()}
    ld = {k: v.clone().requires_grad_() for k, v in dec.items()}
    ins = [t.clone().requires_grad_() for t in (x, pos, tgt, qpos, sine)]
    mem = fe(ins[0], ins[1], mask, le, H, drop)
    out = fd(ins[2], mem, ins[1], ins[3], ins[4], mask, ld, H, S, drop)
    torch.autograd.backward([out, mem], [dt, dy])
    torch.cuda.synchronize()
    assert [(f.train_launches, f.bwd_launches) for f in (fe, fd)] == [
        (b[0] + 1, b[1] + 1) for b in before]
    for t in (*ins, *le.values(), *ld.values()):
        assert torch.isfinite(t.grad.float()).all()


@pytest.mark.parametrize("case", range(4))
def test_attention_kernels_match_plain(card, case):
    """fused_mha as the class attention (21 queries over 121 keys, the
    probabilities returned), the encoder self-attention and the decoder
    cross-attention (100 keys, a padded-key mask), and the talking-heads
    attention over 100 tokens, at rate 0: within 4 bf16 ulps of the plain
    version (the probabilities within PROBS_TOL); one eval launch."""
    from spe_tpu_torch.ops.kernel_checks import attention_cases, compare

    name, _, mod, args, _, label = attention_cases(B=2, N=100, Q=30)[case]
    fused = getattr(mod, "fused_mha" if name == "pallas_mha"
                    else "talking_heads_attention")
    plain = getattr(mod, "fused_mha_reference" if name == "pallas_mha"
                    else "talking_heads_reference")
    before = fused.launches
    errs, tols, finite = compare(fused, plain, args)
    torch.cuda.synchronize()
    assert finite, label
    assert all(e <= t for e, t in zip(errs, tols)), (label, errs, tols)
    assert fused.launches == before + 1


@pytest.mark.parametrize("case", range(4))
def test_attention_train_kernels_match_plain(card, case):
    """The same four at the recipe's attention dropout (none in the class
    attention): the training forward within 4 bf16 ulps (log-sum-exps too;
    the probabilities within PROBS_TOL), every gradient within
    kernel_checks.grad_tols of the hand-derived backward on the same saved
    log-sum-exps, and two backward runs bit-identical."""
    from spe_tpu_torch.ops.kernel_checks import (PROBS_TOL, attention_cases,
                                                 backward_args, bf16_tol,
                                                 flat_grads, grad_tols,
                                                 max_err, plain_train,
                                                 saved_outputs)

    name, _, mod, args, cot, label = attention_cases(B=2, N=100, Q=30,
                                                     train=True)[case]
    plain_fwd, plain_bwd = plain_train(name, mod)
    with torch.no_grad():
        got = mod._train_cuda(*args)
        want = plain_fwd(*args)
        for i, (g, w) in enumerate(zip(got, want)):
            probs = name == "pallas_mha" and args[6] and i == 1
            assert max_err(g, w) <= (PROBS_TOL if probs else bf16_tol(w)), \
                (label, i)
        saved = backward_args(args, saved_outputs(name, got), cot)
        r1, r2, ref = (flat_grads(name, f(*saved)) for f in
                       (mod._backward_cuda, mod._backward_cuda, plain_bwd))
        torch.cuda.synchronize()
    tols = grad_tols(ref)
    for k, w in ref.items():
        assert max_err(r1[k], w) <= tols[k], (label, k)
        assert torch.equal(r1[k], r2[k]), (label, k)


def test_attention_functions_count_launches(card):
    """MHAFn (the decoder cross-attention's shape, with dropout) and
    TalkingHeadsFn through autograd on the card: one training-forward and
    one backward launch each, finite gradients."""
    from spe_tpu_torch.ops import fused_mha, talking_heads
    from spe_tpu_torch.ops.kernel_checks import attention_cases

    cases = attention_cases(B=1, N=64, Q=16, train=True)
    _, _, _, (q, k, v, H, mask, drop, ret), (dy,), _ = cases[2]
    _, _, _, (tq, tk, tv, p, tH, tdrop), (tdy,), _ = cases[3]
    fm, ft = fused_mha.fused_mha, talking_heads.talking_heads_attention
    before = [(f.train_launches, f.bwd_launches) for f in (fm, ft)]
    ins = [t.clone().requires_grad_() for t in (q, k, v, tq, tk, tv)]
    lp = {n: t.clone().requires_grad_() for n, t in p.items()}
    out = fm(*ins[:3], H, mask, drop, ret)
    tout = ft(*ins[3:], lp, tH, tdrop)
    torch.autograd.backward([out, tout], [dy, tdy])
    torch.cuda.synchronize()
    assert [(f.train_launches, f.bwd_launches) for f in (fm, ft)] == [
        (b[0] + 1, b[1] + 1) for b in before]
    for t in (*ins, *lp.values()):
        assert torch.isfinite(t.grad.float()).all()


@pytest.mark.parametrize("case", range(len(GEMM_SHAPES)))
def test_gemm_kernel_matches_plain(card, case):
    """gemm_kernel against gemm_reference on ragged shapes (M, N and K no
    multiple of a tile), every layout, dtype, split, column group,
    accumulate mode and epilogue the port uses, misaligned operands, both
    tile shapes: the written elements within 1% of their largest
    magnitude, nothing else touched, two runs bit-identical."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import gemm_check, gemm_kernel_cases

    label, c = gemm_kernel_cases()[case]
    before = K.gemm.launches
    err, tol, same, rest, finite = gemm_check(K.gemm, K.gemm_reference, c)
    torch.cuda.synchronize()
    assert finite and same and rest, label
    assert err <= tol, (label, err, tol)
    assert K.gemm.launches == before + 2


@pytest.mark.parametrize("case", range(8))
def test_attention_kernel_matches_plain_ragged(card, case):
    """attn_kernel against attention_reference on ragged Nq and Nk (a
    one-key last tile), each head-width template, dropout, probabilities,
    log-sum-exps, shared heads and K/V views aligned for each copy width:
    outputs within 4 bf16 ulps at their largest magnitude (probabilities
    1e-4), two runs bit-identical, the copy width the alignment allows."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import (attention_check,
                                                 attention_kernel_cases)

    cases = attention_kernel_cases()
    assert len(cases) == 8
    label, c = cases[case]
    outs = {"out": torch.empty(c["out"][0], dtype=c["out"][1], device=card)}
    assert K.attention_copy_bytes(c["q"], c["k"], c["v"], outs["out"],
                                  **c["kw"]) == c["copy_bytes"], label
    before = K.attention.launches
    errs, same, finite = attention_check(K.attention, K.attention_reference, c)
    torch.cuda.synchronize()
    assert finite and same, label
    for name, (e, tol) in errs.items():
        assert e <= tol, (label, name, e, tol)
    assert K.attention.launches == before + 2


@pytest.mark.parametrize("case", range(len(LINEAR_SHAPES)))
def test_linear_kernel_matches_plain(card, case):
    """linear_kernel against ln_linear_reference on ragged M, N and K,
    misaligned f32 and bf16 A, both A paths and tiles and every epilogue
    (kernel_checks.LINEAR_SHAPES): out and aux within 4 bf16 ulps of their
    largest magnitude, two runs bit-identical."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import (linear_check,
                                                 linear_kernel_cases)

    label, c = linear_kernel_cases()[case]
    before = K.ln_linear.launches
    errs, same, finite = linear_check(K.ln_linear, K.ln_linear_reference, c)
    torch.cuda.synchronize()
    assert finite and same, label
    for name, (e, tol) in errs.items():
        assert e <= tol, (label, name, e, tol)
    assert K.ln_linear.launches == before + 2


@pytest.mark.parametrize("case", range(len(TH_BWD_SHAPES)))
def test_th_bwd_rows_kernel_matches_plain(card, case):
    """th_bwd_rows_kernel against th_bwd_rows_reference at H=4 and other
    H, N not a multiple of 4, dropout on and off, with and without wl:
    every output within 1% of its largest magnitude (dbl against the mix
    gradient's), two runs bit-identical."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import th_bwd_case, th_bwd_check

    label, B, H, N, rate, wl = TH_BWD_SHAPES[case]
    args, kw = th_bwd_case(B, H, N, rate, wl)
    before = K.th_bwd_rows.launches
    errs, same, finite = th_bwd_check(K.th_bwd_rows, K.th_bwd_rows_reference,
                                      args, kw)
    torch.cuda.synchronize()
    assert finite and same, label
    for name, (e, tol) in errs.items():
        assert e <= tol, (label, name, e, tol)
    assert K.th_bwd_rows.launches == before + 2


@pytest.mark.parametrize("case", range(len(TH_FWD_SHAPES)))
def test_th_fwd_rows_kernel_matches_plain(card, case):
    """th_fwd_rows_kernel against th_fwd_rows_reference at H=4 and other H,
    N not a multiple of 4, dropout on and off, with and without wl
    (kernel_checks.TH_FWD_SHAPES): zd within 4 bf16 ulps of its largest
    magnitude, lse within 1e-5 of its largest, two runs bit-identical."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import th_fwd_case, th_fwd_check

    label, B, H, N, rate, wl = TH_FWD_SHAPES[case]
    args, kw = th_fwd_case(B, H, N, rate, wl)
    before = K.th_fwd_rows.launches
    errs, same, finite = th_fwd_check(K.th_fwd_rows, K.th_fwd_rows_reference,
                                      args, kw)
    torch.cuda.synchronize()
    assert finite and same, label
    for name, (e, tol) in errs.items():
        assert e <= tol, (label, name, e, tol)
    assert K.th_fwd_rows.launches == before + 2


def test_th_fwd_rows_kernel_refuses_long_rows(card):
    """A row of more than 4 * TH_NT = 1024 keys is refused before a
    launch."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import th_fwd_case

    args, kw = th_fwd_case(1, 2, 1025, 0.0, False)
    before = K.th_fwd_rows.launches
    with pytest.raises(ValueError, match="at most 1024"):
        K.th_fwd_rows(*args, **kw)
    assert K.th_fwd_rows.launches == before


@pytest.mark.parametrize("case", range(len(ATTN_ROWS_SHAPES)))
def test_attention_bwd_rows_kernel_matches_plain(card, case):
    """attn_bwd_rows_kernel against attention_bwd_rows_reference at the
    encoder's, the decoder's (mask_heads), the cross-attention's and the
    class attention's (Nk = 1045: scalar rows) row lengths and a ragged
    one (kernel_checks.ATTN_ROWS_SHAPES): zd and dl within 1% of their
    largest magnitude, two runs bit-identical."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import attn_rows_case, attn_rows_check

    label, *shape = ATTN_ROWS_SHAPES[case]
    args, kw = attn_rows_case(*shape)
    before = K.attention_bwd_rows.launches
    errs, same, finite = attn_rows_check(
        K.attention_bwd_rows, K.attention_bwd_rows_reference, args, kw)
    torch.cuda.synchronize()
    assert finite and same, label
    for name, (e, tol) in errs.items():
        assert e <= tol, (label, name, e, tol)
    assert K.attention_bwd_rows.launches == before + 2
