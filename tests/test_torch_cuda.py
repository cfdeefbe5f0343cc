"""The hand-written CUDA kernels on the card (marker `cuda`): each fused
layer against its plain PyTorch version at the recipe widths with cut
sequence lengths, every fused layer's training forward and backward
kernels and their dropout masks likewise, a small full-width detector
through the kernels against the same weights through the plain versions,
the two supervision kernels (connected components, auction) against
their plain versions at the recipe's training shapes (CC also at every
mask size it takes, 1 to 300 masks, labels and sweep counts; the
wrapper's refusals; the auction through each of its paths, iteration and
bid counts too, and back to back), and the standalone
attention kernels (fused_mha in its three flavours, the talking-heads
attention) forward and backward against their plain versions with cut
sequence lengths, and the two tensor-core product kernels (gemm_kernel,
attn_kernel) against kernels.gemm_reference / attention_reference on
ragged shapes, every layout and option, misaligned operands, likewise
linear_kernel against ln_linear_reference, th_bwd_rows_kernel against
th_bwd_rows_reference (one launch a call, no reduce_* kernel, the ticket
back at 0 between shapes called back to back), th_fwd_rows_kernel against
th_fwd_rows_reference,
attn_bwd_rows_kernel against attention_bwd_rows_reference,
colsum_kernel and th_fold_kernel against colsum_reference and
th_fold_reference (th_fold bit for bit) on ragged and misaligned views,
and the one-launch colsum_f32_kernel, ln_bwd_kernel, branch_bwd_kernel
and th_dq_kernel against colsum_f32_reference, ln_backward_reference,
branch_backward_reference and th_dq_reference at every class the main
path gives them, at the other backbones' widths and on ragged and
misaligned ones (one launch a call, no reduce_* kernel, the tickets back
at 0); layernorm_kernel and th_mix_kernel against layernorm_reference and
th_mix_reference likewise (every class of the three recorded runs, the
other widths, ragged and misaligned views), layernorm's bf16 output
against ln_linear's LayerNorm panel bit for bit; the pre-norm encoder
layer's attention through fused_mha (B4), and the mask branch's matching
through the auction kernel.
The
kernels have no CPU mode, so without a card these tests skip.

Run on a machine with the card:  python -m pytest tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

from spe_tpu_torch.ops.kernel_checks import (ATTENTION_KERNEL_CASES,
                                             ATTN_ROWS_SHAPES,
                                             AUCTION_CASES, BRANCH_BWD_SHAPES,
                                             COLSUM_F32_SHAPES, COLSUM_SHAPES,
                                             GEMM_SHAPES, LAYERNORM_SHAPES,
                                             LINEAR_SHAPES, LN_BWD_SHAPES,
                                             TH_BWD_SHAPES, TH_DQ_SHAPES,
                                             TH_FOLD_SHAPES, TH_FWD_SHAPES,
                                             TH_MIX_SHAPES)

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
    mazes that bind the 96-sweep cap): labels and sweep counts exactly
    equal, one launch."""
    from spe_tpu_torch.ops import connected_components as cc
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import cc_masks

    masks = cc_masks().to(card)
    before = cc.connected_components.launches
    got = cc.connected_components(masks)
    want, sweeps = cc.connected_components_reference(masks, with_sweeps=True)
    torch.cuda.synchronize()
    assert cc.connected_components.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(K.connected_components(masks, cc.MAX_SWEEPS)[1], sweeps)


CC_SIZES = [(S, N) for S in (16, 32, 64, 128) for N in (1, 300)] + \
    [(1, 3), (50, 40), (100, 20)]


@pytest.mark.parametrize("S,N", CC_SIZES)
def test_connected_components_kernel_every_size(card, S, N):
    """cc_kernel at S = 16, 32, 64 (compiled in), 128 and the odd sizes 1,
    50, 100 (S read at run time), 1 mask and 300 (past one wave of
    blocks): blobs, all foreground, all background, a checkerboard, a snake
    and both diagonal mazes (past the 96-sweep cap from S = 32 on), at the
    cap and at a cap of 3 sweeps: labels and sweep counts exactly equal to
    connected_components_reference."""
    from spe_tpu_torch.ops import connected_components as cc
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import cc_patterns

    masks = cc_patterns(S, N, seed=S).to(card)
    for cap in (cc.MAX_SWEEPS, 3):
        labels, sweeps = K.connected_components(masks, cap)
        want, want_sweeps = cc.connected_components_reference(
            masks, cap, with_sweeps=True)
        torch.cuda.synchronize()
        assert torch.equal(labels, want), (S, N, cap)
        assert torch.equal(sweeps, want_sweeps), (S, N, cap)
    if N == 300 and S >= 32:
        assert int(want_sweeps.max()) == 3
        assert int(cc.connected_components_reference(
            masks, with_sweeps=True)[1].max()) == cc.MAX_SWEEPS


def test_connected_components_refuses_shapes(card):
    """The wrapper's checks: S > 128, a non-square batch and a
    non-contiguous one are refused by name."""
    from spe_tpu_torch.ops import kernels as K

    bad = [torch.zeros((2, 129, 129), dtype=torch.bool, device=card),
           torch.zeros((2, 16, 32), dtype=torch.bool, device=card),
           torch.zeros((2, 32, 64), dtype=torch.bool, device=card)[:, :, :32]]
    for masks in bad:
        with pytest.raises(ValueError):
            K.connected_components(masks, 96)


@pytest.mark.parametrize("case", [*AUCTION_CASES, "unaligned"])
def test_auction_kernel_equals_plain(card, case):
    """Kernel 6 against auction_phase_reference, assignments, iteration
    counts and bid counts exactly equal, on kernel_checks.auction_case:
    the recipe's 96 DETR-like problems of 120 x 300, an overfull shape
    (more targets than queries), Q = 301 and 7 (rows copied by plain loads),
    Q = 1 (top2 at its -1e30 floor), T = 1100 and 1030 (past one thread a
    person; the second from device memory), (T, Q) past 227 KB of shared
    memory (rows from device memory; Q even and odd), masks that are not a prefix with one problem all padded, exact
    ties (duplicate rows and columns, zeros of both signs) and a cap of 3
    iterations; and the recipe's rows at a 4-byte offset (unaligned: plain
    loads)."""
    from spe_tpu_torch.ops import auction
    from spe_tpu_torch.ops.kernel_checks import auction_case

    benefit, mask, max_iters = auction_case("recipe" if case == "unaligned"
                                            else case)
    benefit, mask = benefit.to(card), mask.to(card)
    if case == "unaligned":
        buf = torch.empty(benefit.numel() + 1, device=card)
        buf[1:] = benefit.flatten()
        benefit = buf[1:].view(benefit.shape)
        assert benefit.data_ptr() % 16 != 0
    before = auction.auction_phase.launches
    got = auction.auction_phase(benefit, mask, max_iters=max_iters)
    want = auction.auction_phase_reference(benefit, mask,
                                           max_iters=max_iters)
    torch.cuda.synchronize()
    assert auction.auction_phase.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w), case
    if case == "cap3":
        assert int(want[1].max()) == 3


def test_auction_kernel_back_to_back(card):
    """Two launches on different problems with nothing between them, then
    the first again: each equal to the plain version, no state carried."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.auction import EPS, MAX_ITERS, \
        auction_phase_reference
    from spe_tpu_torch.ops.kernel_checks import auction_problems

    first = [t.to(card) for t in auction_problems(16, 120, 300, seed=11)]
    second = [t.to(card) for t in auction_problems(16, 60, 300, seed=12)]
    outs = [K.auction(*p, EPS, MAX_ITERS) for p in (first, second, first)]
    wants = [auction_phase_reference(*first), auction_phase_reference(*second)]
    torch.cuda.synchronize()
    for got, want in zip(outs, wants + wants[:1]):
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


def _train_kernels_match_plain(card, case, D=192, H=4):
    """train_cases' fused layer `case` at widths D and heads H: its kernels'
    training forward against the plain one (the class-attention
    probabilities within PROBS_TOL, at the wider widths _probs_tol), its
    backward kernels twice against the plain backward on the same saved
    tensors."""
    from spe_tpu_torch.ops.kernel_checks import (PROBS_TOL, backward_args,
                                                 bf16_tol, flat_grads,
                                                 grad_tols, max_err,
                                                 plain_train, train_cases)

    name, mod, args, cot = train_cases(B=2, N=100, Q=30, D=D, H=H)[case]
    plain_fwd, plain_bwd = plain_train(name, mod)
    with torch.no_grad():
        got = mod._train_cuda(*args)
        want = plain_fwd(*args)
        for i, (g, w) in enumerate(zip(got, want)):
            probs = name == "pallas_ca_block" and i == 1
            tol = bf16_tol(w) if not probs else PROBS_TOL if D == 192 else \
                _probs_tol(plain_fwd, args, w)
            assert max_err(g, w) <= tol, (name, i)
        saved = backward_args(args, got[1:], cot)
        r1, r2, ref = (flat_grads(name, f(*saved)) for f in
                       (mod._backward_cuda, mod._backward_cuda, plain_bwd))
        torch.cuda.synchronize()
    tols = grad_tols(ref)
    for k, w in ref.items():
        assert max_err(r1[k], w) <= tols[k], (name, k)
        assert torch.equal(r1[k], r2[k]), (name, k)


@pytest.mark.parametrize("case", range(5))
def test_train_kernels_match_plain(card, case):
    """The patch block (recipe dropout), the class-attention block (with a
    CAM cotangent), the encoder layer and the decoder layer (layer 0 and a
    later layer; the recipe's dropout 0.1) at N=100 keys, t=21, Q=30
    queries per set: the training forward within 4 bf16 ulps (the CAM
    probabilities within PROBS_TOL), every gradient of the backward within
    kernel_checks.grad_tols of the plain backward on the same saved
    tensors, and two backward runs bit-identical."""
    _train_kernels_match_plain(card, case)


# the wider backbones' widths and heads: XS24 (D 288, 6 heads; dt 36), S
# (384, 8; dt 48), M (768, 16; dt 96)
WIDE = [(288, 6), (384, 8), (768, 16)]
# at those widths the class attention's probabilities, kernel against
# plain, are held to this share of the plain version's own distance from
# an f32 run of it (at D = 768 on the H100: 1.6e-4 apart, each 3.2e-3 from
# f32; at D = 192 2.7e-6 apart, which PROBS_TOL's 1e-4 was set for)
WIDE_PROBS_SHARE = 0.1


def _probs_tol(plain, args, want):
    """PROBS_TOL, or WIDE_PROBS_SHARE of the plain class attention's
    distance from its f32 run on the same inputs (cls and x in f32)."""
    from spe_tpu_torch.ops.kernel_checks import PROBS_TOL, max_err

    with torch.no_grad():
        f32 = plain(args[0].float(), args[1].float(), *args[2:])[1]
    return max(PROBS_TOL, WIDE_PROBS_SHARE * max_err(want, f32))


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("D,H", WIDE, ids=["XS24", "S", "M"])
def test_wide_kernels_match_plain(card, D, H, case):
    """test_kernel_matches_plain at the wider backbones' widths: the patch
    block (no D x D form: its training kernels at rate 0), the class
    attention at dh = 48 (its probabilities within _probs_tol), the
    encoder and the decoder at dt = D / 8."""
    from spe_tpu_torch.ops.kernel_checks import compare, kernel_cases

    name, _, fused, plain, args = kernel_cases(B=2, N=100, Q=30, D=D,
                                               H=H)[case]
    before = fused.launches
    errs, tols, finite = compare(fused, plain, args)
    if name == "pallas_ca_block":
        with torch.no_grad():
            tols[1] = _probs_tol(plain, args, plain(*args)[1])
    torch.cuda.synchronize()
    assert finite, name
    assert all(e <= t for e, t in zip(errs, tols)), (name, errs, tols)
    assert fused.launches == before + 1


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("D,H", WIDE, ids=["XS24", "S", "M"])
def test_wide_train_kernels_match_plain(card, D, H, case):
    """test_train_kernels_match_plain at the wider backbones' widths and
    heads."""
    _train_kernels_match_plain(card, case, D=D, H=H)


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


def test_prenorm_encoder_layer_through_b4(card):
    """The pre-norm encoder layer with use_pallas_attention (the stock
    preset with --pre_norm) at the recipe's width, 8 heads of 24, bf16,
    in training at the recipe's dropout: its self-attention is one MHAFn
    training-forward and one backward launch, the fused encoder layer
    none; gradients finite; at rate 0 its output within 5% of the same
    layer's with the plain attention."""
    from spe_tpu_torch.models.transformer import TransformerEncoderLayer
    from spe_tpu_torch.ops import fused_encoder, fused_mha
    from spe_tpu_torch.ops.kernel_checks import MODEL_REL_TOL, max_err

    torch.manual_seed(0)
    B, N, D = 2, 256, 192
    layers = [TransformerEncoderLayer(D, 8, 512, use_fused=True,
                                      dropout=rate, use_pallas=pallas,
                                      normalize_before=True).to(card)
              for rate, pallas in ((0.1, True), (0.0, True), (0.0, False))]
    torch.nn.init.normal_(layers[0].self_attn.in_proj_weight, std=D ** -0.5)
    for layer in layers[1:]:
        layer.load_state_dict(layers[0].state_dict())
    x = torch.randn(B, N, D, device=card).to(torch.bfloat16)
    pos = torch.randn(B, N, D, device=card).to(torch.bfloat16)
    mask = torch.zeros(B, N, dtype=torch.bool, device=card)
    mask[1, -40:] = True
    fm, fe = fused_mha.fused_mha, fused_encoder.fused_encoder_layer
    before = (fm.train_launches, fm.bwd_launches, fe.train_launches,
              fe.launches)
    xt = x.clone().requires_grad_()
    out = layers[0].train()(xt, pos, mask,
                            torch.Generator(card).manual_seed(1))
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (fm.train_launches, fm.bwd_launches, fe.train_launches,
            fe.launches) == (before[0] + 1, before[1] + 1, *before[2:])
    assert torch.isfinite(xt.grad.float()).all()
    for p in layers[0].parameters():
        assert torch.isfinite(p.grad).all()
    with torch.no_grad():
        got = layers[1].eval()(x, pos, mask)
        want = layers[2].eval()(x, pos, mask)
    assert fm.launches >= 1
    assert max_err(got, want) <= MODEL_REL_TOL * float(
        want.float().abs().max())


def test_mask_matching_auction_equals_plain(card):
    """The mask branch's matching (stage 0 against the raw GT set, one
    more auction launch a step) at the recipe's shapes: 8 problems of at
    most 24 GT x 300 queries; assignments and iteration counts equal to
    the plain auction's on the same costs; one launch."""
    from spe_tpu_torch.ops import auction
    from spe_tpu_torch.train.criterion import match

    g = torch.Generator().manual_seed(0)
    B, Q, T, K = 8, 300, 24, 21
    logits = torch.randn(B, Q, K, generator=g).to(card)
    boxes = (0.2 + 0.6 * torch.rand(B, Q, 4, generator=g)).to(card)
    gt = {"boxes": (0.2 + 0.6 * torch.rand(B, T, 4, generator=g)).to(card),
          "labels": torch.randint(1, 21, (B, T), generator=g).to(card),
          "mask": (torch.arange(T)[None] < torch.randint(
              1, T + 1, (B, 1), generator=g)).to(card)}
    before = auction.auction_phase.launches
    rows, stats = match(logits, boxes, gt)
    torch.cuda.synchronize()
    assert auction.auction_phase.launches == before + 1
    kernel = auction.auction_phase
    auction.auction_phase = auction.auction_phase_reference
    try:
        want_rows, want_stats = match(logits, boxes, gt)
    finally:
        auction.auction_phase = kernel
    assert torch.equal(rows, want_rows)
    assert torch.equal(stats["iters"], want_stats["iters"])
    assert int(stats["cleanup"].sum()) == 0


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


@pytest.mark.parametrize("case", range(ATTENTION_KERNEL_CASES))
def test_attention_kernel_matches_plain_ragged(card, case):
    """attn_kernel against attention_reference on ragged Nq and Nk (a
    one-key last tile), each head-width template (the wider backbones'
    36 x 36, 72 x 36, 96 x 48, 96 x 96 and 192 x 96 too: V padded in
    shared memory at dv = 36), dropout, probabilities, log-sum-exps,
    shared heads and K/V views aligned for each copy width: outputs within
    4 bf16 ulps at their largest magnitude (probabilities 1e-4), two runs
    bit-identical, the copy width the alignment and the form allow."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import (attention_check,
                                                 attention_kernel_cases)

    cases = attention_kernel_cases()
    assert len(cases) == ATTENTION_KERNEL_CASES
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
    """th_bwd_rows_kernel against th_bwd_rows_reference at H = 1, 2, 3, 4,
    6, 8 and 16 (th16_bwd_rows_kernel), N up to 2048 (two units of 4
    columns a thread past 1024: the multi-scale buckets' 1280 and 1600),
    N not a multiple of 4, dropout on and off, with and without wl,
    the two main-path classes, B*N not a multiple of 1024 and B*N under
    TH_NT (the finish's two orders): every output within 1% of its largest
    magnitude (dbl against the mix gradient's), two runs bit-identical, one
    launch a call and no reduce_sum, the ticket back at 0."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import th_bwd_case, th_bwd_check

    label, B, H, N, rate, wl = TH_BWD_SHAPES[case]
    args, kw = th_bwd_case(B, H, N, rate, wl)
    before, reduces = K.th_bwd_rows.launches, K.reduce_sum.launches
    errs, same, finite = th_bwd_check(K.th_bwd_rows, K.th_bwd_rows_reference,
                                      args, kw)
    torch.cuda.synchronize()
    assert finite and same, label
    for name, (e, tol) in errs.items():
        assert e <= tol, (label, name, e, tol)
    assert K.th_bwd_rows.launches == before + 2
    assert K.reduce_sum.launches == reduces
    assert int(K.th_bwd_scratch(card)[0].item()) == 0


def test_th16_rows_one_launch_back_to_back(card):
    """At 16 heads th_bwd_rows launches th16_bwd_rows_kernel alone and
    th_fwd_rows th16_fwd_rows_kernel alone (torch.profiler's names): M48's
    class, the 1600-key bucket with wl and a ragged row back to back and
    the first again, each call equal to its shape's first call bit for bit
    (each backward starts from a ticket at 0), the ticket at 0 after
    them."""
    from torch.profiler import ProfilerActivity, profile

    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import th_bwd_case, th_fwd_case

    shapes = [(8, 1024, 0.05, False), (2, 1600, 0.05, True),
              (1, 1281, 0.1, False)]
    for kind, make, fn in (("bwd", th_bwd_case, K.th_bwd_rows),
                           ("fwd", th_fwd_case, K.th_fwd_rows)):
        cases = [make(B, 16, N, rate, wl) for B, N, rate, wl in shapes]
        cases.append(cases[0])
        first = [fn(*a, **k) for a, k in cases[:3]]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            again = [fn(*a, **k) for a, k in cases]
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == 4 and all(f"th16_{kind}_rows_kernel" in n
                                       for n in names), names
        for got, want in zip(again, first + first[:1]):
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        del cases, first, again
    assert int(K.th_bwd_scratch(card)[0].item()) == 0


def test_th_bwd_rows_one_launch_back_to_back(card):
    """th_bwd_rows launches th_bwd_rows_kernel and nothing else (no reduce_*
    kernel: torch.profiler's names), three shapes back to back on one
    stream and the first again: each call equal to its shape's first call
    bit for bit (each launch starts from a ticket at 0), the ticket at 0
    after them."""
    from torch.profiler import ProfilerActivity, profile

    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import th_bwd_case

    cases = [th_bwd_case(8, 4, 1024, 0.1, False),
             th_bwd_case(2, 8, 577, 0.1, True), th_bwd_case(3, 1, 40, 0.0, False)]
    cases.append(cases[0])
    first = [K.th_bwd_rows(*a, **k) for a, k in cases[:3]]
    torch.cuda.synchronize()
    before, reduces = K.th_bwd_rows.launches, K.reduce_sum.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = [K.th_bwd_rows(*a, **k) for a, k in cases]
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 4 and all("th_bwd_rows_kernel" in n
                                     for n in kernels), kernels
    assert K.th_bwd_rows.launches == before + 4
    assert K.reduce_sum.launches == reduces
    assert int(K.th_bwd_scratch(card)[0].item()) == 0
    for got, want in zip(again, first + first[:1]):
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("case", range(len(TH_FWD_SHAPES)))
def test_th_fwd_rows_kernel_matches_plain(card, case):
    """th_fwd_rows_kernel against th_fwd_rows_reference at H=4 and other H
    (6 and 16 too), N up to 2048,
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
    """A row of more than 4 * TH_NT * 2 = 2048 keys, or a head count
    outside TH_ROWS_HEADS (9), is refused before a launch."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import th_fwd_case

    before = K.th_fwd_rows.launches
    for H, N in ((2, 2049), (9, 64)):
        args, kw = th_fwd_case(1, H, N, 0.0, False)
        with pytest.raises(ValueError, match="at most 2048"):
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


@pytest.mark.parametrize("case", range(len(COLSUM_SHAPES)))
def test_colsum_kernel_matches_plain(card, case):
    """colsum_kernel against colsum_reference at the eval recipe's view of
    qkv and at ragged and misaligned ones (kernel_checks.COLSUM_SHAPES):
    each column within COLSUM_REL_TOL of its sum |v|, two runs
    bit-identical."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import (COLSUM_REL_TOL, colsum_case,
                                                 colsum_err)

    label, *shape = COLSUM_SHAPES[case]
    v = colsum_case(*shape)
    got, again = K.colsum(v), K.colsum(v)
    want = K.colsum_reference(v)
    torch.cuda.synchronize()
    assert torch.equal(got, again), label
    assert colsum_err(got, want, v) <= COLSUM_REL_TOL, label


@pytest.mark.parametrize("case", range(len(TH_FOLD_SHAPES)))
def test_th_fold_kernel_equals_plain(card, case):
    """th_fold_kernel equals th_fold_reference bit for bit at the stock
    step's view of qkv and at ragged and misaligned ones
    (kernel_checks.TH_FOLD_SHAPES)."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import th_fold_case

    label, *shape = TH_FOLD_SHAPES[case]
    q, rows = th_fold_case(*shape)
    got = K.th_fold(q, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, K.th_fold_reference(q, rows)), label


@pytest.mark.parametrize("kernel", ["colsum", "th_fold"])
def test_row_kernels_refuse_shapes(card, kernel):
    """A shape past a kernel's grid or shared memory raises before a
    launch: colsum wider than COLSUM_MAX_C columns, th_fold with more than
    16 heads."""
    from spe_tpu_torch.ops import kernels as K

    if kernel == "colsum":
        v = torch.zeros((1, 1, K.COLSUM_MAX_C + 1), dtype=torch.bfloat16,
                        device=card)
        with pytest.raises(ValueError, match="at most"):
            K.colsum(v)
    else:
        q = torch.zeros((1, 4, 192), dtype=torch.bfloat16, device=card)
        rows = torch.ones((17, 192), device=card)
        with pytest.raises(ValueError, match="at most 16 heads"):
            K.th_fold(q, rows)


@pytest.mark.parametrize("case", range(len(COLSUM_F32_SHAPES)))
def test_colsum_f32_kernel_matches_plain(card, case):
    """colsum_f32_kernel against colsum_f32_reference at every class the
    main path gives it and at ragged and misaligned views
    (kernel_checks.COLSUM_F32_SHAPES): within grad_tol (1% of the largest
    plain magnitude), two runs bit-identical."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import (colsum_f32_case, grad_tol,
                                                 max_err)

    label, *shape = COLSUM_F32_SHAPES[case]
    x = colsum_f32_case(*shape)
    got, again = K.colsum_f32(x), K.colsum_f32(x)
    want = K.colsum_f32_reference(x)
    torch.cuda.synchronize()
    assert torch.equal(got, again), label
    assert max_err(got, want) <= grad_tol(want), label


@pytest.mark.parametrize("case", range(len(LN_BWD_SHAPES)))
def test_ln_backward_kernel_matches_plain(card, case):
    """ln_bwd_kernel against ln_backward_reference at every class the main
    path gives it and at ragged ones, with and without a residual, x bf16
    and f32, dx f32 and bf16 (kernel_checks.LN_BWD_SHAPES): dx, dweight
    and dbias within grad_tol, two runs bit-identical, the tickets back at
    0 after each."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import (grad_tol, ln_backward_case,
                                                 max_err)

    label, *shape = LN_BWD_SHAPES[case]
    args, kw = ln_backward_case(*shape)
    got = K.ln_backward(*args, **kw)
    again = K.ln_backward(*args, **kw)
    want = K.ln_backward_reference(*args, **kw)
    torch.cuda.synchronize()
    assert got[0].dtype == kw["out_dtype"], label
    for name, g, a, w in zip(("dx", "dweight", "dbias"), got, again, want):
        assert torch.equal(g, a), (label, name)
        assert max_err(g, w) <= grad_tol(w), (label, name)
    assert not bool(K.ln_backward_scratch(card)[0].any()), label


def test_ln_backward_refuses_widths(card):
    """ln_backward takes D = 192, 256, 288, 384 or 768 (its template
    instantiations) and
    rows its vector loads can read, and raises on any other before a
    launch."""
    from spe_tpu_torch.ops import kernels as K

    for D in (128, 255, 320):
        dy = torch.zeros((4, D), device=card)
        x = torch.zeros((4, D), device=card, dtype=torch.bfloat16)
        w = torch.ones(D, device=card)
        with pytest.raises(ValueError, match="takes D in"):
            K.ln_backward(dy, x, w, 1e-6)
    w = torch.ones(192, device=card)
    base = torch.zeros(4 * 193 + 1, device=card)
    for dy, x in ((base[1:1 + 4 * 192].view(4, 192), base[:4 * 192].view(4, 192)),
                  (base[:4 * 192].view(4, 192),
                   base.as_strided((4, 192), (193, 1)))):
        with pytest.raises(ValueError, match="aligned rows"):
            K.ln_backward(dy, x, w, 1e-6)


def test_bias_and_ln_grads_one_launch(card):
    """colsum_f32 and ln_backward each launch their one kernel a call and
    nothing else: no reduce_* kernel, no partials (torch.profiler's kernel
    names over one call each, after a first call that allocates the
    ticket)."""
    from torch.profiler import ProfilerActivity, profile

    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import (colsum_f32_case,
                                                 ln_backward_case)

    x = colsum_f32_case(8192, 192, 192)
    args, kw = ln_backward_case(8192, 192, True, True, True)
    for fn, a, k, name in ((K.colsum_f32, (x,), {}, "colsum_f32_kernel"),
                           (K.ln_backward, args, kw, "ln_bwd_kernel")):
        fn(*a, **k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(*a, **k)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1 and name in kernels[0], kernels


@pytest.mark.parametrize("case", range(len(BRANCH_BWD_SHAPES)))
def test_branch_backward_kernel_matches_plain(card, case):
    """branch_bwd_kernel against branch_backward_reference at every class
    the main path gives it, at the other backbones' widths (D = 256, 288,
    384, 768) and on ragged and misaligned ones
    (kernel_checks.BRANCH_BWD_SHAPES): d and dgamma within grad_tol (1% of
    the largest plain magnitude), two runs bit-identical."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import (branch_backward_case,
                                                 grad_tol, max_err)

    label, *shape = BRANCH_BWD_SHAPES[case]
    args, kw = branch_backward_case(*shape)
    got = K.branch_backward(*args, **kw)
    again = K.branch_backward(*args, **kw)
    want = K.branch_backward_reference(*args, **kw)
    torch.cuda.synchronize()
    for name, g, a, w in zip(("d", "dgamma"), got, again, want):
        if w is None:
            assert g is None and a is None, (label, name)
            continue
        assert torch.equal(g, a), (label, name)
        assert max_err(g, w) <= grad_tol(w), (label, name)


@pytest.mark.parametrize("case", range(len(TH_DQ_SHAPES)))
def test_th_dq_kernel_matches_plain(card, case):
    """th_dq_kernel against th_dq_reference at the stock step's class, at
    H = 16, D = 768 with the strided qkv/dqkv views, the other backbones'
    widths, a few rows, a misaligned view (the scalar path), dh = 10 and a
    row of two passes (kernel_checks.TH_DQ_SHAPES): dQ and dwl within
    grad_tol, dQ written into the out view only, two runs bit-identical,
    the ticket back at 0."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import (grad_tol, max_err,
                                                 storage_of, th_dq_case)

    label, *shape = TH_DQ_SHAPES[case]
    dqt, q, rows, scale, out = th_dq_case(*shape)
    # three copies of out's whole storage, viewed as out
    outs = [storage_of(out).clone().as_strided(out.shape, out.stride(),
                                               out.storage_offset())
            for _ in range(3)]
    got = K.th_dq(dqt, q, rows, scale, outs[0])
    again = K.th_dq(dqt, q, rows, scale, outs[1])
    want = K.th_dq_reference(dqt, q, rows, scale, outs[2])
    torch.cuda.synchronize()
    assert torch.equal(got, again), label
    assert max_err(got, want) <= grad_tol(want), label
    assert torch.equal(outs[0], outs[1]), label
    assert max_err(outs[0], outs[2]) <= grad_tol(outs[2]), label
    assert torch.equal(storage_of(outs[0]).isnan(),
                       storage_of(outs[2]).isnan()), label
    assert not bool(K.th_dq_scratch(card)[0].any()), label


def test_branch_and_dq_refuse_shapes(card):
    """branch_backward refuses a val that is not contiguous (M, D) and a
    gamma of the wrong length; th_dq refuses more than 16 heads, D not a
    multiple of H and a dqt that is not contiguous, before a launch."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import th_dq_case

    dres = torch.zeros((8, 192), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        K.branch_backward(dres, torch.zeros((192, 8), device=card).t(), None)
    with pytest.raises(ValueError, match="gamma"):
        K.branch_backward(dres, dres, torch.ones(191, device=card))
    for H, D in ((17, 17 * 4), (4, 190)):
        dqt = torch.zeros((1, H, 3, D), device=card)
        q = torch.zeros((1, 3, D), device=card, dtype=torch.bfloat16)
        rows = torch.ones((H, D), device=card)
        with pytest.raises(ValueError, match="at most 16 heads"):
            K.th_dq(dqt, q, rows, 1.0, torch.zeros((1, 3, D), device=card))
    dqt, q, rows, scale, out = th_dq_case(1, 4, 3, 192, 192, 192)
    wide = torch.zeros((1, 4, 3, 2 * 192), device=card)
    wide[..., :192] = dqt
    with pytest.raises(ValueError, match="disagree"):
        K.th_dq(wide[..., :192], q, rows, scale, out)


def test_branch_and_dq_one_launch(card):
    """branch_backward (with and without val) and th_dq each launch their
    one kernel a call and nothing else: no reduce_* kernel, no partials
    (torch.profiler's kernel names over one call each, after a first call
    that allocates the scratch)."""
    from torch.profiler import ProfilerActivity, profile

    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import (BRANCH_BWD_MAIN,
                                                 branch_backward_case,
                                                 th_dq_case)

    calls = [(K.branch_backward, *branch_backward_case(*shape),
              "branch_bwd_kernel") for shape in BRANCH_BWD_MAIN[::2]]
    calls.append((K.th_dq, th_dq_case(8, 4, 1024, 192, 576, 576), {},
                  "th_dq_kernel"))
    for fn, a, k, name in calls:
        fn(*a, **k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(*a, **k)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1 and name in kernels[0], kernels


@pytest.mark.parametrize("case", range(len(LAYERNORM_SHAPES)))
def test_layernorm_kernel_matches_plain(card, case):
    """layernorm_kernel against layernorm_reference at every class the
    three recorded runs give it, the other backbones' widths, ragged rows
    and widths, strided and misaligned views, bf16 and f32 x and each
    output combination (kernel_checks.LAYERNORM_SHAPES): every output
    within grad_tol (1% of the largest plain magnitude), two runs
    bit-identical, one launch counted a call."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import (grad_tol, layernorm_case,
                                                 max_err)

    label, *shape = LAYERNORM_SHAPES[case]
    args, kw = layernorm_case(*shape)
    before = K.layernorm.launches
    got = K.layernorm(*args, **kw)
    again = K.layernorm(*args, **kw)
    want = K.layernorm_reference(*args, **kw)
    torch.cuda.synchronize()
    assert K.layernorm.launches == before + 2, label
    for name, g, a, w in zip(("f32", "bf16"), got, again, want):
        if w is None:
            assert g is None and a is None, (label, name)
            continue
        assert torch.equal(g, a), (label, name)
        assert max_err(g, w) <= grad_tol(w), (label, name)


@pytest.mark.parametrize("case", range(len(TH_MIX_SHAPES)))
def test_th_mix_kernel_matches_plain(card, case):
    """th_mix_kernel against th_mix_reference at eval's class, the other
    backbones' widths, up to 16 heads and samples that end inside a
    thread's run (kernel_checks.TH_MIX_SHAPES): within grad_tol, two runs
    bit-identical, one launch counted a call."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import grad_tol, max_err, th_mix_case

    label, *shape = TH_MIX_SHAPES[case]
    args = th_mix_case(*shape)
    before = K.th_mix.launches
    got, again = K.th_mix(*args), K.th_mix(*args)
    want = K.th_mix_reference(*args)
    torch.cuda.synchronize()
    assert K.th_mix.launches == before + 2, label
    assert torch.equal(got, again), label
    assert max_err(got, want) <= grad_tol(want), label


@pytest.mark.parametrize("D", [192, 256])
@pytest.mark.parametrize("x_bf16", [True, False])
def test_layernorm_equals_ln_linear_panel(card, D, x_bf16):
    """layernorm's bf16 output equals ln_linear's LayerNorm panel bit for
    bit (an identity weight and a zero bias: the products are exact): both
    take common.cuh's statistics and normalisation."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import layernorm_case

    (x, w, b, eps), _ = layernorm_case(1001, D, x_bf16, False, True, 1e-6, D)
    got = K.layernorm(x, w, b, eps, want_f32=False, want_bf16=True)[1]
    eye = torch.eye(D, device=card, dtype=torch.bfloat16)
    want = K.ln_linear(x, eye, torch.zeros(D, device=card), ln=(w, b, eps))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_layernorm_and_th_mix_refuse_shapes(card):
    """layernorm refuses rows wider than LAYERNORM_MAX_D and a weight of
    the wrong width; th_mix refuses more than 16 heads, D not a multiple
    of H, heads of a width not a multiple of 8, a misaligned pv and column
    sums that are not contiguous, before a launch."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import th_mix_case

    D = K.LAYERNORM_MAX_D + 1
    x = torch.zeros((4, D), device=card)
    with pytest.raises(ValueError, match="takes D <="):
        K.layernorm(x, torch.ones(D, device=card), torch.zeros(D, device=card),
                    1e-5)
    with pytest.raises(ValueError, match="weight and bias"):
        K.layernorm(x[:, :192], torch.ones(191, device=card),
                    torch.zeros(192, device=card), 1e-5)
    before = K.th_mix.launches
    for H, D in ((17, 17 * 8), (4, 190), (3, 30)):
        pv = torch.zeros((1, 3, H, D), device=card)
        with pytest.raises(ValueError, match="at most 16 heads"):
            K.th_mix(pv, torch.zeros((1, D), device=card),
                     torch.zeros((H, H), device=card),
                     torch.zeros(H, device=card))
    pv, csum, ww, bw = th_mix_case(2, 5, 4, 192)
    with pytest.raises(ValueError, match="disagree"):
        K.th_mix(pv, torch.zeros((2, 400), device=card)[:, :192], ww, bw)
    odd = torch.zeros(pv.numel() + 1, device=card)[1:].view(pv.shape)
    with pytest.raises(ValueError, match="aligned"):
        K.th_mix(odd, csum, ww, bw)
    assert K.th_mix.launches == before


def test_layernorm_and_th_mix_one_launch(card):
    """layernorm and th_mix each launch their one kernel a call and nothing
    else (torch.profiler's kernel names over one call each, after a first
    call that queries the wave)."""
    from torch.profiler import ProfilerActivity, profile

    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import layernorm_case, th_mix_case

    args, kw = layernorm_case(8192, 192, False, True, True, 1e-5, 192)
    for fn, a, k, name in ((K.layernorm, args, kw, "layernorm_kernel"),
                           (K.th_mix, th_mix_case(2, 1024, 4, 192), {},
                            "th_mix_kernel")):
        fn(*a, **k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(*a, **k)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1 and name in kernels[0], kernels
