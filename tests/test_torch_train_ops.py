"""The training path's supervision modules and kernels' plain versions
against the JAX package, on numpy-seeded inputs at small sizes:
connected components (kernel 5) and the auction (kernel 6) exactly, the
CAM pseudo-boxes exactly, the criterion pieces and set_criterion_multi to
1e-5 relative, the optimizer's update to f32 roundoff, and the port's
training-mode dropout.

The JAX side runs its plain XLA functions and, for the two kernels, the
Pallas kernels in interpret mode, as the JAX package's own tests do."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spe_tpu.ops import assignment as jassign
from spe_tpu.ops import cam_boxes as jcam
from spe_tpu.ops.pallas_auction import auction_phase_pallas
from spe_tpu.ops.pallas_cc import connected_components_pallas
from spe_tpu.ops.postprocess import postprocess_refine as jrefine
from spe_tpu.train import criterion as jcrit
from spe_tpu_torch.ops import auction as tauction
from spe_tpu_torch.ops import cam_boxes as tcam
from spe_tpu_torch.ops import connected_components as tcc
from spe_tpu_torch.ops.kernel_checks import diagonal_maze
from spe_tpu_torch.ops.postprocess import postprocess_refine
from spe_tpu_torch.train import criterion as tcrit

REL = 1e-5


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _close(got, want, rel=REL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rel,
                               atol=atol)


def _sync(fn, *args):
    """fn(*args) as one jitted JAX call, waited for before anything else is
    dispatched. The JAX package's Pallas kernels run in the threaded
    interpreter here, whose io_callbacks dispatch JAX work of their own;
    an eager dispatch from the test's thread while a kernel runs can
    deadlock the process (a JAX issue, ROADMAP §C)."""
    return jax.block_until_ready(jax.jit(fn)(*args))


# ---------------------------------------------------------------- kernel 5

def test_cc_matches_jax_on_blobs_and_a_capped_maze(rng):
    """32 x 32 masks as tests/test_cam_boxes.py draws them, and two mazes
    whose labels need 101 sweeps, past the 96-sweep cap: the result at the
    cap must be the JAX sweep's too."""
    masks = [rng.uniform(size=(32, 32)) > 0.65 for _ in range(6)]
    masks += [diagonal_maze(32), diagonal_maze(32)[:, ::-1]]
    m = np.stack(masks)
    got, sweeps = tcc.connected_components_reference(torch.from_numpy(m),
                                                     with_sweeps=True)
    _eq(got, jax.vmap(jcam._connected_components)(jnp.asarray(m)))
    assert sweeps[-1] == sweeps[-2] == tcc.MAX_SWEEPS
    full = tcc.connected_components_reference(torch.from_numpy(m[-2:]),
                                              max_sweeps=400)
    assert not torch.equal(full, got[-2:])  # the cap did bind


def test_cc_matches_jax_at_the_recipe_size():
    """The recipe's 64 x 64 masks (cam_cc_size): kernel_checks.cc_masks'
    blobs and both diagonal mazes, whose labels need 457 sweeps: labels
    and sweep counts through the plain version, labels through the JAX
    sweep, exactly equal at the 96-sweep cap."""
    from spe_tpu_torch.ops.kernel_checks import cc_masks

    m = cc_masks(n=8, S=64).numpy()
    got, sweeps = tcc.connected_components_reference(torch.from_numpy(m),
                                                     with_sweeps=True)
    _eq(got, _sync(jax.vmap(jcam._connected_components), jnp.asarray(m)))
    assert sweeps[-1] == sweeps[-2] == tcc.MAX_SWEEPS
    assert int(sweeps[:-2].max()) < tcc.MAX_SWEEPS


def test_cc_matches_pallas_interpret(rng):
    """tests/test_cam_boxes.py's 16 x 16 Pallas masks (percolation noise,
    a diagonal snake, a checkerboard), at the full cap and at a cap of 3
    sweeps that binds on most of them."""
    masks = [rng.uniform(size=(16, 16)) > p for p in (0.35, 0.5, 0.65)]
    snake = np.zeros((16, 16), bool)
    for i in range(16):
        snake[i, (i * 3) % 16] = True
    masks += [snake, np.indices((16, 16)).sum(0) % 2 == 0, diagonal_maze(16)]
    m = np.stack(masks)
    for cap in (tcc.MAX_SWEEPS, 3):
        want = _sync(lambda m: connected_components_pallas(
            m, max_iters=cap, interpret=True), jnp.asarray(m))
        _eq(tcc.connected_components_reference(torch.from_numpy(m), cap), want)


def test_cc_dispatch_takes_the_plain_version_on_cpu(rng):
    m = torch.from_numpy(rng.uniform(size=(3, 8, 8)) > 0.5)
    before = tcc.connected_components.launches
    _eq(tcc.connected_components(m), tcc.connected_components_reference(m))
    assert tcc.connected_components.launches == before


# ---------------------------------------------------------------- kernel 6

def _duplicate_columns(rng, P, Q, T):
    return np.repeat(rng.normal(size=(P, Q, T // 2)), 2, axis=2)


# tests/test_pallas_auction.py's cases, at its sizes
CASES = {
    "random": (5, 40, 16, lambda rng, P, Q, T: rng.normal(size=(P, Q, T)),
               lambda rng, P, T: np.concatenate(
                   [np.ones((P, 1), bool), rng.uniform(size=(P, T - 1)) > 0.3],
                   1)),
    "masked_and_empty": (3, 16, 8, lambda rng, P, Q, T: rng.normal(size=(P, Q, T)),
                         lambda rng, P, T: np.array(
                             [[True] * T, [True] * 3 + [False] * (T - 3),
                              [False] * T])),
    "overfull": (2, 6, 10, lambda rng, P, Q, T: rng.normal(size=(P, Q, T)),
                 lambda rng, P, T: np.ones((P, T), bool)),
    "duplicate_columns": (3, 20, 8, _duplicate_columns,
                          lambda rng, P, T: np.ones((P, T), bool)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_auction_matches_jax(rng, case):
    """The plain auction phase equals the vmapped `_auction_phase` and the
    Pallas kernel (interpret mode) exactly, assignments and iteration
    counts, on the same benefit; the whole batched solver (normalisation,
    phase, cleanup, stats) equals JAX's on the same cost."""
    P, Q, T, make_cost, make_mask = CASES[case]
    cost = make_cost(rng, P, Q, T).astype(np.float32)
    mask = make_mask(rng, P, T)
    benefit = jax.vmap(jassign._normalize_benefit)(jnp.asarray(cost),
                                                   jnp.asarray(mask))
    tb = tauction._normalize_benefit(torch.from_numpy(cost),
                                     torch.from_numpy(mask))
    _eq(tb, benefit)
    got, iters, _ = tauction.auction_phase_reference(tb, torch.from_numpy(mask))
    _, _, want, want_iters = jax.vmap(
        lambda b, m: jassign._auction_phase(b, m, jnp.zeros(Q, jnp.float32),
                                            2e-3, 5000))(benefit,
                                                         jnp.asarray(mask))
    _eq(got, want)
    _eq(iters, want_iters)
    pal, pal_iters = _sync(lambda b, m: auction_phase_pallas(
        b, m, interpret=True), benefit, jnp.asarray(mask))
    _eq(got, pal)
    _eq(iters, pal_iters)

    rows, _, stats = tauction.auction_assignment_stats_batched(
        torch.from_numpy(cost), torch.from_numpy(mask))
    jrows, _, jstats = jax.vmap(jassign.auction_assignment_stats)(
        jnp.asarray(cost), jnp.asarray(mask))
    _eq(rows, jrows)
    _eq(stats["iters"], jstats["iters"])
    _eq(stats["cleanup"], jstats["cleanup"])
    if case == "masked_and_empty":
        assert int(iters[2]) == 0


def test_hungarian_host_is_exact(rng):
    cost = rng.normal(size=(12, 5))
    _eq(tauction.hungarian_host(cost), jassign.hungarian_host(cost))
    over = rng.normal(size=(4, 7))  # more targets than queries
    got = tauction.hungarian_host(over)
    assert (got >= 0).sum() == 4
    _eq(got, jassign.hungarian_host(over))
    # `--assignment hungarian_cpu`: the criterion's match with the exact
    # solver, padded targets at a flat cost
    B, Q, K, T = 2, 10, 5, 4
    logits, boxes = _predictions(rng, B, Q, K)
    tg = _targets(rng, B, T, K, with_scores=False)
    rows, stats = tcrit.match(torch.from_numpy(logits),
                              torch.from_numpy(boxes), _t(tg),
                              method="hungarian_cpu")
    want = jcrit.match(jnp.asarray(logits), jnp.asarray(boxes), _j(tg),
                       method="hungarian_cpu")
    m = tg["mask"]
    _eq(rows.numpy()[m], np.asarray(want)[m])
    assert int(stats["iters"].sum()) == 0


# ------------------------------------------------------ CAM pseudo-boxes

def _cams_off_threshold(rng, B, C, S):
    """CAMs whose min-max normalised pixels x 255 sit 0.5 away from every
    integer, so no pixel is within float noise of any threshold."""
    k = rng.integers(0, 255, size=(B, C, S, S))
    cams = (k + 0.5) / 255.0
    cams[:, :, 0, 0] = 0.0
    cams[:, :, 0, 1] = 1.0
    return cams.astype(np.float32)


def test_cam_pseudo_boxes_match_jax_with_a_class_budget(rng):
    """max_pos = 3 below C = 7 (image 0 has 4 positives, so its weakest
    class is dropped), k = 2 components per class, 8-box budget."""
    B, C, S = 3, 7, 16
    cams = _cams_off_threshold(rng, B, C, S)
    # blobs so the components are not all single pixels
    ys, xs = np.mgrid[0:S, 0:S]
    for b in range(B):
        for c in range(C):
            cy, cx = rng.uniform(3, S - 3, 2)
            blob = np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / 8.0) > 0.4
            cams[b, c][blob] = (250.5 / 255.0)
    label = np.zeros((B, C), np.float32)
    label[0, [0, 2, 4, 5]] = 1
    label[1, [1, 6]] = 1
    label[2, 3] = 1
    kw = dict(area_ratio=0.5, size=S, k=2, max_boxes=8, max_pos=3)
    want = jcam.cam_pseudo_boxes(jnp.asarray(cams), jnp.asarray(label), 0.2,
                                 **kw)
    got = tcam.cam_pseudo_boxes(torch.from_numpy(cams),
                                torch.from_numpy(label), 0.2, **kw)
    _eq(got["mask"], want["mask"])
    _eq(got["labels"], want["labels"])
    _close(got["boxes"], want["boxes"], 0, 1e-7)
    assert got["mask"].sum() > 3


def test_cam_resize_matches_jax(rng):
    """The recipe's CAM upscale (32 -> 64 there; 8 -> 16 here)."""
    cams = rng.normal(size=(2, 3, 8, 8)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(cams), (2, 3, 16, 16), "bilinear")
    _close(tcam._resize(torch.from_numpy(cams), 16), want, 1e-6, 1e-6)
    with pytest.raises(NotImplementedError, match="shrinks"):
        tcam._resize(torch.from_numpy(cams), 4)


# ------------------------------------------------------------- criterion

def _predictions(rng, B, Q, K):
    logits = (rng.normal(size=(B, Q, K)) * 2).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (B, Q, 2)),
                            rng.uniform(0.05, 0.4, (B, Q, 2))], -1)
    return logits, boxes.astype(np.float32)


def _targets(rng, B, T, K, with_scores=True):
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (B, T, 2)),
                            rng.uniform(0.05, 0.4, (B, T, 2))], -1)
    mask = rng.uniform(size=(B, T)) > 0.3
    mask[:, 0] = True
    t = {"boxes": boxes.astype(np.float32),
         "labels": rng.integers(1, K, size=(B, T)).astype(np.int32),
         "mask": mask}
    if with_scores:
        t["scores"] = np.where(mask, rng.uniform(0.05, 0.9, (B, T)),
                               0).astype(np.float32)
    return t


def _j(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


def _t(t):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in t.items()}


def test_matcher_cost_and_layer_losses_match_jax(rng):
    B, Q, K, T = 2, 12, 6, 7
    logits, boxes = _predictions(rng, B, Q, K)
    tg = _targets(rng, B, T, K)
    want = jax.vmap(jcrit.matcher_cost)(
        jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(tg["labels"]),
        jnp.asarray(tg["boxes"]), jnp.asarray(tg["mask"]))
    got = tcrit.matcher_cost(torch.from_numpy(logits), torch.from_numpy(boxes),
                             torch.from_numpy(tg["labels"]),
                             torch.from_numpy(tg["boxes"]),
                             torch.from_numpy(tg["mask"]))
    _close(got, want, REL, 1e-5)
    row = np.stack([rng.permutation(Q)[:T] for _ in range(B)]).astype(np.int32)
    row[1, -1] = -1  # an unassigned target of an over-subscribed problem
    for refine in (False, True):
        kw = dict(focal_alpha=0.25, focal_gamma=0.5, refine_weights=refine)
        w = jcrit._layer_losses(jnp.asarray(logits), jnp.asarray(boxes),
                                _j(tg), jnp.asarray(row), 9.0, **kw)
        g = tcrit._layer_losses(torch.from_numpy(logits),
                                torch.from_numpy(boxes), _t(tg),
                                torch.from_numpy(row), 9.0, **kw)
        for k in w:
            _close(g[k], w[k])


def test_postprocess_refine_matches_jax(rng):
    from spe_tpu.ops.postprocess import postprocess_refine_multi as jmulti
    from spe_tpu_torch.ops.postprocess import postprocess_refine_multi

    B, Q, K, T = 2, 12, 6, 5
    logits, boxes = _predictions(rng, B, Q, K)
    tg = _targets(rng, B, T, K)
    want = jrefine(jnp.asarray(logits), jnp.asarray(boxes),
                   jnp.asarray(tg["labels"]), jnp.asarray(tg["mask"]))
    got = postprocess_refine(torch.from_numpy(logits), torch.from_numpy(boxes),
                             torch.from_numpy(tg["labels"]),
                             torch.from_numpy(tg["mask"]))
    for k in ("boxes", "scores"):
        _close(got[k], want[k], 1e-6, 1e-7)
    _eq(got["labels"], want["labels"])
    _eq(got["mask"], want["mask"])
    label = (rng.uniform(size=(B, K)) > 0.5).astype(np.float32)
    want = jmulti(jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(label),
                  max_keep=16)
    got = postprocess_refine_multi(torch.from_numpy(logits),
                                   torch.from_numpy(boxes),
                                   torch.from_numpy(label), max_keep=16)
    _eq(got["mask"], want["mask"])
    m = np.asarray(want["mask"])
    _eq(got["labels"].numpy()[m], np.asarray(want["labels"])[m])
    _close(got["scores"], want["scores"], 1e-6, 1e-7)
    _close(got["boxes"].numpy()[m], np.asarray(want["boxes"])[m], 1e-6, 1e-7)


def test_loss_primitives_match_jax(rng):
    from spe_tpu.ops import losses as jl
    from spe_tpu_torch.ops import losses as tl

    logits = (rng.normal(size=(2, 7, 5)) * 3).astype(np.float32)
    tgt = (rng.uniform(size=(2, 7, 5)) > 0.7).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=(2, 7, 5)).astype(np.float32)
    J, T = (lambda *a: [jnp.asarray(x) for x in a],
            lambda *a: [torch.from_numpy(x) for x in a])
    _close(tl.sigmoid_binary_cross_entropy(*T(logits, tgt)),
           jl.sigmoid_binary_cross_entropy(*J(logits, tgt)))
    _close(tl.weighted_sigmoid_focal_loss(*T(logits, tgt), 3.0,
                                          torch.from_numpy(w), 0.25, 0.5),
           jl.weighted_sigmoid_focal_loss(*J(logits, tgt), 3.0,
                                          jnp.asarray(w), 0.25, 0.5))
    _close(tl.image_label_bce(*T(logits[0], tgt[0])),
           jl.image_label_bce(*J(logits[0], tgt[0])))
    a = _targets(rng, 2, 6, 3)["boxes"]
    b = _targets(rng, 2, 6, 3)["boxes"]
    pm = (rng.uniform(size=(2, 6)) > 0.3).astype(np.float32)
    pw = rng.uniform(size=(2, 6)).astype(np.float32)
    _close(tl.masked_l1_loss(*T(a, b, pm), 4.0, torch.from_numpy(pw)),
           jl.masked_l1_loss(*J(a, b, pm), 4.0, jnp.asarray(pw)))
    _close(tl.masked_giou_loss(*T(a, b, pm), 4.0),
           jl.masked_giou_loss(*J(a, b, pm), 4.0))


def test_set_criterion_multi_matches_jax(rng):
    """Two stages (CAM targets, then refinement targets with scores), two
    decoder layers each, the box repeat at box_jitter 0 (deterministic):
    one batched auction on both sides, every loss to 1e-5 relative."""
    B, Q, K, T, L = 2, 16, 6, 4, 2
    stages_np = []
    for _ in range(2):
        lg, bx = zip(*[_predictions(rng, B, Q, K) for _ in range(L)])
        stages_np.append({"pred_logits": lg[-1], "pred_boxes": bx[-1],
                          "aux_pred_logits": np.stack(lg[:-1]),
                          "aux_pred_boxes": np.stack(bx[:-1])})
    tg0 = _targets(rng, B, T, K, with_scores=False)
    tg1 = _targets(rng, B, T, K)
    kw = dict(hung_match_ratio=3, box_jitter=0.0, focal_alpha=0.25,
              focal_gamma=0.5)
    want = jcrit.set_criterion_multi(
        [_j(s) for s in stages_np], [_j(tg0), _j(tg1)],
        [jax.random.PRNGKey(0), jax.random.PRNGKey(1)],
        [jnp.float32(11.0), jnp.float32(7.0)], [False, True], **kw)
    args = ([_t(s) for s in stages_np], [_t(tg0), _t(tg1)],
            [torch.Generator().manual_seed(0)] * 2,
            [torch.tensor(11.0), torch.tensor(7.0)], [False, True])
    got, matching = tcrit.set_criterion_multi(*args, **kw)
    for s in range(2):
        assert set(got[s]) == set(want[s])
        for k in want[s]:
            _close(got[s][k], want[s][k])
    assert float(got[0]["match_iters"]) > 0
    # the matching replayed (no assignment run) gives the same losses
    again, used = tcrit.set_criterion_multi(*args, **kw, matching=matching)
    assert used is matching
    for s in range(2):
        for k in got[s]:
            assert torch.equal(again[s][k], got[s][k]), (s, k)


def test_jitter_repeat_keeps_iou(rng):
    """With jitter the repeats keep IoU > 0.7 with their box and the last
    slot is the box itself (conditional_detr.py:409-431)."""
    tg = _t(_targets(rng, 2, 3, 5))
    gen = torch.Generator().manual_seed(0)
    rep = tcrit.jitter_repeat_targets(tg, gen, 5, 0.1)
    boxes = rep["boxes"].reshape(2, 3, 5, 4)
    _eq(boxes[:, :, -1], tg["boxes"])
    from spe_tpu_torch.ops.boxes import box_cxcywh_to_xyxy, box_iou_aligned

    iou = box_iou_aligned(box_cxcywh_to_xyxy(boxes),
                          box_cxcywh_to_xyxy(tg["boxes"])[:, :, None])
    assert (iou > 0.7).all() and (iou < 1).any()
    _eq(rep["labels"], tg["labels"].repeat_interleave(5, 1))


# ------------------------------------------------------------- optimizer

def test_optimizer_matches_jax_flat_update(rng):
    """3 updates of the port's AdamW3 and the JAX fused flat_update on the
    same parameters and gradients: step 1 with the clip active, step 2
    non-finite (skipped: parameters, moments and count untouched), step 3
    past lr_drop (StepLR 0.1). Agreement to f32 roundoff."""
    from spe_tpu.config import SPEConfig
    from spe_tpu.train.optim import _make_fused_optimizer
    from spe_tpu_torch import config as tconfig
    from spe_tpu_torch.train.optim import AdamW3

    kw = dict(lr=1e-3, lr_backbone=1e-4, lr_cls_head=5e-4, weight_decay=5e-2,
              clip_max_norm=0.1, lr_drop=1)
    shapes = {("backbone", "blocks_0", "w"): (4, 3),
              ("backbone", "blocks_token_only_0", "w"): (5,),
              ("transformer", "w"): (2, 6)}
    names = {("backbone", "blocks_0", "w"): "backbone.0.body.blocks.0.w",
             ("backbone", "blocks_token_only_0", "w"):
                 "backbone.0.body.blocks_token_only.0.w",
             ("transformer", "w"): "transformer.w"}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]

    def tree(d):
        out = {}
        for path, v in d.items():
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = jnp.asarray(v)
        return out

    tx = _make_fused_optimizer(SPEConfig(**kw), 1, tree(init))
    jparams, jstate = tree(init), tx.init(tree(init))
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in init.items()}
    opt = AdamW3([(names[k], p) for k, p in tparams.items()],
                 tconfig.SPEConfig(**kw), 1)
    for i, g in enumerate(grads):
        loss = np.float32(np.nan if i == 1 else 1.0)
        jparams, jstate, jnorm, jfinite = tx.flat_update(
            tree(g), jstate, jparams, jnp.isfinite(loss))
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        norm, finite = opt.step(torch.tensor(loss))
        assert finite == bool(jfinite) == (i != 1)
        _close(norm, jnorm, 1e-6, 0)
        assert opt.count == int(jstate.count)
        for k, p in tparams.items():
            want = jparams
            for part in k:
                want = want[part]
            _close(p.detach(), want, 1e-6, 1e-7)
    assert opt.count == 2


# --------------------------------------------------------------- dropout

def _tiny_model(rates):
    from spe_tpu_torch.models.cait import CaiTConfig
    from spe_tpu_torch.models.detector import SPEDetector
    from spe_tpu_torch.models.build import init_weights

    bb = CaiTConfig(img_size=32, embed_dim=16, depth=2, num_heads=2,
                    num_classes=3, layer_to_det=1, init_scale=0.5,
                    drop_rate=rates, attn_drop_rate=rates,
                    drop_path_rate=rates)
    m = SPEDetector(bb, 4, num_queries=6, enc_layers=1, dec_layers=1,
                    dim_feedforward=16, nheads=2, dropout=rates)
    return init_weights(m, 0)


def test_dropout_training_forward(rng):
    x = torch.from_numpy(rng.normal(size=(4, 32, 32, 3)).astype(np.float32))
    model = _tiny_model(0.2)
    with torch.no_grad():
        ref = model.eval()(x)["stages"][0]["pred_logits"]
        model.train()
        a = model(x, generator=torch.Generator().manual_seed(3))
        b = model(x, generator=torch.Generator().manual_seed(3))
        c = model(x, generator=torch.Generator().manual_seed(4))
    a, b, c = (o["stages"][0]["pred_logits"] for o in (a, b, c))
    assert torch.equal(a, b)                  # reproducible from the generator
    assert not torch.equal(a, ref) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        model(x)                              # training dropout needs one

    plain = _tiny_model(0.0)
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = plain.eval()(x)
        got = plain.train()(x, generator=torch.Generator().manual_seed(3))
    for k in ("pred_logits", "pred_boxes"):
        assert torch.equal(got["stages"][0][k], want["stages"][0][k])


def test_drop_path_drops_whole_samples():
    from spe_tpu_torch.ops.refmath import Dropout

    drop = Dropout(torch.Generator().manual_seed(0), path=0.5)
    out = drop.drop_path(torch.ones(64, 5, 3))
    per_sample = out.reshape(64, -1)
    assert ((per_sample == 0).all(1) | (per_sample == 2.0).all(1)).all()
    assert 10 < int((per_sample[:, 0] == 0).sum()) < 54
    site = drop(torch.ones(1000), 0.5)
    assert set(site.unique().tolist()) == {0.0, 2.0}
