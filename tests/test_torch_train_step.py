"""The port's whole training step against the JAX package's: a tiny
detector (TSCAM_cait_tiny, 1 encoder and 2 decoder layers, f32, the fused
flags off, every dropout 0, box_jitter 0, every loss gate on) takes 3 steps
of spe_tpu's jitted make_train_step (fused flat-vector AdamW) and 3 steps
of the port's train_step on the same weights (state_dict_from_jax) and
batches; the port also with its fused backbone, and with every fused layer
(backbone, encoder, decoder) on.

Tolerances, f32 on the CPU:
  * every loss term at every step: 1e-4 relative + 1e-6 absolute. The two
    frameworks sum in other orders; step 2 and 3 also see parameters that
    differ by the update's roundoff.
  * the parameters after step 3: 5e-6 absolute + 1e-4 relative, against
    moves of about lr = 2e-4..1e-3 per step (Adam's normalised step); the
    largest difference seen is 1.1e-6.
  * match_iters equal; match_cleanup 0 on both.
  * the three learning-rate groups hold the same parameters (by count).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spe_tpu.config import SPEConfig
from spe_tpu.models.build import build_model as jax_build_model
from spe_tpu.train.optim import _group_of, make_optimizer
from spe_tpu.train.train_step import Gates as JGates
from spe_tpu.train.train_step import TrainState as JState
from spe_tpu.train.train_step import make_train_step
from spe_tpu_torch import config as tconfig
from spe_tpu_torch.models.build import build_model
from spe_tpu_torch.models.convert import state_dict_from_jax
from spe_tpu_torch.train.optim import AdamW3
from spe_tpu_torch.train.train_step import (Gates, TrainState,
                                            compute_losses, train_step)

CFG = dict(backbone="TSCAM_cait_tiny", num_classes=5, layer_to_det=2,
           num_queries=10, enc_layers=1, dec_layers=2, dim_feedforward=48,
           nheads=2, num_refines=1, max_gt_boxes=6, max_cam_boxes_per_class=2,
           max_pos_classes=3, cam_cc_size=16, hung_match_ratio=3,
           compute_dtype="float32", dropout=0.0, backbone_drop_rate=0.0,
           drop_path_rate=0.0, drop_attn_rate=0.0, box_jitter=0.0,
           warmup_cls_epochs=0, refine_start_epoch=0, init_scale=0.5,
           use_fused_block=False, use_fused_layers=False,
           use_pallas_attention=False, lr=1e-3, lr_backbone=2e-4,
           lr_cls_head=5e-4, weight_decay=5e-2, clip_max_norm=0.1,
           focal_gamma=0.5, dataset_file="voc", device="cpu", max_size=64,
           fixed_size=True)
STEPS = 3
# the coco17 preset's class side at the tiny size: 90 classes (91 class
# tokens and detection columns), a budget of 16 positive classes an image,
# fewer targets than queries (8 < 30) as in the preset (48 x 5 < 300), and
# no repeated targets. At this size the CAMs give most classes the same
# whole-image box; repeated, such targets tie in the auction up to the
# costs' f32 roundoff, which differs between the frameworks (1e-6), and the
# two auctions then part ways (seen at repeat 3: iterations 80 vs 78 on
# the same outputs). Without repeats the assignment is not at such a tie.
COCO17 = dict(num_classes=90, dataset_file="coco", max_pos_classes=16,
              max_gt_boxes=8, num_queries=30, hung_match_ratio=1)


def _batches(rng, B=2, C=5):
    """STEPS batches of B images; with C > 16 each image carries 17-24
    positive classes, past the coco17 budget."""
    out = []
    for _ in range(STEPS):
        label = np.zeros((B, C), np.float32)
        if C > 16:
            for b in range(B):
                label[b, rng.choice(C, int(rng.integers(17, 25)),
                                    replace=False)] = 1
        else:
            label[:, 1] = 1
            label[0, 3] = 1
            label[1, rng.integers(0, C)] = 1
        out.append({"images": rng.normal(size=(B, 64, 64, 3)).astype(np.float32),
                    "img_label": label})
    return out


def _jax_params(rng, base=CFG):
    cfg = SPEConfig(**base)
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 64, 64, 3), jnp.float32))
    flat = flax.traverse_util.flatten_dict(params["params"])
    for k, v in flat.items():  # the zero-init last bbox layer hides the decoder
        if k[0].startswith("bbox_embed") and k[-1] == "kernel" and not np.any(v):
            flat[k] = jnp.asarray(0.1 * rng.normal(size=v.shape), jnp.float32)
    return cfg, model, {"params": flax.traverse_util.unflatten_dict(flat)}


def test_three_train_steps_match_jax(rng):
    _three_steps(rng, {})


def test_three_train_steps_fused_backbone_match_jax(rng):
    """The port's fused backbone (the patch blocks' and class-attention
    blocks' autograd Functions; on the CPU their plain forward and
    hand-derived backward) against the same JAX fused-off step: at rate 0
    the math is the same."""
    _three_steps(rng, {"use_fused_block": True})


def test_three_train_steps_all_fused_match_jax(rng):
    """Every fused layer of the port in training (the backbone blocks' and
    the encoder and decoder layers' autograd Functions; on the CPU their
    plain training forwards and hand-derived backwards) against the same
    JAX fused-off step: at rate 0 the math is the same."""
    _three_steps(rng, {"use_fused_block": True, "use_fused_layers": True})


def test_three_train_steps_pallas_attention_match_jax(rng):
    """The fused flags off with use_pallas_attention on: the patch blocks'
    attention through TalkingHeadsFn (B5), the class attention, the encoder
    and the decoder cross-attention through MHAFn (B4), on the CPU their
    plain training forwards and hand-derived backwards, against the same
    JAX fused-off step: at rate 0 the math is the same."""
    _three_steps(rng, {"use_pallas_attention": True})


def test_three_train_steps_coco17_match_jax(rng):
    """The coco17 preset's class side (COCO17: 90 classes, 91 class tokens
    and detection columns, 16 positive classes kept of the 17-24 each image
    carries) with every fused layer of the port on, against the same JAX
    fused-off step."""
    _three_steps(rng, {"use_fused_block": True, "use_fused_layers": True},
                 base={**CFG, **COCO17})


def test_three_train_steps_single_branch_fused_backbone_match_jax(
        rng, monkeypatch):
    """A single-branch backbone (no det-branch stack: the det features are
    norm_to_det of the patch tokens at block index layer_to_det, the CAM
    the heads' mean) with the port's fused backbone, against the same JAX
    fused-off step: a tiny single-branch entry put in both registries for
    this test."""
    from spe_tpu.models import cait as jcait
    from spe_tpu_torch.models import cait as tcait

    name = "TSCAM_cait_tiny_single"
    monkeypatch.setitem(jcait.BACKBONE_REGISTRY, name,
                        lambda **kw: jcait._cait(64, 32, 4, 2,
                                                 two_branch=False, **kw))
    monkeypatch.setitem(tcait.BACKBONE_REGISTRY, name,
                        lambda **kw: tcait._cait(64, 32, 4, 2,
                                                 two_branch=False, **kw))
    _three_steps(rng, {"use_fused_block": True},
                 base={**CFG, "backbone": name})


def test_compute_losses_replays_supervision(rng):
    """compute_losses returns the supervision it used (CAM pseudo-boxes,
    refinement targets, matching) and takes one in place of its own: the
    same model replaying its own supervision gives the same losses, and a
    replaying run uses what it was given."""
    cfg = tconfig.SPEConfig(**CFG)
    model = build_model(cfg, "cpu").train()
    b = {k: torch.from_numpy(v) for k, v in _batches(rng)[0].items()}
    gates = Gates.for_epoch(cfg, 0)

    def run(supervision=None):
        return compute_losses(model, b, cfg, gates,
                              torch.Generator().manual_seed(0), supervision)

    total, losses, sup = run()
    assert set(sup) == {"cam", "refine", "matching"}
    assert int(sup["cam"]["mask"].sum()) > 0 and float(total.detach()) > 0
    total2, losses2, used = run(sup)
    assert all(used[k] is sup[k] for k in sup)
    assert torch.equal(total2, total)
    for k, v in losses.items():
        assert torch.equal(losses2[k], v), k


def _three_steps(rng, port_overrides, base=CFG):
    jcfg, jmodel, params = _jax_params(rng, base)
    batches = _batches(rng, C=base["num_classes"])
    tx = make_optimizer(jcfg, steps_per_epoch=10, params=params)
    jstate = JState(jnp.int32(0), params, tx.init(params), jnp.int32(0))
    step = jax.jit(make_train_step(jmodel, jcfg, tx))
    jgates = JGates.for_epoch(jcfg, 0)
    want = []
    for i, b in enumerate(batches):
        jstate, m = step(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                         jax.random.PRNGKey(i), jgates)
        want.append({k: float(v) for k, v in m.items()})

    cfg = tconfig.SPEConfig(**{**base, **port_overrides})
    model = build_model(cfg, "cpu")
    params_before = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]), cfg)
    model.load_state_dict(params_before)
    state = TrainState(model, AdamW3(model.named_parameters(), cfg,
                                     steps_per_epoch=10))
    # the weight bridge carries the optimizer's start too: fresh moments are
    # zeros on both sides, so only the three learning-rate groups must map
    sizes = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        g = _group_of(jcfg, path)
        sizes[g] = sizes.get(g, 0) + int(np.prod(leaf.shape))
    assert sizes == {g: sum(p.numel() for p in ps)
                     for g, ps in state.optimizer.groups.items()}
    gen = torch.Generator().manual_seed(0)
    for i, b in enumerate(batches):
        m = train_step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                       cfg, Gates.for_epoch(cfg, 0), gen)
        got = {k: float(v) for k, v in m.items()}
        assert got["match_cleanup"] == want[i]["match_cleanup"] == 0.0
        assert got["match_iters"] == want[i]["match_iters"], i
        assert got["bad_steps"] == want[i]["bad_steps"] == 0
        names = set(want[i]) - {"bad_steps"}
        assert names <= set(got), names - set(got)
        for k in sorted(names):
            assert got[k] == pytest.approx(want[i][k], rel=1e-4, abs=1e-6), \
                (i, k, got[k], want[i][k])

    sd = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate.params["params"]), cfg)
    moved = 0.0
    for name, p in model.named_parameters():
        w = sd[name]
        diff = (p.detach() - w).abs()
        bad = diff > 5e-6 + 1e-4 * w.abs()
        assert not bad.any(), (name, float(diff[bad].max()))
        moved = max(moved, float((w - params_before[name]).abs().max()))
    assert moved > 1e-3  # the steps moved the weights
