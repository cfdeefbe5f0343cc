"""The port against the JAX package at the recipe's width (`-m slow`): the
voc0712 preset's TSCAM_cait_XXS36_Two_Branch (D 192, 36 + 12 patch
blocks, 4 heads) with its 3 encoder and 6 decoder layers and 300 queries
at 512^2, B=1, f32, every dropout 0, the fused flags and
use_pallas_attention off on both sides, the JAX package's init carried
over by state_dict_from_jax (its zero last bbox layers drawn, as
tests/test_torch_train_step.py draws them).

  * eval: stage 0's logits and boxes, the CAMs and the image logits, then
    the top 300 after NMS (postprocess_topk, batched_nms); tolerances of
    tests/test_full_scale_parity.py at this scale: image logits and CAMs
    5e-4, logits 2e-3, boxes 2e-4 (in pixels, 2e-4 of the 512 side); the
    kept detections the same in number, each with a JAX one of its label
    within those of its score and box;
  * one `--remat` training step (every patch and det-branch block
    checkpointed on both sides): every loss term 1e-4 relative + 1e-6;
    the clipped gradients (the JAX side's from its first moment) within
    GRAD_TOL of each tensor's largest; the parameters after the update
    5e-6 + 1e-4 relative, as tests/test_torch_train_step.py holds its
    tiny steps, where the gradient is at least Adam's eps and twice
    GRAD_TOL of its tensor's largest: Adam's first step lr g / (|g| + eps)
    is about +-lr for any g above eps, so only where the gradient's sign
    is decided do the steps agree.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from spe_tpu.config import voc0712_preset as jax_preset
from spe_tpu.models.build import build_model as jax_build_model
from spe_tpu.ops.nms import batched_nms
from spe_tpu.ops.postprocess import postprocess_topk
from spe_tpu.train import engine as jengine
from spe_tpu.train.optim import make_optimizer
from spe_tpu.train.train_step import Gates as JGates
from spe_tpu.train.train_step import TrainState as JState
from spe_tpu.train.train_step import make_train_step
from spe_tpu_torch.config import voc0712_preset
from spe_tpu_torch.models.build import build_model
from spe_tpu_torch.models.convert import state_dict_from_jax
from spe_tpu_torch.ops import nms as tnms
from spe_tpu_torch.ops import postprocess as tpost
from spe_tpu_torch.ops.kernel_checks import zero_grad_ref
from spe_tpu_torch.train import engine as tengine
from spe_tpu_torch.train.optim import AdamW3
from spe_tpu_torch.train.train_step import Gates, TrainState, train_step

SIDE = 512
ADAM_EPS = 1e-8
B1 = 0.9   # Adam's b1 (spe_tpu/train/optim.py, train/optim.py)
# each clipped gradient against the JAX step's, of its tensor's largest
# (a zero-by-construction bias: of its weight's): ReLU kinks in the
# encoder FFN and the decoder's query_scale flip on f32 roundoff (at 8
# patch blocks, the backbone's depth cut, the largest is 1.2e-2 in
# query_scale, 7.3e-3 in encoder layer 0's linear1, 6e-4 in the backbone)
GRAD_TOL = 5e-2
OVERRIDES = dict(compute_dtype="float32", dropout=0.0, backbone_drop_rate=0.0,
                 drop_path_rate=0.0, drop_attn_rate=0.0, box_jitter=0.0,
                 use_fused_block=False, use_fused_layers=False,
                 use_pallas_attention=False, warmup_cls_epochs=0,
                 refine_start_epoch=0, batch_size=1, device="cpu")
TOL = {"x_logits": 5e-4, "cams_cls": 5e-4, "pred_logits": 2e-3,
       "pred_boxes": 2e-4}


def _sync(fn, *args):
    """One jitted call, waited for before anything else is dispatched."""
    return jax.block_until_ready(jax.jit(fn)(*args))


def _kept(res, keep):
    """[(label, score, box)] of the kept detections of image 0."""
    res = {k: np.asarray(v)[0] for k, v in res.items()}
    return [(int(res["labels"][i]), float(res["scores"][i]), res["boxes"][i])
            for i in np.flatnonzero(np.asarray(keep)[0])]


@pytest.mark.slow
def test_recipe_width_eval_and_remat_step_match_jax(rng):
    jcfg = jax_preset(**OVERRIDES, remat=True)
    jmodel = jax_build_model(jcfg)
    images = rng.normal(size=(1, SIDE, SIDE, 3)).astype(np.float32)
    pad = np.zeros((1, SIDE, SIDE), bool)
    sizes = np.array([[375, 500]], np.int64)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros_like(images))
    # the zero-init last bbox layers leave every query's box its reference
    # point's: the refinement targets then tie across queries and the
    # frameworks' roundoff picks among them (the same loss, other
    # gradients), so they are drawn, as test_torch_train_step does
    flat = flax.traverse_util.flatten_dict(params["params"])
    for k, v in flat.items():
        if k[0].startswith("bbox_embed") and k[-1] == "kernel" and \
                not np.any(v):
            flat[k] = jnp.asarray(0.1 * rng.normal(size=v.shape), jnp.float32)
    params = {"params": flax.traverse_util.unflatten_dict(flat)}

    def jax_eval(params, images, pad, sizes):
        outs, full = jengine._eval_outputs(
            jmodel, params, {"images": images, "pad_mask": pad},
            refine_stage=0, use_aux_layer=False)
        res = postprocess_topk(outs["pred_logits"], outs["pred_boxes"],
                               sizes.astype(jnp.float32), keep_queries=300)
        keep = batched_nms(res["boxes"], res["scores"], res["labels"],
                           jnp.ones_like(res["scores"], bool), 0.5)
        return outs, full["backbone"], res, keep

    want = _sync(jax_eval, params, jnp.asarray(images), jnp.asarray(pad),
                 jnp.asarray(sizes))

    cfg = voc0712_preset(**OVERRIDES, remat=True)
    model = build_model(cfg, "cpu")
    params_before = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]), cfg)
    model.load_state_dict(params_before)
    assert all(b.remat for b in model.backbone[0].body.blocks)
    with torch.no_grad():
        outs, full = tengine._eval_outputs(
            model, {"images": torch.from_numpy(images),
                    "pad_mask": torch.from_numpy(pad)},
            refine_stage=0, use_aux_layer=False)
        res = tpost.postprocess_topk(outs["pred_logits"], outs["pred_boxes"],
                                     torch.from_numpy(sizes).float(),
                                     keep_queries=300)
        keep = tnms.batched_nms(res["boxes"], res["scores"], res["labels"],
                                torch.ones_like(res["scores"],
                                                dtype=torch.bool), 0.5)
    got = {**outs, **{k: full["backbone"][k] for k in ("x_logits",
                                                       "cams_cls")}}
    ref = {**want[0], **{k: want[1][k] for k in ("x_logits", "cams_cls")}}
    for k, tol in TOL.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=tol, rtol=0, err_msg=k)
    mine, theirs = _kept(res, keep), _kept(want[2], want[3])
    assert len(mine) == len(theirs) > 0
    box_tol = TOL["pred_boxes"] * SIDE
    for label, score, box in mine:
        assert any(label == lj and abs(score - sj) <= TOL["pred_logits"]
                   and np.abs(box - bj).max() <= box_tol
                   for lj, sj, bj in theirs), (label, score, box)

    label = np.zeros((1, cfg.num_classes), np.float32)
    label[0, [2, 11]] = 1
    batch = {"images": images, "img_label": label}
    tx = make_optimizer(jcfg, steps_per_epoch=10, params=params)
    jstate = JState(jnp.int32(0), params, tx.init(params), jnp.int32(0))
    step = make_train_step(jmodel, jcfg, tx)
    jstate, m = _sync(lambda s, b: step(s, b, jax.random.PRNGKey(0),
                                        JGates.for_epoch(jcfg, 0)),
                      jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    want_m = {k: float(v) for k, v in m.items()}

    state = TrainState(model, AdamW3(model.named_parameters(), cfg,
                                     steps_per_epoch=10))
    got_m = train_step(state, {k: torch.from_numpy(v)
                               for k, v in batch.items()},
                       cfg, Gates.for_epoch(cfg, 0),
                       torch.Generator().manual_seed(0))
    got_m = {k: float(v) for k, v in got_m.items()}
    assert got_m["bad_steps"] == want_m["bad_steps"] == 0
    for k in sorted(set(want_m) - {"bad_steps"}):
        assert got_m[k] == pytest.approx(want_m[k], rel=1e-4, abs=1e-6), \
            (k, got_m[k], want_m[k])
    # the JAX step's clipped gradients: its first moment after one step
    # is (1 - b1) g
    _, unravel = ravel_pytree(params)
    grads = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, unravel(jstate.opt_state.mu / (1.0 - B1))["params"]), cfg)
    sd = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate.params["params"]), cfg)
    clip = min(1.0, cfg.clip_max_norm / got_m["grad_norm"])
    moved, held_count = 0.0, 0
    for name, p in model.named_parameters():
        want_g = grads[name]
        top = float(grads[zero_grad_ref(name) or name].abs().max())
        err = float((p.grad * clip - want_g).abs().max())
        assert err <= GRAD_TOL * top, (name, err, top)
        w = sd[name]
        held = want_g.abs() >= max(ADAM_EPS, 2 * GRAD_TOL * top)
        diff = (p.detach() - w).abs()
        bad = held & (diff > 5e-6 + 1e-4 * w.abs())
        assert not bad.any(), (name, float(diff[bad].max()))
        held_count += int(held.sum())
        moved = max(moved, float((w - params_before[name]).abs().max()))
    assert moved > 0 and held_count > 0
