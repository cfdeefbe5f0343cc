"""`--masks` training of the port against the JAX package on the CPU: 3
steps of the tiny detector with the segmentation head, at dropout 0, of
spe_tpu's jitted make_train_step and of the port's train_step on the same
weights (state_dict_from_jax) and batches (synthetic rectangles with their
masks, through the loader), the port with the fused flags off and under
the stock preset's flags; the same with --frozen_weights, where only the
head moves on both sides; then the port's own pieces: the lenient
checkpoint load, eval outputs without the head, and the CLI (--masks on
coco_panoptic, --frozen_weights from the port's checkpoint).

Tolerances as test_torch_train_step.py's: every loss term, loss_mask and
loss_dice included, 1e-4 relative + 1e-6 absolute at every step; the
parameters after step 3 5e-6 + 1e-4 relative; match_iters equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spe_tpu.train.optim import _group_of, make_optimizer
from spe_tpu.train.train_step import Gates as JGates
from spe_tpu.train.train_step import TrainState as JState
from spe_tpu.train.train_step import make_train_step
from spe_tpu_torch import config as tconfig
from spe_tpu_torch.data.loader import DataLoader
from spe_tpu_torch.data.synthetic import SyntheticDetection
from spe_tpu_torch.models.build import build_model
from spe_tpu_torch.models.convert import state_dict_from_jax
from spe_tpu_torch.models.segmentation import SEGM_PREFIXES
from spe_tpu_torch.train.optim import AdamW3
from spe_tpu_torch.train.train_step import Gates, TrainState, train_step
from test_torch_train_step import CFG, STEPS, _jax_params

MASKS = {**CFG, "masks": True, "dataset_file": "synthetic"}
STOCK = {"use_fused_block": True, "use_fused_layers": True,
         "use_pallas_attention": True}
KEYS = ("images", "pad_mask", "img_label", "gt_boxes", "gt_labels",
        "gt_mask", "gt_masks")


def _batches():
    """STEPS batches of 2 synthetic 64^2 images of 1-3 rectangles of the 5
    classes, with their GT boxes and masks (max_gt 6)."""
    ds = SyntheticDetection(num_images=2 * STEPS, num_classes=5, img_size=64,
                            seed=3, return_masks=True)
    loader = DataLoader(ds, 2, 5, fixed_size=64, seed=0, max_gt=6,
                        num_threads=1)
    out = [{k: b[k] for k in KEYS} for b in loader.epoch(0)]
    assert len(out) == STEPS and all(b["gt_masks"].any() for b in out)
    return out


def _mask_steps(rng, port_overrides, base=MASKS):
    jcfg, jmodel, params = _jax_params(rng, base)
    batches = _batches()
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
    before = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]), cfg)
    assert set(before) == set(model.state_dict())
    model.load_state_dict(before)
    state = TrainState(model, AdamW3(model.named_parameters(), cfg,
                                     steps_per_epoch=10))
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
        assert got["match_iters"] == want[i]["match_iters"], i
        assert got["bad_steps"] == want[i]["bad_steps"] == 0
        names = set(want[i]) - {"bad_steps"}
        assert {"loss_mask", "loss_dice"} <= names <= set(got), \
            names ^ set(got)
        assert want[i]["loss_mask"] > 0 and want[i]["loss_dice"] > 0
        for k in sorted(names):
            assert got[k] == pytest.approx(want[i][k], rel=1e-4, abs=1e-6), \
                (i, k, got[k], want[i][k])
    after = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate.params["params"]), cfg)
    moved = {}
    for name, p in model.named_parameters():
        w = after[name]
        diff = (p.detach() - w).abs()
        bad = diff > 5e-6 + 1e-4 * w.abs()
        assert not bad.any(), (name, float(diff[bad].max()))
        moved[name] = (bool((p.detach() != before[name]).any()),
                       bool((w != before[name]).any()))
    return moved


@pytest.mark.parametrize("flags", ["off", "stock"])
def test_three_mask_train_steps_match_jax(rng, flags):
    moved = _mask_steps(rng, {} if flags == "off" else STOCK)
    head = [n for n in moved if n.startswith(SEGM_PREFIXES)]
    # k_linear's bias has an exactly zero gradient (the softmax over
    # positions ignores a per-query constant) and a zero init: it stays
    assert len(head) == 20 and all(moved[n][0] for n in head
                                   if not n.endswith("k_linear.bias"))


def test_three_frozen_mask_train_steps_match_jax(rng):
    """--frozen_weights: every parameter outside the head bit for bit
    unchanged on both sides, the head's moved, and both sides agree."""
    moved = _mask_steps(rng, {}, base={**MASKS, "frozen_weights": "ckpt"})
    for name, (port, jax_) in moved.items():
        assert port == jax_ == name.startswith(SEGM_PREFIXES), name


def _tiny_argv(tmp_path, extra=()):
    return ["--preset", "voc0712", "--device", "cpu", "--backbone",
            "TSCAM_cait_tiny", "--max_size", "64", "--layer_to_det", "2",
            "--enc_layers", "1", "--dec_layers", "2", "--dim_feedforward",
            "32", "--nheads", "2", "--num_queries", "12", "--batch_size", "2",
            "--compute_dtype", "float32", "--cam_cc_size", "16",
            "--max_gt_boxes", "6", "--warmup_cls_epochs", "0",
            "--refine_start_epoch", "0", "--epochs", "1",
            "--output_dir", str(tmp_path / "out"), *extra]


def test_eval_outputs_without_the_head(rng):
    """With --masks the eval forward equals the same weights' without the
    head, and computes no pred_masks; with_masks asks for them."""
    base = tconfig.SPEConfig(**{**CFG, "use_fused_block": True})
    plain = build_model(base, "cpu")
    masked = build_model(base.replace(masks=True), "cpu")
    sd = plain.state_dict()
    missing = masked.load_state_dict(sd, strict=False).missing_keys
    assert missing and all(k.startswith(SEGM_PREFIXES) for k in missing)
    x = torch.from_numpy(rng.normal(size=(2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        want, got = plain(x), masked(x)
        assert "pred_masks" not in got
        for r in want["stages"]:
            for k, v in want["stages"][r].items():
                assert torch.equal(got["stages"][r][k], v), (r, k)
        assert masked(x, with_masks=True)["pred_masks"].shape == (2, 10, 16, 16)
        with pytest.raises(ValueError, match="no segmentation head"):
            plain(x, with_masks=True)


def test_load_params_lenient(tmp_path):
    from spe_tpu_torch.train.checkpoint import (load_params_lenient,
                                                save_checkpoint)

    cfg = tconfig.SPEConfig(**CFG)
    det = build_model(cfg, "cpu")
    state = TrainState(det, AdamW3(det.named_parameters(), cfg, 1))
    save_checkpoint(tmp_path / "det.pth", state, 0, cfg)
    other = build_model(cfg.replace(masks=True, seed=5), "cpu")
    head = {k: v.clone() for k, v in other.state_dict().items()
            if k.startswith(SEGM_PREFIXES)}
    kept = load_params_lenient(tmp_path / "det.pth", other)
    assert sorted(kept) == sorted(head)
    for k, v in other.state_dict().items():
        want = head[k] if k in head else det.state_dict()[k]
        assert torch.equal(v, want), k
    wrong = build_model(cfg.replace(num_queries=7), "cpu")
    with pytest.raises(ValueError, match="query_embed"):
        load_params_lenient(tmp_path / "det.pth", wrong)


def test_cli_masks_panoptic_and_frozen_weights(tmp_path):
    """The CLI: one epoch of the detector on a mini-COCO, then --masks
    --frozen_weights from its checkpoint on the coco_panoptic tree of the
    same images (mask losses in the log, COCO eval): only the head moves.
    --frozen_weights without --masks is refused."""
    import json

    from spe_tpu_torch.cli.main import main, parse_config
    from spe_tpu_torch.data import (write_mini_coco,
                                    write_mini_coco_panoptic)

    coco = write_mini_coco(tmp_path, n_train=4, n_val=2, img_size=64)
    pan = write_mini_coco_panoptic(coco)
    data = ["--dataset_eval", "coco", "--coco_path", str(coco),
            "--num_classes", "90"]
    main(_tiny_argv(tmp_path, ["--dataset_file", "coco_panoptic",
                               "--coco_panoptic_path", str(pan), *data]))
    ckpt = tmp_path / "out" / "checkpoint.pth"
    start = torch.load(ckpt, weights_only=False)["model"]
    res = main(_tiny_argv(tmp_path / "f", [
        "--masks", "--dataset_file", "coco_panoptic", "--coco_panoptic_path",
        str(pan), "--frozen_weights", str(ckpt), *data]))
    (epoch,) = res["epochs"]
    assert epoch["train"]["steps"] == 2
    log = json.loads((tmp_path / "f" / "out" / "log.txt").read_text())
    assert log["train_loss_mask"] > 0 and log["train_loss_dice"] > 0
    assert 0 <= log["test_AP"] <= 1 or log["test_AP"] == -1
    params = dict(res["state"].model.named_parameters())
    head = [n for n in params if n.startswith(SEGM_PREFIXES)]
    assert head and not any(n in start for n in head)
    for n, p in params.items():
        if n not in head:
            assert torch.equal(p.detach(), start[n]), n
    init = build_model(parse_config(_tiny_argv(tmp_path, [
        "--masks", "--num_classes", "90"])), "cpu").state_dict()
    assert all(not torch.equal(params[n].detach(), init[n]) for n in head
               if not n.endswith("k_linear.bias"))
    with pytest.raises(ValueError, match="segmentation only"):
        parse_config(_tiny_argv(tmp_path, ["--frozen_weights", str(ckpt)]))
