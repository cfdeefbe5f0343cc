"""The port's data parallelism (spe_tpu_torch.parallel.dist) on the CPU:
two processes over gloo on 127.0.0.1, each under its own timeout, so that a
deadlock fails the test instead of hanging it.

  * pack_detections / unpack_detections against the JAX package's on the
    same detections (exactly), and a two-plane merge against the union;
  * one train step of the tiny detector on 2 processes of 2 images each
    against the JAX package's jitted make_train_step(num_devices=2) on the
    4-image batch: the losses 1e-4 relative + 1e-6, the parameters after
    the update 5e-6 + 1e-4 relative (test_torch_train_step.py's one-step
    tolerances), both processes' parameters bit for bit equal;
  * the CLI on 2 processes (--world_size 2 --dist_url tcp://...): trains
    and evaluates a tiny mini-VOC, process 0 alone prints and writes;
  * the CLI's COCO eval on 2 processes, each over half the images, merged:
    equal to the one-process eval (AP/AR 1e-9, eval losses 1e-6 relative).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spe_tpu.config import SPEConfig
from spe_tpu.data.coco_eval import CocoEvaluator as JEvaluator
from spe_tpu.models.build import build_model as jax_build_model
from spe_tpu.train import engine as jengine
from spe_tpu.train.optim import make_optimizer
from spe_tpu.train.train_step import Gates as JGates
from spe_tpu.train.train_step import TrainState as JState
from spe_tpu.train.train_step import make_train_step
from spe_tpu_torch.data import write_mini_coco, write_mini_voc
from spe_tpu_torch.data.coco_eval import CocoEvaluator as TEvaluator
from spe_tpu_torch.models.convert import state_dict_from_jax
from spe_tpu_torch.train import engine as tengine

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 120   # seconds a 2-process run may take

# run by each process: `python -c WORKER <mode> <rank> <port> <dir>`
WORKER = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
mode, rank, port, tmp = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
os.environ["RANK"] = str(rank)
url = f"tcp://127.0.0.1:{port}"
if mode == "cli":
    from spe_tpu_torch.cli.main import main
    argv = json.load(open(f"{tmp}/argv.json")) + ["--world_size", "2",
                                                  "--dist_url", url]
    res = main(argv)
    stats = res if "--eval" in argv else res["epochs"][-1]["eval"]
    json.dump(stats, open(f"{tmp}/stats{rank}.json", "w"))
else:
    from spe_tpu_torch import config
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.parallel import dist
    from spe_tpu_torch.train.optim import AdamW3
    from spe_tpu_torch.train.train_step import Gates, TrainState, train_step
    dist.init_distributed(2, url, "cpu")
    spec = torch.load(f"{tmp}/step.pt")
    cfg = config.SPEConfig(**spec["cfg"])
    model = build_model(cfg, "cpu")
    model.load_state_dict(spec["weights"])
    state = TrainState(model, AdamW3(model.named_parameters(), cfg, 10))
    half = {k: v[2 * rank:2 * rank + 2] for k, v in spec["batch"].items()}
    m = train_step(state, half, cfg, Gates.for_epoch(cfg, 0),
                   torch.Generator().manual_seed(rank))
    torch.save({"metrics": {k: float(v) for k, v in m.items()},
                "params": {k: p.detach() for k, p in
                           model.named_parameters()}},
               f"{tmp}/rank{rank}.pt")
    dist.shutdown()
print(f"WORKER DONE rank={rank}", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_processes(mode, tmp):
    """Both processes of `mode` on tmp -> their outputs; fails on a nonzero
    exit or when they outlast TIMEOUT (both killed)."""
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "PROCESS_ID", "JAX_PROCESS_ID", "WORLD_SIZE",
                        "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, mode, str(r), port, str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(REPO), env=env) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate()[0] for p in procs]
        pytest.fail(f"{mode}: the 2 processes outlasted {TIMEOUT}s "
                    "(deadlock?):\n" + "\n=== rank 1 ===\n".join(
                        o[-3000:] for o in outs))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
        assert f"WORKER DONE rank={r}" in out, out[-4000:]
    return outs


# ------------------------------------------------------- detection merge

def _gt():
    imgs = [{"id": i, "width": 100, "height": 100} for i in (1, 2, 3)]
    anns = [{"id": i, "image_id": img, "category_id": cat, "bbox": box,
             "area": box[2] * box[3], "iscrowd": 0}
            for i, (img, cat, box) in enumerate(
                [(1, 1, [10, 10, 30, 30]), (2, 2, [40, 40, 20, 20]),
                 (3, 1, [5, 50, 40, 25]), (3, 2, [60, 10, 30, 30])], 1)]
    return {"images": imgs, "annotations": anns,
            "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}


def _detections(rng, images):
    return [{"image_id": int(img), "category_id": int(rng.integers(1, 3)),
             "bbox": [float(v) for v in np.round(
                 rng.uniform([0, 0, 5, 5], [60, 60, 40, 40]), 2)],
             "score": float(rng.uniform(0.05, 1.0))}
            for img in images for _ in range(5)]


def _evaluators(dets):
    out = []
    for cls in (JEvaluator, TEvaluator):
        ev = cls(_gt())
        ev.update(dets)
        out.append(ev)
    return out


def test_pack_detections_matches_jax(rng):
    jev, tev = _evaluators(_detections(rng, (1, 2, 3)))
    want = jengine.pack_detections(jev, max_dets=64)
    got = tengine.pack_detections(tev, max_dets=64)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and (got[:, 0] > 0.5).sum() == 15


def test_unpack_detections_matches_jax(rng):
    planes = np.stack([
        jengine.pack_detections(_evaluators(_detections(rng, imgs))[0], 32)
        for imgs in ((1, 2), (3,))])
    jev, tev = JEvaluator(_gt()), TEvaluator(_gt())
    jengine.unpack_detections(jev, planes)
    tengine.unpack_detections(tev, planes)
    assert tev._dt == jev._dt
    assert sum(len(v) for v in tev._dt.values()) == 15


def test_two_plane_merge_is_the_union(rng):
    """Process 0 saw images 1 and 2, process 1 image 3: after the merge both
    summarise the union, as the JAX merge does and as one process that saw
    every image does."""
    dets = [_detections(rng, (1, 2)), _detections(rng, (3,))]
    tevs = [TEvaluator(_gt()) for _ in dets]
    for ev, d in zip(tevs, dets):
        ev.update(d)
    planes = np.stack([tengine.pack_detections(ev, 32) for ev in tevs])
    for ev in tevs:
        tengine.unpack_detections(ev, planes)
    jev = JEvaluator(_gt())
    jengine.unpack_detections(jev, planes)
    whole = TEvaluator(_gt())
    whole.update(dets[0] + dets[1])
    want = whole.summarize()
    for s in [ev.summarize() for ev in tevs] + [jev.summarize()]:
        for k, v in want.items():
            assert s[k] == pytest.approx(v, abs=1e-9), k
    assert want["AR100"] >= 0


# ---------------------------------------------------- one train step, 2 ranks

CFG = dict(backbone="TSCAM_cait_tiny", num_classes=5, layer_to_det=2,
           num_queries=10, enc_layers=1, dec_layers=2, dim_feedforward=48,
           nheads=2, num_refines=1, max_gt_boxes=6, max_cam_boxes_per_class=2,
           max_pos_classes=3, cam_cc_size=16, hung_match_ratio=1,
           compute_dtype="float32", dropout=0.0, backbone_drop_rate=0.0,
           drop_path_rate=0.0, drop_attn_rate=0.0, box_jitter=0.0,
           warmup_cls_epochs=0, refine_start_epoch=0, init_scale=0.5,
           use_fused_block=False, use_fused_layers=False,
           use_pallas_attention=False, lr=1e-3, lr_backbone=2e-4,
           lr_cls_head=5e-4, weight_decay=5e-2, clip_max_norm=0.1,
           focal_gamma=0.5, dataset_file="voc", device="cpu", max_size=64,
           fixed_size=True)
# the terms that are sums over the batch's images over the normaliser, or
# means over them: the processes' mean of each is the global batch's
SUMMED = ("loss_ce", "loss_bbox", "loss_giou", "cardinality_error",
          "img_label")


def _batch(rng, B=4, C=5):
    label = np.zeros((B, C), np.float32)
    label[:, 1] = 1
    label[0, 3] = label[2, 4] = 1
    label[np.arange(B), rng.integers(0, C, B)] = 1
    return {"images": rng.normal(size=(B, 64, 64, 3)).astype(np.float32),
            "img_label": label}


def test_two_process_step_matches_jax_num_devices_2(rng, tmp_path):
    cfg = SPEConfig(**CFG)
    jmodel = jax_build_model(cfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 64, 64, 3), jnp.float32))
    flat = flax.traverse_util.flatten_dict(params["params"])
    for k, v in flat.items():  # the zero-init last bbox layer hides the decoder
        if k[0].startswith("bbox_embed") and k[-1] == "kernel" and not np.any(v):
            flat[k] = jnp.asarray(0.1 * rng.normal(size=v.shape), jnp.float32)
    params = {"params": flax.traverse_util.unflatten_dict(flat)}
    batch = _batch(rng)
    tx = make_optimizer(cfg, steps_per_epoch=10, params=params)
    step = jax.jit(make_train_step(jmodel, cfg, tx, num_devices=2))
    jstate, m = jax.block_until_ready(step(
        JState(jnp.int32(0), params, tx.init(params), jnp.int32(0)),
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0), JGates.for_epoch(cfg, 0)))
    want = {k: float(v) for k, v in m.items()}
    before = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]), cfg)
    after = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params["params"]), cfg)

    torch.save({"cfg": CFG, "weights": before,
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}},
               tmp_path / "step.pt")
    _two_processes("step", tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in (0, 1)]
    got = [r["metrics"] for r in ranks]

    assert want["bad_steps"] == got[0]["bad_steps"] == got[1]["bad_steps"] == 0
    for k in ("loss", "grad_norm"):   # the processes' mean: global
        assert got[0][k] == got[1][k], k
        assert got[0][k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k
    assert max(g["match_iters"] for g in got) == want["match_iters"]
    assert sum(g["match_cleanup"] for g in got) == want["match_cleanup"] == 0
    terms = [k for k in want if any(s in k for s in SUMMED)]
    assert len(terms) >= 10, terms
    for k in terms:
        mean = (got[0][k] + got[1][k]) / 2
        assert mean == pytest.approx(want[k], rel=1e-4, abs=1e-6), k

    p0, p1 = ranks[0]["params"], ranks[1]["params"]
    assert set(p0) == set(after)
    moved = 0.0
    for name, w in after.items():
        assert torch.equal(p0[name], p1[name]), name
        diff = (p0[name] - w).abs()
        bad = diff > 5e-6 + 1e-4 * w.abs()
        assert not bad.any(), (name, float(diff[bad].max()))
        moved = max(moved, float((w - before[name]).abs().max()))
    assert moved > 1e-4   # the step moved the weights


# ------------------------------------------------------------------ the CLI

TINY = ["--device", "cpu", "--backbone", "TSCAM_cait_tiny", "--max_size",
        "64", "--layer_to_det", "2", "--enc_layers", "1", "--dec_layers", "2",
        "--dim_feedforward", "32", "--nheads", "2", "--num_queries", "12",
        "--compute_dtype", "float32", "--cam_cc_size", "16",
        "--max_gt_boxes", "6", "--hung_match_ratio", "3"]


def test_two_process_cli_trains_and_evaluates_voc(tmp_path):
    """One epoch of 8 mini-VOC images over 2 processes of 2 a batch: a step
    each, VOC eval on process 0; process 0 alone prints and writes log.txt
    and the checkpoints, the others' eval stats are {}."""
    devkit = write_mini_voc(tmp_path / "data", n_trainval=8, n_test=4,
                            img_size=64)
    out = tmp_path / "out"
    (tmp_path / "argv.json").write_text(json.dumps(
        ["--preset", "voc0712", "--dataset_file", "voc_voc", "--test_path",
         str(devkit), *TINY, "--batch_size", "2", "--warmup_cls_epochs", "0",
         "--refine_start_epoch", "0", "--epochs", "1",
         "--output_dir", str(out)]))
    outs = _two_processes("cli", tmp_path)
    assert "number of params" in outs[0] and "Start training" in outs[0]
    assert "number of params" not in outs[1] and "Epoch" not in outs[1]
    assert sorted(p.name for p in out.iterdir()) == [
        "checkpoint.pth", "checkpoint0000.pth", "checkpoint_best.pth",
        "log.txt"]
    (rec,) = [json.loads(line) for line in
              (out / "log.txt").read_text().splitlines()]
    assert rec["train_steps"] == 2     # 8 images / 2 processes / batch 2
    assert np.isfinite(rec["train_loss"]) and "test_mAP" in rec
    stats = [json.loads((tmp_path / f"stats{r}.json").read_text())
             for r in (0, 1)]
    assert stats[0]["mAP"] == rec["test_mAP"] and stats[1] == {}
    ckpt = torch.load(out / "checkpoint.pth", weights_only=False)
    assert ckpt["epoch"] == 0 and ckpt["optimizer"]["count"] == 2


def test_two_process_coco_eval_matches_one_process(tmp_path):
    """`--eval` of the coco17 preset on 8 mini-COCO images, one a batch (the
    eval losses are means over batches): 2 processes of 4 images each,
    merged, against one process over all 8; the weights of a checkpoint
    whose heads put detections on the data's classes."""
    from spe_tpu_torch.cli.main import main, parse_config
    from spe_tpu_torch.models.build import build_model

    coco = write_mini_coco(tmp_path / "data", n_train=0, n_val=8,
                           img_size=64)
    argv = ["--preset", "coco17", "--coco_path", str(coco), *TINY,
            "--batch_size", "1", "--eval"]
    model = build_model(parse_config(argv), "cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for r in range(2):
            model.bbox_embed[r].layers[-1].weight.normal_(0, 0.3,
                                                          generator=gen)
            model.class_embed[r].bias[:4] += 3.0
    torch.save({"model": model.state_dict()}, tmp_path / "heads.pth")
    argv += ["--resume", str(tmp_path / "heads.pth")]
    (tmp_path / "argv.json").write_text(json.dumps(
        argv + ["--output_dir", str(tmp_path / "out")]))
    _two_processes("cli", tmp_path)
    stats = [json.loads((tmp_path / f"stats{r}.json").read_text())
             for r in (0, 1)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = main(argv)
    finally:
        torch.set_num_threads(n)
    assert want.pop("forwards") == 16    # 8 images x 2 stages
    assert [s.pop("forwards") for s in stats] == [8, 8]
    assert want["AR100"] > 0, want      # some detection matched
    for s in stats:
        assert sorted(s) == sorted(want)
        for k, v in want.items():
            tol = dict(rel=1e-6) if k.startswith(("eval_", "stage0_eval",
                                                  "stage1_eval")) \
                else dict(abs=1e-9)
            assert s[k] == pytest.approx(v, **tol), k
    assert sorted(p.name for p in (tmp_path / "out" / "eval").iterdir()) == [
        "stage0_000.npz", "stage1_000.npz"]
