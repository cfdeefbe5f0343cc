"""The port's COCO path against the JAX package: the numpy COCO evaluator
(spe_tpu_torch.data.coco_eval) on the same detections, the loader's GT
arrays (collate max_gt), evaluate_coco on a generated 90-class mini-COCO
with the same weights as the JAX evaluate_coco (flax path), and the CLI on
the coco17 preset at a tiny size (per-stage stats, eval/ artifacts, the
best checkpoint by AP50, --eval --resume).

Tolerances: the evaluators are the same numpy on the same detections, so
their stats and arrays are equal exactly; evaluate_coco's AP/AR within
1e-9 (the detections of the two frameworks differ by f32 roundoff, which
moves no score order or IoU threshold here) and its eval losses within
1e-4 relative (f32 sums in other orders)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spe_tpu.config import SPEConfig
from spe_tpu.data import coco_eval as jcoco_eval
from spe_tpu.data import loader as jloader
from spe_tpu.data.coco import CocoFormatDataset as JCocoDataset
from spe_tpu.data.transforms import FixedSizeTransform as JFixedSize
from spe_tpu.models.cait import CaiTConfig
from spe_tpu.models.detector import SPEDetector
from spe_tpu.train import engine as jengine
from spe_tpu_torch.data import coco_eval as tcoco_eval
from spe_tpu_torch.data import loader as tloader
from spe_tpu_torch.data import write_mini_coco, write_mini_coco_panoptic
from spe_tpu_torch.data.coco import CocoFormatDataset as TCocoDataset
from spe_tpu_torch.data.transforms import FixedSizeTransform as TFixedSize
from spe_tpu_torch.models import cait as tcait
from spe_tpu_torch.models import detector as tdet
from spe_tpu_torch.models.convert import state_dict_from_jax
from spe_tpu_torch.train import engine as tengine


def _gt_and_detections(rng, n_img=6, n_cat=5):
    """A COCO ground truth over 640 x 480 images with boxes of every area
    range, crowd boxes and an image without any box; detections near the
    boxes and at random, 120 of one category on one image (past maxDets
    100) -> (gt dict, [detections of each half of the images])."""
    images = [{"id": i + 1, "width": 640, "height": 480} for i in range(n_img)]
    cats = [{"id": c + 1, "name": f"c{c}"} for c in range(n_cat)]
    anns, dets = [], [[], []]
    side = {0: (8, 30), 1: (34, 94), 2: (100, 300)}   # small, medium, large
    for im in images[:-1]:                            # the last has none
        for _ in range(int(rng.integers(2, 7))):
            lo, hi = side[int(rng.integers(0, 3))]
            w, h = rng.uniform(lo, hi, size=2)
            x, y = rng.uniform(0, 640 - w), rng.uniform(0, 480 - h)
            anns.append({"id": len(anns) + 1, "image_id": im["id"],
                         "category_id": int(rng.integers(1, n_cat + 1)),
                         "bbox": [x, y, w, h], "area": float(w * h),
                         "iscrowd": int(rng.uniform() < 0.15)})
    for a in anns:
        half = dets[int(a["image_id"] > n_img // 2)]
        for _ in range(int(rng.integers(0, 4))):
            x, y, w, h = np.asarray(a["bbox"]) * rng.uniform(0.8, 1.2, 4)
            half.append({"image_id": a["image_id"],
                         "category_id": a["category_id"]
                         if rng.uniform() < 0.8 else int(rng.integers(1, n_cat + 1)),
                         "bbox": [x, y, w, h], "score": float(rng.uniform())})
    for im in images:
        n = 120 if im["id"] == 2 else int(rng.integers(5, 40))
        for _ in range(n):
            w, h = rng.uniform(5, 200, size=2)
            dets[int(im["id"] > n_img // 2)].append({
                "image_id": im["id"],
                "category_id": 1 if im["id"] == 2 else int(rng.integers(1, n_cat + 1)),
                "bbox": [rng.uniform(0, 600), rng.uniform(0, 440), w, h],
                "score": float(rng.uniform())})
    return {"images": images, "annotations": anns, "categories": cats}, dets


@pytest.mark.parametrize("merged", [False, True], ids=["one", "merged"])
def test_coco_evaluator_matches_jax(rng, tmp_path, merged):
    """The same detections through both evaluators: summarize() equal key
    for key and the saved precision/recall arrays equal, exactly; the
    merged case splits the detections over two evaluators and merges."""
    gt, dets = _gt_and_detections(rng)
    assert any(a["iscrowd"] for a in gt["annotations"])
    out = {}
    for name, mod in (("jax", jcoco_eval), ("port", tcoco_eval)):
        ev = mod.CocoEvaluator(gt)
        if merged:
            other = mod.CocoEvaluator(gt)
            ev.update(dets[0])
            other.update(dets[1])
            ev.merge(other)
        else:
            ev.update(dets[0] + dets[1])
        ev.save_eval(tmp_path / f"{name}.npz")
        out[name] = (ev.summarize(), np.load(tmp_path / f"{name}.npz"))
    (want, want_arr), (got, got_arr) = out["jax"], out["port"]
    assert got == want
    assert all(want[k] > -1 for k in ("APs", "APm", "APl")), want
    assert sorted(got_arr.files) == sorted(want_arr.files)
    for k in want_arr.files:
        np.testing.assert_array_equal(got_arr[k], want_arr[k])


def test_update_from_arrays_matches_jax(rng):
    """The device-friendly entry: (B, N) arrays with a valid mask."""
    gt, _ = _gt_and_detections(rng, n_img=4)
    ids = np.array([1, 2, 3, 4])
    x0 = rng.uniform(0, 400, size=(4, 30, 2))
    boxes = np.concatenate([x0, x0 + rng.uniform(5, 200, size=(4, 30, 2))],
                           -1).astype(np.float32)
    scores = rng.uniform(size=(4, 30)).astype(np.float32)
    labels = rng.integers(1, 6, size=(4, 30))
    valid = rng.uniform(size=(4, 30)) < 0.7
    stats = []
    for mod in (jcoco_eval, tcoco_eval):
        ev = mod.CocoEvaluator(gt)
        ev.update_from_arrays(ids, boxes, scores, labels, valid)
        stats.append(ev.summarize())
    assert stats[1] == stats[0]


def _samples(rng):
    """(image, target) pairs: 3, 0 (an empty image) and 9 boxes."""
    out = []
    for i, n in enumerate((3, 0, 9)):
        h, w = 48 + 16 * i, 64
        xy = rng.uniform(0, 30, size=(n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(2, 30, size=(n, 2))],
                               -1).astype(np.float32)
        out.append((rng.normal(size=(h, w, 3)).astype(np.float32),
                    {"boxes": boxes, "labels": rng.integers(1, 91, size=n),
                     "img_label": np.zeros(90, np.float32), "image_id": i,
                     "orig_size": np.array([h * 2, w * 2]),
                     "size": np.array([h, w])}))
    return out


@pytest.mark.parametrize("fixed", [None, 96], ids=["padded", "fixed"])
def test_collate_max_gt_matches_jax(rng, fixed):
    """collate(max_gt=6): the GT arrays (normalised cxcywh, the w = h =
    1e-3 padding, labels, mask; 9 boxes truncated to 6; an empty image)
    and every other array equal to the JAX package's."""
    samples = _samples(rng)
    want = jloader.collate(samples, 90, fixed_size=fixed, max_gt=6)
    got = tloader.collate(samples, 90, fixed_size=fixed, max_gt=6)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["gt_mask"].sum(1).tolist() == [3, 0, 6]
    assert (got["gt_boxes"][1, :, 2:] == np.float32(1e-3)).all()


@pytest.fixture
def mini_coco(tmp_path):
    root = write_mini_coco(tmp_path, n_val=4, img_size=64, num_classes=3,
                           seed=2)
    ann = root / "annotations" / "instances_val2017.json"
    return root, ann, json.loads(ann.read_text())


def test_evaluate_coco_matches_jax(mini_coco):
    """Both refinement stages of a tiny 90-class detector, same weights
    (the last bbox layer drawn, so the boxes see the decoder): the port
    (fused flags on, so its plain fused-layer versions on the CPU) and the
    JAX flax path find the same AP/AR and eval losses."""
    root, ann, gt = mini_coco
    cfg = SPEConfig(num_classes=90, dataset_file="coco", max_size=64,
                    fixed_size=True, num_queries=8, enc_layers=1,
                    dec_layers=2, dim_feedforward=32, nheads=2,
                    num_refines=1, max_gt_boxes=6, compute_dtype="float32")
    bb = dict(img_size=64, patch_size=16, embed_dim=32, depth=3, num_heads=2,
              num_classes=90, layer_to_det=2, depth_token_only=2,
              init_scale=0.5)
    kw = dict(num_det_classes=91, num_queries=8, num_refines=1, enc_layers=1,
              dec_layers=2, dim_feedforward=32, nheads=2)
    jmodel = SPEDetector(backbone_cfg=CaiTConfig(**bb), **kw)
    params = jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))()
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(3)
    for r in range(2):
        head = params["params"][f"bbox_embed_{r}"]
        last = sorted(k for k in head if k.startswith("layers_"))[-1]
        head[last]["kernel"] = (0.3 * rng.normal(
            size=head[last]["kernel"].shape)).astype(np.float32)
        # the data's 3 classes lead the top 100, so detections match
        cls = params["params"][f"class_embed_{r}"]
        cls["bias"] = cls["bias"] + np.where(np.arange(91) < 4, 3.0,
                                             0.0).astype(np.float32)

    def loader(mod, ds):
        return mod.DataLoader(ds, batch_size=2, num_classes=90, fixed_size=64,
                              shuffle=False, drop_last=False, max_gt=6)

    jl = loader(jloader, JCocoDataset(root / "val2017", ann,
                                      transform=JFixedSize(64, train=False),
                                      remove_empty=False))
    tl = loader(tloader, TCocoDataset(root / "val2017", ann,
                                      transform=TFixedSize(64, train=False),
                                      remove_empty=False))
    model = tdet.SPEDetector(tcait.CaiTConfig(**bb, use_fused_block=True),
                             use_fused_layers=True, **kw).eval()
    model.load_state_dict(state_dict_from_jax(params["params"]))
    n = torch.get_num_threads()
    torch.set_num_threads(1)   # the plain auction: many small ops
    try:
        for stage in (0, 1):
            want = jengine.evaluate_coco(jmodel, params, jl, gt, cfg,
                                         refine_stage=stage)
            got = tengine.evaluate_coco(model, tl, gt, cfg,
                                        torch.device("cpu"),
                                        refine_stage=stage)
            assert got.pop("forwards") == 2
            assert sorted(got) == sorted(want)
            losses = [k for k in want if k.startswith("eval_")]
            assert len(losses) == 4, sorted(want)
            for k in want:
                tol = dict(rel=1e-4) if k in losses else dict(abs=1e-9)
                assert got[k] == pytest.approx(want[k], **tol), (stage, k)
            assert want["AR100"] > 0, want   # some detection matched
    finally:
        torch.set_num_threads(n)


TINY = ["--device", "cpu", "--backbone", "TSCAM_cait_tiny", "--max_size",
        "64", "--layer_to_det", "2", "--enc_layers", "1", "--dec_layers", "2",
        "--dim_feedforward", "32", "--nheads", "2", "--num_queries", "12",
        "--batch_size", "2", "--compute_dtype", "float32", "--cam_cc_size",
        "16", "--max_gt_boxes", "6", "--hung_match_ratio", "3"]


def test_cli_coco17_trains_evaluates_and_resumes(tmp_path):
    """`--preset coco17` at a tiny size on the CPU (every fused flag as the
    preset sets it, the gates open): two epochs, each evaluated on both
    stages into log.txt and eval/stage{s}_{epoch}.npz; checkpoint_best is
    the epoch of the best AP50; `--eval --resume` of it reproduces that
    epoch's stats; --dataset_eval coco_panoptic, without a COCO ground
    truth, is refused by name."""
    from spe_tpu_torch.cli.main import main

    coco = write_mini_coco(tmp_path / "data", n_train=4, n_val=4,
                           img_size=64)
    out = tmp_path / "out"
    args = ["--preset", "coco17", "--coco_path", str(coco), *TINY]
    res = main(args + ["--warmup_cls_epochs", "0", "--refine_start_epoch",
                       "0", "--epochs", "2", "--output_dir", str(out)])
    assert [e["train"]["steps"] for e in res["epochs"]] == [2, 2]
    recs = [json.loads(line) for line in
            (out / "log.txt").read_text().splitlines()]
    assert [r["epoch"] for r in recs] == [0, 1]
    for r, e in zip(recs, res["epochs"]):
        assert r["test_forwards"] == 4        # 2 batches x 2 stages
        for k in ("AP50", "stage0_AP50", "stage1_AP50", "AR100",
                  "eval_loss_ce", "stage1_eval_loss_giou"):
            assert r[f"test_{k}"] == e["eval"][k], k
            assert np.isfinite(r[f"test_{k}"]), k
        assert r["test_AP"] == r["test_stage0_AP"]
        for k in ("AP", "AP50", "AR1", "AR100", "APs", "ARl"):
            assert r[f"test_{k}"] == -1 or 0 <= r[f"test_{k}"] <= 1, k
    assert sorted(p.name for p in (out / "eval").iterdir()) == [
        "stage0_000.npz", "stage0_001.npz", "stage1_000.npz",
        "stage1_001.npz"]
    with np.load(out / "eval" / "stage1_001.npz") as z:
        assert z["precision"].shape == (10, 101, 90, 4, 3)
    ap50 = [r["test_AP50"] for r in recs]
    best = torch.load(out / "checkpoint_best.pth", weights_only=False)
    assert best["epoch"] == int(np.argmax(ap50))

    again = main(args + ["--eval", "--resume", str(out / "checkpoint_best.pth"),
                         "--output_dir", str(tmp_path / "eval_out")])
    want = recs[best["epoch"]]
    for k, v in again.items():
        if k != "forwards":
            assert v == pytest.approx(want[f"test_{k}"], abs=1e-9), k
    assert (tmp_path / "eval_out" / "eval" / "stage1_000.npz").exists()
    # the JAX CLI routes coco_panoptic to its COCO eval too, which reads a
    # COCO ground truth the panoptic dataset does not have
    pan = write_mini_coco_panoptic(coco)
    with pytest.raises(NotImplementedError, match="coco_panoptic"):
        main(args + ["--eval", "--dataset_eval", "coco_panoptic",
                     "--coco_panoptic_path", str(pan)])
