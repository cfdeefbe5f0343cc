"""The port's eval path against the JAX package: the small ops it runs
(position embeddings, pos-embed interpolation, CAM std-reweighting,
postprocess_topk, batched NMS) on the same numpy-seeded inputs, and
evaluate_voc on a generated mini-VOC with the same weights as the JAX
evaluate_voc (flax path). Plus the CLI's refusal of training."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spe_tpu.config import SPEConfig
from spe_tpu.data.loader import DataLoader
from spe_tpu.data.mini_data import make_mini_voc
from spe_tpu.data.transforms import FixedSizeTransform
from spe_tpu.data.voc import VOCDevkitDataset
from spe_tpu.models.cait import CaiTConfig, std_reweighting
from spe_tpu.models.detector import SPEDetector
from spe_tpu.models.layers import interpolate_pos_embed
from spe_tpu.ops import embeds as jembeds
from spe_tpu.ops.nms import batched_nms
from spe_tpu.ops.postprocess import postprocess_topk
from spe_tpu.train import engine as jengine
from spe_tpu_torch.models import cait as tcait
from spe_tpu_torch.models import detector as tdet
from spe_tpu_torch.models import layers as tlayers
from spe_tpu_torch.models.convert import state_dict_from_jax
from spe_tpu_torch.ops import embeds as tembeds
from spe_tpu_torch.ops import nms as tnms
from spe_tpu_torch.ops import postprocess as tpost
from spe_tpu_torch.train import engine as tengine


def _close(a, b, tol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def test_embeddings_and_interpolation(rng):
    mask = np.zeros((2, 5, 7), bool)
    mask[1, 3:] = True
    mask[1, :, 5:] = True
    _close(tembeds.position_embedding_sine(torch.from_numpy(mask), 16),
           jembeds.position_embedding_sine(jnp.asarray(mask), 16), 1e-5)
    pts = rng.uniform(size=(2, 9, 2)).astype(np.float32)
    _close(tembeds.gen_sineembed_for_position(torch.from_numpy(pts), 32),
           jembeds.gen_sineembed_for_position(jnp.asarray(pts), 32), 1e-5)
    x = rng.uniform(-0.1, 1.1, size=(3, 4)).astype(np.float32)
    _close(tembeds.inverse_sigmoid(torch.from_numpy(x)),
           jembeds.inverse_sigmoid(jnp.asarray(x)), 1e-5)
    # the recipe's pos-embed resize: 24x24 grid -> 32x32 (384 -> 512 px)
    pe = rng.normal(size=(1, 24 * 24, 8)).astype(np.float32)
    _close(tlayers.interpolate_pos_embed(torch.from_numpy(pe), (24, 24), (32, 32)),
           interpolate_pos_embed(jnp.asarray(pe), (24, 24), (32, 32)), 1e-5)
    cam = rng.uniform(size=(2, 4, 3, 16)).astype(np.float32)
    _close(tcait.std_reweighting(torch.from_numpy(cam)),
           std_reweighting(jnp.asarray(cam)), 1e-6)


def test_postprocess_and_nms(rng):
    B, Q, K = 2, 40, 6
    logits = rng.normal(size=(B, Q, K)).astype(np.float32)
    # clustered boxes so class-wise suppression chains actually happen
    centres = rng.uniform(0.2, 0.8, size=(B, 5, 2))
    cxcy = centres[:, rng.integers(0, 5, size=Q)] + 0.02 * rng.normal(size=(B, Q, 2))
    wh = rng.uniform(0.1, 0.3, size=(B, Q, 2))
    boxes = np.concatenate([cxcy, wh], -1).astype(np.float32)
    sizes = np.array([[480, 640], [375, 500]], np.int64)
    want = postprocess_topk(jnp.asarray(logits), jnp.asarray(boxes),
                            jnp.asarray(sizes).astype(jnp.float32),
                            keep_queries=60)
    got = tpost.postprocess_topk(torch.from_numpy(logits),
                                 torch.from_numpy(boxes),
                                 torch.from_numpy(sizes), keep_queries=60)
    _close(got["scores"], want["scores"])
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    _close(got["boxes"], want["boxes"], 1e-4)
    valid = np.ones((B, 60), bool)
    valid[0, -5:] = False
    keep_j = batched_nms(want["boxes"], want["scores"], want["labels"],
                         jnp.asarray(valid), 0.5)
    keep_t = tnms.batched_nms(got["boxes"], got["scores"], got["labels"],
                              torch.from_numpy(valid), 0.5)
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    assert 0 < keep_t.sum() < valid.sum()  # suppression happened


@pytest.fixture
def mini_voc(tmp_path):
    devkit, _ = make_mini_voc(tmp_path, n_trainval=0, n_test=4, img_size=64)
    ds = VOCDevkitDataset(devkit, [("VOC2007", "test")],
                          transform=FixedSizeTransform(64, train=False))
    loader = DataLoader(ds, batch_size=2, num_classes=20, fixed_size=64,
                        shuffle=False, drop_last=False)
    return devkit, ds, loader


def test_evaluate_voc_matches_jax(mini_voc):
    """Flip-TTA VOC eval, same weights: the port (fused flags on, so its
    plain fused-layer versions on the CPU) and the JAX flax path must find
    the same mAP and CorLoc."""
    _, ds, loader = mini_voc
    cfg = SPEConfig(num_classes=20, max_size=64, fixed_size=True,
                    num_queries=8, enc_layers=1, dec_layers=2,
                    dim_feedforward=32, nheads=2, num_refines=1,
                    compute_dtype="float32")
    bb = dict(img_size=64, patch_size=16, embed_dim=32, depth=3, num_heads=2,
              num_classes=20, layer_to_det=2, depth_token_only=2,
              init_scale=0.5)
    kw = dict(num_det_classes=21, num_queries=8, num_refines=1, enc_layers=1,
              dec_layers=2, dim_feedforward=32, nheads=2)
    jmodel = SPEDetector(backbone_cfg=CaiTConfig(**bb), **kw)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 64, 64, 3), jnp.float32))
    want = jengine.evaluate_voc(jmodel, params, loader, ds, cfg,
                                with_flip=True, keep=40)
    model = tdet.SPEDetector(tcait.CaiTConfig(**bb, use_fused_block=True),
                             use_fused_layers=True, **kw).eval()
    model.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"])))
    got = tengine.evaluate_voc(model, loader, ds, cfg, torch.device("cpu"),
                               with_flip=True, keep=40)
    assert got["forwards"] == 2
    for k in ("mAP", "CorLoc"):
        assert got[k] == pytest.approx(want[k], abs=1e-9), k


def test_flip_merge_semantics():
    out_n = {"pred_logits": torch.ones(1, 3, 4),
             "pred_boxes": torch.tensor([[[0.2, 0.5, 0.1, 0.1]] * 3])}
    out_f = {"pred_logits": torch.zeros(1, 3, 4),
             "pred_boxes": torch.tensor([[[0.7, 0.5, 0.1, 0.1]] * 3])}
    merged = tengine._flip_merge(out_n, out_f, {"x_logits": torch.zeros(1, 2)},
                                 {"x_logits": torch.ones(1, 2)})
    assert merged["pred_logits"].shape == (1, 6, 4)
    _close(merged["pred_boxes"][0, 3:, 0], np.full(3, 0.3), 1e-6)
    _close(merged["pred_boxes"][0, :3, 0], np.full(3, 0.2), 1e-6)
    _close(merged["x_logits"], np.ones((1, 2)))


def test_cli_eval_runs_and_training_refused(mini_voc):
    from spe_tpu_torch.cli.main import main, parse_config

    devkit = mini_voc[0]
    args = ["--preset", "voc0712", "--device", "cpu", "--test_path",
            str(devkit), "--backbone", "TSCAM_cait_tiny", "--max_size", "64",
            "--layer_to_det", "2", "--enc_layers", "1", "--dec_layers", "2",
            "--dim_feedforward", "32", "--nheads", "2", "--num_queries", "12",
            "--batch_size", "2", "--compute_dtype", "float32"]
    stats = main(args + ["--eval"])
    assert stats["forwards"] == 2 and 0.0 <= stats["mAP"] <= 1.0
    # training runs (test_cli_trains_checkpoints_and_resumes), --masks and
    # --frozen_weights too (test_torch_mask_training.py), tensor parallelism
    # too (test_torch_tp.py); what it has not ported, --masks under tensor
    # parallelism, is refused, and a model axis must divide the processes
    tp = ["--world_size", "2", "--model_axis", "2"]
    with pytest.raises(NotImplementedError, match="not ported"):
        main(args + tp + ["--masks"])
    with pytest.raises(ValueError, match="must divide"):
        main(args + ["--world_size", "3", "--model_axis", "2"])
    with pytest.raises(ValueError, match="use_fused_block"):
        parse_config(args + tp + ["--tp_attention"])
    cfg = parse_config(args + tp + ["--tp_attention", "--no_use_fused_block",
                                    "--no_use_fused_layers"])
    assert cfg.model_axis == 2 and cfg.tp_attention
    # distributed training and the matching-cost audit are ported
    # (test_torch_distributed.py, test_torch_match_cost.py)
    cfg = parse_config(args + ["--world_size", "2", "--log_match_cost"])
    assert cfg.world_size == 2 and cfg.log_match_cost


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    """Training through the CLI on the CPU (fused flags off, gates open):
    every step finite and matched, the weights move, a checkpoint per
    epoch and log.txt; --resume continues after the saved epoch from the
    saved weights and optimizer state."""
    from spe_tpu_torch.cli.main import main
    from spe_tpu_torch.data import write_mini_voc

    devkit = write_mini_voc(tmp_path / "voc", n_test=2, n_trainval=4,
                            img_size=64)
    out = tmp_path / "out"
    args = ["--preset", "voc0712", "--device", "cpu", "--dataset_file",
            "voc_voc", "--test_path", str(devkit), "--backbone",
            "TSCAM_cait_tiny", "--max_size", "64", "--layer_to_det", "2",
            "--enc_layers", "1", "--dec_layers", "2", "--dim_feedforward",
            "32", "--nheads", "2", "--num_queries", "12", "--batch_size", "2",
            "--compute_dtype", "float32", "--cam_cc_size", "16",
            "--no_use_fused_block", "--no_use_fused_layers",
            "--no_use_pallas_attention", "--warmup_cls_epochs", "0",
            "--refine_start_epoch", "0", "--output_dir", str(out)]
    first = main(args + ["--epochs", "1"])
    (ep,) = first["epochs"]
    assert ep["train"]["steps"] == 2 and first["state"].bad_steps == 0
    for h in ep["train"]["history"]:
        assert np.isfinite(h["loss"]) and h["match_cleanup"] == 0
        assert 0 < h["match_iters"] < 5000
    assert (out / "checkpoint0000.pth").exists()
    assert len((out / "log.txt").read_text().splitlines()) == 1
    saved = torch.load(out / "checkpoint.pth", weights_only=False)
    assert saved["epoch"] == 0 and saved["optimizer"]["count"] == 2

    second = main(args + ["--epochs", "2", "--resume",
                          str(out / "checkpoint.pth")])
    assert len(second["epochs"]) == 1
    assert second["state"].optimizer.count == 4
    fresh = main(args + ["--epochs", "1", "--output_dir", ""])
    moved = max(float((p - q).abs().max()) for p, q in zip(
        fresh["state"].model.state_dict().values(),
        saved["model"].values()))
    assert moved == 0.0  # same seed, same data: the same first epoch
    init = main(args + ["--epochs", "0", "--output_dir", ""])
    assert max(float((p - q).abs().max()) for p, q in zip(
        init["state"].model.state_dict().values(),
        saved["model"].values())) > 1e-4


def test_cli_resume_loads_reference_checkpoint(mini_voc, tmp_path):
    """--resume takes a reference-layout {'model': state_dict} .pth: the
    eval with the seed-0 weights saved and reloaded under another seed must
    reproduce the seed-0 eval."""
    from spe_tpu.config import config_from_args
    from spe_tpu_torch.cli.main import main
    from spe_tpu_torch.models.build import build_model

    args = ["--preset", "voc0712", "--eval", "--device", "cpu",
            "--test_path", str(mini_voc[0]), "--backbone", "TSCAM_cait_tiny",
            "--max_size", "64", "--layer_to_det", "2", "--enc_layers", "1",
            "--dec_layers", "2", "--dim_feedforward", "32", "--nheads", "2",
            "--num_queries", "12", "--batch_size", "2", "--compute_dtype",
            "float32", "--init_scale", "0.5"]
    model = build_model(config_from_args(args + ["--seed", "0"]))
    ckpt = tmp_path / "ref.pth"
    torch.save({"model": {f"module.{k}": v for k, v in
                          model.state_dict().items()}}, ckpt)
    want = main(args + ["--seed", "0"])
    other = main(args + ["--seed", "1"])
    got = main(args + ["--seed", "1", "--resume", str(ckpt)])
    assert got["mAP"] == want["mAP"] and got["CorLoc"] == want["CorLoc"]
    assert got["ap_per_class"] == want["ap_per_class"]
    assert other["ap_per_class"] != want["ap_per_class"]
