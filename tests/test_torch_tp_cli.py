"""The port's CLI under tensor parallelism on the CPU, mirroring
tests/test_tp_cli.py, and its COCO eval of the datasets other than VOC
and COCO, as the JAX CLI routes them (spe_tpu/cli/main.py:86,184).

  * `--world_size 2 --model_axis 2 --tp_attention --use_pallas_attention`
    on 2 processes over gloo (tests/torch_procs.py): one epoch on the
    synthetic dataset and its COCO eval; process 0 alone writes log.txt
    and the checkpoints, which hold whole tensors: a one-process `--eval
    --resume` of checkpoint.pth gives the run's eval stats (AP/AR 1e-9,
    the eval losses 1e-6 relative);
  * `--model_axis 2 --use_fused_block` is refused by name, as the JAX CLI
    refuses it (test_cli_tp_refuses_fused_block);
  * `--eval --dataset_file synthetic --dataset_eval synthetic` against the
    JAX CLI's on the same weights (its init from --seed, carried over by
    state_dict_from_jax): every stage's COCO AP/AR within 1e-9, the eval
    losses 1e-4 relative; voc, voc12 and coco_panoptic are taken too.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spe_tpu_torch.models.convert import state_dict_from_jax
from torch_procs import run

ARGS = ["--dataset_file", "synthetic", "--dataset_eval", "synthetic",
        "--backbone", "TSCAM_cait_tiny", "--layer_to_det", "3",
        "--num_classes", "5", "--num_queries", "12",
        "--enc_layers", "1", "--dec_layers", "2", "--dim_feedforward", "64",
        "--nheads", "2", "--num_refines", "1", "--max_gt_boxes", "6",
        "--cam_cc_size", "16", "--hung_match_ratio", "3",
        "--compute_dtype", "float32", "--dropout", "0.0",
        "--max_size", "64", "--fixed_size", "--num_workers", "1"]
PORT = ["--device", "cpu", "--batch_size", "8"]

WORKER = r"""
from spe_tpu_torch.cli.main import main
argv = json.load(open(f"{tmp}/argv.json")) + ["--world_size", str(world),
                                              "--dist_url", url]
res = main(argv)
json.dump(res["epochs"][-1]["eval"], open(f"{tmp}/stats{rank}.json", "w"))
print(f"WORKER DONE rank={rank}", flush=True)
"""


def test_cli_tp_train_and_eval(tmp_path):
    from spe_tpu_torch.cli.main import main

    out = tmp_path / "tp_run"
    # 80 x 80 images: the boxes of the barely trained bbox heads (half the
    # image a side) lie off the COCO area bounds, where the sums' order
    # could move a box across one
    args = ARGS + ["--max_size", "80"]
    argv = args + PORT + ["--epochs", "1", "--model_axis", "2",
                          "--tp_attention", "--use_pallas_attention",
                          "--output_dir", str(out)]
    (tmp_path / "argv.json").write_text(json.dumps(argv))
    outs = run(WORKER, "cli", 2, tmp_path)
    assert "number of params" in outs[0] and "Epoch" not in outs[1]
    rec = json.loads((out / "log.txt").read_text().strip().splitlines()[-1])
    assert rec["train_steps"] == 32     # 256 images, batch 8, one data rank
    assert np.isfinite(rec["train_loss"]) and "test_AP50" in rec
    stats = [json.loads((tmp_path / f"stats{r}.json").read_text())
             for r in (0, 1)]
    assert stats[0] == stats[1]          # the model ranks evaluate alike
    assert sorted(p.name for p in out.iterdir()) == [
        "checkpoint.pth", "checkpoint0000.pth", "checkpoint_best.pth",
        "eval", "log.txt"]
    # whole tensors: one process evaluates the checkpoint as the group did
    ckpt = torch.load(out / "checkpoint.pth", weights_only=False)
    assert ckpt["model"]["transformer.encoder.layers.0.linear1.weight"] \
        .shape == (64, 32)
    one = main(args + PORT + ["--eval", "--resume",
                              str(out / "checkpoint.pth")])
    for k, v in stats[0].items():   # the losses: the sums' order differs
        tol = dict(rel=1e-6) if "eval_" in k else dict(abs=1e-9)
        if isinstance(v, float):
            assert one[k] == pytest.approx(v, **tol), k


def test_cli_tp_refuses_fused_block(tmp_path):
    from spe_tpu_torch.cli.main import main

    with pytest.raises(ValueError, match="use_fused_block"):
        main(ARGS + PORT + ["--epochs", "1", "--world_size", "2",
                            "--model_axis", "2", "--use_fused_block",
                            "--output_dir", str(tmp_path / "refuse")])


def test_cli_eval_routes_synthetic_to_coco_like_jax(tmp_path, monkeypatch):
    from spe_tpu.cli.main import main as jax_main
    from spe_tpu.config import config_from_args
    from spe_tpu.models.build import build_model as jax_build_model
    from spe_tpu.models.detector import SPEDetector
    from spe_tpu_torch.cli.main import main, parse_config

    # the JAX CLI's init with its last bbox layers drawn: at their zero
    # init every box is half the image a side, 32 x 32 here, on the COCO
    # small/medium area bound, where f32 roundoff decides APs
    init = SPEDetector.init

    def drawn(self, *a, **kw):
        params = init(self, *a, **kw)
        inner = dict(params["params"])
        for r in range(self.num_refines + 1):
            head = dict(inner[f"bbox_embed_{r}"])
            last = max(k for k in head if k.startswith("layers_"))
            w = head[last]["kernel"]
            head[last] = {**head[last], "kernel": 0.3 * jax.random.normal(
                jax.random.PRNGKey(7 + r), w.shape, w.dtype)}
            inner[f"bbox_embed_{r}"] = head
        return {**params, "params": inner}

    monkeypatch.setattr(SPEDetector, "init", drawn)
    # the JAX CLI's batch is --batch_size a device (8 virtual devices)
    want = jax_main(ARGS + ["--eval", "--batch_size", "1"])
    jcfg = config_from_args(ARGS)
    params = jax_build_model(jcfg).init(
        jax.random.PRNGKey(jcfg.seed), jnp.zeros((1, 64, 64, 3), jnp.float32))
    torch.save({"model": state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, params["params"]))}, tmp_path / "jax_init.pth")
    got = main(ARGS + PORT + ["--eval", "--resume",
                              str(tmp_path / "jax_init.pth")])
    stages = [k for k in want if k.startswith("stage1_")]
    assert stages and got["forwards"] == 2 * 8   # 64 images, 2 stages
    assert want["stage0_AR100"] > 0
    for k, v in want.items():
        tol = dict(rel=1e-4) if "eval_" in k else dict(abs=1e-9)
        assert got[k] == pytest.approx(float(v), **tol), k
    for other in ("voc", "voc12", "coco_panoptic"):
        assert parse_config(ARGS + ["--dataset_eval", other]) \
            .dataset_eval == other
