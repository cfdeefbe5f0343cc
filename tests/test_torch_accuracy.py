"""The port's accuracy runs (spe_tpu_torch.cli.accuracy) against the JAX
package's scripts/run_accuracy.py: the rehearsals on the CPU at a tiny size
(1 epoch, 64 px), the milestone check at its edges, rehearse-full's judging
of the arms' log records (one passing set, one set for each failure), and
the CLI argv of the rehearsals and of rehearse-full's arms equal to the
JAX script's apart from the port's --device and fused-off flags."""

import importlib.util
import json
import math
import subprocess
from pathlib import Path

import pytest
import torch

from spe_tpu_torch.cli import accuracy

REPO = Path(__file__).resolve().parent.parent


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "run_accuracy", REPO / "scripts" / "run_accuracy.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("task", ["rehearse", "rehearse-coco"])
def test_rehearsal_runs_on_the_cpu(tmp_path, one_thread, task):
    last = accuracy.main([task, "--workdir", str(tmp_path), "--epochs", "1",
                          "--img_size", "64", "--device", "cpu"])
    assert math.isfinite(last["train_loss"]) and last["epoch"] == 0
    key = "test_mAP" if task == "rehearse" else "test_stage1_AP50"
    assert key in last
    assert (tmp_path / "run" / "checkpoint_best.pth").exists()


@pytest.mark.parametrize("task", ["rehearse", "rehearse-coco"])
def test_rehearsal_argv_is_the_jax_scripts(tmp_path, monkeypatch, task):
    """The JAX script's argv (its CLI call captured before it runs) against
    the port's: the same but for --no_use_fused_block and
    --no_use_fused_layers, which the port adds (the rehearsal backbone lies
    outside the fused kernels' shapes)."""
    jax_script = _jax_script()
    seen = []

    def capture(argv):
        seen.append(argv)
        raise RuntimeError("captured")

    monkeypatch.setattr(jax_script, "_run_cli", capture)
    data = tmp_path / "minidata"
    (data / ("coco" if task == "rehearse-coco" else "VOCdevkit")).mkdir(
        parents=True)   # the data exist: nothing is generated
    args = type("Args", (), {"workdir": str(tmp_path), "output_dir": "x",
                             "epochs": 3})()
    with pytest.raises(RuntimeError, match="captured"):
        (jax_script.rehearse if task == "rehearse"
         else jax_script.rehearse_coco)(args)
    if task == "rehearse":
        data_args = ["--coco_path", str(data / "voc_coco"),
                     "--test_path", str(data / "VOCdevkit")]
        preset = "voc0712"
    else:
        data_args, preset = ["--coco_path", str(data / "coco")], "coco17"
    got = accuracy.rehearsal_argv(preset, data_args, tmp_path / "run", 3, 128)
    extra = ["--no_use_fused_block", "--no_use_fused_layers"]
    assert [a for a in got if a not in extra] == seen[0]
    assert all(a in got for a in extra)


def test_full_arms_argv_are_the_jax_scripts(tmp_path, monkeypatch):
    """rehearse-full's three arms: the JAX script's subprocess argv (captured,
    with log records that pass written in place of each run) against the
    port's full_arms, apart from the device arm's fused-off flags and the
    CPU arms' --device cpu."""
    jax_script = _jax_script()
    seen = {}

    def fake_run(cmd, env, cwd, check):
        argv = cmd[3:]
        out = Path(argv[argv.index("--output_dir") + 1])
        out.mkdir(parents=True)
        recs = [{"train_loss": 1.0, "test_mAP": 0.2, "test_CorLoc": 0.2,
                 "train_match_cleanup": 0.0, "train_match_subopt_mean": 0.0,
                 "train_match_subopt_max": 0.0} for _ in range(50)]
        (out / "log.txt").write_text("\n".join(json.dumps(r) for r in recs))
        seen[out.name[len("run_"):]] = argv

    monkeypatch.setattr(subprocess, "run", fake_run)
    data = tmp_path / "minidata"
    (data / "VOCdevkit").mkdir(parents=True)
    args = type("Args", (), {"workdir": str(tmp_path), "output_dir": "x",
                             "epochs": 2, "ab_tol_rel": 0.5})()
    jax_script.rehearse_full(args)
    arms = accuracy.full_arms(data, tmp_path, 2)
    assert [a[0] for a in arms] == list(seen)
    for name, solver, cpu, argv in arms:
        drop = ["--device", "cpu"] if cpu else accuracy.FUSED_OFF
        if cpu:
            assert argv[-2:] == drop
            argv = argv[:-2]
        else:
            assert argv[-3:] == drop
            argv = argv[:-3]
        assert argv == seen[name], name
        assert argv[argv.index("--assignment") + 1] == solver


@pytest.mark.parametrize("task, stats, ok", [
    ("voc", {"mAP": 0.50}, True),            # 50.0 >= 51.0 - 1.0
    ("voc", {"mAP": 0.4999}, False),
    ("voc", {}, False),                      # no mAP at all
    ("coco", {"AP50": 0.185, "AP": 0.069}, True),
    ("coco", {"AP50": 0.185, "AP": 0.0689}, False),
    ("coco", {"AP50": 0.1849, "AP": 0.10}, False),
])
def test_check_milestones_edges(task, stats, ok):
    if ok:
        accuracy.check_milestones(task, stats, tol=1.0)
    else:
        with pytest.raises(SystemExit, match="milestone check FAILED"):
            accuracy.check_milestones(task, stats, tol=1.0)


def _arm(epochs=50, best=0.2, final=0.1, subopt=1e-4, cleanup=0.0,
         loss=1.0, trace=True):
    recs = []
    for e in range(epochs):
        r = {"train_loss": loss if e == epochs - 1 else 1.0,
             "test_mAP": final if e == epochs - 1 else (best if e == 20
                                                        else 0.01),
             "test_CorLoc": 0.2, "train_match_cleanup": cleanup}
        if trace:
            r.update(train_match_subopt_mean=subopt,
                     train_match_subopt_max=2 * subopt)
        recs.append(r)
    return recs


def _arms(**changes):
    arms = {"auction_device": _arm(trace=False), "auction_cpu": _arm(),
            "hungarian_cpu": _arm(subopt=0.0)}
    for name, kw in changes.items():
        arms[name] = _arm(**kw)
    return arms


def test_judge_arms_passes():
    comparison, failures = accuracy.judge_arms(_arms(), 50)
    assert failures == []
    assert comparison["solver_final_mAP_delta"] == 0.0
    assert comparison["solver_delta_limit"] == pytest.approx(0.075)
    assert comparison["best_mAP"]["auction_cpu"] == 0.2
    assert comparison["match_subopt"]["auction_cpu"]["mean_over_epochs"] \
        == pytest.approx(1e-4)


@pytest.mark.parametrize("changes, says", [
    ({"auction_device": dict(best=0.11, trace=False)}, "learning floor"),
    ({"hungarian_cpu": dict(final=0.049, subopt=0.0)}, "learning floor"),
    # |0.3 - 0.1| = 0.2 > 0.5 x 0.3 + 0.025
    ({"auction_cpu": dict(best=0.3, final=0.3)}, "solver A/B"),
    ({"auction_cpu": dict(subopt=0.021)}, "eps guarantee band"),
    ({"auction_cpu": dict(cleanup=1.0)}, "cleanup activations"),
    ({"hungarian_cpu": dict(trace=False)}, "log_match_cost terms missing"),
    ({"auction_device": dict(epochs=49, trace=False)}, "49 epochs logged"),
    ({"auction_cpu": dict(loss=float("nan"))}, "non-finite train_loss"),
])
def test_judge_arms_fails(changes, says):
    _, failures = accuracy.judge_arms(_arms(**changes), 50)
    assert len(failures) == 1 and says in failures[0], failures
