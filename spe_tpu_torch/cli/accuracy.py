"""The port's accuracy runs (port of scripts/run_accuracy.py): the
published recipes through the port's CLI with their milestones, and the
no-data rehearsals on generated mini datasets.

  # VOC / COCO: the recipe; with --eval, assert the published milestones
  # (reference README.md:18-20: VOC0712 mAP 51.0, COCO AP 7.9 / AP50 19.5)
  python -m spe_tpu_torch.cli.accuracy voc --coco_path <voc_coco> \\
      --test_path <VOCdevkit> --backbone_weights <local .pth> \\
      --output_dir runs/voc0712
  python -m spe_tpu_torch.cli.accuracy coco --coco_path <COCO2017> \\
      --backbone_weights <local .pth> --output_dir runs/coco17
  python -m spe_tpu_torch.cli.accuracy voc --eval \\
      --resume runs/voc0712/checkpoint_best.pth --coco_path ... [--tol 1.0]

  # rehearsals: a generated mini VOC (or COCO2017) layout through the same
  # path, convert -> train -> per-epoch eval -> log.txt -> checkpoints
  python -m spe_tpu_torch.cli.accuracy rehearse [--workdir DIR] [--epochs 2]
  python -m spe_tpu_torch.cli.accuracy rehearse-coco [--workdir DIR]

  # the full 50-epoch schedule and the solver A/B -> solver_ab.json: the
  # auction on the card, the auction and the exact solver on the CPU, the
  # CPU arms with --log_match_cost
  python -m spe_tpu_torch.cli.accuracy rehearse-full [--workdir DIR]

Arguments this module does not know go to the CLI (e.g. `--device cpu`, or
`--batch_size 4` to a recipe). The rehearsal backbones (TSCAM_cait_tiny,
D=32, and TSCAM_cait_mini, D=64) lie outside the fused kernels' shapes, so
the rehearsals run with --no_use_fused_block --no_use_fused_layers
--no_use_pallas_attention: on the card their kernels are connected
components and the auction. Nothing is downloaded: --backbone_weights names
a local file.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from pathlib import Path

PUBLISHED = {"voc": {"mAP": 51.0}, "coco": {"AP50": 19.5, "AP": 7.9}}
REPO = Path(__file__).resolve().parents[2]
# the rehearsal backbones lie outside the fused kernels' shapes
FUSED_OFF = ["--no_use_pallas_attention", "--no_use_fused_block",
             "--no_use_fused_layers"]
# the learning floors and the auction's cost band of rehearse-full
FLOOR = {"best": 0.12, "final": 0.05}
SUBOPT_BAND = 2e-2


def run_cli(argv):
    from spe_tpu_torch.cli.main import main

    print("+ spe_tpu_torch.cli.main " + " ".join(argv), flush=True)
    return main(argv)


def run_recipe(task: str, args, extra):
    preset = "voc0712" if task == "voc" else "coco17"
    argv = ["--preset", preset, "--output_dir", args.output_dir]
    for flag in ("coco_path", "test_path", "backbone_weights", "resume"):
        if getattr(args, flag):
            argv += [f"--{flag}", getattr(args, flag)]
    if args.eval:
        argv += ["--eval"]
    result = run_cli(argv + extra)
    if args.eval:
        check_milestones(task, result, args.tol)
    return result


def check_milestones(task: str, stats: dict, tol: float):
    """Each published number of the task (percent) against the stats (in
    [0, 1]) less tol; SystemExit listing the misses."""
    failures = []
    for key, target in PUBLISHED[task].items():
        got = float(stats.get(key, float("nan"))) * 100.0
        if not got >= target - tol:
            failures.append(f"{key}: got {got:.2f}, want >= {target} - {tol}")
        else:
            print(f"MILESTONE OK  {key}: {got:.2f} (published {target}, "
                  f"tol {tol})")
    if failures:
        raise SystemExit("published-milestone check FAILED:\n  "
                         + "\n  ".join(failures))


def rehearsal_argv(preset: str, data_args, out, epochs: int, img_size: int):
    """The rehearsals' CLI argv (scripts/run_accuracy.py:97-143, :317-365):
    the recipe shrunk to TSCAM_cait_tiny, every other knob published."""
    return ["--preset", preset, *data_args, "--output_dir", str(out),
            "--backbone", "TSCAM_cait_tiny", "--layer_to_det", "3",
            "--enc_layers", "1", "--dec_layers", "2",
            "--dim_feedforward", "64", "--nheads", "2",
            "--num_queries", "12", "--max_gt_boxes", "6",
            "--cam_cc_size", "16", "--hung_match_ratio", "3",
            "--max_size", str(img_size), "--batch_size", "2",
            "--epochs", str(epochs),
            "--warmup_cls_epochs", "0", "--refine_start_epoch", "1",
            "--dropout", "0.0", "--backbone_drop_rate", "0.0",
            "--drop_path_rate", "0.0", "--drop_attn_rate", "0.0",
            *FUSED_OFF]


def _records(out, epochs):
    log = out / "log.txt"
    assert log.exists(), "the CLI did not write log.txt"
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert len(recs) == epochs, (len(recs), epochs)
    assert math.isfinite(recs[-1]["train_loss"]), recs[-1]["train_loss"]
    return recs


def rehearse(args, extra=()):
    """The VOC recipe's path on a generated mini VOCdevkit (24 trainval, 12
    test images) and its COCO-format jsons: the CLI, log.txt, the
    checkpoints."""
    from spe_tpu_torch.data.mini_data import make_mini_voc

    work = Path(args.workdir or Path(args.output_dir) / "rehearsal")
    data, out = work / "minidata", work / "run"
    if not (data / "VOCdevkit").exists():
        print(f"generating a mini VOCdevkit and COCO-format jsons in {data}")
        make_mini_voc(data, n_trainval=24, n_test=12, img_size=args.img_size)
    run_cli(rehearsal_argv(
        "voc0712", ["--coco_path", str(data / "voc_coco"),
                    "--test_path", str(data / "VOCdevkit")],
        out, args.epochs, args.img_size) + list(extra))
    recs = _records(out, args.epochs)
    last = recs[-1]
    assert "test_mAP" in last and "test_CorLoc" in last, sorted(last)
    for name in ("checkpoint.pth", "checkpoint_best.pth"):
        assert (out / name).exists(), f"no {name}"
    print(f"REHEARSAL OK  epochs={len(recs)} "
          f"train_loss={last['train_loss']:.3f} mAP={last['test_mAP']:.4f} "
          f"CorLoc={last['test_CorLoc']:.4f}  ({out})")
    return last


def rehearse_coco(args, extra=()):
    """The coco17 recipe's path on a generated mini COCO2017 layout (24
    train, 12 val images): per-stage eval, eval/ arrays, the best-AP50
    checkpoint."""
    from spe_tpu_torch.data.mini_data import make_mini_coco

    work = Path(args.workdir or Path(args.output_dir) / "rehearsal_coco")
    data, out = work / "minidata", work / "run"
    if not (data / "coco").exists():
        print(f"generating a mini COCO2017 layout in {data}")
        make_mini_coco(data, n_train=24, n_val=12, img_size=args.img_size)
    run_cli(rehearsal_argv("coco17", ["--coco_path", str(data / "coco")],
                           out, args.epochs, args.img_size) + list(extra))
    recs = _records(out, args.epochs)
    last = recs[-1]
    assert "test_AP50" in last and "test_stage1_AP50" in last, sorted(last)
    assert (out / "checkpoint_best.pth").exists(), "no checkpoint_best.pth"
    assert list((out / "eval").glob("stage*_*.npz")), "no eval/ arrays"
    print(f"COCO REHEARSAL OK  epochs={len(recs)} "
          f"train_loss={last['train_loss']:.3f} "
          f"AP50={last['test_AP50']:.4f}  ({out})")
    return last


def full_schedule(epochs_arg: int):
    """-> (epochs, boundaries): 50 epochs unless more are asked for, the
    warmup at 7 (published), refine, cam_thr drop and lr drop at 2/5, 1/2
    and 4/5 of them (scripts/run_accuracy.py:213-221)."""
    epochs = 50 if epochs_arg <= 10 else int(epochs_arg)
    return epochs, {"warmup": 7, "refine": max(epochs * 2 // 5, 2),
                    "cam_thr_drop": epochs // 2, "lr_drop": epochs * 4 // 5}


def full_arms(data, work, epochs_arg: int = 2):
    """-> [(arm, solver, on the CPU, CLI argv)] of rehearse-full: the JAX
    script's argv (scripts/run_accuracy.py:223-272), the device arm with
    FUSED_OFF and the CPU arms with --device cpu besides."""
    epochs, sched = full_schedule(epochs_arg)
    schedule = ["--warmup_cls_epochs", str(sched["warmup"]),
                "--refine_start_epoch", str(sched["refine"]),
                "--cam_thr_drop_epoch", str(sched["cam_thr_drop"]),
                "--lr_drop", str(sched["lr_drop"]),
                "--epochs", str(epochs)]
    arms = []
    for name, solver, cpu in (("auction_device", "auction", False),
                              ("auction_cpu", "auction", True),
                              ("hungarian_cpu", "hungarian_cpu", True)):
        argv = [
            "--preset", "voc0712",
            "--coco_path", str(data / "voc_coco"),
            "--test_path", str(data / "VOCdevkit"),
            "--output_dir", str(work / f"run_{name}"),
            "--assignment", solver,
            "--backbone", "TSCAM_cait_mini", "--layer_to_det", "4",
            "--enc_layers", "1", "--dec_layers", "2",
            "--dim_feedforward", "128", "--nheads", "2",
            "--num_queries", "12", "--max_gt_boxes", "6",
            "--cam_cc_size", "16", "--hung_match_ratio", "3",
            "--max_size", "128", "--batch_size", "4",
            "--dropout", "0.0", "--backbone_drop_rate", "0.0",
            "--drop_path_rate", "0.0", "--drop_attn_rate", "0.0",
            "--lr", "1e-3", "--lr_backbone", "1e-3", "--lr_cls_head", "1e-3",
            "--init_scale", "1.0",
        ] + schedule
        argv += FUSED_OFF + (["--log_match_cost", "--device", "cpu"]
                             if cpu else [])
        arms.append((name, solver, cpu, argv))
    return arms


def judge_arms(results, epochs: int, ab_tol_rel: float = 0.5):
    """The arms' log.txt records {arm: [record an epoch]} -> (the
    comparison written to solver_ab.json, the failures). Each arm: every
    epoch logged with a finite loss; the auction arms without a cleanup
    activation; the CPU arms with the cost trace; best mAP >= 0.12 and final
    mAP >= 0.05. Across them: |auction_cpu - hungarian_cpu| final mAP
    within ab_tol_rel of the better arm + 0.025 (one object of the 20-image
    mini test set), and auction_cpu's mean realized-cost gap within the
    auction's eps band, 2e-2 (scripts/run_accuracy.py:274-314)."""
    failures = []
    for name, recs in results.items():
        if len(recs) != epochs:
            failures.append(f"{name}: {len(recs)} epochs logged of {epochs}")
        if not all(math.isfinite(r["train_loss"]) for r in recs):
            failures.append(f"{name}: a non-finite train_loss")
        if name.startswith("auction"):
            bad = [r["train_match_cleanup"] for r in recs
                   if r.get("train_match_cleanup", 0.0) > 0]
            if bad:
                failures.append(f"{name}: auction cleanup activations {bad}")
        if name.endswith("_cpu") and not (
                recs and "train_match_subopt_mean" in recs[-1]):
            failures.append(f"{name}: --log_match_cost terms missing from "
                            "log.txt")
    keys = ("train_loss", "test_mAP", "test_CorLoc")
    last = {n: {k: r[-1][k] for k in keys} for n, r in results.items()}
    best = {n: max(r["test_mAP"] for r in recs) for n, recs in results.items()}
    subopt = {n: {
        "mean_over_epochs": sum(r.get("train_match_subopt_mean", 0.0)
                                for r in recs) / len(recs),
        "max_over_epochs": max(r.get("train_match_subopt_max", 0.0)
                               for r in recs),
    } for n, recs in results.items()}
    final = {n: last[n]["test_mAP"] for n in last}
    ab_delta = abs(final["auction_cpu"] - final["hungarian_cpu"])
    ab_limit = ab_tol_rel * max(final["auction_cpu"],
                                final["hungarian_cpu"]) + 0.025
    comparison = {
        **last, "best_mAP": best, "learning_floor": FLOOR,
        "solver_final_mAP_delta": ab_delta, "solver_delta_limit": ab_limit,
        "ab_tol_rel": ab_tol_rel,
        "platform_abs_deltas_same_solver": {
            k: abs(last["auction_device"][k] - last["auction_cpu"][k])
            for k in ("test_mAP", "test_CorLoc")},
        "match_subopt": subopt,
        "match_cleanup_total": sum(
            r.get("train_match_cleanup", 0.0)
            for n in ("auction_device", "auction_cpu") for r in results[n]),
    }
    for name in results:
        if not (best[name] >= FLOOR["best"] and final[name] >= FLOOR["final"]):
            failures.append(f"{name} failed the learning floor: "
                            f"best={best[name]:.3f} (>={FLOOR['best']}), "
                            f"final={final[name]:.3f} (>={FLOOR['final']})")
    if ab_delta > ab_limit:
        failures.append(f"solver A/B: |auction-hungarian| final mAP "
                        f"{ab_delta:.4f} > {ab_limit:.4f}")
    if subopt["auction_cpu"]["mean_over_epochs"] > SUBOPT_BAND:
        failures.append("auction realized-cost suboptimality "
                        f"{subopt['auction_cpu']['mean_over_epochs']:.4f} "
                        f"exceeds the eps guarantee band ({SUBOPT_BAND})")
    return comparison, failures


def rehearse_full(args, extra=()):
    """The full-schedule rehearsal and solver A/B on a generated mini-VOC of
    80 trainval and 20 test images (TSCAM_cait_mini from random init, lr
    1e-3): the three arms run at once, each its own CLI process (the device
    arm on the card, the CPU arms sharing the CPU's cores), then
    judge_arms -> work/solver_ab.json; SystemExit on a failure."""
    from spe_tpu_torch.data.mini_data import make_mini_voc

    work = Path(args.workdir or Path(args.output_dir) / "rehearsal_full")
    data = work / "minidata"
    if not (data / "VOCdevkit").exists():
        print(f"generating a mini VOCdevkit and COCO-format jsons in {data}")
        make_mini_voc(data, n_trainval=80, n_test=20, img_size=128)
    epochs, sched = full_schedule(args.epochs)
    arms = full_arms(data, work, args.epochs)
    threads = str(max(1, ((os.cpu_count() or 2) - 2) // 2))
    procs = {}
    for name, _, cpu, argv in arms:
        env = dict(os.environ)
        if cpu:
            env["OMP_NUM_THREADS"] = threads
        print(f"+ [{name}] spe_tpu_torch.cli.main " + " ".join(argv),
              flush=True)
        with (work / f"{name}.out").open("w") as log:
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "spe_tpu_torch.cli.main", *argv,
                 *extra], env=env, cwd=str(REPO), stdout=log,
                stderr=subprocess.STDOUT)
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"rehearse-full: arm {name} exited with "
                             f"{proc.returncode} (see {work / name}.out)")
    results = {name: [json.loads(line) for line in
                      (work / f"run_{name}" / "log.txt").read_text()
                      .splitlines()] for name, *_ in arms}
    comparison, failures = judge_arms(results, epochs, args.ab_tol_rel)
    comparison = {"epochs": epochs, "schedule": sched, **comparison}
    (work / "solver_ab.json").write_text(json.dumps(comparison, indent=2))
    print("SOLVER A/B:", json.dumps(comparison), flush=True)
    if failures:
        raise SystemExit("rehearse-full FAILED:\n  " + "\n  ".join(failures))
    print(f"FULL-SCHEDULE REHEARSAL OK  ({work / 'solver_ab.json'})")
    return comparison


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("task", choices=["voc", "coco", "rehearse", "rehearse-coco",
                                    "rehearse-full"])
    p.add_argument("--coco_path")
    p.add_argument("--test_path")
    p.add_argument("--backbone_weights")
    p.add_argument("--resume")
    p.add_argument("--output_dir", default="runs/accuracy")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--tol", type=float, default=1.0,
                   help="accept milestone - tol (published-number points)")
    p.add_argument("--workdir", help="rehearsals: the mini data and runs")
    p.add_argument("--epochs", type=int, default=2, help="rehearsals only")
    p.add_argument("--img_size", type=int, default=128,
                   help="rehearse, rehearse-coco: the generated images' "
                        "side and --max_size")
    p.add_argument("--ab_tol_rel", type=float, default=0.5,
                   help="rehearse-full: the largest |auction - hungarian| "
                        "final mAP as a share of the better arm's (+0.025)")
    args, extra = p.parse_known_args(argv)
    if args.task == "rehearse":
        return rehearse(args, extra)
    if args.task == "rehearse-coco":
        return rehearse_coco(args, extra)
    if args.task == "rehearse-full":
        return rehearse_full(args, extra)
    return run_recipe(args.task, args, extra)


if __name__ == "__main__":
    main()
