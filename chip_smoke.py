"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA device

Phases, each printing its own line; any failure exits non-zero:
  1. device  — the card's name and power limit (nvidia-smi); no card fails.
  2. build   — nvcc builds spe_tpu_torch/csrc/*.cu into build/spe_tpu_torch/.
  3. kernels — each fused-layer kernel at the voc0712 eval shapes (B=2)
               against its plain PyTorch version on the same bf16 inputs:
               max abs error vs the stated tolerance, and CUDA-event times.
  4. slice   — `spe_tpu_torch.cli.main --preset voc0712 --eval` on a
               generated mini-VOC at full width, with the launch counters
               checked per forward; then one batch through a kernel model
               and a plain-version model with the same weights (LayerScale
               1, so every branch shows), outputs checked finite and within
               5% of the plain model's largest magnitude; the eval
               forward's images/s at batch 8, and its device time by kernel
               (torch.profiler) with the device's idle share.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.

Imports only the port, spe_tpu_torch. The port reads its flags and data
through the JAX package's host-only config and data modules, which import
no JAX; the run fails if jax, jaxlib or flax was loaded by its end.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"[device] {card}", flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()} "
          f"name {torch.cuda.get_device_name(0)}", flush=True)


def phase_build():
    try:
        from spe_tpu_torch.ops import kernels
    except ImportError as e:
        fail(f"the port is not importable ({e}): run chip_smoke.py from the "
             "root of the repository")
    t0 = time.perf_counter()
    kernels.lib()
    print(f"[build] {kernels.library_path()} built and loaded in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of fn() over `reps` CUDA-event timed runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_kernels():
    """Each kernel against its plain version at the recipe shapes (B=2);
    returns {name: JSON entry}. The decoder runs both of its parameter sets
    (layer 0 with ca_qpos_proj, later layers without); its entry carries the
    larger error and the later layers' time (5 of the 6 layers)."""
    from spe_tpu_torch.ops.kernel_checks import (SOURCE, ULPS, compare,
                                                 kernel_cases)

    results = {}
    ok = True
    for name, replaces, fused, plain, args in kernel_cases():
        errs, tols, finite = compare(fused, plain, args)
        passed = finite and all(e <= tl for e, tl in zip(errs, tols))
        ms = cuda_ms(lambda: fused(*args))
        plain_ms = cuda_ms(lambda: plain(*args))
        ok &= passed
        print(f"[kernels] {name}: max_abs_err {errs} tol {tols} "
              f"({ULPS} bf16 ulp at max|plain|) finite {finite} -> "
              f"{'ok' if passed else 'MISMATCH'}; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms", flush=True)
        prev = results.get(name, {}).get("max_abs_err", 0.0)
        results[name] = {"name": name, "route": "cuda", "source": SOURCE,
                         "replaces": replaces, "launches": 0,
                         "max_abs_err": max(prev, *errs), "ms": ms,
                         "plain_ms": plain_ms}
    if not ok:
        fail("a kernel disagrees with its plain version")
    return results


def _counters():
    from spe_tpu_torch.ops import (fused_block, fused_ca_block,
                                   fused_decoder, fused_encoder)

    return {"pallas_block": (fused_block.fused_layer_scale_block, 48),
            "pallas_ca_block": (fused_ca_block.fused_class_attn_block, 2),
            "pallas_encoder": (fused_encoder.fused_encoder_layer, 3),
            "pallas_decoder": (fused_decoder.fused_decoder_layer, 6)}


def _first_ca_probs(model, store):
    """Keep the first class-attention block's probabilities (B, H, t, t+P)
    f32 in store["probs"] on every forward."""
    blk = model.backbone[0].body.blocks_token_only[0]
    return blk.register_forward_hook(
        lambda mod, args, out: store.__setitem__("probs", out[1]))


def phase_slice(kernel_results, n_images=8, batch=8):
    import torch

    from spe_tpu_torch.cli.main import main as cli_main
    from spe_tpu_torch.cli.main import parse_config
    from spe_tpu_torch.data import eval_data, write_mini_voc
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.ops.kernel_checks import MAP_KEYS, max_err, model_tol
    from spe_tpu_torch.train.engine import infer_voc

    tmp = tempfile.TemporaryDirectory()
    devkit = write_mini_voc(tmp.name, n_test=n_images)
    argv = ["--preset", "voc0712", "--eval", "--dataset_eval", "voc_voc",
            "--test_path", str(devkit), "--batch_size", str(batch),
            "--seed", "0"]
    counters = _counters()
    for fn, _ in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    stats = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, (fn, _) in counters.items()}
    forwards = stats["forwards"]
    print(f"[slice] cli --eval over {n_images} images: {forwards} forwards "
          f"(batch {batch}, flip-TTA doubles each), {wall:.1f}s wall; "
          f"launches {counts}", flush=True)
    for k, (fn, per_forward) in counters.items():
        if counts[k] != per_forward * forwards:
            fail(f"{k}: {counts[k]} launches, expected {per_forward} per "
                 f"forward x {forwards}")
        kernel_results[k]["launches"] = counts[k]
    print(f"[slice] VOC mAP {stats['mAP']:.4f} CorLoc {stats['CorLoc']:.4f} "
          "(random weights from --seed: the numbers carry no accuracy "
          "meaning)", flush=True)
    if not (stats["mAP"] == stats["mAP"] and stats["CorLoc"] == stats["CorLoc"]):
        fail("mAP/CorLoc is NaN")

    # One batch through the same weights, kernels vs plain versions. The
    # stock LayerScale (1e-5) would let every block's branches round away in
    # bf16 on both sides, so this pair is built with LayerScale 1.
    cfg = parse_config(argv).replace(init_scale=1.0)
    model = build_model(cfg)
    plain = build_model(cfg.replace(use_fused_block=False,
                                    use_fused_layers=False))
    _, loader = eval_data(cfg)
    b = next(iter(loader.epoch(0)))
    images = torch.as_tensor(b["images"], device="cuda")
    pad = torch.as_tensor(b["pad_mask"], device="cuda")
    sizes = torch.as_tensor(b["orig_size"], device="cuda")
    # the last bbox layer is zero at init (conditional_detr.py:63-66), which
    # leaves the boxes blind to the decoder; give both models the same
    # random one so pred_boxes checks the decoder output too
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for r, head in enumerate(model.bbox_embed):
            w = 0.02 * torch.randn(head.layers[-1].weight.shape, generator=gen)
            head.layers[-1].weight.copy_(w)
            plain.bbox_embed[r].layers[-1].weight.copy_(w)
    probs_got, probs_want = {}, {}
    hooks = [_first_ca_probs(model, probs_got),
             _first_ca_probs(plain, probs_want)]
    with torch.no_grad():
        got = model(images, pad_mask=pad)
        want = plain(images, pad_mask=pad)
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()
    pairs = {"pred_logits": (got["stages"][0]["pred_logits"],
                             want["stages"][0]["pred_logits"]),
             "pred_boxes": (got["stages"][0]["pred_boxes"],
                            want["stages"][0]["pred_boxes"]),
             "ca0_probs": (probs_got["probs"], probs_want["probs"]),
             "cams_cls": (got["backbone"]["cams_cls"],
                          want["backbone"]["cams_cls"]),
             "x_logits": (got["backbone"]["x_logits"],
                          want["backbone"]["x_logits"])}
    for k, v in got["stages"][1].items():
        pairs[f"stage1.{k}"] = (v, want["stages"][1][k])
    bad = []
    for k, (g, w) in pairs.items():
        if not bool(torch.isfinite(g).all()):
            bad.append(f"{k} not finite")
            continue
        err = max_err(g, w)
        tol = model_tol(k, w)
        print(f"[slice] {k} {tuple(g.shape)}: max_abs_err {err:.3e} vs plain "
              f"model, tol {tol:.3e} (0.05 x "
              f"{'range' if k in MAP_KEYS else 'max|plain|'})", flush=True)
        if err > tol:
            bad.append(f"{k} err {err:.3e} > {tol:.3e}")
    # what the same limits read on broken maps: the kernels' CAMs mirrored
    # left-right, and their probabilities with the heads rolled by one
    for k, broken in (("cams_cls", got["backbone"]["cams_cls"].flip(-1)),
                      ("ca0_probs", probs_got["probs"].roll(1, dims=1))):
        print(f"[slice] broken {k}: max_abs_err "
              f"{max_err(broken, pairs[k][1]):.3e}, tol "
              f"{model_tol(k, pairs[k][1]):.3e}", flush=True)
    if bad:
        fail("slice vs plain model: " + "; ".join(bad))

    # eval forward throughput at batch 8 (flip-TTA: 16 images per forward);
    # the weights' values do not change the work
    def run(m):
        return lambda: infer_voc(m, images, pad, sizes, with_flip=True)

    rates = {}
    for label, m in (("kernels", model), ("plain", plain),
                     ("kernels", model), ("plain", plain)):
        ms = cuda_ms(run(m), reps=3, warmup=1)
        rates.setdefault(label, []).append(batch / (ms / 1e3))
    print(f"[slice] eval forward + top-300 + NMS, batch {batch} with flip "
          f"(2 x {batch} images per forward): images/s kernels "
          f"{rates['kernels']}, plain {rates['plain']}", flush=True)
    print(f"[slice] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          "GiB", flush=True)
    profile_forward(run(model), batch)
    tmp.cleanup()


def profile_forward(fn, batch, reps=2):
    """Device time by kernel over `reps` eval forwards (torch.profiler),
    and the device's idle share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in rows)
    print(f"[profile] {reps} eval forwards of batch {batch} (flip): wall "
          f"{wall_us / 1e3:.1f} ms, device busy {total / 1e3:.1f} ms, idle "
          f"share {max(0.0, 1 - total / wall_us):.3f}", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"[profile] {e.self_device_time_total / 1e3:9.2f} ms "
              f"{100 * e.self_device_time_total / max(total, 1):5.1f}% "
              f"x{e.count:5d}  {e.key[:100]}", flush=True)


def main():
    import torch

    phase_device()
    phase_build()
    results = phase_kernels()
    phase_slice(results)
    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    if jax_mods:
        fail(f"JAX was imported: {jax_mods[:5]}")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
