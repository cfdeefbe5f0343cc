"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA device

Phases, each printing its own lines; any failure exits non-zero:
  1. device  — the card's name and power limit (nvidia-smi); no card fails.
  2. build   — nvcc builds spe_tpu_torch/csrc/*.cu into build/spe_tpu_torch/
               (one nvcc per source, all at once).
  3. kernels — each fused-layer kernel at the voc0712 eval shapes (B=2)
               against its plain PyTorch version on the same bf16 inputs
               (max abs error vs the stated tolerance); the dropout masks
               of the training kernels against the torch formula, bit for
               bit, with their kept shares (every site, the encoder's and
               decoder's at the recipe's 0.1); every fused layer's
               training forward and backward kernels (patch block, class
               attention, encoder, decoder layer 0 and a later layer)
               against their plain versions at the recipe shapes and rates
               (B=2), the backward twice (identical bits); the
               two supervision kernels at the recipe's training shapes (64
               CC masks of 64 x 64 with two mazes past the sweep cap; 96
               auction problems of 120 x 300, plus an overfull shape),
               which must equal their plain versions exactly; CUDA-event
               times, and each kernel's bound (least time on the card).
  4. slice   — `spe_tpu_torch.cli.main --preset voc0712 --eval` on a
               generated mini-VOC at full width, with the launch counters
               checked per forward; then one batch through a kernel model
               and a plain-version model with the same weights (LayerScale
               1, so every branch shows), outputs checked finite and within
               5% of the plain model's largest magnitude; the eval
               forward's images/s at batch 8, and its device time by kernel
               (torch.profiler) with the device's idle share.
  5. train   — the CLI trains the voc0712 recipe at full width with the
               fused flags off (B=8, 24 generated images: 3 steps) and
               evaluates: one CC and one auction launch per step, no
               fused-layer launch, finite losses, no skipped step, the
               auction converged, the weights moved, the checkpoint
               reloads; images/s, ms per step, peak memory. Then one batch
               of supervision through the kernels and through their plain
               versions on the same model outputs (identical pseudo-boxes,
               assignments, iterations; losses within 1e-6 relative), and
               one step's device-time split (model, supervision tail,
               backward, optimizer) with the profiler's idle share.
  6. fused   — the same CLI run with the fused backbone (the preset's
               use_fused_block, encoder/decoder plain): 48 patch-block and
               2 class-attention training forwards and backward launches
               per step, no encoder/decoder launch, the checks of phase 5.
               Then one batch at dropout 0 with the same weights through
               the fused and the plain backbone, the plain run's
               pseudo-boxes, refinement targets and matching replayed in
               the fused run (compute_losses' supervision): losses within
               5% and every parameter's gradient within 5% of the plain
               side's largest magnitude; every parameter of the backbone,
               the encoder, the decoder and the query embeddings with a
               gradient on both sides (the backbone's nonzero); and the
               fused step's device-time split.
  7. stock   — the CLI trains `--preset voc0712` with every fused flag on
               (no --no_use_* flag), the checks of phase 5 with 48 + 48
               block, 2 + 2 class-attention, 3 + 3 encoder and 6 + 6
               decoder training forward and backward launches per step and
               the epoch's eval launches counted apart; then the
               same-grads check of phase 6, every fused flag on against
               every one off, where only the decoder self-attention's q/k
               projection gradients (bf16 rounding noise at init on both
               paths) may miss 5%, and then only if they are no further
               from the plain model's gradient in f32 than 3x the plain
               bf16 one and point its way (cosine at least 0.5 and at
               least the plain one's less 0.25); and the step's
               device-time split.
About 2.5 minutes of command time on an H100.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.

Imports only the port, spe_tpu_torch; the run fails if jax, jaxlib, flax
or the JAX package (spe_tpu) was loaded by its end.
"""

from __future__ import annotations

import json
import math
import re
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
                                                 kernel_cases, layer_bound_ms)

    results = {}
    ok = True
    for name, replaces, fused, plain, args in kernel_cases():
        errs, tols, finite = compare(fused, plain, args)
        passed = finite and all(e <= tl for e, tl in zip(errs, tols))
        ms = cuda_ms(lambda: fused(*args))
        plain_ms = cuda_ms(lambda: plain(*args))
        bound, bound_by = layer_bound_ms(name, args)
        ok &= passed
        print(f"[kernels] {name}: max_abs_err {errs} tol {tols} "
              f"({ULPS} bf16 ulp at max|plain|) finite {finite} -> "
              f"{'ok' if passed else 'MISMATCH'}; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({bound_by}); no "
              "single PyTorch call computes the layer", flush=True)
        prev = results.get(name, {}).get("max_abs_err", 0.0)
        results[name] = {"name": name, "route": "cuda", "source": SOURCE,
                         "replaces": replaces, "launches": 0,
                         "max_abs_err": max(prev, *errs), "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": bound_by, "library_ms": None}
    if not ok:
        fail("a kernel disagrees with its plain version")
    return results


def phase_masks():
    """The kernels' counter masks against the torch formula, bit for bit,
    at the recipe's rates and the block's shapes (B=2); the kept share of
    each within 4 sigma of 1 - rate."""
    import torch

    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import RECIPE_RATES, TRANSFORMER_RATE
    from spe_tpu_torch.ops.refmath import (SITE_ATTN, SITE_CROSS_ATTN,
                                           SITE_CROSS_PROJ, SITE_HIDDEN,
                                           SITE_OUT, SITE_PATH1, SITE_PROJ,
                                           counter_keep, path_keep)

    attn, proj, path = RECIPE_RATES
    rate = TRANSFORMER_RATE
    seed = torch.tensor([20240611], dtype=torch.int32, device="cuda")
    ok = True
    # the patch block's sites, then the encoder's and decoder's: the
    # encoder attention (B, 8, 1024, 1024), the decoder self-attention
    # keyed (b, s*H + h) (B, 2 * 8, 300, 300), the cross-attention and its
    # projection on sites of their own, the FFN of 2048
    for site, rate, shape in ((SITE_ATTN, attn, (2, 4, 1024, 1024)),
                              (SITE_PROJ, proj, (2, 1, 1024, 192)),
                              (SITE_HIDDEN, proj, (2, 1, 1024, 768)),
                              (SITE_PATH1, path, (4096,)),
                              (SITE_ATTN, rate, (2, 8, 1024, 1024)),
                              (SITE_ATTN, rate, (2, 16, 300, 300)),
                              (SITE_CROSS_ATTN, rate, (2, 8, 600, 1024)),
                              (SITE_CROSS_PROJ, rate, (2, 1, 600, 192)),
                              (SITE_OUT, rate, (2, 1, 600, 192)),
                              (SITE_HIDDEN, rate, (2, 1, 1024, 2048))):
        got = K.dropout_mask(seed, site, rate, shape)
        want = (path_keep(seed, site, rate, shape[0]) if len(shape) == 1
                else counter_keep(seed, site, rate, shape))
        same = bool(torch.equal(got, want))
        share = float(got.float().mean())
        sigma = (rate * (1 - rate) / got.numel()) ** 0.5
        within = abs(share - (1 - rate)) <= 4 * sigma
        ok &= same and within
        print(f"[masks] site {site} rate {rate} {shape}: kernel == torch "
              f"{same}; kept {share:.5f} vs {1 - rate:.5f} (4 sigma "
              f"{4 * sigma:.5f}) -> {'ok' if same and within else 'BAD'}",
              flush=True)
    if not ok:
        fail("the kernels' dropout masks differ from the torch formula")


def phase_train_kernels(results):
    """Every fused layer's training forward and backward kernels against
    their plain versions at the recipe shapes (B=2; the recipe's dropout
    rates on the patch block, 0.1 on every encoder and decoder site, a
    nonzero CAM cotangent on class attention); the backward run twice must
    give identical bits. The decoder runs layer 0 and a later layer; its
    entries carry the larger error and the later layer's times (5 of the 6
    layers)."""
    import torch

    from spe_tpu_torch.ops.kernel_checks import (BWD_REPLACES, PROBS_TOL,
                                                 SOURCE, ULPS, backward_args,
                                                 bf16_tol, bwd_bound_ms,
                                                 flat_grads, grad_tols,
                                                 max_err, plain_train,
                                                 train_bound_ms, train_cases,
                                                 zero_grad_ref)

    bad = []
    for name, mod, args, cot in train_cases():
        plain_fwd, plain_bwd = plain_train(name, mod)
        with torch.no_grad():
            got = mod._train_cuda(*args)
            want = plain_fwd(*args)
            torch.cuda.synchronize()
            tols = [bf16_tol(w) for w in want]
            if name == "pallas_ca_block":
                tols[1] = PROBS_TOL
            errs = [max_err(g, w) for g, w in zip(got, want)]
            fwd_ok = all(e <= t for e, t in zip(errs, tols)) and all(
                bool(torch.isfinite(g).all()) for g in got)
            # the backward of both on the kernels' saved tensors
            saved = backward_args(args, got[1:], cot)

            def bwd():
                return mod._backward_cuda(*saved)

            def ref():
                return plain_bwd(*saved)

            g1, g2, gw = (flat_grads(name, r) for r in (bwd(), bwd(), ref()))
            torch.cuda.synchronize()

        same = all(torch.equal(g1[k], g2[k]) for k in gw)
        gt = grad_tols(gw)
        worst, bwd_ok = 0.0, True
        for n, w in gw.items():
            u, tol = g1[n], gt[n]
            e = max_err(u, w)
            worst = max(worst, e / max(tol, 1e-30))
            if zero_grad_ref(n):
                print(f"[train-kernels] {name} {n} (zero in exact "
                      f"arithmetic): max|plain| {float(w.abs().max()):.3e}, "
                      f"err {e:.3e}, tol {tol:.3e} (1% of max|d "
                      f"{zero_grad_ref(n)}|)", flush=True)
            if not (e <= tol and bool(torch.isfinite(u).all())):
                bwd_ok = False
                print(f"[train-kernels] {name} {n}: err {e:.3e} > tol "
                      f"{tol:.3e}", flush=True)
        ms_f = cuda_ms(lambda: mod._train_cuda(*args), reps=5, warmup=1)
        plain_f = cuda_ms(lambda: plain_fwd(*args), reps=5, warmup=1)
        ms_b = cuda_ms(bwd, reps=5, warmup=1)
        plain_b = cuda_ms(ref, reps=3, warmup=1)
        bf, bf_by = train_bound_ms(name, args)
        bb, bb_by = bwd_bound_ms(name, args, cot)
        print(f"[train-kernels] {name} training forward: max_abs_err "
              f"{[f'{e:.3e}' for e in errs]} tol {[f'{t:.3e}' for t in tols]} "
              f"({ULPS} bf16 ulp at max|plain|; probabilities {PROBS_TOL}) -> "
              f"{'ok' if fwd_ok else 'MISMATCH'}; kernel {ms_f:.3f} ms, plain "
              f"{plain_f:.3f} ms, bound {bf:.4f} ms ({bf_by})", flush=True)
        print(f"[train-kernels] {name} backward: {len(gw)} gradients "
              f"within tolerance (1% of max|plain|; largest err/tol "
              f"{worst:.3f}) {bwd_ok}; two runs bit-identical {same}; kernel "
              f"{ms_b:.3f} ms, plain {plain_b:.3f} ms, bound {bb:.4f} ms "
              f"({bb_by}); no single PyTorch call computes it", flush=True)
        if not (fwd_ok and bwd_ok and same):
            bad.append(name)
        prev = results.get(f"{name}_bwd", {}).get("max_abs_err", 0.0)
        results[name].update(
            train_ms=ms_f, train_plain_ms=plain_f, train_bound_ms=bf,
            train_max_abs_err=max(results[name].get("train_max_abs_err", 0.0),
                                  *errs))
        results[f"{name}_bwd"] = {
            "name": f"{name}_bwd", "route": "cuda", "source": SOURCE,
            "replaces": BWD_REPLACES[name], "launches": 0,
            "max_abs_err": max(prev, *(max_err(g1[k], gw[k]) for k in gw)),
            "ms": ms_b, "plain_ms": plain_b, "bound_ms": bb, "bound_by": bb_by,
            "library_ms": None}
        del g1, g2, gw, got, want, saved
        torch.cuda.empty_cache()
    if bad:
        fail(f"training kernels disagree with their plain versions: {bad}")


def _exact(got, want):
    """-> (all equal, max abs difference) over matching integer tensors."""
    same = all(g.shape == w.shape and bool((g == w).all())
               for g, w in zip(got, want))
    err = max(float((g.long() - w.long()).abs().max()) for g, w in
              zip(got, want))
    return same, err


def phase_supervision_kernels(results):
    """Kernels 5 and 6 against their plain versions on the card, exactly."""
    import torch

    from spe_tpu_torch.ops import auction as auc
    from spe_tpu_torch.ops import connected_components as cc
    from spe_tpu_torch.ops.kernel_checks import (auction_bound_ms,
                                                 auction_problems,
                                                 cc_bound_ms, cc_masks)

    masks = cc_masks().cuda()
    got = (cc.connected_components(masks),)
    labels, sweeps = cc.connected_components_reference(masks,
                                                       with_sweeps=True)
    same, err = _exact(got, (labels,))
    ms = cuda_ms(lambda: cc.connected_components(masks))
    plain_ms = cuda_ms(lambda: cc.connected_components_reference(masks),
                       reps=5, warmup=1)
    bound, bound_by = cc_bound_ms(masks, sweeps)
    print(f"[kernels] pallas_cc: {tuple(masks.shape)} masks, sweeps "
          f"{sorted(set(sweeps.tolist()))} (cap {cc.MAX_SWEEPS}); labels equal "
          f"{same} (max_abs_err {err}); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound:.5f} ms ({bound_by}); no single "
          "PyTorch call computes it", flush=True)
    if not same or int(sweeps.max()) != cc.MAX_SWEEPS:
        fail("pallas_cc: labels differ from the plain version, or no mask "
             "reached the sweep cap")
    results["pallas_cc"] = {
        "name": "pallas_cc", "route": "cuda",
        "source": "spe_tpu_torch/csrc/cc.cu",
        "replaces": "spe_tpu/ops/pallas_cc.py:109", "launches": 0,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None}

    benefit, pmask = auction_problems(device="cuda")
    got = auc.auction_phase(benefit, pmask)
    want = auc.auction_phase_reference(benefit, pmask)
    same, err = _exact(got, want)
    over = auction_problems(3, 120, 60, seed=1, device="cuda")
    same_over, _ = _exact(auc.auction_phase(*over),
                          auc.auction_phase_reference(*over))
    ms = cuda_ms(lambda: auc.auction_phase(benefit, pmask))
    plain_ms = cuda_ms(lambda: auc.auction_phase_reference(benefit, pmask),
                       reps=3, warmup=1)
    bound, bound_by = auction_bound_ms(benefit, want[2])
    print(f"[kernels] pallas_auction: {tuple(benefit.shape)} problems, "
          f"iterations max {int(want[1].max())} mean "
          f"{float(want[1].float().mean()):.1f}, bids {int(want[2].sum())}; "
          f"assignments/iterations/bids equal {same} (max_abs_err {err}), "
          f"overfull (3, 120, 60) equal {same_over}; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound:.5f} ms ({bound_by}); no "
          "single PyTorch call computes it", flush=True)
    if not (same and same_over):
        fail("pallas_auction: the kernel differs from the plain version")
    results["pallas_auction"] = {
        "name": "pallas_auction", "route": "cuda",
        "source": "spe_tpu_torch/csrc/auction.cu",
        "replaces": "spe_tpu/ops/pallas_auction.py:123", "launches": 0,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
    torch.cuda.synchronize()


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
                                    use_fused_layers=False,
                                    use_pallas_attention=False))
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


# the stock preset: every fused flag on (use_fused_block, use_fused_ca_block
# "auto" following it, use_fused_layers, use_pallas_attention); every loss
# gate open from the first step
STOCK_TRAIN_ARGV = ["--preset", "voc0712", "--dataset_file", "voc_voc",
                    "--dataset_eval", "voc_voc", "--batch_size", "8",
                    "--epochs", "1", "--warmup_cls_epochs", "0",
                    "--refine_start_epoch", "0"]
OFF_FLAGS = ["--no_use_fused_layers", "--no_use_pallas_attention"]
# the fused flags off
TRAIN_ARGV = STOCK_TRAIN_ARGV + ["--no_use_fused_block"] + OFF_FLAGS
# the slice of the fused backbone: use_fused_block on as in the preset
# (use_fused_ca_block "auto" follows it), the encoder/decoder plain
FUSED_TRAIN_ARGV = STOCK_TRAIN_ARGV + OFF_FLAGS
# training forward launches per step of each fused layer (and as many
# backward launches); also its eval launches per forward
PER_STEP = {"pallas_block": 48, "pallas_ca_block": 2, "pallas_encoder": 3,
            "pallas_decoder": 6}


def _supervision_counters():
    from spe_tpu_torch.ops import auction, connected_components

    return {"pallas_cc": connected_components.connected_components,
            "pallas_auction": auction.auction_phase}


def _all_counts(reset=False):
    """{counter name: launches} of every fused layer (eval, and for the
    backbone blocks training forward and backward) and the supervision
    kernels; with reset, set them all to 0 first."""
    fns = {k: fn for k, (fn, _) in _counters().items()}
    names = {}
    for k, fn in fns.items():
        for attr in ("launches", "train_launches", "bwd_launches"):
            if hasattr(fn, attr):
                names[f"{k}.{attr}"] = (fn, attr)
    for k, fn in _supervision_counters().items():
        names[k] = (fn, "launches")
    if reset:
        for fn, attr in names.values():
            setattr(fn, attr, 0)
    return {k: getattr(fn, attr) for k, (fn, attr) in names.items()}


def phase_train(kernel_results, mode, n_train=24, n_test=8, batch=8):
    """The CLI trains the recipe at full width for 3 steps and evaluates:
    with the fused flags off (mode "off"), with the fused backbone
    ("backbone": 48 patch blocks and 2 class-attention blocks through their
    training kernels) or as the stock preset ("stock": every fused layer
    through its training kernels)."""
    import torch

    from spe_tpu_torch.cli.main import main as cli_main
    from spe_tpu_torch.cli.main import parse_config
    from spe_tpu_torch.data import write_mini_voc
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.train.checkpoint import restore_checkpoint
    from spe_tpu_torch.train.optim import AdamW3
    from spe_tpu_torch.train.train_step import TrainState

    tag, argv = {"off": ("train", TRAIN_ARGV),
                 "backbone": ("train-fused", FUSED_TRAIN_ARGV),
                 "stock": ("train-stock", STOCK_TRAIN_ARGV)}[mode]
    fused = {"off": (), "backbone": ("pallas_block", "pallas_ca_block"),
             "stock": tuple(PER_STEP)}[mode]
    tmp = tempfile.TemporaryDirectory()
    devkit = write_mini_voc(tmp.name, n_test=n_test, n_trainval=n_train)
    out = f"{tmp.name}/out"
    argv = argv + ["--test_path", str(devkit), "--output_dir", out]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _all_counts(reset=True)
    t0 = time.perf_counter()
    res = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = _all_counts()
    (epoch,) = res["epochs"]
    hist = epoch["train"]["history"]
    steps = len(hist)
    print(f"[{tag}] cli over {n_train} images, batch {batch}: {steps} steps, "
          f"then eval of {n_test}; {wall:.1f}s wall; launches {counts}",
          flush=True)
    for h in hist:
        print(f"[{tag}] step " + " ".join(f"{k} {v:.4f}" for k, v in h.items()),
              flush=True)
    bad = []
    if steps != n_train // batch:
        bad.append(f"{steps} steps, expected {n_train // batch}")
    want = {k: steps for k in _supervision_counters()}
    # the epoch's eval forwards launch the eval kernels of the fused layers
    forwards = epoch["eval"]["forwards"]
    for k, per in PER_STEP.items():
        on = k in fused
        want[f"{k}.train_launches"] = per * steps if on else 0
        want[f"{k}.bwd_launches"] = per * steps if on else 0
        want[f"{k}.launches"] = per * forwards if on else 0
    print(f"[{tag}] expected launches (training per step x {steps} steps; "
          f"eval per forward x {forwards} forwards): {want}", flush=True)
    for k, n in want.items():
        if counts[k] != n:
            bad.append(f"{k}: {counts[k]} launches, expected {n}")
    for i, h in enumerate(hist):
        if not all(math.isfinite(v) for v in h.values()):
            bad.append(f"step {i}: a non-finite value")
        if not (0 < h["match_iters"] < 5000) or h["match_cleanup"] != 0:
            bad.append(f"step {i}: match_iters {h['match_iters']} "
                       f"match_cleanup {h['match_cleanup']}")
    state = res["state"]
    if state.bad_steps:
        bad.append(f"bad_steps {state.bad_steps}")
    cfg = parse_config(argv)
    init = build_model(cfg).state_dict()
    trained = state.model.state_dict()
    moved = max(float((trained[k].float() - v.float()).abs().max())
                for k, v in init.items())
    fresh = build_model(cfg)
    reload = TrainState(fresh, AdamW3(fresh.named_parameters(), cfg, 1))
    ep = restore_checkpoint(f"{out}/checkpoint.pth", reload)
    same = all(torch.equal(reload.model.state_dict()[k], v)
               for k, v in trained.items())
    print(f"[{tag}] weights moved by up to {moved:.3e}; checkpoint reloads "
          f"(epoch {ep}, optimizer count {reload.optimizer.count}, weights "
          f"equal {same}); eval mAP {epoch['eval']['mAP']:.4f} (random "
          "weights: no accuracy meaning)", flush=True)
    if moved <= 0 or not same or ep != 0 \
            or reload.optimizer.count != state.optimizer.count:
        bad.append("the weights did not move or the checkpoint did not "
                   "reload")
    step_ms = [h["step_ms"] for h in hist]
    steady = step_ms[1:] or step_ms
    print(f"[{tag}] ms per step {[round(t, 1) for t in step_ms]} (first "
          f"includes warm-up); steady {statistics.mean(steady):.1f} ms = "
          f"{batch / (statistics.mean(steady) / 1e3):.2f} train images/s at "
          f"batch {batch}; epoch {epoch['train']['seconds']:.1f}s for "
          f"{steps * batch} images = "
          f"{steps * batch / epoch['train']['seconds']:.2f} images/s; peak "
          f"device memory {peak:.2f} GiB", flush=True)
    if bad:
        fail(f"{tag}: " + "; ".join(bad))
    if mode == "stock":   # this slice's main path: every kernel's count
        for k in PER_STEP:
            kernel_results[f"{k}_bwd"]["launches"] = counts[f"{k}.bwd_launches"]
            kernel_results[k]["train_launches"] = counts[f"{k}.train_launches"]
        for k in _supervision_counters():
            kernel_results[k]["launches"] = counts[k]
    tmp.cleanup()
    return cfg


def phase_same_step(cfg, batch=8):
    """One batch of supervision on the same model outputs through the
    kernels and through their plain versions; then one step's device-time
    split."""
    import torch

    from spe_tpu_torch.data import train_data, write_mini_voc
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.ops import auction as auc
    from spe_tpu_torch.ops import cam_boxes
    from spe_tpu_torch.ops import connected_components as cc
    from spe_tpu_torch.train import train_step as ts
    from spe_tpu_torch.train.engine import train_batch

    tmp = tempfile.TemporaryDirectory()
    devkit = write_mini_voc(tmp.name, n_test=1, n_trainval=batch, seed=1)
    cfg = cfg.replace(test_path=str(devkit))
    model = build_model(cfg).train()
    _, loader = train_data(cfg)
    b = train_batch(next(iter(loader.epoch(0))), torch.device("cuda"))
    gates = ts.Gates.for_epoch(cfg, 0)
    with torch.no_grad():
        out = model(b["images"], pad_mask=b["pad_mask"],
                    generator=torch.Generator("cuda").manual_seed(0))

    class Cached:  # the same model outputs for both runs
        training = True

        def __call__(self, *args, **kw):
            return out

    def tail(plain):
        orig = (cam_boxes.connected_components, auc.auction_phase)
        if plain:
            cam_boxes.connected_components = cc.connected_components_reference
            auc.auction_phase = auc.auction_phase_reference
        try:
            return ts.compute_losses(Cached(), b, cfg, gates,
                                     torch.Generator("cuda").manual_seed(1))
        finally:
            cam_boxes.connected_components, auc.auction_phase = orig

    launches = (cc.connected_components.launches, auc.auction_phase.launches)
    k_total, k_losses, k_seen = tail(plain=False)
    p_total, p_losses, p_seen = tail(plain=True)
    if (cc.connected_components.launches - launches[0],
            auc.auction_phase.launches - launches[1]) != (1, 1):
        fail("same step: the kernel run did not launch each kernel once")
    same = {k: bool(torch.equal(k_seen["cam"][k], p_seen["cam"][k]))
            for k in ("boxes", "labels", "mask")}
    (k_rows, k_stats), (p_rows, p_stats) = (k_seen["matching"],
                                            p_seen["matching"])
    same["rows"] = bool(torch.equal(k_rows, p_rows))
    same["iters"] = bool(torch.equal(k_stats["iters"], p_stats["iters"]))
    rel = max(abs(float(k_losses[k]) - float(p_losses[k]))
              / max(abs(float(p_losses[k])), 1e-30) for k in p_losses)
    print(f"[same-step] one batch, same model outputs: kernels vs plain on "
          f"the card: identical {same}; losses max relative difference "
          f"{rel:.3e} (limit 1e-6); totals {float(k_total):.6f} / "
          f"{float(p_total):.6f}; {int(k_seen['cam']['mask'].sum())} "
          f"pseudo-boxes, match_iters {float(k_losses['match_iters']):.0f}",
          flush=True)
    if not all(same.values()) or rel > 1e-6:
        fail("same step: the kernels and their plain versions disagree")

    step_split(model, cfg, b, gates, "fused flags off")
    tmp.cleanup()


def step_split(model, cfg, b, gates, label, batch=8):
    """One train step's device-time split (CUDA events at the phase
    boundaries: model forward, supervision tail, backward, optimizer) and
    a profiled step's kernel sums with the device's idle share."""
    import torch

    from spe_tpu_torch.train import train_step as ts
    from spe_tpu_torch.train.optim import AdamW3

    state = ts.TrainState(model, AdamW3(model.named_parameters(), cfg, 1))
    gen = torch.Generator("cuda").manual_seed(2)
    ts.train_step(state, b, cfg, gates, gen)  # warm-up
    marks = {}

    def mark(name):
        marks[name] = torch.cuda.Event(enable_timing=True)
        marks[name].record()

    fwd, crit, opt_step = (model.forward, ts.set_criterion_multi,
                           state.optimizer.step)

    def forward(*a, **kw):
        mark("model")
        r = fwd(*a, **kw)
        mark("supervision")
        return r

    def set_crit(*a, **kw):
        r = crit(*a, **kw)
        mark("backward")
        return r

    def step(*a, **kw):
        mark("optimizer")
        r = opt_step(*a, **kw)
        mark("end")
        return r

    model.forward, ts.set_criterion_multi, state.optimizer.step = \
        forward, set_crit, step
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts.train_step(state, b, cfg, gates, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        del model.forward, state.optimizer.step
        ts.set_criterion_multi = crit
    names = ["model", "supervision", "backward", "optimizer", "end"]
    split = {a: marks[a].elapsed_time(marks[c]) for a, c in
             zip(names, names[1:])}
    total = sum(split.values())
    print(f"[split] {label}: one train step, batch {batch}, device "
          f"timeline between CUDA events: " + ", ".join(
              f"{k} {v:.1f} ms ({100 * v / total:.1f}%)"
              for k, v in split.items())
          + f"; host wall {wall:.1f} ms", flush=True)
    torch.cuda.reset_peak_memory_stats()
    profile_forward(lambda: ts.train_step(state, b, cfg, gates, gen), batch,
                    reps=1, what=f"train steps ({label})")
    print(f"[split] {label}: peak device memory of a step "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)


def _same_tree(a, b):
    """Tensors, dicts, tuples and lists of them equal?"""
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and bool(torch.equal(a, b))
    return a == b


# The only gradients the same-grads check may hold to the plain model in f32
# instead of the plain one in bf16: the decoder self-attention's q/k
# projections. At init the queries' contents are near equal, so that
# attention is near uniform over near equal values and dl = p(dp -
# rowsum(dp p)) is a small difference of large terms: in bf16, on either
# path, the largest elements of these gradients are mostly rounding noise
# (their directions hold: the plain bf16 one's cosine with the f32 one is
# 0.86-0.999).
NOISY = re.compile(r"transformer\.decoder\.layers\.\d+\."
                   r"sa_[qk](content|pos)_proj\.(weight|bias)$")
# Such a gradient passes beyond MODEL_REL_TOL only if it is no further from
# the f32 one than NOISE_FACTOR times the plain bf16 one (largest element)
# and points the f32 one's way: its cosine with it at least COS_MIN and at
# least the plain bf16 one's less COS_MARGIN. A zeroed gradient has cosine
# 0, a negated one the negative of a correct one's: neither passes. The k
# biases, zero by construction (zero is their exact gradient), are held to
# the distance alone.
NOISE_FACTOR = 3.0
COS_MIN = 0.5
COS_MARGIN = 0.25
# the parameters that must get a gradient on both sides of the same-grads
# check; the backbone's must be nonzero too (the zero-by-construction
# biases aside). Some of decoder layer 0's are zero on both sides at init:
# its tgt is zero and the biases are, so its self-attention output and
# LN1 input are zero.
GRAD_PREFIXES = ("backbone.", "transformer.encoder.", "transformer.decoder.",
                 "query_embed.", "queries_embed_refine.")


def _cos(a, b):
    """Cosine of two gradients (0 where either is zero)."""
    na, nb = float(a.double().norm()), float(b.double().norm())
    return float((a.double() * b.double()).sum()) / (na * nb) \
        if na and nb else 0.0


def phase_same_grads(cfg, label, noisy=None, batch=8):
    """One batch at dropout 0 through the same weights with the fused
    layers of `cfg` on and every fused flag off (bf16 both). The fused run
    replays the plain run's supervision (its pseudo-boxes, refinement
    targets and matching, from compute_losses), so both differentiate one
    loss: bf16 differences move near-tied matchings and top-k picks. The
    losses agree within MODEL_REL_TOL of the plain side's magnitude, and
    each parameter's gradient within MODEL_REL_TOL of its largest plain
    magnitude. With `noisy` (a pattern of names; see NOISY), a third run,
    the plain model in f32 with the supervision replayed, holds those
    gradients that miss MODEL_REL_TOL to the f32 math instead. Every
    parameter of the backbone, the encoder, the decoder (query_scale,
    ref_point_head included) and the query embeddings gets a gradient on
    both sides (the backbone's nonzero). Then the fused configuration's
    step split."""
    import torch

    from spe_tpu_torch.data import train_data, write_mini_voc
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.ops.kernel_checks import (MODEL_REL_TOL, grad_views,
                                                 zero_grad_ref)
    from spe_tpu_torch.train import train_step as ts
    from spe_tpu_torch.train.engine import train_batch

    tmp = tempfile.TemporaryDirectory()
    devkit = write_mini_voc(tmp.name, n_test=1, n_trainval=batch, seed=2)
    cfg = cfg.replace(test_path=str(devkit), dropout=0.0,
                      backbone_drop_rate=0.0, drop_attn_rate=0.0,
                      drop_path_rate=0.0)
    plain_cfg = cfg.replace(use_fused_block=False, use_fused_layers=False,
                            use_pallas_attention=False)
    _, loader = train_data(cfg)
    b = train_batch(next(iter(loader.epoch(0))), torch.device("cuda"))
    gates = ts.Gates.for_epoch(cfg, 0)

    def gen():
        return torch.Generator("cuda").manual_seed(3)

    runs, sup = {}, None
    order = [("plain", plain_cfg)]
    if noisy is not None:
        order.append(("f32", plain_cfg.replace(compute_dtype="float32")))
    order.append(("fused", cfg))
    for run, run_cfg in order:
        model = build_model(run_cfg).train()
        if run == "fused":   # what the fused run would have used on its own
            own = ts.compute_losses(model, b, run_cfg, gates, gen())[2]
            own = {"cam": _same_tree(own["cam"], sup["cam"]),
                   "refine": _same_tree(own["refine"], sup["refine"]),
                   # the rows (its statistics count iterations)
                   "matching": _same_tree(own["matching"][0],
                                          sup["matching"][0])}
        _all_counts(reset=True)
        total, losses, used = ts.compute_losses(model, b, run_cfg, gates,
                                                gen(), sup)
        sup = used
        total.backward()
        torch.cuda.synchronize()
        runs[run] = ({k: float(v.detach()) for k, v in losses.items()},
                     grad_views({n: p.grad.detach().float().clone()
                                 if p.grad is not None else None
                                 for n, p in model.named_parameters()}),
                     _all_counts())
        if run == "fused":
            fused_model = model
        else:
            del model, total, losses
            torch.cuda.empty_cache()
    (lf, gf, cf), (lp, gp, _) = runs["fused"], runs["plain"]
    g32 = runs["f32"][1] if noisy is not None else None
    bad = []
    on = [k for k in PER_STEP if k in ("pallas_block", "pallas_ca_block")
          or cfg.use_fused_layers]
    want = {f"{k}.{a}": PER_STEP[k] if k in on else 0 for k in PER_STEP
            for a in ("train_launches", "bwd_launches")}
    if any(cf[k] != n for k, n in want.items()):
        bad.append(f"fused launches {cf}, expected {want}")
    for k, v in lp.items():
        if abs(lf[k] - v) > MODEL_REL_TOL * abs(v) + 1e-6:
            bad.append(f"loss {k}: {lf[k]:.6f} vs {v:.6f}")
    worst, escaped, zero = ("", 0.0), [], []
    for n, w in gp.items():
        g = gf[n]
        # a bias shared by a softmax row has no gradient in exact
        # arithmetic: held against its weight's gradient scale instead
        ref_name = zero_grad_ref(n)
        if g is None or w is None:
            if n.startswith(GRAD_PREFIXES) or (g is None) != (w is None):
                zero.append(n)
            continue
        if ref_name is None and n.startswith("backbone.") and not (
                bool(g.abs().max() > 0) and bool(w.abs().max() > 0)):
            zero.append(n)
        top = float(gp[ref_name or n].abs().max())
        tol = MODEL_REL_TOL * top
        err = float((g - w).abs().max())
        if err <= tol:
            if top > 0 and err / top > worst[1]:
                worst = (n, err / top)
            continue
        if noisy is None or not noisy.match(n):
            bad.append(f"{n}: err {err:.3e} > {tol:.3e} (max|plain| "
                       f"{top:.3e})")
            continue
        r = g32[n]
        plain_f32 = float((w - r).abs().max())
        fused_f32 = float((g - r).abs().max())
        # (the cosines of a zero-by-construction bias compare noise)
        cos_f, cos_p = (_cos(g, r), _cos(w, r)) if ref_name is None else \
            (None, None)
        escaped.append((n, err / top, fused_f32 / top, plain_f32 / top,
                        cos_f, cos_p))
        if fused_f32 > NOISE_FACTOR * plain_f32 or (
                cos_f is not None and cos_f < max(COS_MIN,
                                                  cos_p - COS_MARGIN)):
            bad.append(f"{n}: err {err:.3e} > {tol:.3e} (max|plain| "
                       f"{top:.3e}); against f32: fused {fused_f32:.3e} vs "
                       f"plain {plain_f32:.3e} (at most {NOISE_FACTOR}x), "
                       f"cosine fused {cos_f} vs plain {cos_p} (at least "
                       f"{COS_MIN} and plain - {COS_MARGIN})")
    if zero:
        bad.append(f"no gradient on a side: {zero}")
    print(f"[same-grads] {label}: the fused run's own supervision equal to "
          f"the plain run's (replayed, so all runs differentiate one loss): "
          f"{own}", flush=True)
    cosines = [e[4] for e in escaped if e[4] is not None]
    drops = [e[5] - e[4] for e in escaped if e[4] is not None]
    held = (f"{len(escaped)} decoder self-attention q/k gradients beyond "
            f"it, held to the f32 model (fused vs f32 <= {NOISE_FACTOR} x "
            f"plain bf16 vs f32, largest ratio "
            f"{max((e[2] / max(e[3], 1e-30) for e in escaped), default=0):.2f}"
            f"; cosine with f32 >= max({COS_MIN}, plain's - {COS_MARGIN}), "
            f"lowest fused {min(cosines, default=1):.4f}, largest drop from "
            f"the plain one's {max(drops, default=0):.4f})"
            if noisy is not None else "none may miss it")
    print(f"[same-grads] {label}: one batch at dropout 0, fused layers vs "
          f"every fused flag off, same weights: losses {len(lp)} (total "
          f"fused {sum(lf.values()):.6f}, plain {sum(lp.values()):.6f}); "
          f"{len(gp)} parameter gradients (fused q|k|v tensors in thirds), "
          f"{len(gp) - len(escaped)} within {MODEL_REL_TOL} of max|plain| "
          f"(largest {worst[1]:.3e}, {worst[0]}); {held}; training launches "
          f"{({k: v for k, v in cf.items() if 'train' in k})}; parameters "
          f"without a gradient {len(zero)}", flush=True)
    for n, e, e32, p32, cf_, cp_ in sorted(escaped, key=lambda r: -r[1]):
        cos = "zero by construction" if cf_ is None else \
            f"cosine with f32: fused {cf_:.4f}, plain {cp_:.4f}"
        print(f"[same-grads] {label}: noise-dominated {n}: (all / "
              f"max|plain|) fused vs plain {e:.3f}, fused vs f32 {e32:.3f}, "
              f"plain vs f32 {p32:.3f}; {cos}", flush=True)
    for line in bad[:20]:
        print(f"[same-grads] {line}", flush=True)
    if bad:
        fail(f"same grads ({label}): the fused layers disagree with the "
             "plain ones")
    del runs, gf, gp, g32
    fused_model.zero_grad(set_to_none=True)
    step_split(fused_model, cfg, b, gates, label)
    tmp.cleanup()


def profile_forward(fn, batch, reps=2, what="eval forwards (flip)"):
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
    print(f"[profile] {reps} {what} of batch {batch}: wall "
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
    phase_masks()
    phase_train_kernels(results)
    phase_supervision_kernels(results)
    phase_slice(results)
    cfg = phase_train(results, "off")
    phase_same_step(cfg)
    fused_cfg = phase_train(results, "backbone")
    phase_same_grads(fused_cfg, "fused backbone")
    stock_cfg = phase_train(results, "stock")
    phase_same_grads(stock_cfg, "stock preset", NOISY)
    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax", "spe_tpu"))
    if jax_mods:
        fail(f"JAX or the JAX package was imported: {jax_mods[:5]}")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
