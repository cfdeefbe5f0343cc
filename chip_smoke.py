"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA device
    python3 chip_smoke.py --nccl     # phase 11 over NCCL, a process on
                                     # each card of the machine
    python3 chip_smoke.py --against DIR   # the toolkit classes, CC and the
                                     # auction on DIR's kernels and on
                                     # these, in turns (the other
                                     # wrappers', th_bwd_rows', CC's and
                                     # the auction's outputs compared bit
                                     # for bit)

Phases, each printing its own lines; any failure exits non-zero:
  1. device  — the card's name and power limit (nvidia-smi); no card fails.
  2. build   — nvcc builds spe_tpu_torch/csrc/*.cu into build/spe_tpu_torch/
               (one nvcc per source, all at once); cuobjdump counts the
               tensor-core instructions (HMMA/HGMMA) in every
               instantiation of attn_kernel, gemm_kernel, linear_kernel and
               the 16-head row passes th16_bwd_rows_kernel and
               th16_fwd_rows_kernel, with their registers and local memory,
               and fails on none; it prints the registers and local memory
               of every instantiation of th_bwd_rows_kernel,
               th_fwd_rows_kernel, th16_bwd_rows_kernel,
               th16_fwd_rows_kernel, attn_bwd_rows_kernel, colsum_kernel,
               th_fold_kernel, colsum_f32_kernel, ln_bwd_kernel,
               branch_bwd_kernel, th_dq_kernel, layernorm_kernel,
               th_mix_kernel, cc_kernel and auction_kernel and fails if an
               H=4 one of the first two or any of the others uses local
               memory (LOCAL + STACK). Then the native host
               libraries (phase_native): LAPJV built with g++ and held to
               scipy's optimal totals on tie-heavy costs; the C++ JPEG
               decoder built and loaded, its host time beside PIL's on a
               batch of 8 at 512^2 (decode_times), or, where it does not
               build or load (no libjpeg), g++'s message printed and
               --no_use_native_loader passed to every CLI phase.
  3. kernels — each fused-layer kernel at the voc0712 eval shapes (B=2)
               against its plain PyTorch version on the same bf16 inputs
               (max abs error vs the stated tolerance), and the standalone
               attention kernels likewise: fused_mha as the class
               attention (21 x 1045, probabilities), the encoder
               self-attention (1024 x 1024, key mask) and the decoder
               cross-attention (600 x 1024, q/k 48 and v 24 per head),
               with scaled_dot_product_attention timed beside the forms
               without probabilities, and the talking-heads attention
               (1024 x 1024, 4 heads of 48); the dropout masks
               of the training kernels against the torch formula, bit for
               bit, with their kept shares (every site, the encoder's and
               decoder's at the recipe's 0.1); every fused layer's
               training forward and backward kernels (patch block, class
               attention, encoder, decoder layer 0 and a later layer) and
               the standalone attentions' (the four shapes above, the
               recipe's attention dropout) against their plain versions at
               the recipe shapes and rates (B=2), the backward twice
               (identical bits); the
               two supervision kernels at the recipe's training shapes (64
               CC masks of 64 x 64 with two mazes past the sweep cap,
               labels and sweep counts; 96 auction problems of 120 x 300,
               96 of coco17's 240 x 300, whose rows pass shared memory,
               and an overfull shape), which must equal their plain
               versions exactly; CUDA-event times (CC's and the
               auction's also in a CUDA graph, per sweep or iteration of
               the slowest mask or problem), and each kernel's bound
               (least time on the card).
               Then the toolkit's kernels, gemm_kernel, attn_kernel,
               linear_kernel, th_bwd_rows_kernel, th_fwd_rows_kernel and
               attn_bwd_rows_kernel, at every shape class one stock
               training step, one standalone-attention training step, one
               coco17 training step (91 class tokens, 128 CC masks, 96
               auctions of 240 x 300), one stock eval forward and one
               coco17 COCO eval of 8 images (8 auctions of 48 x 300) give
               them (B=8; a recorder around their kernels.* wrappers):
               each class replayed on fresh
               random inputs of the recorded layout against its plain
               version (gemm, th_bwd_rows and attention_bwd_rows 1% of the
               largest magnitude, attention, ln_linear and th_fwd_rows' zd
               4 bf16 ulps, th_fwd_rows' lse 1e-5 relative, probabilities
               1e-4), twice (identical bits), with its launches per run,
               its time, the plain version's, the bound and the library's
               (torch.matmul on pre-rounded contiguous bf16 operands;
               scaled_dot_product_attention where it computes the same
               function; torch.addmm for ln_linear). The same runs record
               the other wrappers (layernorm, colsum, th_mix, reduce_sum,
               colsum_f32, ln_backward, branch_backward, th_fold, th_dq,
               softmax_backward): each class's first call replayed on
               copies of its inputs against its plain version (1% of the
               largest magnitude, twice identical), with launches, time,
               byte bound and, where one PyTorch call computes it
               (F.layer_norm, native_layer_norm_backward, torch.sum,
               torch.mul with a bf16 out=, torch._softmax_backward_data),
               the library's time; th_fold bit for bit, layernorm's bf16
               output equal to ln_linear's LayerNorm panel bit for bit,
               and the time of colsum, th_fold, colsum_f32, ln_backward,
               branch_backward, th_dq, layernorm and th_mix also with the
               L2 cache flushed before each call; the plain versions of
               colsum_f32, ln_backward, branch_backward, th_dq (the four
               that finish their sums in their one launch), layernorm and
               th_mix timed and their sums over one stock step (th_mix:
               one eval forward) in the JSON line; layernorm's and
               th_mix's own launch counters held to the recorded calls of
               each run; the reduce_* launches per run (and per kernel,
               with their time and bound) beside those of the two-pass
               design they replaced, none allowed in the standalone-
               attention step; the CC masks and the auction problems of
               each recorded run replayed against the plain versions
               (labels and sweep counts; assignments, iteration and bid
               counts; exactly) and timed; mask_kernel's byte bound beside
               each mask check.
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
  8. attention — the CLI trains `--preset voc0712 --no_use_fused_block
               --no_use_fused_layers` (use_pallas_attention as the preset
               sets it): per step 48 + 48 talking-heads and 2 + 3 + 6
               (class, encoder, decoder cross) fused_mha training forward
               and backward launches, no fused-layer launch, the epoch's
               eval launches counted apart, the checks of phase 5; then
               the same-grads check of that configuration against every
               fused flag and use_pallas_attention off, under phase 7's
               rule (the decoder self-attention's q/k gradients, plain on
               both sides but bf16 noise at init, held to the f32 model);
               a fourth run takes the kernels' plain versions in their
               place, and the kernels are held to it, it to every flag
               off, under the same rule (which names miss with each);
               and the step's device-time split.
  9. coco    — the CLI trains `--preset coco17` (every fused flag on) on a
               generated mini-COCO of 90 classes (24 train, 8 val images,
               resized to 512^2): phase 7's checks (48 + 48 block, 2 + 2
               class-attention, 3 + 3 encoder, 6 + 6 decoder, one CC and
               one auction launch per step) and the epoch's eval of both
               refinement stages (the aux layer, top-100, NMS, COCO AP/AR;
               the eval losses: one more auction launch a forward): the
               stats finite, AP/AR in [0, 1] or -1, eval/stage{s}_000.npz
               written, each stage's eval time on the 8 val images and on
               64 others (a cost an image and one an eval), a profiled
               stage-0 eval of the 64 (the auction at 48 x 300, one a
               batch), and `--eval --resume` of the
               checkpoint within 1e-9 of the epoch's stats; then one
               coco17 batch's supervision kernels against their plain
               versions as in phase 5 (each CC and auction launch
               replayed: labels, sweeps, assignments, iteration and bid
               counts exactly) and the step's split, whose auction must
               run once as auction_kernel<0> (rows from device memory);
               then phase 4's kernel-vs-plain model check at coco17 width
               on the aux layer's logits and boxes of both stages, the 90
               CAMs and the first class-attention block's 91 x 1115
               probabilities.
 10. backbones — the XS24, S24 and M48 two-branch backbones and the
               multi-scale XXS36 buckets (see phase_backbones).
 11. distributed — two processes on the one card over gloo
               (`--dist-worker`), one step of the stock voc0712 preset at
               full width (dropout 0, hung_match_ratio 1) on 2 of 4
               generated images each: their parameters bit for bit equal,
               each process's launches those of a stock step; against one
               process on the 4 as two micro-batches with the processes'
               normalisers (the loss and every parameter after the update
               within 1e-6, grad_norm and every averaged gradient within
               1e-5) and in one forward with the normaliser max(N, 2)
               given the micro-batches' supervision (phase 8's same-grads
               rule; the normalisers twice the processes');
               the coco17 COCO eval of 8 generated images, 4 a process and
               merged, against one process's (the detections bit for bit,
               AP/AR within 1e-3, eval losses 1e-4); then `python -m
               spe_tpu_torch.cli.accuracy rehearse --epochs 2` on the card.
               Host ms of the step on each side, the gradient all-reduce's
               bytes and CUDA-event ms, the evals' seconds.
 12. segmentation — the stock preset at full width with --masks (the
               segmentation head, the mask losses on the synthetic dataset
               with masks) from a detector checkpoint the phase writes,
               with --frozen_weights: timed steps at the largest batch of
               8, 4, 2 that fits (a CC and two auction launches a step:
               the mask matching is the second; every parameter outside
               the head bit for bit its checkpoint's, the head moved; peak
               memory; the mask matching's auction against its plain
               version exactly; the step's split); one step at B=4 without
               frozen weights under phase 8's same-grads rule (the plain
               run's supervision and mask matching replayed). Then
               --pre_norm --position_embedding learned: its launches a
               forward (no fused encoder layer; fused_mha in each encoder
               layer), one eval batch with flip against the plain model
               (phase 4) and one step's same-grads (phase 8). Then one CLI
               epoch of 2 steps with --masks on a generated coco_panoptic
               tree, evaluated with COCO AP.
 13. tensor parallel — `--model_axis 2 --tp_attention --no_use_fused_block
               --no_use_fused_layers` on the stock voc0712 model at full
               width, two processes on the one card over gloo
               (`--tp-worker`), through build_model, train_step,
               save_checkpoint and the eval forward: one TP step at B=4
               against one process given its supervision (phase 8's
               same-grads rule), the ranks' replicated parameters, CC
               labels and auction assignments equal, the gathered
               checkpoint in one process, the flipped eval at B=8 against
               one process (phase 4's 5%), B4 on each rank's heads against
               the full-head call and the plain version and its masks
               keyed by global head (bit for bit), kv_sharded_attention
               and ring_kv_attention against unsharded attention (1e-5,
               f32), each rank's launches, model-group collectives, ms a
               step and peak memory; scaled_dot_product_attention's
               forward and backward beside B4's (row 7b's library time);
               then (g) `--masks --frozen_weights` in the model group on
               the synthetic dataset with masks, from a whole-tensor
               detector checkpoint the phase writes, at the largest B of
               4 and 2 at which two processes of one process's peak fit
               the card: given the one-process supervision and mask
               matching, the gathered gradients by phase 8's same-grads
               rule; a CC and two auction launches a step; the replicated
               parameters, the mask head's among them, bit for bit on
               both ranks; the frozen parameters unmoved, the head's
               moved; each rank's peak GiB.
Each phase's seconds print on a `[seconds]` line as it ends.
Each profile also sums the device time of the product kernels by family
(attn_kernel<192, 192, ...> apart) and of every __global__ function in
spe_tpu_torch/csrc. At most 1000 s of command time on an H100, the
kernels' build included (PERF.md).
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.

Imports only the port, spe_tpu_torch; the run fails if jax, jaxlib, flax
or the JAX package (spe_tpu) was loaded by its end.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card():
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    print(f"[device] {card()}", flush=True)
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
          f"{time.perf_counter() - t0:.1f}s; nvcc a source (s): "
          f"{ {n: round(t, 1) for n, t in kernels.build.seconds.items()} }",
          flush=True)
    tensor_core_check(kernels)


# the CLI phases' flag when the C++ JPEG decoder does not build on the
# machine (phase_native): their loaders then take the PIL decode path
NATIVE_OFF = []


def phase_native():
    """The port's native host libraries, built with g++ from the checkout
    (spe_tpu_torch/native): LAPJV, held on tie-heavy costs to scipy's
    optimal totals (every min(Q, T) pair assigned); then the batch JPEG
    decoder. Where it builds, the CLI phases take the native decode path,
    as the presets do, and decode_times prints its host time beside PIL's;
    where it does not (no libjpeg), the compiler's refusal is printed and
    the CLI phases run with --no_use_native_loader."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    from spe_tpu_torch.native import build as native_build
    from spe_tpu_torch.ops.auction import hungarian_host

    t0 = time.perf_counter()
    native_build.load("lapjv")
    built = time.perf_counter() - t0
    rng = np.random.default_rng(20)
    bad = []
    for i in range(100):
        q, t = (int(v) for v in rng.integers(1, 40, 2))
        cost = rng.integers(0, 3, (q, t)).astype(np.float64)
        rows = hungarian_host(cost)
        cols = np.nonzero(rows >= 0)[0]
        r, c = linear_sum_assignment(cost)
        if len(cols) != min(q, t) or abs(
                cost[rows[cols], cols].sum() - cost[r, c].sum()) > 1e-9:
            bad.append((i, q, t))
    print(f"[native] LAPJV (native/lapjv.cc) built in {built:.1f}s; 100 "
          f"tie-heavy problems up to 39 x 39: every pair assigned at "
          f"scipy's optimal total {not bad}", flush=True)
    if bad:
        fail(f"native LAPJV: not optimal on {bad[:5]}")
    try:
        native_build.load("dataio")
    except RuntimeError as e:
        lines = str(e).splitlines()
        reason = " | ".join(lines[:1] + ([ln.strip() for ln in lines[1:]
                                           if "error" in ln] or lines[-2:]))
        native_loader_off()
        print(f"[native] the C++ JPEG decoder (native/dataio.cc) does not "
              f"build on this machine: {reason}; the CLI phases run with "
              f"{' '.join(NATIVE_OFF)} (the PIL decode path)", flush=True)
        return
    decode_times()


def native_loader_off():
    """Every CLI phase's argv takes the PIL decode path."""
    NATIVE_OFF.append("--no_use_native_loader")
    for argv in (STOCK_TRAIN_ARGV, TRAIN_ARGV, FUSED_TRAIN_ARGV,
                 ATTN_TRAIN_ARGV, COCO_TRAIN_ARGV, DIST_TRAIN_ARGV,
                 MASKS_ARGV, PRENORM_ARGV, TP_ARGV):
        argv.extend(NATIVE_OFF)


def host_cpu():
    """The host's CPU model name (/proc/cpuinfo), or 'unknown'."""
    try:
        with open("/proc/cpuinfo") as f:
            for row in f:
                if row.startswith("model name"):
                    return row.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def decode_times(batch=8, size=512, reps=5):
    """The mini-VOC batch of 8 at 512^2 through the train loader's native
    decode path and through its PIL path: host ms a batch (median of
    reps, the files warm in the page cache)."""
    from spe_tpu_torch.data import write_mini_voc
    from spe_tpu_torch.data.loader import DataLoader
    from spe_tpu_torch.data.voc import VOCDevkitDataset

    tmp = tempfile.TemporaryDirectory()
    devkit = write_mini_voc(tmp.name, n_trainval=2 * batch, n_test=0,
                            img_size=375)
    ds = VOCDevkitDataset(devkit, [("VOC2007", "trainval"),
                                   ("VOC2012", "trainval")])
    ms = {}
    for native in (True, False):
        loader = DataLoader(ds, batch, 20, fixed_size=size, seed=0,
                            use_native=native, num_threads=2)
        times = []
        for r in range(reps):
            t0 = time.perf_counter()
            next(iter(loader.epoch(r)))
            times.append((time.perf_counter() - t0) * 1e3)
        ms[native] = statistics.median(times)
    tmp.cleanup()
    print(f"[data] a train batch of {batch} mini-VOC JPEGs (375 x 375) at "
          f"{size}^2, 2 decode threads: native {ms[True]:.1f} ms, PIL "
          f"{ms[False]:.1f} ms (host clock, median of {reps}, the files warm "
          f"in the page cache; CPU {host_cpu()}; card {card()})", flush=True)
    return ms


# the kernels that must run on the tensor cores: the product kernels and
# the 16-head talking-heads row passes (their mixes and partials)
TENSOR_CORE_KERNELS = ("attn_kernel", "gemm_kernel", "linear_kernel",
                       "th16_bwd_rows_kernel", "th16_fwd_rows_kernel")
# the row kernels whose per-row arrays must stay in registers: by the
# template arguments of an instantiation, must it use no local memory?
# (th_*_rows_kernel at H = 6-8 spills; every 16-head instantiation, on the
# tensor cores, must not)
ROW_KERNELS = {"th_bwd_rows_kernel": lambda a: a[0] == "4",
               "th_fwd_rows_kernel": lambda a: a[0] == "4",
               "th16_bwd_rows_kernel": lambda a: True,
               "th16_fwd_rows_kernel": lambda a: True,
               "attn_bwd_rows_kernel": lambda a: True,
               "colsum_kernel": lambda a: True,
               "th_fold_kernel": lambda a: True,
               "colsum_f32_kernel": lambda a: True,
               "ln_bwd_kernel": lambda a: True,
               "branch_bwd_kernel": lambda a: True,
               "th_dq_kernel": lambda a: True,
               "layernorm_kernel": lambda a: True,
               "th_mix_kernel": lambda a: True,
               "cc_kernel": lambda a: True,
               "auction_kernel": lambda a: True}


def tensor_core_check(kernels):
    """Count the tensor-core instructions (HMMA, HGMMA) in the SASS of every
    instantiation of attn_kernel, gemm_kernel and linear_kernel in the
    built library (cuobjdump of the nvcc's toolkit) and print their
    registers and local memory (spills); fail if one has no tensor-core
    instruction. Print the registers and local memory of every
    instantiation of the row kernels (ROW_KERNELS); fail if one that must
    keep its arrays in registers uses local memory."""
    import os

    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    so = str(kernels.library_path())
    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True)
    res = subprocess.run([tool, "-res-usage", so], capture_output=True,
                         text=True)
    if sass.returncode or res.returncode:
        fail(f"cuobjdump failed: {sass.stderr.strip()} {res.stderr.strip()}")
    counts, name = {}, None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.search(r"\bH(G)?MMA\b", line):
            counts[name] += 1
    usage = dict(re.findall(r"Function (\S+):\s*\n\s*(REG:\d+ STACK:\d+ "
                            r"SHARED:\d+ LOCAL:\d+)", res.stdout))
    bad = []
    for fam in TENSOR_CORE_KERNELS:
        mine = {n: c for n, c in counts.items() if fam in n}
        if not mine:
            bad.append(f"no {fam} in the library")
        for n, c in sorted(mine.items()):
            print(f"[build] {fam} {n}: {c} HMMA/HGMMA instructions; "
                  f"{usage.get(n, 'no resource line')}", flush=True)
            if c == 0:
                bad.append(f"{n} has no tensor-core instruction")
        print(f"[build] {fam}: {len(mine)} instantiations, "
              f"{sum(mine.values())} tensor-core instructions in all",
              flush=True)
    for fam, no_local in ROW_KERNELS.items():
        rows = {n: u for n, u in usage.items() if fam in n}
        if not rows:
            bad.append(f"no {fam} in the library")
        for n, u in sorted(rows.items()):
            # the template arguments of the mangled name: Li<int>E, Lb<bool>E
            m = re.search(rf"{fam}I((?:L[ib]\d+E)+)E", n)
            args = tuple(re.findall(r"L[ib](\d+)E", m.group(1))) if m \
                else ("?",)
            # spilled registers live in the stack frame, in local memory
            local = sum(int(re.search(rf"{k}:(\d+)", u).group(1))
                        for k in ("LOCAL", "STACK"))
            print(f"[build] {fam} <{', '.join(args)}> {n}: {u}", flush=True)
            if local and no_local(args):
                bad.append(f"{n} uses {local} bytes of local memory "
                           "(LOCAL + STACK)")
    if bad:
        fail("; ".join(bad))


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


def graph_ms(fn, reps=20):
    """Device milliseconds of one fn() without the host's launch overhead:
    `reps` calls captured in one CUDA graph, the graph replayed between
    CUDA events (median of 3 replays) / reps. None (printed "not
    measured") if fn cannot be captured."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
    except RuntimeError as e:
        print(f"[graph] not captured ({str(e).splitlines()[0][:120]})",
              flush=True)
        return None
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del g
    return statistics.median(times)


# bytes written between the calls cold_ms times: more than the H100's 50 MB
# of L2
FLUSH_BYTES = 128 << 20


def cold_ms(fn, reps=20):
    """Median device milliseconds of one fn() with the L2 cache flushed
    before it: a FLUSH_BYTES buffer written, then a spin kernel that keeps
    the device busy while the host launches fn, then fn between CUDA
    events."""
    import torch

    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    fn()
    events = []
    for _ in range(reps):
        flush.fill_(1.0)
        torch.cuda._sleep(200_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def _ms(t):
    return "not measured" if t is None else f"{t:.4f} ms"


def phase_kernels():
    """Each kernel against its plain version at the recipe shapes (B=2);
    returns ({name: JSON entry}, the toolkit's recorded classes). The
    decoder runs both of its parameter sets
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
    ok &= attention_kernels(results)
    if not ok:
        fail("a kernel disagrees with its plain version")
    return results, phase_toolkit(results)


# the standalone attention kernels' entry in the kernels line carries the
# numbers of this shape (the largest per launch); every shape's are under
# "shapes"
MAIN_SHAPE = {"pallas_mha": "encoder self-attention",
              "pallas_attention": "patch-block talking heads"}
ATTN_SOURCE = {"pallas_mha": "spe_tpu_torch/csrc/attention.cu",
               "pallas_attention": "spe_tpu_torch/csrc"}


def _sdpa(args):
    """The one PyTorch call that computes fused_mha's output (rate 0, no
    probabilities): scaled_dot_product_attention with the key bias as a
    float mask, on the same head views, its output (B, H, Nq, dv). A
    yardstick timed here; the port never calls it."""
    import torch.nn.functional as F

    from spe_tpu_torch.ops.refmath import key_bias, split_heads

    q, k, v, H, mask = args[:5]
    bias = key_bias(mask, k.shape[0], k.shape[1], q.device)
    bias = None if bias is None else bias[:, None, None, :].to(q.dtype)
    qh, kh, vh = (split_heads(t, H) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)


def attention_kernels(results):
    """fused_mha (B4) at its three recipe shapes and the talking-heads
    attention (B5) against their plain versions at rate 0 (B=2); B4's
    forms without probabilities also against scaled_dot_product_attention,
    timed as the library yardstick. -> all within tolerance."""
    from spe_tpu_torch.ops.kernel_checks import (ULPS, attention_cases,
                                                 compare, layer_bound_ms,
                                                 max_err)
    from spe_tpu_torch.ops.refmath import merge_heads

    ok = True
    for name, replaces, mod, args, _, label in attention_cases():
        fused = getattr(mod, "fused_mha" if name == "pallas_mha"
                        else "talking_heads_attention")
        plain = getattr(mod, "fused_mha_reference" if name == "pallas_mha"
                        else "talking_heads_reference")
        errs, tols, finite = compare(fused, plain, args)
        passed = finite and all(e <= tl for e, tl in zip(errs, tols))
        ms = cuda_ms(lambda: fused(*args))
        dev = graph_ms(lambda: fused(*args))
        plain_ms = cuda_ms(lambda: plain(*args), reps=5, warmup=1)
        bound, bound_by = layer_bound_ms(name, args)
        lib_ms = lib_dev = None
        lib_note = "no single PyTorch call computes it"
        if name == "pallas_mha" and not args[6]:
            lib = _sdpa(args)
            lib_ms, lib_dev = cuda_ms(lib), graph_ms(lib)
            lib_err = max_err(merge_heads(lib()), plain(*args))
            ratio = (f"{dev / lib_dev:.2f}" if dev and lib_dev else
                     "not measured")
            lib_note = (f"scaled_dot_product_attention {lib_ms:.3f} ms, on "
                        f"the device {_ms(lib_dev)} (its max_abs_err vs plain "
                        f"{lib_err:.3e}); kernel / SDPA on the device {ratio}")
        ok &= passed
        print(f"[kernels] {name} ({label}, q {tuple(args[0].shape)}, k "
              f"{tuple(args[1].shape)}, v {tuple(args[2].shape)}): "
              f"max_abs_err {errs} tol {tols} ({ULPS} bf16 ulp at max|plain|; "
              f"probabilities 1e-4) finite {finite} -> "
              f"{'ok' if passed else 'MISMATCH'}; kernel {ms:.3f} ms (on the "
              f"device, in a CUDA graph: {_ms(dev)}), plain "
              f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({bound_by}); "
              f"{lib_note}", flush=True)
        entry = results.setdefault(name, {
            "name": name, "route": "cuda", "source": ATTN_SOURCE[name],
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
            "shapes": {}})
        entry["max_abs_err"] = max(entry["max_abs_err"], *errs)
        entry["shapes"][label] = {"ms": ms, "plain_ms": plain_ms,
                                  "bound_ms": bound, "bound_by": bound_by,
                                  "library_ms": lib_ms, "device_ms": dev,
                                  "library_device_ms": lib_dev}
        if label == MAIN_SHAPE[name]:
            entry.update(entry["shapes"][label])
    return ok


# the toolkit's two product kernels, by the class of each call: gemm's M, N,
# K, batch, operand dtypes, layout and epilogue; attention's template, Nq,
# Nk and form
TOOLKIT = {"gemm_kernel": ("spe_tpu_torch/csrc/grad.cu",
                           "spe_tpu/ops/pallas_block.py:530"),
           "attn_kernel": ("spe_tpu_torch/csrc/attention.cu",
                           "spe_tpu/ops/pallas_mha.py:165"),
           "linear_kernel": ("spe_tpu_torch/csrc/linear.cu",
                             "spe_tpu/ops/pallas_block.py:166"),
           "th_bwd_rows_kernel": ("spe_tpu_torch/csrc/th_train.cu",
                                  "spe_tpu/ops/pallas_block.py:356"),
           "th_fwd_rows_kernel": ("spe_tpu_torch/csrc/th_train.cu",
                                  "spe_tpu/ops/pallas_block.py:166"),
           "attn_bwd_rows_kernel": ("spe_tpu_torch/csrc/th_train.cu",
                                    "spe_tpu/ops/pallas_encoder.py:97")}
# the runs each kernel's per-run sums (launches x time) are taken over; the
# first is its main path, whose numbers head its entry
SUM_RUNS = {"gemm_kernel": ("stock step", "attention step"),
            "attn_kernel": ("eval forward", "stock step", "attention step"),
            "linear_kernel": ("eval forward", "stock step"),
            "th_bwd_rows_kernel": ("stock step", "attention step"),
            "th_fwd_rows_kernel": ("stock step", "attention step"),
            "attn_bwd_rows_kernel": ("stock step", "attention step")}
# the kernels.* wrapper of each toolkit kernel
WRAPPER = {"gemm_kernel": "gemm", "attn_kernel": "attention",
           "linear_kernel": "ln_linear", "th_bwd_rows_kernel": "th_bwd_rows",
           "th_fwd_rows_kernel": "th_fwd_rows",
           "attn_bwd_rows_kernel": "attention_bwd_rows"}
# the other wrappers of the main path and the kernels each launches
# (kernels.dropout_mask's mask_kernel serves phase 3's mask check only)
SMALL = {"layernorm": ("layernorm_kernel",), "colsum": ("colsum_kernel",),
         "th_mix": ("th_mix_kernel",),
         "reduce_sum": ("reduce_thread_kernel", "reduce_block_kernel"),
         "colsum_f32": ("colsum_f32_kernel",), "ln_backward": ("ln_bwd_kernel",),
         "branch_backward": ("branch_bwd_kernel",),
         "th_fold": ("th_fold_kernel",), "th_dq": ("th_dq_kernel",),
         "softmax_backward": ("softmax_bwd_kernel",)}


def _layout(st, m_i, k_i):
    """"k"/"m" (or "n"): which index of a 2-d operand has unit stride; "g":
    neither."""
    return "k" if st[k_i] == 1 else "m" if st[m_i] == 1 else "g"


def _on(n, v):
    """Is option n of a call on? (a dropout (site, rate) at rate 0 is off)"""
    if v is None or hasattr(v, "data_ptr"):
        return v is not None
    return v[1] > 0 if n in ("drop", "path") else bool(v)


def _gemm_class(a, b, c, kw):
    epi = tuple(n for n in ("drop", "gelu_aux", "relu_aux", "col_group",
                            "accumulate", "split_k") if _on(n, kw.get(n)))
    if kw.get("alpha", 1.0) != 1.0:
        epi += ("alpha",)
    lay = (_layout(kw["a_str"], 2, 3) + _layout(kw["b_str"], 3, 2)
           .replace("m", "n"))
    return (kw["M"], kw["N"], kw["K"], tuple(kw.get("nb", (1, 1))),
            str(a.dtype)[6:], str(b.dtype)[6:], str(c.dtype)[6:], lay, epi)


def _attention_class(q, k, out, kw):
    form = tuple(n for n in ("qscale", "kbias", "hbias", "probs", "lse",
                             "drop") if _on(n, kw.get(n)))
    return (kw["dq"], kw["dv"], q.shape[1], k.shape[1], q.shape[0],
            kw["num_heads"], str(out.dtype)[6:], form)


def _linear_class(a, w, kw):
    opts = tuple(n for n in ("ln", "a2", "res", "gamma", "drop", "path",
                             "col_group") if _on(n, kw.get(n)))
    if kw.get("aux") is not None:
        opts += ("aux_pre" if kw.get("aux_pre") else "aux",)
    out = kw.get("out")
    odt = out.dtype if out is not None else kw.get("out_dtype", "bfloat16")
    return (a.shape[0], w.shape[0], a.shape[1], str(a.dtype)[6:],
            kw.get("act", "none"), str(odt).replace("torch.", ""), opts)


def _th_rows_class(s, rate, kw):
    B, H, N, _ = s.shape
    return (B, H, N, "drop" if rate > 0 else "no drop",
            "wl" if kw.get("wl") is not None else "no wl")


def _attn_rows_class(s, kbias, drop, kw):
    mh = kw.get("mask_heads")
    return (*s.shape, "kbias" if kbias is not None else "no kbias",
            "drop" if _on("drop", drop) else "no drop",
            f"mask_heads {mh}" if mh else "mask_heads H")


def _small_class(args, kw):
    """Shapes and dtypes of the tensors, the other arguments as given."""
    def key(v):
        if hasattr(v, "data_ptr"):
            return (tuple(v.shape), str(v.dtype)[6:])
        return tuple(key(x) for x in v) if isinstance(v, tuple) else v
    return (tuple(key(a) for a in args),
            tuple(sorted((n, key(v)) for n, v in kw.items())))


def _tensors(v):
    if hasattr(v, "data_ptr"):
        return [v]
    if isinstance(v, (tuple, list)):
        return [t for x in v for t in _tensors(x)]
    if isinstance(v, dict):
        return [t for x in v.values() for t in _tensors(x)]
    return []


def _copy(v):
    """A copy of every tensor in v in its own storage (the same strides
    where they do not overlap)."""
    import torch

    if hasattr(v, "data_ptr"):
        if min(v.stride(), default=1) > 0:
            return torch.empty_strided(v.shape, v.stride(), dtype=v.dtype,
                                       device=v.device).copy_(v)
        return v.clone()
    if isinstance(v, tuple):
        return tuple(_copy(x) for x in v)
    if isinstance(v, dict):
        return {n: _copy(x) for n, x in v.items()}
    return v


@contextlib.contextmanager
def record_toolkit(classes, run):
    """While active, count every call of a WRAPPER in classes[(kernel,
    class)]["launches"][run], keeping the first call's layout (tensor_meta
    of each tensor, the scalars) to replay it; every call of a SMALL
    wrapper in classes[(name, class)], keeping a copy of the first call's
    arguments and its bytes (each tensor argument and output once); and
    every CC launch in classes[("cc_kernel", masks' shape)] and every
    auction launch in classes[("auction_kernel", benefit's shape)], keeping
    a copy of each run's first arguments under "inputs" (RECORDED_INPUTS)."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import tensor_meta

    gemm, attention, ln_linear, th_bwd_rows, th_fwd_rows, attn_rows, cc, \
        auction = (K.gemm, K.attention, K.ln_linear, K.th_bwd_rows,
                   K.th_fwd_rows, K.attention_bwd_rows, K.connected_components,
                   K.auction)

    def meta(kw):
        out = {}
        for n, v in kw.items():
            if v is None:
                continue
            if n == "seed":
                v = v.clone()
            elif n == "ln":
                v = (tensor_meta(v[0]), tensor_meta(v[1]), v[2])
            elif hasattr(v, "data_ptr"):
                v = tensor_meta(v)
            out[n] = v
        return out

    def note(kernel, cls, make):
        entry = classes.setdefault((kernel, cls), {"launches": {}})
        entry["launches"][run] = entry["launches"].get(run, 0) + 1
        if "call" not in entry:
            entry["call"] = make()

    def rec_gemm(a, b, c, **kw):
        note("gemm_kernel", _gemm_class(a, b, c, kw),
             lambda: (tensor_meta(a), tensor_meta(b), tensor_meta(c),
                      meta(kw)))
        return gemm(a, b, c, **kw)

    def rec_attention(q, k, v, out, **kw):
        note("attn_kernel", _attention_class(q, k, out, kw),
             lambda: (tensor_meta(q), tensor_meta(k), tensor_meta(v),
                      (tuple(out.shape), out.dtype), meta(kw)))
        return attention(q, k, v, out, **kw)

    def rec_linear(a, w, bias=None, **kw):
        note("linear_kernel", _linear_class(a, w, kw),
             lambda: (tensor_meta(a), tensor_meta(w),
                      meta({**kw, "bias": bias})))
        return ln_linear(a, w, bias, **kw)

    def rec_th_bwd(s, lse, dzd, bl, ww, bw, seed, rate, **kw):
        note("th_bwd_rows_kernel", _th_rows_class(s, rate, kw),
             lambda: (tuple(s.shape), rate, kw.get("site", 1),
                      kw.get("wl") is not None))
        return th_bwd_rows(s, lse, dzd, bl, ww, bw, seed, rate, **kw)

    def rec_th_fwd(s, bl, ww, bw, seed, rate, **kw):
        note("th_fwd_rows_kernel", _th_rows_class(s, rate, kw),
             lambda: (tuple(s.shape), rate, kw.get("site", 1),
                      kw.get("wl") is not None))
        return th_fwd_rows(s, bl, ww, bw, seed, rate, **kw)

    def rec_attn_rows(s, dzd, lse, kbias, seed, drop, **kw):
        note("attn_bwd_rows_kernel", _attn_rows_class(s, kbias, drop, kw),
             lambda: (tuple(s.shape), kbias is not None, drop,
                      kw.get("mask_heads")))
        return attn_rows(s, dzd, lse, kbias, seed, drop, **kw)

    def rec_inputs(kernel, fn):
        def rec(*args):
            entry = classes.setdefault((kernel, tuple(args[0].shape)),
                                       {"launches": {}, "inputs": {}})
            entry["launches"][run] = entry["launches"].get(run, 0) + 1
            entry["inputs"].setdefault(run, _copy(args))
            return fn(*args)
        return rec

    def rec_small(name, fn):
        def rec(*args, **kw):
            entry = classes.setdefault((name, _small_class(args, kw)),
                                       {"launches": {}})
            entry["launches"][run] = entry["launches"].get(run, 0) + 1
            first = "call" not in entry
            if first:
                entry["call"] = (_copy(args), _copy(kw))
            out = fn(*args, **kw)
            if first:
                entry["bytes"] = sum(t.numel() * t.element_size()
                                     for t in _tensors((args, kw, out)))
            return out
        return rec

    # the wrappers count their launches on the module's names: carried over
    orig = {"gemm": gemm, "attention": attention, "ln_linear": ln_linear,
            "th_bwd_rows": th_bwd_rows, "th_fwd_rows": th_fwd_rows,
            "attention_bwd_rows": attn_rows}
    recs = {"gemm": rec_gemm, "attention": rec_attention,
            "ln_linear": rec_linear, "th_bwd_rows": rec_th_bwd,
            "th_fwd_rows": rec_th_fwd, "attention_bwd_rows": rec_attn_rows}
    for n, r in recs.items():
        r.launches = orig[n].launches
    orig["connected_components"] = cc
    recs["connected_components"] = rec_inputs("cc_kernel", cc)
    orig["auction"], recs["auction"] = auction, rec_inputs("auction_kernel",
                                                           auction)
    orig.update({n: getattr(K, n) for n in SMALL})
    recs.update({n: rec_small(n, getattr(K, n)) for n in SMALL})
    # the SMALL wrappers that count their launches start this run at 0
    counted = [n for n in SMALL if hasattr(orig[n], "launches")]
    for n in counted:
        recs[n].launches = 0
    for n, r in recs.items():
        setattr(K, n, r)
    try:
        yield classes
    finally:
        for n, o in orig.items():
            setattr(K, n, o)
            if hasattr(recs[n], "launches"):
                o.launches = recs[n].launches
    for n in counted:
        calls = sum(e["launches"].get(run, 0) for (k, _), e in
                    classes.items() if k == n)
        if recs[n].launches != calls:
            fail(f"{n}: {recs[n].launches} kernel launches counted over one "
                 f"{run}, {calls} calls recorded")


def _replay(kernel, call, gen):
    """A recorded call as a kernel_checks case: fresh random tensors of the
    recorded layouts (same storage sizes, offsets and strides)."""
    import torch

    from spe_tpu_torch.ops.kernel_checks import strided_like

    def fresh(kw):
        return {n: strided_like(v, gen, "cuda") if isinstance(v, tuple)
                and v and isinstance(v[0], torch.dtype) else v
                for n, v in kw.items()}

    if kernel == "gemm_kernel":
        a, b, c, kw = call
        return dict(a=strided_like(a, gen, "cuda"),
                    b=strided_like(b, gen, "cuda"),
                    c=strided_like(c, gen, "cuda"), kw=fresh(kw))
    if kernel == "linear_kernel":
        a, w, kw = call
        kw = dict(kw)
        out, aux = kw.pop("out", None), kw.pop("aux", None)
        ln = kw.pop("ln", None)
        kw = fresh(kw)
        if ln is not None:
            kw["ln"] = (strided_like(ln[0], gen, "cuda"),
                        strided_like(ln[1], gen, "cuda"), ln[2])
        return dict(a=strided_like(a, gen, "cuda"),
                    w=strided_like(w, gen, "cuda"), kw=kw, out=out, aux=aux)
    if kernel in ("th_bwd_rows_kernel", "th_fwd_rows_kernel"):
        from spe_tpu_torch.ops.kernel_checks import th_bwd_case, th_fwd_case

        (B, H, N, _), rate, site, wl = call
        make = th_bwd_case if kernel == "th_bwd_rows_kernel" else th_fwd_case
        args, kw = make(B, H, N, rate, wl, device="cuda", site=site)
        return dict(args=args, kw=kw)
    if kernel == "attn_bwd_rows_kernel":
        from spe_tpu_torch.ops.kernel_checks import attn_rows_case

        (B, H, Nq, Nk), kbias, drop, mask_heads = call
        site, rate = drop if drop is not None else (10, 0.0)
        args, kw = attn_rows_case(B, H, Nq, Nk, kbias, rate, mask_heads,
                                  device="cuda", site=site)
        return dict(args=args, kw=kw)
    q, k, v, out, kw = call
    kw = dict(kw)
    flags = {n: kw.pop(n, None) is not None for n in ("probs", "lse")}
    return dict(q=strided_like(q, gen, "cuda"), k=strided_like(k, gen, "cuda"),
                v=strided_like(v, gen, "cuda"), kw=fresh(kw), out=out, **flags)


RECORDED_RUNS = ("stock step", "attention step", "eval forward",
                 "coco17 step", "coco17 eval")
# the classes record_toolkit keeps the inputs of, replayed apart
# (recorded_inputs, against_inputs; what each needs: _recorded_kernel)
RECORDED_INPUTS = ("cc_kernel", "auction_kernel")


def _recorded_kernel(kernel):
    """What recorded_inputs and against_inputs need of a RECORDED_INPUTS
    kernel: its entry in the JSON line, its wrapper on a module of kernels
    (this checkout's or DIR's) and the recorded arguments, its plain
    version, its bound from the arguments and the plain outputs (whose
    second is the sweep or iteration count), a note on the problem, and
    the inputs phase 3 checks, also compared under --against."""
    from spe_tpu_torch.ops import auction as auc
    from spe_tpu_torch.ops import connected_components as cc
    from spe_tpu_torch.ops import kernel_checks as kc

    if kernel == "cc_kernel":
        return dict(
            entry="pallas_cc", count="sweeps",
            call=lambda m, x: m.connected_components(*x),
            plain=lambda x: cc.connected_components_reference(
                *x, with_sweeps=True),
            bound=lambda x, want: kc.cc_bound_ms(x[0], want[1]),
            note=lambda x, want: f"sweeps {sorted(set(want[1].tolist()))}",
            checked=lambda: [("cc_masks()", (kc.cc_masks().cuda(),
                                             cc.MAX_SWEEPS))])
    return dict(
        entry="pallas_auction", count="iterations",
        call=lambda m, x: m.auction(*x),
        plain=lambda x: auc.auction_phase_reference(*x),
        bound=lambda x, want: kc.auction_bound_ms(x[0], want[2], x[1]),
        note=lambda x, want: (
            f"valid persons {int(x[1].sum())}, iterations max "
            f"{int(want[1].max())} mean {float(want[1].float().mean()):.1f},"
            f" bids {int(want[2].sum())}"),
        checked=lambda: [(f"{name}'s auction_problems{shape}",
                          (*kc.auction_problems(*shape, device="cuda"),
                           auc.EPS, auc.MAX_ITERS))
                         for name, shape in AUCTION_CHECKED])


# phase 3's auction problems, kernel_checks.auction_problems' (P, T, Q, K):
# the voc0712 recipe's (T = 24 boxes x 5) and coco17's (T = 48 x 5, 91
# classes), whose rows pass shared memory (the kernel's device-memory path)
AUCTION_CHECKED = (("voc0712", ()), ("coco17", (96, 240, 300, 91)))


def record_classes(batch=8, extra=()):
    """One training step of the stock preset, of the standalone-attention
    configuration and of the coco17 preset (90 classes: 91 class tokens,
    128 CC masks, 240 x 300 auctions), one stock eval forward (flip:
    2 x batch images) and one coco17 COCO eval of batch images
    (engine.evaluate_coco: the t = 91 eval forward and the eval losses'
    batch x 48 x 300 auction), through the kernels at B=batch, with every
    call of a WRAPPER or SMALL wrapper recorded by class -> {(kernel or
    wrapper, class): {"launches": {run: n}, "call", and for a SMALL one
    "bytes"}}."""
    import torch

    from spe_tpu_torch.cli.main import parse_config
    from spe_tpu_torch.data import (eval_data, train_data, write_mini_coco,
                                    write_mini_voc)
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.train import train_step as ts
    from spe_tpu_torch.train.engine import (evaluate_coco, infer_voc,
                                            train_batch)
    from spe_tpu_torch.train.optim import AdamW3

    tmp = tempfile.TemporaryDirectory()
    devkit = write_mini_voc(tmp.name, n_test=batch, n_trainval=batch, seed=3)
    coco = write_mini_coco(tmp.name, n_train=batch, n_val=batch, seed=3)
    data = ["--test_path", str(devkit), "--coco_path", str(coco)]
    classes = {}
    for run, argv in (("stock step", STOCK_TRAIN_ARGV),
                      ("attention step", ATTN_TRAIN_ARGV),
                      ("coco17 step", COCO_TRAIN_ARGV)):
        cfg = parse_config(argv + data + ["--output_dir", f"{tmp.name}/o",
                                          *extra])
        model = build_model(cfg).train()
        _, loader = train_data(cfg)
        b = train_batch(next(iter(loader.epoch(0))), torch.device("cuda"))
        state = ts.TrainState(model, AdamW3(model.named_parameters(), cfg, 1))
        with record_toolkit(classes, run):
            ts.train_step(state, b, cfg, ts.Gates.for_epoch(cfg, 0),
                          torch.Generator("cuda").manual_seed(4))
            torch.cuda.synchronize()
        if run == "stock step":
            model.eval()
            _, loader = eval_data(cfg)
            e = next(iter(loader.epoch(0)))
            with torch.no_grad(), record_toolkit(classes, "eval forward"):
                infer_voc(model, torch.as_tensor(e["images"], device="cuda"),
                          torch.as_tensor(e["pad_mask"], device="cuda"),
                          torch.as_tensor(e["orig_size"], device="cuda"),
                          with_flip=True)
                torch.cuda.synchronize()
        if run == "coco17 step":
            ds, loader = eval_data(cfg)
            with record_toolkit(classes, "coco17 eval"):
                evaluate_coco(model, loader, ds.raw, cfg,
                              torch.device("cuda"))
                torch.cuda.synchronize()
        del model, state, b
        torch.cuda.empty_cache()
    tmp.cleanup()
    return classes


def _toolkit_case(K, kc, kernel, case):
    """One replayed class -> (errors {output: (err, tol)}, the kernel's two
    runs identical (gemm: and nothing else written), all finite, the
    kernel call, the plain call, bound, library call or None, note)."""
    import torch

    if kernel == "gemm_kernel":
        err, tol, same, rest, finite = kc.gemm_check(K.gemm, K.gemm_reference,
                                                      case)
        c1, c2 = kc.clone_layout(case["c"]), kc.clone_layout(case["c"])
        return ({"c": (err, tol)}, same and rest, finite,
                lambda: K.gemm(case["a"], case["b"], c1, **case["kw"]),
                lambda: K.gemm_reference(case["a"], case["b"], c2,
                                         **case["kw"]),
                kc.gemm_bound_ms(case), kc.gemm_library(case), "")
    if kernel == "attn_kernel":
        errs, same, finite = kc.attention_check(K.attention,
                                                K.attention_reference, case)
        args, kw, _ = kc.attention_args(case)
        return (errs, same, finite, lambda: K.attention(*args, **kw),
                lambda: K.attention_reference(*args, **kw),
                kc.attention_bound_case_ms(case), kc.attention_library(case),
                f"; K/V copies of {K.attention_copy_bytes(*args, **kw)} bytes")
    if kernel == "linear_kernel":
        errs, same, finite = kc.linear_check(K.ln_linear, K.ln_linear_reference,
                                             case)

        def outs():   # the preallocated outputs of the recorded call
            kw = dict(case["kw"])
            for n in ("out", "aux"):
                if case[n] is not None:
                    kw[n] = kc.strided_like(case[n], torch.Generator(), "cuda")
            return kw

        kw1, kw2 = outs(), outs()
        return (errs, same, finite,
                lambda: K.ln_linear(case["a"], case["w"], **kw1),
                lambda: K.ln_linear_reference(case["a"], case["w"], **kw2),
                kc.linear_bound_ms(case), kc.linear_library(case), "")
    args, kw = case["args"], case["kw"]
    check, bound = {"th_bwd_rows_kernel": (kc.th_bwd_check, kc.th_bwd_bound_ms),
                    "th_fwd_rows_kernel": (kc.th_fwd_check, kc.th_fwd_bound_ms),
                    "attn_bwd_rows_kernel": (kc.attn_rows_check,
                                             kc.attn_rows_bound_ms)}[kernel]
    fn = getattr(K, WRAPPER[kernel])
    plain = getattr(K, f"{WRAPPER[kernel]}_reference")
    errs, same, finite = check(fn, plain, args, kw)
    return (errs, same, finite, lambda: fn(*args, **kw),
            lambda: plain(*args, **kw), bound(args, kw), None, "")


# the argument a SMALL wrapper writes in place (an output of the call)
WRITES = {"th_dq": 4}
# the SMALL wrappers held to their plain versions bit for bit, and those
# also timed with the L2 cache flushed before each call (cold_ms)
EXACT = ("th_fold",)
COLD = ("colsum", "th_fold", "colsum_f32", "ln_backward", "branch_backward",
        "th_dq", "layernorm", "th_mix")
# the SMALL wrappers with an entry of their own in the JSON line (their
# kernel, its source, the TPU code it replaces and the run whose sums head
# the entry): the four that finish their sums in one launch, where they
# called reduce_sum before, and the row passes layernorm and th_mix
SMALL_ENTRIES = {"colsum_f32": ("colsum_f32_kernel",
                                "spe_tpu_torch/csrc/grad.cu",
                                "spe_tpu/ops/pallas_block.py:336",
                                "stock step"),
                 "ln_backward": ("ln_bwd_kernel",
                                 "spe_tpu_torch/csrc/grad.cu",
                                 "spe_tpu/ops/pallas_block.py:74",
                                 "stock step"),
                 "branch_backward": ("branch_bwd_kernel",
                                     "spe_tpu_torch/csrc/grad.cu",
                                     "spe_tpu/ops/pallas_block.py:332",
                                     "stock step"),
                 "th_dq": ("th_dq_kernel", "spe_tpu_torch/csrc/th_train.cu",
                           "spe_tpu/ops/pallas_block.py:432", "stock step"),
                 "layernorm": ("layernorm_kernel",
                               "spe_tpu_torch/csrc/rowops.cu",
                               "spe_tpu/ops/pallas_block.py:63 (_ln_fwd; "
                               "pallas_encoder.py:163,174, "
                               "pallas_decoder.py:247,273,284)",
                               "stock step"),
                 "th_mix": ("th_mix_kernel", "spe_tpu_torch/csrc/rowops.cu",
                            "spe_tpu/ops/pallas_block.py:143-148",
                            "eval forward")}
# the SMALL_ENTRIES wrappers that called reduce_sum in their first design
ONE_LAUNCH_SUMS = ("colsum_f32", "ln_backward", "branch_backward", "th_dq")


def two_pass_reduces(name, args, kw):
    """The reduce_sum launches a call of a ONE_LAUNCH_SUMS wrapper made in
    the two-pass design it replaced: one a call, branch_backward's only
    with val (the dgamma sum)."""
    return int(args[1] is not None) if name == "branch_backward" else 1


def reduce_kernel(parts):
    """The kernel spe_reduce launches for a reduce_sum call on parts."""
    Z = parts.shape[0]
    return "reduce_block_kernel" if Z >= 256 and parts.numel() // Z <= 65535 \
        else "reduce_thread_kernel"


# the SMALL_ENTRIES wrappers whose plain versions make their dropout keys
# from host scalars (no CUDA graph): timed from the host
PLAIN_HOST = ("branch_backward",)


def _small_outputs(fn, name, args, kw):
    """fn on the arguments (a fresh copy of the one it writes) -> its
    output tensors."""
    args = list(args)
    if name in WRITES:
        args[WRITES[name]] = _copy(args[WRITES[name]])
    outs = _tensors(fn(*args, **kw))
    return outs + ([args[WRITES[name]]] if name in WRITES else [])


def _small_library(name, args, kw):
    """One PyTorch call that computes the SMALL wrapper's function on the
    recorded inputs (converted outside the timed call), or None: timed
    beside the kernel, never called by the port."""
    import torch
    import torch.nn.functional as F

    if name == "layernorm":
        x, w, b, eps = args
        w, b = w.to(x.dtype), b.to(x.dtype)
        return lambda: F.layer_norm(x, (x.shape[-1],), w, b, eps)
    if name == "ln_backward" and kw.get("res") is None:
        dy, x, w, eps = args
        xf = x.float().contiguous()
        mean = xf.mean(-1, keepdim=True)
        rstd = torch.rsqrt(xf.var(-1, unbiased=False, keepdim=True) + eps)
        zero = torch.zeros_like(w)
        return lambda: torch.ops.aten.native_layer_norm_backward(
            dy, xf, [x.shape[-1]], mean, rstd, w, zero, [True, True, True])
    if name == "colsum":
        return lambda: torch.sum(args[0], 1, dtype=torch.float32)
    if name == "softmax_backward" and args[2:3] in ((), (None,)) and \
            kw.get("dattn") is None:
        probs, dp = args[:2]
        return lambda: torch._softmax_backward_data(dp, probs, -1,
                                                    torch.float32)
    if name == "th_fold":
        q, rows = args
        out = torch.empty((q.shape[0], rows.shape[0], *q.shape[1:]),
                          dtype=torch.bfloat16, device=q.device)
        return lambda: torch.mul(q[:, None], rows[None, :, None, :], out=out)
    if name in ("colsum_f32", "reduce_sum"):
        return lambda: torch.sum(args[0], 0)
    return None


def ln_panel_equal(x, weight, bias, eps):
    """layernorm's bf16 output against ln_linear's LayerNorm panel on the
    same rows (an identity weight and a zero bias: the products are exact),
    bit for bit: both take common.cuh's statistics and normalisation."""
    import torch

    from spe_tpu_torch.ops import kernels as K

    D = x.shape[1]
    eye = torch.eye(D, device=x.device, dtype=torch.bfloat16)
    zero = torch.zeros(D, device=x.device)
    got = K.layernorm(x, weight, bias, eps, want_f32=False, want_bf16=True)[1]
    return bool(torch.equal(got, K.ln_linear(x, eye, zero,
                                             ln=(weight, bias, eps))))


def small_kernels(classes, results, per_class=None, runs=RECORDED_RUNS,
                  reps=20):
    """The SMALL wrappers' recorded classes (record_toolkit): each first
    call replayed on copies of its inputs, the kernel twice and its plain
    version (kernels.<name>_reference) once, every output within
    GRAD_REL_TOL of its largest plain magnitude (EXACT ones equal to it)
    and the two runs bit-identical; its device time in a CUDA graph (COLD
    ones also with the L2 cache flushed), its bound (the call's bytes over
    the memory rate) and the library's time (COLD ones also flushed); then
    the sums over each recorded run (launches x time), and the reduce_*
    launches beside those of the two-pass design (two_pass_reduces of each
    SMALL_ENTRIES call). The SMALL_ENTRIES wrappers' plain versions
    are timed too, and their stock-step sums go into `results`; with
    per_class (a list), every class's plain version is timed and its
    numbers appended there. The reduce_* lines cover `runs`; every timer
    takes `reps` calls. Fails on a mismatch."""
    import torch

    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import (HBM_BYTES_PER_MS, grad_tol,
                                                 max_err)

    bad, sums, two_pass, split = [], {}, {}, {}
    for (name, cls), rec in sorted(
            ((k, v) for k, v in classes.items() if k[0] in SMALL),
            key=lambda kv: (kv[0][0], -sum(kv[1]["launches"].values()))):
        args, kw = rec["call"]
        fn, plain = getattr(K, name), getattr(K, f"{name}_reference")
        got, again, want = (_small_outputs(f, name, args, kw)
                            for f in (fn, fn, plain))
        errs = [(max_err(g, w), 0.0 if name in EXACT else grad_tol(w))
                for g, w in zip(got, want)]
        same = len(got) == len(want) and all(
            torch.equal(g, a) for g, a in zip(got, again))
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
        passed = same and finite and all(e <= t for e, t in errs)
        panel_note = ""
        if name == "layernorm":
            panel = ln_panel_equal(*args)
            passed &= panel
            panel_note = f", bf16 out == ln_linear's panel {panel}"
        ms = graph_ms(lambda: fn(*args, **kw), reps)
        plain_ms = None
        if name in SMALL_ENTRIES or per_class is not None:
            timer = cuda_ms if name in PLAIN_HOST else graph_ms
            plain_ms = timer(lambda: plain(*args, **kw), reps=min(reps, 10)
                             if name in PLAIN_HOST else reps)
        cold = cold_ms(lambda: fn(*args, **kw), reps) if name in COLD \
            else None
        lib = _small_library(name, args, kw)
        lib_ms = graph_ms(lib, reps) if lib is not None else None
        lib_cold = cold_ms(lib, reps) if lib is not None and name in COLD \
            else None
        bound = rec["bytes"] / HBM_BYTES_PER_MS
        if ms is None:
            fail(f"{name} {cls}: not captured in a CUDA graph")
        shapes = [list(t.shape) for t in _tensors((args, kw))] + [
            v for v in (*args, *kw.items()) if not _tensors(v)]
        cold_note = "" if cold is None else f", L2-cold {cold:.4f} ms"
        lib_note = "" if lib_cold is None else f", L2-cold {lib_cold:.4f} ms"
        print(f"[small] {name} {shapes}: launches {rec['launches']}; "
              f"max_abs_err/tol {[f'{e:.2e}/{t:.2e}' for e, t in errs]} "
              f"identical {same} finite {finite}{panel_note} -> "
              f"{'ok' if passed else 'MISMATCH'}; on the device (CUDA graph): "
              f"kernel {ms:.4f} ms{cold_note}, bound {bound:.5f} ms (bytes), "
              f"library {'none' if lib is None else _ms(lib_ms)}{lib_note}",
              flush=True)
        if not passed:
            bad.append(f"{name} {shapes}")
        err = max((e for e, _ in errs), default=0.0)
        if per_class is not None:
            per_class.append({"name": name, "shapes": shapes,
                              "class": repr(cls), "launches": rec["launches"],
                              "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound, "library_ms": lib_ms,
                              "max_abs_err": err})
        for run, n in rec["launches"].items():
            if name == "reduce_sum":
                tot = split.setdefault((reduce_kernel(args[0]), run),
                                       [0, 0.0, 0.0])
                tot[0] += n
                tot[1] += n * ms
                tot[2] += n * bound
            if name in ONE_LAUNCH_SUMS:
                two_pass[run] = two_pass.get(run, 0) + n * two_pass_reduces(
                    name, args, kw)
            tot = sums.setdefault((name, run), [0, 0.0, 0.0, 0.0, 0.0, 0.0,
                                                0.0])
            tot[0] += n
            tot[1] += n * ms
            tot[2] += n * bound
            tot[3] = None if lib_ms is None or tot[3] is None else \
                tot[3] + n * lib_ms
            tot[4] = None if cold is None or tot[4] is None else \
                tot[4] + n * cold
            tot[5] = None if plain_ms is None or tot[5] is None else \
                tot[5] + n * plain_ms
            tot[6] = max(tot[6], err)
        del args, kw, got, again, want
    for (name, run), (n, ms, bound, lib_ms, cold, plain_ms, err) in \
            sorted(sums.items()):
        cold_note = "" if cold is None else f" (L2-cold {cold:.3f} ms)"
        plain_note = "" if plain_ms is None else f", plain {plain_ms:.3f} ms"
        print(f"[small] {name} ({', '.join(SMALL[name])}): one {run}: {n} "
              f"launches, kernel {ms:.3f} ms{cold_note}{plain_note}, bound "
              f"{bound:.4f} ms, library "
              f"{'none' if lib_ms is None else _ms(lib_ms)}", flush=True)
        if name in SMALL_ENTRIES and run == SMALL_ENTRIES[name][3]:
            kernel, source, replaces, _ = SMALL_ENTRIES[name]
            results[kernel] = {
                "name": kernel, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes", "library_ms": lib_ms, "cold_ms": cold,
                "per": f"sums of launches x time over one {run} (B=8), "
                       "each class replayed in a CUDA graph"}
    for (kernel, run), (n, ms, bound) in sorted(split.items()):
        print(f"[small] {kernel}: one {run}: {n} launches, kernel {ms:.3f} "
              f"ms, bound {bound:.4f} ms", flush=True)
    for run in runs:
        n = sums.get(("reduce_sum", run), [0])[0]
        rows = sum(e["launches"].get(run, 0) for (k, _), e in classes.items()
                   if k == "th_bwd_rows_kernel")
        calls = ", ".join(f"{k} {sums.get((k, run), [0])[0]}"
                          for k in ONE_LAUNCH_SUMS)
        print(f"[small] reduce_* launches over one {run}: {n} (the two-pass "
              f"design: {n + two_pass.get(run, 0) + rows}, with one a call "
              f"of {calls}, th_bwd_rows {rows}, branch_backward's with val "
              "only)", flush=True)
        if run == "attention step" and n:
            bad.append(f"{n} reduce_* launches over one attention step")
    torch.cuda.empty_cache()
    if bad:
        fail(f"kernels disagree with their plain versions, or the "
             f"attention step launched reduce_*: {bad}")


def replay_class(K, kc, kernel, cls, rec, gen, reps=20):
    """One recorded WRAPPER class replayed on fresh inputs of its layout
    against its plain version, twice, with its CUDA-graph time (`reps`
    calls a graph) and, at the full 20, its time from the host, plain
    time (3 calls, else 1), bound and library time; printed -> (its
    numbers, passed)."""
    import torch

    case = _replay(kernel, rec["call"], gen)
    errs, same, finite, fn, plain, bound, lib, extra_note = \
        _toolkit_case(K, kc, kernel, case)
    passed = finite and same and all(e <= t for e, t in errs.values())
    host_ms = cuda_ms(fn) if reps >= 20 else None
    ms = graph_ms(fn, reps)
    # the plain versions make their dropout keys on the host: timed from
    # the host
    plain_ms = cuda_ms(plain, reps=3, warmup=1) if reps >= 20 else \
        cuda_ms(plain, reps=1, warmup=0)
    lib_ms = graph_ms(lib, reps) if lib is not None else None
    if ms is None:
        fail(f"{kernel} {cls}: not captured in a CUDA graph")
    lib_note = (f"library {lib_ms:.4f} ms (kernel / library "
                f"{ms / lib_ms:.2f})" if lib_ms is not None else
                "no single PyTorch call computes it")
    print(f"[toolkit] {kernel} {cls}: launches {rec['launches']}; "
          f"max_abs_err/tol "
          f"{ {n: f'{v[0]:.3e}/{v[1]:.3e}' for n, v in errs.items()} } "
          f"identical {same} finite {finite} -> "
          f"{'ok' if passed else 'MISMATCH'}; on the device (CUDA graph): "
          f"kernel {ms:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]}), "
          f"{lib_note}; one call from the host: kernel {_ms(host_ms)}, "
          f"plain {plain_ms:.4f} ms{extra_note}", flush=True)
    del case, fn, plain, lib
    torch.cuda.empty_cache()
    return ({"class": repr(cls), "launches": rec["launches"], "ms": ms,
             "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound[0],
             "bound_by": bound[1], "library_ms": lib_ms,
             "max_abs_err": {n: v[0] for n, v in errs.items()}}, passed)


def phase_toolkit(results, extra=()):
    """The WRAPPER kernels (gemm_kernel, attn_kernel, linear_kernel and the
    three row kernels) at every class the main path gives them
    (record_classes), each on fresh random inputs of the recorded layout
    against its plain version (gemm, th_bwd_rows and attention_bwd_rows:
    1% of the largest plain magnitude; attention, ln_linear and
    th_fwd_rows' zd: 4 bf16 ulps at the output's, th_fwd_rows' lse 1e-5
    relative, probabilities 1e-4), twice (identical bits); their time
    beside the plain version's, the bound and the library's (torch.matmul
    on pre-rounded contiguous bf16 operands; scaled_dot_product_attention
    where it computes the same function; torch.addmm for ln_linear). Adds
    the kernels' entries to `results`, the per-class numbers under
    "classes" and the per-run sums (SUM_RUNS) at the top (the main run's)
    and under "per_run". Then the SMALL wrappers' classes (small_kernels).
    -> the recorded classes."""
    import torch

    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops import kernel_checks as kc

    t0 = time.perf_counter()
    classes = record_classes(extra=extra)
    print(f"[toolkit] recorded {len(classes)} classes over "
          f"{', '.join(RECORDED_RUNS)} (B=8) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    gen = torch.Generator().manual_seed(5)
    ok = True
    ratios = {"gemm_kernel": [], "linear_kernel": []}
    entries = {name: {"name": name, "route": "cuda", "source": src,
                      "replaces": rep, "launches": 0, "max_abs_err": 0.0,
                      "classes": []}
               for name, (src, rep) in TOOLKIT.items()}
    for (kernel, cls), rec in sorted(classes.items(), key=lambda kv: (
            kv[0][0], -sum(kv[1]["launches"].values()))):
        if kernel in SMALL or kernel in RECORDED_INPUTS:
            continue
        c, passed = replay_class(K, kc, kernel, cls, rec, gen)
        if c["library_ms"] and kernel in ratios:
            ratios[kernel].append(c["ms"] / c["library_ms"])
        ok &= passed
        e = entries[kernel]
        e["max_abs_err"] = max(e["max_abs_err"], *c["max_abs_err"].values())
        e["classes"].append(c)
    for name, e in entries.items():
        # per-run sums over the classes, launches x time
        e["per_run"] = {}
        for run in SUM_RUNS[name]:
            cl = [c for c in e["classes"] if c["launches"].get(run)]
            if not cl:
                fail(f"{name}: no launch in one {run}")
            tot = {k: sum(c["launches"][run] * c[k] for c in cl)
                   for k in ("ms", "plain_ms", "bound_ms")}
            libs = [c["library_ms"] for c in cl]
            tot.update(
                launches=sum(c["launches"][run] for c in cl),
                bound_by=max(cl, key=lambda c: c["bound_ms"] * c[
                    "launches"][run])["bound_by"],
                library_ms=None if None in libs else sum(
                    c["launches"][run] * c["library_ms"] for c in cl))
            e["per_run"][run] = tot
            print(f"[toolkit] {name}: {len(e['classes'])} classes; one {run}: "
                  f"{tot['launches']} launches, kernel {tot['ms']:.3f} ms, "
                  f"plain {tot['plain_ms']:.3f} ms, bound "
                  f"{tot['bound_ms']:.4f} ms, library "
                  f"{tot['library_ms'] if tot['library_ms'] is None else round(tot['library_ms'], 3)} ms",
                  flush=True)
        main = e["per_run"][SUM_RUNS[name][0]]
        e.update({k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
                 per=f"sums of launches x time over one "
                     f"{SUM_RUNS[name][0]} (B=8)")
        results[name] = e
    for name, rs in ratios.items():
        if rs:
            geo = math.exp(sum(math.log(r) for r in rs) / len(rs))
            lib = "torch.matmul" if name == "gemm_kernel" else "torch.addmm"
            print(f"[toolkit] {name} / {lib} over {len(rs)} classes: "
                  f"geometric mean {geo:.2f}, largest {max(rs):.2f}",
                  flush=True)
    if not ok:
        fail("a toolkit kernel disagrees with its plain version")
    small_kernels(classes, results)
    recorded_inputs(classes, results)
    return classes


def recorded_inputs(classes, results, require=True):
    """The inputs each recorded run gave each RECORDED_INPUTS kernel
    (record_toolkit): its outputs against its plain version, exactly (CC:
    labels and sweep counts; the auction: assignments, iteration and bid
    counts); the kernel's device time (CUDA graph) and its bound; under the
    "recorded" key of the kernel's entry. Fails on a mismatch or (with
    require) on a kernel with no launch recorded."""
    from spe_tpu_torch.ops import kernels as K

    for kernel in RECORDED_INPUTS:
        spec = _recorded_kernel(kernel)
        out = {}
        for (name, shape), rec in classes.items():
            if name != kernel:
                continue
            for run, x in rec["inputs"].items():
                want = spec["plain"](x)
                same, err = _exact(spec["call"](K, x), want)
                ms = graph_ms(lambda: spec["call"](K, x))
                bound, bound_by = spec["bound"](x, want)
                print(f"[toolkit] {kernel} {shape} of one {run}: launches "
                      f"{rec['launches']}; {spec['note'](x, want)}; outputs "
                      f"equal {same} (max_abs_err {err}); on the device "
                      f"(CUDA graph): kernel {_ms(ms)}, bound {bound:.5f} ms "
                      f"({bound_by})", flush=True)
                if not same:
                    fail(f"{kernel} {shape} of one {run}: the kernel differs "
                         "from the plain version")
                out[run] = {"shape": list(shape), "ms": ms, "bound_ms": bound,
                            f"max_{spec['count']}": int(want[1].max())}
        if not out and require:
            fail(f"no {kernel} launch recorded")
        if out:
            results.setdefault(spec["entry"], {})["recorded"] = out


def phase_against(parent_root):
    """The toolkit's classes (record_classes) on another checkout's
    kernels: its spe_tpu_torch/ops/kernels.py loaded beside this one (its
    own csrc, built into its own build/), each class's kernel timed on the
    device in turns (other, this, this, other) on the same inputs, the
    WRAPPER kernels' on fresh inputs of the recorded layout, the SMALL
    wrappers' on the recorded call's copies (the COLD ones also with the
    L2 cache flushed); then the sums over each run (launches x time)."""
    import importlib.util
    import os

    import torch

    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops import kernel_checks as kc

    path = os.path.join(parent_root, "spe_tpu_torch", "ops", "kernels.py")
    spec = importlib.util.spec_from_file_location("other_kernels", path)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    t0 = time.perf_counter()
    other.lib()
    print(f"[against] {other.library_path()} built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    classes = record_classes()
    gen = torch.Generator().manual_seed(5)
    sums = {}
    for (kernel, cls), rec in sorted(classes.items(), key=lambda kv: (
            kv[0][0], -sum(kv[1]["launches"].values()))):
        if kernel in RECORDED_INPUTS:
            continue
        small = kernel in SMALL
        case = None if small else _replay(kernel, rec["call"], gen)
        times, cold = {}, {}
        same_note = ""
        if small or kernel == "th_bwd_rows_kernel":
            if small:
                args, kw = rec["call"]
                mine, theirs = (_small_outputs(getattr(m, kernel), kernel,
                                               args, kw) for m in (K, other))
            else:
                mine, theirs = (m.th_bwd_rows(*case["args"], **case["kw"])
                                for m in (K, other))
            same_note = "; outputs equal to DIR's bit for bit: " + str(
                len(mine) == len(theirs) and
                all(torch.equal(a, b) for a, b in zip(mine, theirs)))
            del mine, theirs
        for mod in (other, K, K, other):
            if small:
                args, kw = rec["call"]
                fn = (lambda m=mod, a=args, k=kw: getattr(m, kernel)(*a, **k))
                if kernel in COLD:
                    cold.setdefault(mod is K, []).append(cold_ms(fn))
            elif kernel == "gemm_kernel":
                c1 = kc.clone_layout(case["c"])
                fn = (lambda m=mod: m.gemm(case["a"], case["b"], c1,
                                           **case["kw"]))
            elif kernel == "attn_kernel":
                args, kw, _ = kc.attention_args(case)
                fn = (lambda m=mod: m.attention(*args, **kw))
            elif kernel == "linear_kernel":
                kw = dict(case["kw"])
                for n in ("out", "aux"):
                    if case[n] is not None:
                        kw[n] = kc.strided_like(case[n], torch.Generator(),
                                                "cuda")
                fn = (lambda m=mod, kw=kw: m.ln_linear(case["a"], case["w"],
                                                       **kw))
            else:
                fn = (lambda m=mod, w=WRAPPER[kernel]: getattr(m, w)(
                    *case["args"], **case["kw"]))
            times.setdefault(mod is K, []).append(graph_ms(fn))
        print(f"[against] {kernel} {cls}: launches {rec['launches']}; on the "
              f"device (CUDA graph), other then this then this then other: "
              f"{times[False][0]:.4f} {times[True][0]:.4f} "
              f"{times[True][1]:.4f} {times[False][1]:.4f} ms{same_note}",
              flush=True)
        if cold:
            print(f"[against] {kernel} {cls}: L2-cold, other then this then "
                  f"this then other: {cold[False][0]:.4f} {cold[True][0]:.4f} "
                  f"{cold[True][1]:.4f} {cold[False][1]:.4f} ms", flush=True)
        for run in rec["launches"] if small else SUM_RUNS[kernel]:
            n = rec["launches"].get(run, 0)
            tot = sums.setdefault((kernel, run), [0.0, 0.0])
            tot[0] += n * statistics.mean(times[False])
            tot[1] += n * statistics.mean(times[True])
        del case
        torch.cuda.empty_cache()
    against_inputs(other, classes, sums)
    for (kernel, run), (o, t) in sorted(sums.items()):
        print(f"[against] {kernel}: one {run}, launches x time (mean of the "
              f"two turns): other {o:.3f} ms, this {t:.3f} ms", flush=True)


def against_inputs(other, classes, sums):
    """Each RECORDED_INPUTS kernel on phase 3's inputs and on each recorded
    run's, on the other checkout's kernel and on this one in turns (CUDA
    graph), the outputs of the two compared (a mismatch fails); the
    recorded runs' launches x time added to sums."""
    import torch

    from spe_tpu_torch.ops import kernels as K

    for kernel in RECORDED_INPUTS:
        spec = _recorded_kernel(kernel)
        cases = [(label, x, None, 0) for label, x in spec["checked"]()]
        for (name, _), rec in classes.items():
            if name == kernel:
                cases += [(f"one {run}'s", x, run, rec["launches"][run])
                          for run, x in rec["inputs"].items()]
        for label, x, run, n in cases:
            mine, theirs = (spec["call"](m, x) for m in (K, other))
            same = all(torch.equal(a, b) for a, b in zip(mine, theirs))
            times = {}
            for mod in (other, K, K, other):
                times.setdefault(mod is K, []).append(graph_ms(
                    lambda m=mod: spec["call"](m, x)))
            print(f"[against] {kernel} {label} {tuple(x[0].shape)} "
                  f"({spec['count']} up to {int(mine[1].max())}): on the "
                  f"device (CUDA graph), other then this then this then "
                  f"other: {times[False][0]:.4f} {times[True][0]:.4f} "
                  f"{times[True][1]:.4f} {times[False][1]:.4f} ms; outputs "
                  f"equal to DIR's: {same}", flush=True)
            if not same:
                fail(f"{kernel} {label}: the outputs differ from DIR's")
            if run is not None:
                tot = sums.setdefault((kernel, run), [0.0, 0.0])
                tot[0] += n * statistics.mean(times[False])
                tot[1] += n * statistics.mean(times[True])


def phase_masks():
    """The kernels' counter masks against the torch formula, bit for bit,
    at the recipe's rates and the block's shapes (B=2); the kept share of
    each within 4 sigma of 1 - rate."""
    import torch

    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import (HBM_BYTES_PER_MS,
                                                 RECIPE_RATES,
                                                 TRANSFORMER_RATE)
    from spe_tpu_torch.ops.refmath import (SITE_ATTN, SITE_CROSS_ATTN,
                                           SITE_CROSS_PROJ, SITE_HIDDEN,
                                           SITE_MHA_ATTN, SITE_OUT,
                                           SITE_PATH1, SITE_PROJ,
                                           SITE_TH_ATTN, counter_keep,
                                           path_keep)

    attn, proj, path = RECIPE_RATES
    rate = TRANSFORMER_RATE
    seed = torch.tensor([20240611], dtype=torch.int32, device="cuda")
    ok = True
    # the patch block's sites, then the encoder's and decoder's: the
    # encoder attention (B, 8, 1024, 1024), the decoder self-attention
    # keyed (b, s*H + h) (B, 2 * 8, 300, 300), the cross-attention and its
    # projection on sites of their own, the FFN of 2048; the standalone
    # attentions: talking heads after the mix (b, g, q, k), fused_mha's
    # encoder self-attention and decoder cross-attention (b, h, q, k)
    for site, rate, shape in ((SITE_ATTN, attn, (2, 4, 1024, 1024)),
                              (SITE_TH_ATTN, attn, (2, 4, 1024, 1024)),
                              (SITE_MHA_ATTN, rate, (2, 8, 1024, 1024)),
                              (SITE_MHA_ATTN, rate, (2, 8, 600, 1024)),
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
        # mask_kernel writes one byte an element and reads the seed
        bound = got.numel() / HBM_BYTES_PER_MS
        print(f"[masks] site {site} rate {rate} {shape}: kernel == torch "
              f"{same}; kept {share:.5f} vs {1 - rate:.5f} (4 sigma "
              f"{4 * sigma:.5f}) -> {'ok' if same and within else 'BAD'}; "
              f"mask_kernel bound {bound:.5f} ms (bytes written)",
              flush=True)
    if not ok:
        fail("the kernels' dropout masks differ from the torch formula")


def _check_train(name, mod, args, cot, label=""):
    """One training case: the kernels' training forward against the plain
    one, the backward kernels (twice: identical bits) against the plain
    backward on the kernels' saved tensors, and their times and bounds.
    -> (ok, {errors, times, bounds}); `label` names the shape."""
    import torch

    from spe_tpu_torch.ops.kernel_checks import (PROBS_TOL, ULPS,
                                                 backward_args, bf16_tol,
                                                 bwd_bound_ms, flat_grads,
                                                 grad_tols, max_err,
                                                 plain_train, saved_outputs,
                                                 train_bound_ms,
                                                 zero_grad_ref)

    plain_fwd, plain_bwd = plain_train(name, mod)
    with torch.no_grad():
        got = mod._train_cuda(*args)
        want = plain_fwd(*args)
        torch.cuda.synchronize()
        tols = [bf16_tol(w) for w in want]
        if name == "pallas_ca_block" or (name == "pallas_mha" and args[6]):
            tols[1] = PROBS_TOL      # the probabilities
        errs = [max_err(g, w) for g, w in zip(got, want)]
        fwd_ok = all(e <= t for e, t in zip(errs, tols)) and all(
            bool(torch.isfinite(g).all()) for g in got)
        # the backward of both on the kernels' saved tensors
        saved = backward_args(args, saved_outputs(name, got), cot)

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
            print(f"[train-kernels] {name}{label} {n} (zero in exact "
                  f"arithmetic): max|plain| "
                  f"{float(w.abs().max()):.3e}, err {e:.3e}, tol {tol:.3e} "
                  f"(1% of max|d {zero_grad_ref(n)}|)", flush=True)
        if not (e <= tol and bool(torch.isfinite(u).all())):
            bwd_ok = False
            print(f"[train-kernels] {name}{label} {n}: err {e:.3e} > tol "
                  f"{tol:.3e}", flush=True)
    m = dict(errs=errs, bwd_err=max(max_err(g1[k], gw[k]) for k in gw),
             ms_f=cuda_ms(lambda: mod._train_cuda(*args), reps=5, warmup=1),
             plain_f=cuda_ms(lambda: plain_fwd(*args), reps=5, warmup=1),
             ms_b=cuda_ms(bwd, reps=5, warmup=1),
             plain_b=cuda_ms(ref, reps=3, warmup=1))
    m["bf"], m["bf_by"] = train_bound_ms(name, args)
    m["bb"], m["bb_by"] = bwd_bound_ms(name, args, cot)
    print(f"[train-kernels] {name}{label} training forward: max_abs_err "
          f"{[f'{e:.3e}' for e in errs]} tol {[f'{t:.3e}' for t in tols]} "
          f"({ULPS} bf16 ulp at max|plain|; probabilities {PROBS_TOL}) -> "
          f"{'ok' if fwd_ok else 'MISMATCH'}; kernel {m['ms_f']:.3f} ms, plain "
          f"{m['plain_f']:.3f} ms, bound {m['bf']:.4f} ms ({m['bf_by']})",
          flush=True)
    print(f"[train-kernels] {name}{label} backward: {len(gw)} gradients "
          f"within tolerance "
          f"(1% of max|plain|; largest err/tol {worst:.3f}) {bwd_ok}; two runs "
          f"bit-identical {same}; kernel {m['ms_b']:.3f} ms, plain "
          f"{m['plain_b']:.3f} ms, bound {m['bb']:.4f} ms ({m['bb_by']}); no "
          "single PyTorch call computes it", flush=True)
    del g1, g2, gw, got, want, saved
    torch.cuda.empty_cache()
    return fwd_ok and bwd_ok and same, m


def _bwd_entry(results, name, source, m):
    from spe_tpu_torch.ops.kernel_checks import BWD_REPLACES

    prev = results.get(f"{name}_bwd", {}).get("max_abs_err", 0.0)
    results[f"{name}_bwd"] = {
        "name": f"{name}_bwd", "route": "cuda", "source": source,
        "replaces": BWD_REPLACES[name], "launches": 0,
        "max_abs_err": max(prev, m["bwd_err"]), "ms": m["ms_b"],
        "plain_ms": m["plain_b"], "bound_ms": m["bb"], "bound_by": m["bb_by"],
        "library_ms": None}


def phase_train_kernels(results):
    """Every fused layer's training forward and backward kernels against
    their plain versions at the recipe shapes (B=2; the recipe's dropout
    rates on the patch block, 0.1 on every encoder and decoder site, a
    nonzero CAM cotangent on class attention), and the standalone
    attention kernels' likewise (fused_mha at its three shapes, the
    talking-heads attention; the recipe's attention dropout); the backward
    run twice must give identical bits. The decoder runs layer 0 and a
    later layer; its entries carry the larger error and the later layer's
    times (5 of the 6 layers). The standalone attentions' entries carry
    the MAIN_SHAPE's times, every shape's under "shapes"."""
    from spe_tpu_torch.ops.kernel_checks import (SOURCE, attention_cases,
                                                 train_cases)

    bad = []
    for name, mod, args, cot in train_cases():
        ok, m = _check_train(name, mod, args, cot)
        if not ok:
            bad.append(name)
        results[name].update(
            train_ms=m["ms_f"], train_plain_ms=m["plain_f"],
            train_bound_ms=m["bf"],
            train_max_abs_err=max(results[name].get("train_max_abs_err", 0.0),
                                  *m["errs"]))
        _bwd_entry(results, name, SOURCE, m)
    for name, _, mod, args, cot, label in attention_cases(train=True):
        ok, m = _check_train(name, mod, args, cot, f" ({label})")
        if not ok:
            bad.append(f"{name} ({label})")
        entry = results[name]
        entry["train_max_abs_err"] = max(entry.get("train_max_abs_err", 0.0),
                                         *m["errs"])
        shape = entry["shapes"][label]
        shape.update(train_ms=m["ms_f"], train_plain_ms=m["plain_f"],
                     train_bound_ms=m["bf"], bwd_ms=m["ms_b"],
                     bwd_plain_ms=m["plain_b"], bwd_bound_ms=m["bb"])
        prev = results.get(f"{name}_bwd", {})
        if label == MAIN_SHAPE[name] or not prev:
            entry.update(train_ms=m["ms_f"], train_plain_ms=m["plain_f"],
                         train_bound_ms=m["bf"])
            _bwd_entry(results, name, SOURCE, m)
        results[f"{name}_bwd"]["max_abs_err"] = max(
            results[f"{name}_bwd"]["max_abs_err"], prev.get("max_abs_err", 0.0),
            m["bwd_err"])
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
    """Kernels 5 and 6 against their plain versions on the card, exactly
    (CC: labels and sweep counts, on 64 masks of 64 x 64 with two mazes
    past the sweep cap)."""
    import torch

    from spe_tpu_torch.ops import auction as auc
    from spe_tpu_torch.ops import connected_components as cc
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import (auction_bound_ms,
                                                 auction_problems,
                                                 cc_bound_ms, cc_masks)

    masks = cc_masks().cuda()
    got = (cc.connected_components(masks),
           *K.connected_components(masks, cc.MAX_SWEEPS))
    labels, sweeps = cc.connected_components_reference(masks,
                                                       with_sweeps=True)
    same, err = _exact(got, (labels, labels, sweeps))
    ms = cuda_ms(lambda: cc.connected_components(masks))
    dev_ms = graph_ms(lambda: K.connected_components(masks, cc.MAX_SWEEPS))
    plain_ms = cuda_ms(lambda: cc.connected_components_reference(masks),
                       reps=5, warmup=1)
    bound, bound_by = cc_bound_ms(masks, sweeps)
    per_sweep = "not measured" if dev_ms is None else \
        f"{1e3 * dev_ms / int(sweeps.max()):.2f} us"
    print(f"[kernels] pallas_cc: {tuple(masks.shape)} masks, sweeps "
          f"{sorted(set(sweeps.tolist()))} (cap {cc.MAX_SWEEPS}); labels and "
          f"sweep counts equal {same} (max_abs_err {err}); kernel {ms:.4f} ms "
          f"(on the device, CUDA graph: {_ms(dev_ms)}, {per_sweep} a sweep of "
          f"the slowest mask), plain {plain_ms:.3f} ms, bound {bound:.5f} ms "
          f"({bound_by}); no single PyTorch call computes it", flush=True)
    if not same or int(sweeps.max()) != cc.MAX_SWEEPS:
        fail("pallas_cc: labels or sweep counts differ from the plain "
             "version, or no mask reached the sweep cap")
    results.setdefault("pallas_cc", {}).update({
        "name": "pallas_cc", "route": "cuda",
        "source": "spe_tpu_torch/csrc/cc.cu",
        "replaces": "spe_tpu/ops/pallas_cc.py:109", "launches": 0,
        "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None})

    over = auction_problems(3, 120, 60, seed=1, device="cuda")
    same_over, _ = _exact(auc.auction_phase(*over),
                          auc.auction_phase_reference(*over))
    entry = results.setdefault("pallas_auction", {})
    for k, (name, shape) in enumerate(AUCTION_CHECKED):
        benefit, pmask = auction_problems(*shape, device="cuda")
        got = auc.auction_phase(benefit, pmask)
        want = auc.auction_phase_reference(benefit, pmask)
        same, err = _exact(got, want)
        ms = cuda_ms(lambda: auc.auction_phase(benefit, pmask))
        dev_ms = graph_ms(lambda: K.auction(benefit, pmask, auc.EPS,
                                            auc.MAX_ITERS))
        plain_ms = cuda_ms(lambda: auc.auction_phase_reference(benefit, pmask),
                           reps=3, warmup=1)
        bound, bound_by = auction_bound_ms(benefit, want[2], pmask)
        per_iter = "not measured" if dev_ms is None else \
            f"{1e3 * dev_ms / int(want[1].max()):.3f} us"
        print(f"[kernels] pallas_auction: {name}'s {tuple(benefit.shape)} "
              f"problems, valid persons {int(pmask.sum())}, iterations max "
              f"{int(want[1].max())} mean {float(want[1].float().mean()):.1f}"
              f", bids {int(want[2].sum())}; assignments/iterations/bids "
              f"equal {same} (max_abs_err {err}), overfull (3, 120, 60) "
              f"equal {same_over}; kernel {ms:.4f} ms (on the device, CUDA "
              f"graph: {_ms(dev_ms)}, {per_iter} an iteration of the slowest "
              f"problem), plain {plain_ms:.3f} ms, bound {bound:.5f} ms "
              f"({bound_by}); no single PyTorch call computes it", flush=True)
        if not (same and same_over):
            fail(f"pallas_auction: {name}'s problems: the kernel differs "
                 "from the plain version")
        times = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                 "bound_ms": bound, "bound_by": bound_by}
        if k:
            entry[name] = {"shape": list(benefit.shape),
                            "max_iterations": int(want[1].max()), **times}
            continue
        entry.update({
            "name": "pallas_auction", "route": "cuda",
            "source": "spe_tpu_torch/csrc/auction.cu",
            "replaces": "spe_tpu/ops/pallas_auction.py:123", "launches": 0,
            "max_abs_err": err, **times, "library_ms": None})
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


def kernel_vs_plain(cfg, b, tag, pick, weights=None):
    """One batch b through a kernel model and a plain-version model of cfg
    with the same weights -> (model, plain, pairs, failures); weights(m)
    loads more into each model after its init (a pretrained backbone;
    LayerScale then set to 1 over it, as below). The stock
    LayerScale (1e-5) would let every block's branches round away in bf16
    on both sides, so this pair is built with LayerScale 1; the last bbox
    layer is zero at init (conditional_detr.py:63-66), which leaves the
    boxes blind to the decoder, so both models get the same random one.
    pick(kernel outputs, plain outputs, the first class-attention block's
    probabilities of each) -> {name: (kernel, plain)}: each finite and
    within 5% of the plain one's largest magnitude (a map's: of its range,
    kernel_checks.MAP_KEYS)."""
    import torch

    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.ops.kernel_checks import MAP_KEYS, max_err, model_tol

    cfg = cfg.replace(init_scale=1.0)
    model = build_model(cfg)
    plain = build_model(cfg.replace(use_fused_block=False,
                                    use_fused_layers=False,
                                    use_pallas_attention=False))
    if weights is not None:   # then LayerScale 1 again, over the loaded one
        with torch.no_grad():
            for m in (model, plain):
                weights(m)
                for n, p in m.named_parameters():
                    if n.endswith(("gamma_1", "gamma_2")):
                        p.fill_(1.0)
    images = torch.as_tensor(b["images"], device="cuda")
    pad = torch.as_tensor(b["pad_mask"], device="cuda")
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
    pairs = pick(got, want, probs_got["probs"], probs_want["probs"])
    bad = []
    for k, (g, w) in pairs.items():
        if not bool(torch.isfinite(g).all()):
            bad.append(f"{k} not finite")
            continue
        err = max_err(g, w)
        tol = model_tol(k, w)
        print(f"[{tag}] {k} {tuple(g.shape)}: max_abs_err {err:.3e} vs plain "
              f"model, tol {tol:.3e} (0.05 x "
              f"{'range' if k in MAP_KEYS else 'max|plain|'})", flush=True)
        if err > tol:
            bad.append(f"{k} err {err:.3e} > {tol:.3e}")
    return model, plain, pairs, bad


def phase_slice(kernel_results, n_images=8, batch=8):
    import torch

    from spe_tpu_torch.cli.main import main as cli_main
    from spe_tpu_torch.cli.main import parse_config
    from spe_tpu_torch.data import eval_data, write_mini_voc
    from spe_tpu_torch.ops.kernel_checks import max_err, model_tol
    from spe_tpu_torch.train.engine import infer_voc

    tmp = tempfile.TemporaryDirectory()
    devkit = write_mini_voc(tmp.name, n_test=n_images)
    argv = ["--preset", "voc0712", "--eval", "--dataset_eval", "voc_voc",
            "--test_path", str(devkit), "--batch_size", str(batch),
            "--seed", "0", *NATIVE_OFF]
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

    cfg = parse_config(argv)
    _, loader = eval_data(cfg)
    b = next(iter(loader.epoch(0)))

    def pick(got, want, probs_got, probs_want):
        pairs = {"pred_logits": (got["stages"][0]["pred_logits"],
                                 want["stages"][0]["pred_logits"]),
                 "pred_boxes": (got["stages"][0]["pred_boxes"],
                                want["stages"][0]["pred_boxes"]),
                 "ca0_probs": (probs_got, probs_want),
                 "cams_cls": (got["backbone"]["cams_cls"],
                              want["backbone"]["cams_cls"]),
                 "x_logits": (got["backbone"]["x_logits"],
                              want["backbone"]["x_logits"])}
        for k, v in got["stages"][1].items():
            pairs[f"stage1.{k}"] = (v, want["stages"][1][k])
        return pairs

    model, plain, pairs, bad = kernel_vs_plain(cfg, b, "slice", pick)
    images = torch.as_tensor(b["images"], device="cuda")
    pad = torch.as_tensor(b["pad_mask"], device="cuda")
    sizes = torch.as_tensor(b["orig_size"], device="cuda")
    # what the same limits read on broken maps: the kernels' CAMs mirrored
    # left-right, and their probabilities with the heads rolled by one
    for k, broken in (("cams_cls", pairs["cams_cls"][0].flip(-1)),
                      ("ca0_probs", pairs["ca0_probs"][0].roll(1, dims=1))):
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
# the fused flags off with the preset's use_pallas_attention: every
# attention but the decoder self-attention through the standalone kernels
ATTN_TRAIN_ARGV = STOCK_TRAIN_ARGV + ["--no_use_fused_block",
                                      "--no_use_fused_layers"]


# the coco17 preset (90 classes, 48 boxes x 5 a problem, 16 CAM classes
# an image), every fused flag on; every loss gate open from the first step
COCO_TRAIN_ARGV = ["--preset", "coco17", "--batch_size", "8", "--epochs", "1",
                   "--warmup_cls_epochs", "0", "--refine_start_epoch", "0"]


def write_data(cfg, root, n_train, n_test, seed):
    """A generated dataset of cfg.dataset_file's kind under root, a
    mini-COCO of 90 classes or a VOCdevkit of 20 -> {its cfg field: its
    path}."""
    from spe_tpu_torch.data import write_mini_coco, write_mini_voc

    if cfg.dataset_file == "coco":
        return {"coco_path": str(write_mini_coco(
            root, n_train=n_train, n_val=n_test, seed=seed))}
    return {"test_path": str(write_mini_voc(
        root, n_test=n_test, n_trainval=n_train, seed=seed))}


def _supervision_counters():
    from spe_tpu_torch.ops import auction, connected_components

    return {"pallas_cc": connected_components.connected_components,
            "pallas_auction": auction.auction_phase}


def _attention_counters():
    """The standalone attention kernels: fused_mha serves the class
    attention, the encoder and the decoder cross-attention of the layers
    whose fused flag is off, the talking-heads attention the patch
    blocks'."""
    from spe_tpu_torch.ops import fused_mha, talking_heads

    return {"pallas_mha": fused_mha.fused_mha,
            "pallas_attention": talking_heads.talking_heads_attention}


def _per_forward(model):
    """{kernel: launches per forward} read off the built model's layers (a
    training step launches each as often forward and backward): a layer
    with use_fused set runs its fused kernel; one without it runs its
    attention through the talking-heads kernel (block_attention) or
    fused_mha (layer_attention), or plain."""
    from spe_tpu_torch.models.cait import (LayerScaleBlock,
                                           LayerScaleBlockClassAttn)
    from spe_tpu_torch.models.transformer import (ConditionalDecoderLayer,
                                                  TransformerEncoderLayer)
    from spe_tpu_torch.ops.fused_mha import layer_attention
    from spe_tpu_torch.ops.talking_heads import block_attention

    fused = {LayerScaleBlock: "pallas_block",
             LayerScaleBlockClassAttn: "pallas_ca_block",
             TransformerEncoderLayer: "pallas_encoder",
             ConditionalDecoderLayer: "pallas_decoder"}
    attention = {block_attention: "pallas_attention",
                 layer_attention: "pallas_mha"}
    per = dict.fromkeys([*_counters(), *_attention_counters()], 0)
    for m in model.modules():
        if type(m) not in fused:
            continue
        if m.use_fused:
            per[fused[type(m)]] += 1
        elif m.attention in attention:
            per[attention[m.attention]] += 1
    return per


def _all_counts(reset=False):
    """{counter name: launches} of every fused layer and standalone
    attention kernel (eval, training forward and backward) and the
    supervision kernels; with reset, set them all to 0 first."""
    fns = {**{k: fn for k, (fn, _) in _counters().items()},
           **_attention_counters()}
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


def phase_train(kernel_results, mode, n_train=24, n_test=8, batch=8,
                inspect=None):
    """The CLI trains the recipe at full width for 3 steps and evaluates:
    with the fused flags off (mode "off"), with the fused backbone
    ("backbone": 48 patch blocks and 2 class-attention blocks through their
    training kernels), as the stock preset ("stock": every fused layer
    through its training kernels) or with the fused flags off and
    use_pallas_attention on ("attention": the 48 patch blocks' attention
    through the talking-heads kernels, the class attention, the encoder
    and the decoder cross-attention through fused_mha); or the coco17
    preset as the stock one ("coco17", on a generated mini-COCO of 90
    classes, evaluated on both refinement stages with the eval losses: one
    auction launch an eval forward). inspect(CLI result, cfg, output
    directory, CLI argv) checks more of the run before its directory
    goes. -> (cfg, the launch counts of the run)."""
    import torch

    from spe_tpu_torch.cli.main import best_key, parse_config
    from spe_tpu_torch.cli.main import main as cli_main
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.train.checkpoint import restore_checkpoint
    from spe_tpu_torch.train.optim import AdamW3
    from spe_tpu_torch.train.train_step import TrainState

    tag, argv = {"off": ("train", TRAIN_ARGV),
                 "backbone": ("train-fused", FUSED_TRAIN_ARGV),
                 "stock": ("train-stock", STOCK_TRAIN_ARGV),
                 "attention": ("train-attention", ATTN_TRAIN_ARGV),
                 "coco17": ("train-coco17", COCO_TRAIN_ARGV)}[mode]
    # the kernels each mode's model runs (each a number of times per
    # forward that _per_forward reads off the built model)
    runs = {"off": (), "backbone": ("pallas_block", "pallas_ca_block"),
            "stock": tuple(_counters()),
            "attention": tuple(_attention_counters()),
            "coco17": tuple(_counters())}[mode]
    tmp = tempfile.TemporaryDirectory()
    data = write_data(parse_config(argv), tmp.name, n_train, n_test, seed=0)
    out = f"{tmp.name}/out"
    argv = argv + [a for k, v in data.items() for a in (f"--{k}", v)] + [
        "--output_dir", out]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _all_counts(reset=True)
    for name in WRAPPER.values():
        getattr(K, name).launches = 0
    t0 = time.perf_counter()
    res = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = _all_counts()
    toolkit = {k: getattr(K, name).launches for k, name in WRAPPER.items()}
    (epoch,) = res["epochs"]
    hist = epoch["train"]["history"]
    steps = len(hist)
    print(f"[{tag}] cli over {n_train} images, batch {batch}: {steps} steps, "
          f"then eval of {n_test}; {wall:.1f}s wall; launches {counts}; "
          f"toolkit launches {toolkit}", flush=True)
    for h in hist:
        print(f"[{tag}] step " + " ".join(f"{k} {v:.4f}" for k, v in h.items()),
              flush=True)
    bad = []
    if steps != n_train // batch:
        bad.append(f"{steps} steps, expected {n_train // batch}")
    want = {k: steps for k in _supervision_counters()}
    cfg = parse_config(argv)
    built = build_model(cfg)
    per = _per_forward(built)
    if {k for k, n in per.items() if n} != set(runs):
        bad.append(f"the model runs {per} per forward, expected only {runs}")
    # the epoch's eval forwards launch the eval kernels
    forwards = epoch["eval"]["forwards"]
    if cfg.dataset_eval == "coco":   # the eval losses: an auction a forward
        want["pallas_auction"] += forwards
    for k, n in per.items():
        want[f"{k}.train_launches"] = want[f"{k}.bwd_launches"] = n * steps
        want[f"{k}.launches"] = n * forwards
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
    init = built.state_dict()
    trained = state.model.state_dict()
    moved = max(float((trained[k].float() - v.float()).abs().max())
                for k, v in init.items())
    fresh = build_model(cfg)
    reload = TrainState(fresh, AdamW3(fresh.named_parameters(), cfg, 1))
    ep = restore_checkpoint(f"{out}/checkpoint.pth", reload)
    same = all(torch.equal(reload.model.state_dict()[k], v)
               for k, v in trained.items())
    key = best_key(cfg)
    print(f"[{tag}] weights moved by up to {moved:.3e}; checkpoint reloads "
          f"(epoch {ep}, optimizer count {reload.optimizer.count}, weights "
          f"equal {same}); eval {key} {epoch['eval'][key]:.4f} (random "
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
    if mode in ("stock", "attention"):
        # the toolkit's kernels: the stock preset is their main path, the
        # standalone attention runs all but linear_kernel (its layers are
        # plain) too
        for k, n in toolkit.items():
            if not n and (mode == "stock" or k != "linear_kernel"):
                bad.append(f"{k}: no launch")
            key = "launches" if mode == "stock" else "attention_launches"
            kernel_results[k][key] = n
        if bad:
            fail(f"{tag}: " + "; ".join(bad))
    if mode == "stock":   # this slice's main path: every kernel's count
        for k in _counters():
            kernel_results[f"{k}_bwd"]["launches"] = counts[f"{k}.bwd_launches"]
            kernel_results[k]["train_launches"] = counts[f"{k}.train_launches"]
        for k in _supervision_counters():
            kernel_results[k]["launches"] = counts[k]
    if mode == "attention":   # this slice's main path: the attention kernels
        for k in _attention_counters():
            kernel_results[k]["launches"] = counts[f"{k}.launches"] + counts[
                f"{k}.train_launches"]
            kernel_results[k]["train_launches"] = counts[f"{k}.train_launches"]
            kernel_results[k]["eval_launches"] = counts[f"{k}.launches"]
            kernel_results[f"{k}_bwd"]["launches"] = counts[f"{k}.bwd_launches"]
    if inspect is not None:
        inspect(res, cfg, out, argv)
    tmp.cleanup()
    return cfg, counts


def phase_same_step(cfg, label="fused flags off", batch=8):
    """One batch of supervision on the same model outputs through the
    kernels and through their plain versions (pseudo-boxes, assignments
    and iterations identical, losses within 1e-6 relative), each CC and
    auction launch of the kernel run replayed against its plain version
    (labels and sweep counts; assignments, iteration and bid counts;
    exactly); then one step's device-time split -> its profile's
    {kernel name: (ms, launches)}."""
    import torch

    from spe_tpu_torch.data import train_data
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.ops import auction as auc
    from spe_tpu_torch.ops import cam_boxes
    from spe_tpu_torch.ops import connected_components as cc
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.train import train_step as ts
    from spe_tpu_torch.train.engine import train_batch

    tmp = tempfile.TemporaryDirectory()
    cfg = cfg.replace(**write_data(cfg, tmp.name, batch, 1, seed=1))
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
    classes = {}
    with record_toolkit(classes, "same step"):
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
    for (kernel, shape), rec in sorted(classes.items()):
        spec = _recorded_kernel(kernel)
        x = rec["inputs"]["same step"]
        want = spec["plain"](x)
        same[kernel], err = _exact(spec["call"](K, x), want)
        print(f"[same-step] {label}: {kernel} {shape}: {spec['note'](x, want)}"
              f"; outputs equal to the plain version's {same[kernel]} "
              f"(max_abs_err {err})", flush=True)
    if {k for k, _ in classes} != set(RECORDED_INPUTS):
        fail(f"same step: recorded {sorted(classes)}")
    rel = max(abs(float(k_losses[k]) - float(p_losses[k]))
              / max(abs(float(p_losses[k])), 1e-30) for k in p_losses)
    print(f"[same-step] {label}: one batch, same model outputs: kernels vs "
          f"plain on the card: identical {same}; losses max relative "
          f"difference {rel:.3e} (limit 1e-6); totals {float(k_total):.6f} / "
          f"{float(p_total):.6f}; {int(k_seen['cam']['mask'].sum())} "
          f"pseudo-boxes, match_iters {float(k_losses['match_iters']):.0f}",
          flush=True)
    if not all(same.values()) or rel > 1e-6:
        fail("same step: the kernels and their plain versions disagree")

    rows = step_split(model, cfg, b, gates, label)
    tmp.cleanup()
    return rows


def step_split(model, cfg, b, gates, label, batch=8):
    """One train step's device-time split (CUDA events at the phase
    boundaries: model forward, supervision tail, with --masks the mask
    branch's matching and losses, backward, optimizer) and
    a profiled step's kernel sums with the device's idle share -> the
    profiled step's {kernel name: (ms, launches)}."""
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

    fwd, crit, masks, opt_step = (model.forward, ts.set_criterion_multi,
                                  ts.mask_branch, state.optimizer.step)

    def forward(*a, **kw):
        mark("model")
        r = fwd(*a, **kw)
        mark("supervision")
        return r

    def set_crit(*a, **kw):
        r = crit(*a, **kw)
        mark("backward")
        return r

    def mask_branch(*a, **kw):   # the mask matching and losses
        mark("masks")
        r = masks(*a, **kw)
        mark("backward")
        return r

    def step(*a, **kw):
        mark("optimizer")
        r = opt_step(*a, **kw)
        mark("end")
        return r

    model.forward, ts.set_criterion_multi, ts.mask_branch = \
        forward, set_crit, mask_branch
    state.optimizer.step = step
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts.train_step(state, b, cfg, gates, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        del model.forward, state.optimizer.step
        ts.set_criterion_multi, ts.mask_branch = crit, masks
    names = ["model", "supervision", *(["masks"] if "masks" in marks
                                       else []),
             "backward", "optimizer", "end"]
    split = {a: marks[a].elapsed_time(marks[c]) for a, c in
             zip(names, names[1:])}
    total = sum(split.values())
    print(f"[split] {label}: one train step, batch {batch}, device "
          f"timeline between CUDA events: " + ", ".join(
              f"{k} {v:.1f} ms ({100 * v / total:.1f}%)"
              for k, v in split.items())
          + f"; host wall {wall:.1f} ms ({card()})", flush=True)
    torch.cuda.reset_peak_memory_stats()
    rows = profile_forward(lambda: ts.train_step(state, b, cfg, gates, gen),
                           batch, reps=1, what=f"train steps ({label})")
    print(f"[split] {label}: peak device memory of a step "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
          f"({card()})", flush=True)
    return rows


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
# 0.86-0.999). They react so to any rounding upstream: with the fused
# flags off and the standalone attention kernels on, this self-attention is
# plain on both sides, yet they miss 5% on the same names whether the
# kernels or the kernels' plain versions (f32 scale and mixes) run in place
# of the plain model's attentions, and the kernels miss it against their
# own plain versions too (f32 sums in another order), while every path
# stays as close to the f32 model as the plain bf16 one.
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
# At B=2 the synthetic data's decoder linear1 gradients are bf16 noise at
# init on both paths, with or without the mask head (PERF.md §6, PR 18:
# each bf16 side ~20% of the largest from the f32 one): phase 13's (g),
# which fits two ranks on the card only at B=2, holds them to the f32 model
# by NOISY's rule too
NOISY_B2 = re.compile(NOISY.pattern + r"|transformer\.decoder\.layers\.\d+\."
                      r"linear1\.(weight|bias)$")
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


@contextlib.contextmanager
def _plain_attention(on=True):
    """With on, the standalone attention Functions (MHAFn, TalkingHeadsFn)
    take their plain versions on the card too, the training forwards and
    hand-derived backwards that the kernel checks hold the kernels to: the
    kernels' math (the scale on the f32 logits, the talking-heads mixes in
    f32, unfolded) without the kernels."""
    from spe_tpu_torch.ops import fused_mha, talking_heads

    saved = fused_mha._plain, talking_heads._plain
    if on:
        fused_mha._plain = talking_heads._plain = lambda t: True
    try:
        yield
    finally:
        fused_mha._plain, talking_heads._plain = saved


def _hold(gf, gp, g32, noisy):
    """Hold the gradients gf to gp: each within MODEL_REL_TOL of its
    largest plain magnitude; with `noisy` (a pattern of names) and the f32
    model's gradients g32, a named one beyond it is held to the f32 math
    instead (see NOISY). -> (failures, the escaped names' (name, err,
    err vs f32, plain vs f32, cosines), names without a gradient on a
    side, how many within, (worst name, its relative error))."""
    from spe_tpu_torch.ops.kernel_checks import MODEL_REL_TOL, zero_grad_ref

    worst, escaped, zero, within, bad = ("", 0.0), [], [], 0, []
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
            within += 1
            if top > 0 and err / top > worst[1]:
                worst = (n, err / top)
            continue
        if noisy is None or not noisy.match(n):
            # with an f32 run, where each bf16 side lies from it (a reading,
            # not a rule)
            f32 = "" if g32 is None or g32.get(n) is None else (
                f"; against f32: fused {float((g - g32[n]).abs().max()):.3e}"
                f", plain {float((w - g32[n]).abs().max()):.3e}")
            bad.append(f"{n}: err {err:.3e} > {tol:.3e} (max|plain| "
                       f"{top:.3e}){f32}")
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
    return bad, escaped, zero, within, worst


def _report(label, pair, lf, lp, n_grads, held, noisy):
    """Print one pair's verdict of the same-grads check -> its failures."""
    from spe_tpu_torch.ops.kernel_checks import MODEL_REL_TOL

    bad, escaped, zero, within, worst = held
    bad = list(bad)
    for k, v in lp.items():
        if abs(lf[k] - v) > MODEL_REL_TOL * abs(v) + 1e-6:
            bad.append(f"loss {k}: {lf[k]:.6f} vs {v:.6f}")
    if zero:
        bad.append(f"no gradient on a side: {zero}")
    cosines = [e[4] for e in escaped if e[4] is not None]
    drops = [e[5] - e[4] for e in escaped if e[4] is not None]
    rule = (f"{len(escaped)} decoder self-attention q/k gradients beyond "
            f"it, held to the f32 model (vs f32 <= {NOISE_FACTOR} x plain "
            f"bf16 vs f32, largest ratio "
            f"{max((e[2] / max(e[3], 1e-30) for e in escaped), default=0):.2f}"
            f"; cosine with f32 >= max({COS_MIN}, plain's - {COS_MARGIN}), "
            f"lowest {min(cosines, default=1):.4f}, largest drop from "
            f"the plain one's {max(drops, default=0):.4f})"
            if noisy is not None else "none may miss it")
    print(f"[same-grads] {label}: {pair}: losses {len(lp)} (total "
          f"{sum(lf.values()):.6f} vs {sum(lp.values()):.6f}); "
          f"{n_grads} parameter gradients (fused "
          f"q|k|v tensors in thirds), {within} within {MODEL_REL_TOL} of "
          f"max|plain| (largest {worst[1]:.3e}, {worst[0]}); {rule}; "
          f"parameters without a gradient {len(zero)}", flush=True)
    for n, e, e32, p32, cf_, cp_ in sorted(escaped, key=lambda r: -r[1]):
        cos = "zero by construction" if cf_ is None else \
            f"cosine with f32: {cf_:.4f} vs plain {cp_:.4f}"
        print(f"[same-grads] {label}: {pair}: noise-dominated {n}: (all / "
              f"max|plain|) vs plain {e:.3f}, vs f32 {e32:.3f}, plain vs "
              f"f32 {p32:.3f}; {cos}", flush=True)
    for line in bad[:20]:
        print(f"[same-grads] {label}: {pair}: {line}", flush=True)
    return bad


def phase_same_grads(cfg, label, noisy=None, batch=8, weights=None):
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
    both sides (the backbone's nonzero). Where `cfg` runs the standalone
    attention kernels, one more run takes their plain versions in their
    place (_plain_attention); the kernels are held to it, and it to the
    plain model, by the same rule: whether a miss comes from the kernels
    or from their math. weights(m) loads more into every model after its
    init (a pretrained backbone). Then the fused configuration's step
    split. With --masks the plain run's mask matching is replayed too, and
    the segmentation head's gradients held by the same rule."""
    import torch

    from spe_tpu_torch.data import train_data, write_mini_voc
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.ops.kernel_checks import grad_views
    from spe_tpu_torch.train import train_step as ts
    from spe_tpu_torch.train.engine import train_batch

    tmp = tempfile.TemporaryDirectory()
    # a generated VOCdevkit, or the synthetic dataset (with its masks
    # under --masks) where cfg trains on it
    data = {} if cfg.dataset_file == "synthetic" else {
        "test_path": str(write_mini_voc(tmp.name, n_test=1,
                                        n_trainval=batch, seed=2))}
    cfg = cfg.replace(**data, batch_size=batch, dropout=0.0,
                      backbone_drop_rate=0.0, drop_attn_rate=0.0,
                      drop_path_rate=0.0)
    plain_cfg = cfg.replace(use_fused_block=False, use_fused_layers=False,
                            use_pallas_attention=False)
    _, loader = train_data(cfg)
    b = train_batch(next(iter(loader.epoch(0))), torch.device("cuda"))
    gates = ts.Gates.for_epoch(cfg, 0)

    def gen():
        return torch.Generator("cuda").manual_seed(3)

    def build(run_cfg):
        model = build_model(run_cfg).train()
        if weights is not None:
            weights(model)
        return model

    runs, sup = {}, None
    # the fused run's model, built first: what it launches decides the runs
    fused_model = build(cfg)
    order = [("plain", plain_cfg)]
    if noisy is not None:
        order.append(("f32", plain_cfg.replace(compute_dtype="float32")))
    attention = any(_per_forward(fused_model)[k]
                    for k in _attention_counters())
    if attention:
        order.append(("kernel math", cfg))
    order.append(("fused", cfg))
    for run, run_cfg in order:
        model = fused_model if run == "fused" else build(run_cfg)
        if run == "fused":   # what the fused run would have used on its own
            own = ts.compute_losses(model, b, run_cfg, gates, gen())[2]
            own = {"cam": _same_tree(own["cam"], sup["cam"]),
                   "refine": _same_tree(own["refine"], sup["refine"]),
                   # the rows (its statistics count iterations)
                   "matching": _same_tree(own["matching"][0],
                                          sup["matching"][0])}
        _all_counts(reset=True)
        with _plain_attention(run == "kernel math"):
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
        if run != "fused":
            del model, total, losses
            torch.cuda.empty_cache()
    (lf, gf, cf), (lp, gp, _) = runs["fused"], runs["plain"]
    g32 = runs["f32"][1] if noisy is not None else None
    print(f"[same-grads] {label}: the fused run's own supervision equal to "
          f"the plain run's (replayed, so all runs differentiate one loss): "
          f"{own}", flush=True)
    bad = []
    want = {f"{k}.{a}": n for k, n in _per_forward(fused_model).items()
            for a in ("train_launches", "bwd_launches")}
    if any(cf[k] != n for k, n in want.items()):
        bad.append(f"fused launches {cf}, expected {want}")
    held = _hold(gf, gp, g32, noisy)
    bad += _report(label, "fused layers vs every fused flag off", lf, lp,
                   len(gp), held, noisy)
    if attention:
        lm, gm, cm = runs["kernel math"]
        # (the fused layers of a mixed configuration, e.g. the stock
        # preset with --pre_norm, launch their kernels in every run)
        launched = {k: v for k, v in cm.items() if v and k.split(".")[0]
                    in _attention_counters()}
        if launched:
            bad.append(f"the kernel-math run launched the attention "
                       f"kernels: {launched}")
        bad += _report(label, "kernels vs their plain versions", lf, lm,
                       len(gp), _hold(gf, gm, g32, noisy), noisy)
        math = _hold(gm, gp, g32, noisy)
        bad += _report(label, "their plain versions vs every fused flag off",
                       lm, lp, len(gp), math, noisy)
        missed = {e[0] for e in held[1]}
        print(f"[same-grads] {label}: beyond {len(missed)} names with the "
              f"kernels, {len(math[1])} with their plain versions, "
              f"{len(missed & {e[0] for e in math[1]})} of them the same",
              flush=True)
    print(f"[same-grads] {label}: training launches "
          f"{({k: v for k, v in cf.items() if 'train' in k})}", flush=True)
    if bad:
        fail(f"same grads ({label}): the fused layers disagree with the "
             "plain ones")
    del runs, gf, gp, g32
    fused_model.zero_grad(set_to_none=True)
    step_split(fused_model, cfg, b, gates, label, batch)
    tmp.cleanup()


# the stats of one COCO evaluation (engine.evaluate_coco) and its losses
COCO_STATS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10",
              "AR100", "ARs", "ARm", "ARl")
COCO_LOSSES = ("eval_loss_ce", "eval_loss_bbox", "eval_loss_giou",
               "eval_cardinality_error")


def coco_eval(res, cfg, out, argv, batch=8, n_large=64):
    """The coco17 CLI run's epoch eval: every stage's stats (AP/AR in
    [0, 1] or -1; the eval losses finite) and eval/stage{s}_000.npz; each
    stage's eval time (forward, top-100, NMS, eval losses, the host's
    COCO accumulation; the loader's decode included) on the run's val
    images and on n_large others, split into a cost an image and a fixed
    cost an eval; one profiled stage-0 eval of the n_large images (the
    eval losses' auction at 48 persons a problem, one a batch); then
    `--eval --resume` of the run's checkpoint reproduces the stats within
    1e-9."""
    import torch

    from spe_tpu_torch.cli.main import main as cli_main
    from spe_tpu_torch.data import eval_data, write_mini_coco
    from spe_tpu_torch.train import engine

    stats = res["epochs"][0]["eval"]
    stages = range(cfg.num_refines + 1)
    bad = []
    for st in stages:
        got = {k: stats[f"stage{st}_{k}"] for k in COCO_STATS + COCO_LOSSES}
        print(f"[coco] stage {st}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in got.items()) + " (random weights: no "
            "accuracy meaning)", flush=True)
        bad += [f"stage {st} {k} {got[k]}" for k in COCO_STATS
                if not (got[k] == -1.0 or 0.0 <= got[k] <= 1.0)]
        bad += [f"stage {st} {k} {got[k]}" for k in COCO_LOSSES
                if not math.isfinite(got[k])]
        npz = f"{out}/eval/stage{st}_000.npz"
        if not os.path.exists(npz):
            bad.append(f"no {npz}")
    tmp = tempfile.TemporaryDirectory()
    large = cfg.replace(coco_path=str(write_mini_coco(tmp.name, n_val=n_large,
                                                      seed=5)))
    model, dev = res["state"].model, torch.device("cuda")
    sets = [eval_data(cfg), eval_data(large)]
    for st in stages:
        secs = {}
        for ds, loader in sets:
            runs = []
            for _ in range(3):   # the first warms up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.evaluate_coco(model, loader, ds.raw, cfg, dev,
                                     refine_stage=st)
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            secs[len(ds)] = statistics.mean(runs[1:])
            print(f"[coco] stage {st}: eval of {len(ds)} images at batch "
                  f"{batch} (forward, top-100, NMS, eval losses, host COCO "
                  f"accumulation, JPEG decode): seconds {runs} (first warms "
                  f"up) = {len(ds) / secs[len(ds)]} images/s", flush=True)
        (n0, s0), (n1, s1) = sorted(secs.items())
        per = (s1 - s0) / (n1 - n0)
        print(f"[coco] stage {st}: {per * 1e3} ms an image and "
              f"{(s0 - n0 * per) * 1e3} ms an eval (the line through "
              f"{n0} and {n1} images) = {1 / per} images/s past the fixed "
              "cost", flush=True)
    ds, loader = sets[1]
    rows = profile_forward(
        lambda: engine.evaluate_coco(model, loader, ds.raw, cfg, dev),
        batch, reps=1, what=f"COCO evals of {len(ds)} images (stage 0, "
                            "eval losses included)")
    auction = {k: v for k, v in rows.items() if "auction_kernel" in k}
    print(f"[coco] the eval losses' auction (48 persons x 300 queries a "
          f"problem) in the profiled eval (ms, launches): {auction}",
          flush=True)
    if sum(n for _, n in auction.values()) != -(-len(ds) // batch):
        bad.append(f"the profiled eval launched the auction {auction}")
    tmp.cleanup()

    again = cli_main(argv + ["--eval", "--resume", f"{out}/checkpoint.pth",
                             "--output_dir", ""])
    diff = {k: abs(again[k] - v) for k, v in stats.items()
            if isinstance(v, float)}
    worst = max(diff, key=diff.get)
    print(f"[coco] --eval --resume checkpoint.pth: {len(diff)} stats, "
          f"largest difference {diff[worst]:.3e} ({worst}; limit 1e-9)",
          flush=True)
    if diff[worst] > 1e-9:
        bad.append(f"the resumed eval's {worst} differs by {diff[worst]:.3e}")
    if bad:
        fail("coco eval: " + "; ".join(bad))


def phase_coco(kernel_results, batch=8):
    """The coco17 preset on the card (phase 9): the CLI trains 3 steps at
    full width through every fused layer and evaluates both stages
    (phase_train's checks and coco_eval's); one coco17 batch's supervision
    through the kernels and their plain versions, and its step's split,
    whose auction must take the device-memory path (240 x 300 rows pass
    shared memory: auction_kernel<0>); then one batch of 8 through a
    kernel model and a plain-version model (phase 4's rule) on the aux
    layer's logits and boxes of both stages (the evaluated layer), the 90
    CAMs and the first class-attention block's probabilities (91 rows)."""
    from spe_tpu_torch.data import eval_data, write_mini_coco

    cfg, counts = phase_train(kernel_results, "coco17", inspect=coco_eval)
    for k in _counters():   # the coco17 run's counts beside the main path's
        kernel_results[k]["coco17_train_launches"] = counts[
            f"{k}.train_launches"]
        kernel_results[f"{k}_bwd"]["coco17_launches"] = counts[
            f"{k}.bwd_launches"]
    for k in _supervision_counters():
        kernel_results[k]["coco17_launches"] = counts[k]
    rows = phase_same_step(cfg, "coco17 stock preset")
    auction = {k: v for k, v in rows.items() if "auction_kernel" in k}
    print(f"[coco] the step's auction (ms, launches): {auction}", flush=True)
    if [n for k, (_, n) in auction.items()] != [1] or \
            "auction_kernel<0>" not in next(iter(auction)):
        fail(f"coco17: the step's auction did not run once on the "
             f"device-memory path: {auction}")

    tmp = tempfile.TemporaryDirectory()
    cfg = cfg.replace(coco_path=str(write_mini_coco(tmp.name, n_val=batch,
                                                    seed=4)))
    _, loader = eval_data(cfg)

    def pick(got, want, probs_got, probs_want):
        pairs = {"ca0_probs": (probs_got, probs_want),
                 "cams_cls": (got["backbone"]["cams_cls"],
                              want["backbone"]["cams_cls"])}
        for st in range(cfg.num_refines + 1):
            g, w = got["stages"][st], want["stages"][st]
            for k in ("aux_pred_logits", "aux_pred_boxes"):
                pairs[f"stage{st}.{k}[-1]"] = (g[k][-1], w[k][-1])
        return pairs

    _, _, pairs, bad = kernel_vs_plain(cfg, next(iter(loader.epoch(0))),
                                       "coco", pick)
    if tuple(pairs["cams_cls"][0].shape[:2]) != (batch, 90):
        bad.append(f"CAMs {tuple(pairs['cams_cls'][0].shape)}")
    if bad:
        fail("coco17 vs plain model: " + "; ".join(bad))
    tmp.cleanup()


# phase 10: the wider registered two-branch backbones through the kernels
# at full width and depth under the voc0712 preset at 512^2 (1024
# patches): XS24 (6 heads, dt = 36), S24 (8 heads, dt = 48; S36 has its
# shapes) started from a checkpoint in timm's layout, and M48 (16 heads,
# dt = 96, a 448 source grid; M36 has its shapes but for its 384 grid)
# (tag, backbone, weights from a timm checkpoint, timed steps, the names
# the B=2 same-grads check holds to f32): the single-branch XXS36 (no
# det-branch stack, det features at block index layer_to_det, the heads'
# mean CAM) takes the eval and same-grads checks; at B=2 its decoder
# linear1 gradients are bf16 noise on both paths, as NOISY_B2 says, and
# are held to the f32 run as phase 13's (g) holds them
BACKBONES = (("XS24", "TSCAM_cait_XS24_Two_Branch", False, True, NOISY),
             ("S24", "TSCAM_cait_S24_Two_Branch", True, True, NOISY),
             ("M48", "TSCAM_cait_M48_Two_Branch", False, True, NOISY),
             ("XXS36 single-branch", "TSCAM_cait_XXS36", False, False,
              NOISY_B2))
# the timed steps' batch: the recipe's 8, else the largest of these that fits
BACKBONE_BATCHES = (8, 4, 2)
# multi-scale buckets of max_size 640 at the 128 quantum: the JAX bench's
# 512 x 640 (1280 patches) and 640 x 640 (1600)
MULTISCALE_BUCKETS = ((512, 640), (640, 640))
# calls a CUDA graph of phase 10's replays (phase 3's: 20)
REPLAY_REPS = 5
# the source and the TPU code of each SMALL wrapper's kernel
SMALL_SOURCES = {
    "layernorm": ("rowops.cu", "spe_tpu/ops/pallas_block.py:63"),
    "colsum": ("rowops.cu", "spe_tpu/ops/pallas_block.py:143-148"),
    "th_mix": ("rowops.cu", "spe_tpu/ops/pallas_block.py:143-148"),
    "reduce_sum": ("grad.cu", "spe_tpu/ops/pallas_block.py:513"),
    "colsum_f32": ("grad.cu", "spe_tpu/ops/pallas_block.py:336"),
    "ln_backward": ("grad.cu", "spe_tpu/ops/pallas_block.py:74"),
    "branch_backward": ("grad.cu", "spe_tpu/ops/pallas_block.py:332"),
    "th_fold": ("th_train.cu", "spe_tpu/ops/pallas_block.py:136"),
    "th_dq": ("th_train.cu", "spe_tpu/ops/pallas_block.py:432"),
    "softmax_backward": ("th_train.cu", "spe_tpu/ops/pallas_ca_block.py:166")}


def write_timm_checkpoint(cfg, path, seed):
    """A pretrained CaiT checkpoint of cfg.backbone in timm's layout, from
    seeded random weights (the port's init of the backbone, its
    LayerScale included): {'model': {'module.' + name: tensor}} with the blocks,
    the class-attention blocks, the patch embedding, pos_embed on the
    backbone's source grid, cls_token, norm and a 1000-class `head`; no
    det branch, norm_det, extra_cls_token or detector heads (the loader
    clones the det branch from the tail blocks)."""
    import torch

    from spe_tpu_torch.models.build import build_model

    body = build_model(cfg.replace(seed=seed), device="cpu").backbone[0].body
    own = ("blocks_det.", "norm_det.", "extra_cls_token", "cls_head")
    sd = {k: v for k, v in body.state_dict().items() if not k.startswith(own)}
    gen = torch.Generator().manual_seed(seed)
    sd["head.weight"] = 0.02 * torch.randn((1000, body.cfg.embed_dim),
                                           generator=gen)
    sd["head.bias"] = torch.zeros(1000)
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, path)
    print(f"[backbones] wrote {path}: {len(sd)} entries in timm's layout "
          f"({sum(v.numel() for v in sd.values())} values)", flush=True)


def _flipped(b):
    """An eval batch and its left-right flip, as infer_voc's flip-TTA runs
    them: one forward of 2 x batch images."""
    import numpy as np

    return {k: np.concatenate([b[k], b[k][:, :, ::-1]])
            for k in ("images", "pad_mask")}


def _stage_pairs(got, want, probs_got, probs_want):
    """phase 4's outputs: stage 0's logits and boxes, the first class-
    attention block's probabilities, the CAMs, the image logits and every
    output of stage 1."""
    pairs = {"pred_logits": (got["stages"][0]["pred_logits"],
                             want["stages"][0]["pred_logits"]),
             "pred_boxes": (got["stages"][0]["pred_boxes"],
                            want["stages"][0]["pred_boxes"]),
             "ca0_probs": (probs_got, probs_want),
             "cams_cls": (got["backbone"]["cams_cls"],
                          want["backbone"]["cams_cls"]),
             "x_logits": (got["backbone"]["x_logits"],
                          want["backbone"]["x_logits"])}
    for k, v in got["stages"][1].items():
        pairs[f"stage1.{k}"] = (v, want["stages"][1][k])
    return pairs


def backbone_steps(cfg, tag, weights, classes, n_timed=3):
    """The stock preset's training step with cfg's backbone through every
    kernel: at BACKBONE_BATCHES' first batch size that fits, a warm-up
    step, a step recorded into classes (run "<tag> step"), then n_timed
    timed steps (host clock to the loss read back), with every launch
    counter set to 0 before them and checked after (the fused layers'
    training forwards and backwards per _per_forward, every toolkit
    wrapper launched); the losses finite, no skipped step; peak memory;
    a profiled step's device busy time and idle share -> the summary."""
    import itertools

    import torch

    from spe_tpu_torch.data import train_data
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.train import train_step as ts
    from spe_tpu_torch.train.engine import LOGGED, train_batch
    from spe_tpu_torch.train.optim import AdamW3

    for batch in BACKBONE_BATCHES:
        bcfg = cfg.replace(batch_size=batch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = state = None
        try:
            model = build_model(bcfg).train()
            if weights is not None:
                weights(model)
            _, loader = train_data(bcfg)
            batches = [train_batch(x, torch.device("cuda")) for x in
                       itertools.islice(loader.epoch(0), 2)]
            state = ts.TrainState(model, AdamW3(model.named_parameters(),
                                                bcfg, 2 + n_timed))
            gates = ts.Gates.for_epoch(bcfg, 0)
            gen = torch.Generator("cuda").manual_seed(4)
            ts.train_step(state, batches[0], bcfg, gates, gen)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            del model, state
            torch.cuda.empty_cache()
            print(f"[backbones] {tag}: batch {batch} does not fit the card",
                  flush=True)
            continue
        break
    else:
        fail(f"{tag}: no batch of {BACKBONE_BATCHES} fits the card")
    with record_toolkit(classes, f"{tag} step"):
        ts.train_step(state, batches[1], bcfg, gates, gen)
        torch.cuda.synchronize()
    _all_counts(reset=True)
    for name in WRAPPER.values():
        getattr(K, name).launches = 0
    history, step_ms = [], []
    for i in range(n_timed):
        t0 = time.perf_counter()
        m = ts.train_step(state, batches[i % 2], bcfg, gates, gen)
        history.append({k: float(m[k]) for k in ("loss", *LOGGED) if k in m})
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = _all_counts()
    toolkit = {k: getattr(K, name).launches for k, name in WRAPPER.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per = _per_forward(model)
    bad = [f"{k}.{a}: {counts[f'{k}.{a}']} launches, expected "
           f"{n * n_timed}" for k, n in per.items()
           for a in ("train_launches", "bwd_launches")
           if counts[f"{k}.{a}"] != n * n_timed]
    bad += [f"{k}: no launch" for k, n in toolkit.items() if not n]
    bad += [f"step {i}: a non-finite value" for i, h in enumerate(history)
            if not all(math.isfinite(v) for v in h.values())]
    if state.bad_steps:
        bad.append(f"bad_steps {state.bad_steps}")
    for i, h in enumerate(history):
        print(f"[backbones] {tag} step {i} (batch {batch}): " + " ".join(
            f"{k} {v:.4f}" for k, v in h.items()), flush=True)
    print(f"[backbones] {tag}: batch {batch}; ms a step {step_ms} (host "
          f"clock to the loss read back) = "
          f"{batch / (statistics.mean(step_ms) / 1e3):.2f} train images/s; "
          f"peak device memory {peak:.2f} GiB; launches {counts}; toolkit "
          f"launches {toolkit}", flush=True)
    if bad:
        fail(f"{tag} steps: " + "; ".join(bad))
    profile_forward(lambda: ts.train_step(state, batches[0], bcfg, gates,
                                          gen), batch, reps=1,
                    what=f"train steps ({tag})")
    summary = {"batch": batch, "step_ms": step_ms, "peak_gib": peak,
               "losses": [h["loss"] for h in history],
               "busy_ms": profile_forward.last["busy_ms"],
               "idle": profile_forward.last["idle"], "launches": toolkit}
    del model, state, batches
    torch.cuda.empty_cache()
    return summary


def multiscale_step(classes, batch=8):
    """The stock XXS36 preset multi-scale (fixed_size off, max_size 640,
    buckets of 128): one step on each MULTISCALE_BUCKETS shape (a
    generated batch resized to it), recorded into classes; the talking-
    heads row passes must run at the bucket's patches (1280, 1600), the
    losses finite."""
    import torch
    import torch.nn.functional as F

    from spe_tpu_torch.cli.main import parse_config
    from spe_tpu_torch.data import train_data, write_mini_voc
    from spe_tpu_torch.models.build import (build_model, kernel_domain_errors,
                                            training_patches)
    from spe_tpu_torch.train import train_step as ts
    from spe_tpu_torch.train.engine import train_batch
    from spe_tpu_torch.train.optim import AdamW3

    tmp = tempfile.TemporaryDirectory()
    devkit = write_mini_voc(tmp.name, n_test=1, n_trainval=batch, seed=7)
    fixed = parse_config(STOCK_TRAIN_ARGV + ["--test_path", str(devkit)])
    cfg = fixed.replace(fixed_size=False, max_size=640)
    n = training_patches(cfg, 16)
    errors = kernel_domain_errors(cfg)
    print(f"[multi-scale] max_size 640, buckets of {cfg.bucket_quantum}: at "
          f"most {n} training patches; kernel_domain_errors {errors}",
          flush=True)
    if n != 1600 or errors:
        fail(f"multi-scale: {n} patches, {errors}")
    model = build_model(cfg).train()
    state = ts.TrainState(model, AdamW3(model.named_parameters(), cfg, 2))
    gates = ts.Gates.for_epoch(cfg, 0)
    gen = torch.Generator("cuda").manual_seed(5)
    _, loader = train_data(fixed)
    b = train_batch(next(iter(loader.epoch(0))), torch.device("cuda"))
    for h, w in MULTISCALE_BUCKETS:
        run = f"multi-scale {h}x{w} step"
        images = F.interpolate(b["images"].permute(0, 3, 1, 2), size=(h, w),
                               mode="bilinear", align_corners=False)
        hb = {"images": images.permute(0, 2, 3, 1).contiguous(),
              "pad_mask": torch.zeros((batch, h, w), dtype=torch.bool,
                                      device="cuda"),
              "img_label": b["img_label"]}
        t0 = time.perf_counter()
        with record_toolkit(classes, run):
            m = ts.train_step(state, hb, cfg, gates, gen)
            loss = float(m["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        rows = {cls[2] for (k, cls), e in classes.items() if run in
                e["launches"] and k in ("th_fwd_rows_kernel",
                                        "th_bwd_rows_kernel")}
        print(f"[multi-scale] {run} (batch {batch}): loss {loss:.4f}, "
              f"{ms:.1f} ms with the recorder; the row passes' patches "
              f"{sorted(rows)}", flush=True)
        if not math.isfinite(loss) or rows != {h * w // 256}:
            fail(f"multi-scale {h}x{w}: loss {loss}, row passes at {rows}")
    del model, state
    torch.cuda.empty_cache()
    tmp.cleanup()


def instantiation(kernel, cls, shapes=None):
    """The entry of the kernels line a phase 10 class goes into: its
    template instantiation where the class picks a new one, else its
    kernel at the backbones' shapes."""
    if kernel == "attn_kernel":
        return f"attn_kernel<{cls[0]}, {cls[1]}>"
    if kernel in ("th_fwd_rows_kernel", "th_bwd_rows_kernel"):
        _, H, N, _, wl = cls
        if H == 16:   # the 16-head design's own kernels (csrc/th_h16.cu)
            return f"th16_{kernel[3:]}<{str(wl == 'wl').lower()}>"
        return (f"{kernel}<{H}, {str(wl == 'wl').lower()}, "
                f"{1 if N <= 1024 else 2}>")
    if kernel == "ln_backward":
        return f"ln_bwd_kernel<{shapes[1][1]}>"
    if kernel == "layernorm":
        return f"layernorm_kernel (D = {shapes[0][1]})"
    if kernel == "th_fold":
        return f"th_fold_kernel (H = {shapes[1][0]})"
    if kernel == "th_dq":
        return f"th_dq_kernel (H = {shapes[2][0]})"
    name = SMALL[kernel][0] if kernel in SMALL else kernel
    return f"{name} at the backbones' shapes"


# the 16-head row passes' forms no phase's run gives (the U = 2 rows of
# 1025-2048 keys, with and without wl): replayed beside phase 10's classes
# at the 640 x 640 bucket's 1600 patches and the preset's attention
# dropout, (kernel, class) -> the recorded call
H16_REPLAYED = {
    (k, (2, 16, 1600, "drop", "wl" if wl else "no wl")):
        ((2, 16, 1600, 1600), 0.05, 1, wl)
    for k in ("th_fwd_rows_kernel", "th_bwd_rows_kernel")
    for wl in (False, True)}


def _source(kernel, cls):
    """The source file and TPU kernel of a WRAPPER class's kernel (the
    16-head row passes' own file)."""
    src, rep = TOOLKIT[kernel]
    if kernel in ("th_fwd_rows_kernel", "th_bwd_rows_kernel") and cls[1] == 16:
        src = "spe_tpu_torch/csrc/th_h16.cu"
    return src, rep


def replay_backbone_classes(classes, seen, results):
    """Every class phase 10's runs recorded that phase 3 did not (`seen`; a new
    instantiation or a new shape of an old one) replayed as phase 3
    replays its own (replay_class, small_kernels with every plain version
    timed, recorded_inputs for CC and the auction); the classes summed
    into one entry of the kernels line per instantiation: launches, kernel,
    plain, bound and library ms summed over the phase 10 runs (launches x
    time), the largest error. Then the H16_REPLAYED classes, held to their
    plain versions the same way and listed under the 16-head entries
    ("replayed_only": no run launches them)."""
    import torch

    from spe_tpu_torch.ops import kernel_checks as kc
    from spe_tpu_torch.ops import kernels as K

    new = {k: v for k, v in classes.items() if k not in seen}
    runs = sorted({r for e in new.values() for r in e["launches"]})
    print(f"[backbones] {len(new)} classes new to phase 3 over {runs}",
          flush=True)
    gen = torch.Generator().manual_seed(6)
    groups, ok = {}, True
    for (kernel, cls), rec in sorted(new.items(), key=lambda kv: (
            kv[0][0], -sum(kv[1]["launches"].values()))):
        if kernel in SMALL or kernel in RECORDED_INPUTS:
            continue
        c, passed = replay_class(K, kc, kernel, cls, rec, gen, REPLAY_REPS)
        ok &= passed
        c["max_abs_err"] = max(c["max_abs_err"].values())
        src, rep = _source(kernel, cls)
        groups.setdefault(instantiation(kernel, cls), (src, rep, []))[2] \
            .append(c)
    extra = {}
    for (kernel, cls), call in sorted(H16_REPLAYED.items()):
        c, passed = replay_class(K, kc, kernel, cls,
                                 {"launches": {}, "call": call}, gen,
                                 REPLAY_REPS)
        ok &= passed
        c["instantiation"] = instantiation(kernel, cls)
        extra.setdefault(kernel, []).append(c)
    if not ok:
        fail("a backbone class disagrees with its plain version")
    small = []
    small_kernels({k: v for k, v in new.items() if k[0] in SMALL}, {}, small,
                  runs, REPLAY_REPS)
    for c in small:
        src, rep = SMALL_SOURCES[c["name"]]
        groups.setdefault(instantiation(c["name"], None, c["shapes"]),
                          (f"spe_tpu_torch/csrc/{src}", rep, []))[2].append(c)
    recorded_inputs({k: v for k, v in new.items()
                     if k[0] in RECORDED_INPUTS}, {}, require=False)
    for label, (src, rep, cl) in sorted(groups.items()):
        n = {r: sum(c["launches"].get(r, 0) for c in cl) for r in runs}
        tot = {k: sum(sum(c["launches"].values()) * c[k] for c in cl)
               for k in ("ms", "bound_ms")}
        plains = [c["plain_ms"] for c in cl]
        libs = [c["library_ms"] for c in cl]
        entry = {"name": label, "route": "cuda", "source": src,
                 "replaces": rep, "launches": sum(n.values()),
                 "max_abs_err": max(c["max_abs_err"] for c in cl),
                 "ms": tot["ms"],
                 "plain_ms": None if None in plains else sum(
                     sum(c["launches"].values()) * c["plain_ms"] for c in cl),
                 "bound_ms": tot["bound_ms"],
                 "bound_by": max(cl, key=lambda c: c["bound_ms"] * sum(
                     c["launches"].values())).get("bound_by", "bytes"),
                 "library_ms": None if None in libs else sum(
                     sum(c["launches"].values()) * c["library_ms"]
                     for c in cl),
                 "per": "sums of launches x time over phase 10's recorded "
                        "runs, each class replayed in a CUDA graph",
                 "runs": {r: v for r, v in n.items() if v}}
        kernel = {"th16_fwd": "th_fwd_rows_kernel",
                  "th16_bwd": "th_bwd_rows_kernel"}.get(label[:8])
        if kernel and kernel in extra:
            entry["replayed_only"] = extra.pop(kernel)
        results[label] = entry
        print(f"[backbones] {label}: {len(cl)} classes, launches "
              f"{entry['runs']}; kernel {entry['ms']:.3f} ms, plain "
              f"{entry['plain_ms']} ms, bound {entry['bound_ms']:.4f} ms "
              f"({entry['bound_by']}), library {entry['library_ms']}; "
              f"max_abs_err {entry['max_abs_err']:.3e}", flush=True)
    if extra:
        fail(f"no 16-head entry in the kernels line to list {sorted(extra)} "
             "under")


def phase_backbones(results, seen):
    """Phase 10: each of BACKBONES at full width and depth, voc0712 preset,
    512^2, every fused flag on (S24's weights from a checkpoint this phase
    writes in timm's layout, through models/convert.py's loader of
    --backbone_weights): (a) one eval batch with flip against the
    plain-version model on the same weights at phase 4's tolerances
    (kernel_vs_plain); (b) one train
    step under phase 8's same-grads rule at B=2 (phase_same_grads, the
    decoder self-attention's q/k gradients held to an f32 plain run); (c)
    three timed train steps (backbone_steps), one more step recorded
    (the two-branch ones; the single-branch XXS36 takes (a) and (b)). Then
    the multi-scale XXS36 steps (multiscale_step), recorded too, and every
    recorded class not among phase 3's (`seen`) replayed against its plain
    version (replay_backbone_classes), with the 16-head row passes' forms
    that no run gives (H16_REPLAYED)."""
    from spe_tpu_torch.cli.main import parse_config
    from spe_tpu_torch.data import eval_data, write_mini_voc
    from spe_tpu_torch.models.convert import load_backbone_weights

    classes, summary = {}, {}
    for tag, name, from_pth, timed_steps, noisy in BACKBONES:
        t0 = time.perf_counter()
        tmp = tempfile.TemporaryDirectory()
        devkit = write_mini_voc(tmp.name, n_test=8, n_trainval=16, seed=6)
        cfg = parse_config(STOCK_TRAIN_ARGV + [
            "--backbone", name, "--test_path", str(devkit), "--output_dir",
            f"{tmp.name}/out"])
        weights = None
        if from_pth:
            path = f"{tmp.name}/{tag}_timm.pth"
            write_timm_checkpoint(cfg, path, seed=11)

            def weights(m, path=path):   # prints what it copied and skipped
                load_backbone_weights(m, path)
        _, loader = eval_data(cfg)
        b = _flipped(next(iter(loader.epoch(0))))
        _, _, _, bad = kernel_vs_plain(cfg, b, f"{tag} eval", _stage_pairs,
                                       weights)
        if bad:
            fail(f"{tag} eval vs plain model: " + "; ".join(bad))
        phase_same_grads(cfg, f"{tag} backbone", noisy, batch=2,
                         weights=weights)
        summary[tag] = (backbone_steps(cfg, tag, weights, classes)
                        if timed_steps else {})
        summary[tag]["seconds"] = time.perf_counter() - t0
        tmp.cleanup()
    multiscale_step(classes)
    print(f"[backbones] {json.dumps(summary)}", flush=True)
    replay_backbone_classes(classes, seen, results)


def profile_forward(fn, batch, reps=2, what="eval forwards (flip)"):
    """Device time by kernel over `reps` eval forwards (torch.profiler),
    and the device's idle share of the wall time -> {kernel name: (ms,
    launches)} of the device rows."""
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
    profile_forward.last = {"wall_ms": wall_us / 1e3, "busy_ms": total / 1e3,
                            "idle": max(0.0, 1 - total / wall_us)}
    print(f"[profile] {reps} {what} of batch {batch}: wall "
          f"{wall_us / 1e3:.1f} ms, device busy {total / 1e3:.1f} ms, idle "
          f"share {max(0.0, 1 - total / wall_us):.3f}", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"[profile] {e.self_device_time_total / 1e3:9.2f} ms "
              f"{100 * e.self_device_time_total / max(total, 1):5.1f}% "
              f"x{e.count:5d}  {e.key[:100]}", flush=True)
    for fam in PROFILE_FAMILIES:
        mine = [e for e in rows if fam in e.key]
        t = sum(e.self_device_time_total for e in mine)
        print(f"[profile] family {fam}: {t / 1e3:.2f} ms "
              f"({100 * t / max(total, 1):.1f}% of device time), "
              f"{sum(e.count for e in mine)} launches", flush=True)
    mine = {}
    for name in csrc_kernels():
        pat = re.compile(rf"\b{name}\b")
        hits = [e for e in rows if pat.search(e.key)]
        mine[name] = (sum(e.self_device_time_total for e in hits) / 1e3,
                      sum(e.count for e in hits))
    t = sum(ms for ms, _ in mine.values())
    print(f"[profile] the csrc kernels: {t:.2f} ms "
          f"({100 * t * 1e3 / max(total, 1):.1f}% of device time); by "
          "__global__ (ms/launches): " + ", ".join(
              f"{n} {ms:.3f}/{c}" for n, (ms, c) in
              sorted(mine.items(), key=lambda kv: -kv[1][0])), flush=True)
    return {e.key: (e.self_device_time_total / 1e3, e.count) for e in rows}


# the last profile's wall and device-busy ms and idle share
profile_forward.last = {}


# kernels summed over their instantiations in each profile
PROFILE_FAMILIES = ("attn_kernel<192, 192", "attn_kernel", "gemm_kernel",
                    "th_bwd_rows_kernel", "th_fwd_rows_kernel",
                    "th16_bwd_rows_kernel", "th16_fwd_rows_kernel",
                    "attn_bwd_rows_kernel", "linear_kernel")


def csrc_kernels():
    """The names of the __global__ functions in spe_tpu_torch/csrc/*.cu
    and *.cuh."""
    from spe_tpu_torch.ops import kernels

    names = []
    for src in kernels._sources():
        # past the attributes: __launch_bounds__(...), __cluster_dims__(...)
        names += re.findall(r"__global__\s+void\s+(?:__\w+__\("
                            r"(?:[^()]|\([^()]*\))*\)\s*)*(\w+)\s*\(",
                            src.read_text())
    return names


# phase 11: two processes on the one card over gloo (NCCL refuses two
# ranks on one device; gloo carries the card's tensors through the host)
DIST_TRAIN_ARGV = STOCK_TRAIN_ARGV + [
    "--dropout", "0", "--backbone_drop_rate", "0", "--drop_path_rate", "0",
    "--drop_attn_rate", "0", "--hung_match_ratio", "1"]
DIST_TIMEOUT = 300   # seconds the two processes may take


def _dist_models(spec, device):
    """The models of phase 11 on `device`, the same in every process (built
    from the seed) -> (voc0712 cfg, the stock voc0712 model, coco17 cfg,
    the coco17 eval model with its heads drawn so that detections land on
    the data's first classes)."""
    import torch

    from spe_tpu_torch.config import SPEConfig
    from spe_tpu_torch.models.build import build_model

    voc, coco = SPEConfig(**spec["voc"]), SPEConfig(**spec["coco"])
    eval_model = build_model(coco, device).eval()
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for r in range(coco.num_refines + 1):
            w = eval_model.bbox_embed[r].layers[-1].weight
            w.copy_(torch.randn(w.shape, generator=gen) * 0.3)
            eval_model.class_embed[r].bias[:4] += 3.0
    return voc, build_model(voc, device), coco, eval_model


def _digest(model):
    return _digest_state(dict(model.named_parameters()))


def _coco_stages(model, loader, ds, cfg, device):
    """Both refinement stages' COCO eval -> ({stage{s}_stat: value}, s,
    each stage's detections after the merge: the packed rows
    [valid, image_id, category_id, x, y, w, h, score], sorted)."""
    import numpy as np
    import torch

    from spe_tpu_torch.train import engine

    gt = ds.coco_gt() if hasattr(ds, "coco_gt") else ds.raw
    merge, planes = engine.merge_across_processes, []

    def merged(evaluator, *args, **kw):
        merge(evaluator, *args, **kw)
        rows = engine.pack_detections(evaluator)
        rows = rows[rows[:, 0] > 0.5]
        planes.append(rows[np.lexsort(rows.T[::-1])])

    engine.merge_across_processes = merged
    stats, t0 = {}, time.perf_counter()
    try:
        for st in range(cfg.num_refines + 1):
            s = engine.evaluate_coco(model, loader, gt, cfg, device,
                                     refine_stage=st)
            s.pop("forwards")
            stats.update({f"stage{st}_{k}": v for k, v in s.items()})
        torch.cuda.synchronize()
    finally:
        engine.merge_across_processes = merge
    return stats, time.perf_counter() - t0, planes


def dist_worker(rank, world, backend, port, tmp):
    """One of phase 11's processes (`python3 chip_smoke.py --dist-worker
    RANK WORLD BACKEND PORT DIR`): over gloo on cuda:0, or over NCCL on
    cuda:RANK, one step of the stock voc0712 model on its 2 images, with
    its kernel launches and its all-reduce's bytes and CUDA-event ms; then
    the coco17 eval of its share of the 8 images, merged; results to
    DIR/rank{RANK}.pt (rank 0: the parameters after the step and the
    averaged gradients too)."""
    import torch

    from spe_tpu_torch.data import eval_data
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.parallel import dist
    from spe_tpu_torch.train import train_step as ts
    from spe_tpu_torch.train.optim import AdamW3

    os.environ.update(RANK=str(rank),
                      LOCAL_RANK="0" if backend == "gloo" else str(rank))
    dev = dist.init_distributed(world, f"tcp://127.0.0.1:{port}", "cuda",
                                backend=backend)
    spec = torch.load(f"{tmp}/spec.pt")
    voc, model, coco, eval_model = _dist_models(spec, dev)
    out = {"init": (_digest(model), _digest(eval_model)), "device": str(dev)}
    state = ts.TrainState(model, AdamW3(model.named_parameters(), voc, 1))
    half = {k: v[2 * rank:2 * rank + 2].to(dev)
            for k, v in spec["batch"].items()}
    reduce, timed = dist.all_reduce_mean_, []
    normalisers, nb = ts.num_boxes_per_stage, []

    def num_boxes_per_stage(*args, **kw):
        got = normalisers(*args, **kw)
        nb.append([float(v) for v in got])
        return got

    def all_reduce_mean_(flat, group=None):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        reduce(flat, group)
        b.record()
        torch.cuda.synchronize()
        timed.append((flat.numel() * flat.element_size(), a.elapsed_time(b)))
        return flat

    dist.all_reduce_mean_ = all_reduce_mean_
    ts.num_boxes_per_stage = num_boxes_per_stage
    toolkit = {k: getattr(K, name) for k, name in WRAPPER.items()}
    for fn in toolkit.values():
        fn.launches = 0
    _all_counts(reset=True)
    dist.barrier("step")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = ts.train_step(state, half, voc, ts.Gates.for_epoch(voc, 0),
                      torch.Generator(dev).manual_seed(rank))
    loss = float(m["loss"])
    out.update(step_ms=(time.perf_counter() - t0) * 1e3, counts=_all_counts(),
               toolkit={k: fn.launches for k, fn in toolkit.items()},
               per=_per_forward(model), all_reduce=timed, nb=nb[0],
               loss=loss, grad_norm=float(m["grad_norm"]),
               after=_digest(model))
    dist.all_reduce_mean_, ts.num_boxes_per_stage = reduce, normalisers
    if rank == 0:
        out["params"] = {n: p.detach().cpu() for n, p in
                         model.named_parameters()}
        out["grads"] = {n: p.grad.detach().cpu() for n, p in
                        model.named_parameters() if p.grad is not None}
    del state, model
    ds, loader = eval_data(coco)
    out["images"] = len(loader._indices(0))
    out["coco"], out["eval_s"], out["dets"] = _coco_stages(
        eval_model, loader, ds, coco, dev)
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.shutdown()


def _launch(world, backend, tmp):
    """The processes of phase 11 -> their rank{r}.pt results and the wall
    seconds; a failure or DIST_TIMEOUT fails the smoke."""
    import socket

    import torch

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-worker", str(r),
         str(world), backend, str(port), tmp], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(world)]
    try:
        outs = [p.communicate(timeout=DIST_TIMEOUT)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        fail(f"distributed: the processes outlasted {DIST_TIMEOUT}s")
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(o[-4000:], flush=True)
            fail(f"distributed: process {r} exited {p.returncode}")
    return ([torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
             for r in range(world)], time.perf_counter() - t0)


# (a): the processes against one process on the same images in the same
# micro-batches, so the same kernels at the same shapes: the loss within
# phase_same_step's 1e-6 relative, and every parameter after the update
# within 1e-6 of its tensor's largest magnitude (a last-bit change of a
# gradient moves an updated parameter by an ulp, ~6e-8 of it); grad_norm
# and every averaged gradient within DIST_GRAD_TOL of its tensor's largest
# (the sums' order is all that differs)
DIST_SAME_TOL, DIST_GRAD_TOL = 1e-6, 1e-5


def _cat_supervision(sups):
    """The micro-batches' supervisions (compute_losses's third value) as
    that of their images in one batch: every target concatenated over the
    images, the matching's (stage x layer, image) problems likewise."""
    import torch

    def cat(ds):
        return {k: torch.cat([d[k] for d in ds]) for k in ds[0]}

    B = sups[0]["cam"]["labels"].shape[0]

    def problems(ts):  # each (S*L*B, ...) -> (S*L*B*len(ts), ...)
        return torch.cat([t.reshape(-1, B, *t.shape[1:]) for t in ts],
                         1).flatten(0, 1)

    rows, stats = zip(*[s["matching"] for s in sups])
    return {"cam": cat([s["cam"] for s in sups]),
            "refine": {k: cat([s["refine"][k] for s in sups])
                       for k in sups[0]["refine"]},
            "matching": (problems(rows),
                         {k: problems([st[k] for st in stats])
                          for k in stats[0]})}


def _supervision_diff(a, b):
    """Where two supervisions of one batch differ -> {part: (differing,
    of)}: images for the CAM pseudo-boxes ("cam") and each refinement
    stage's targets ("refine{k}"), (stage x layer, image) problems for the
    matching's rows."""
    def images(x, y):
        n = x["labels"].shape[0]
        d = sum((x[k] != y[k]).reshape(n, -1).any(1).int() for k in x)
        return int((d > 0).sum()), n

    out = {"cam": images(a["cam"], b["cam"])}
    out.update({f"refine{k}": images(a["refine"][k], b["refine"][k])
                for k in a["refine"]})
    ra, rb = a["matching"][0], b["matching"][0]
    out["matching"] = (int((ra != rb).any(1).sum()), ra.shape[0])
    return out


def _dense_grads(model):
    """{name: its gradient in f32, zeros where it is None}."""
    import torch

    return {n: (p.grad if p.grad is not None else
                torch.zeros_like(p)).detach().float().clone()
            for n, p in model.named_parameters()}


def _grad_gaps(got, want):
    """{name: max |got - want| over the largest |want| of the tensor, or of
    the weight a zero-by-construction bias is held against}."""
    from spe_tpu_torch.ops.kernel_checks import zero_grad_ref

    gaps = {}
    for n, w in want.items():
        top = float(want[zero_grad_ref(n) or n].abs().max())
        err = float((got[n] - w).abs().max())
        gaps[n] = err / top if top else (math.inf if err else 0.0)
    return gaps


def _same_update(spec, ranks, world, bad):
    """(a)'s references on cuda:0 -> (the printed findings, ms of the one
    forward and backward, ms of the micro-batches' step).
    1. One process on the 2 x world images as world micro-batches of 2 with
       the processes' normalisers, gradients accumulated, one update: held
       at DIST_SAME_TOL and DIST_GRAD_TOL (see above).
    2. One process on the images in one forward with the normaliser
       max(N, world): its pseudo-boxes, refinement targets and matching
       against the micro-batches', its loss and gradients against the
       processes' (reported: the kernels round otherwise at batch
       2 x world, near-tied stage-0 detections pick other refinement
       targets and matches, and a changed target changes its loss's
       gradients whole). Then the same forward given the micro-batches'
       supervision, and the plain model in f32 given it too: the processes'
       loss and averaged gradients held to the one forward's by phase 8's
       same-grads rule (_hold with NOISY: the decoder self-attention's q/k
       gradients are rounding noise at init and are held to the f32 ones
       instead), the normalisers world times the processes'."""
    import torch

    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.ops.kernel_checks import grad_views
    from spe_tpu_torch.train import train_step as ts
    from spe_tpu_torch.train.optim import AdamW3

    dev = torch.device("cuda", 0)
    batch, r0 = spec["batch"], ranks[0]
    ours = {n: g.to(dev).float() for n, g in r0["grads"].items()}
    voc, model, _, eval_model = _dist_models(spec, dev)
    if any(rk["init"] != (_digest(model), _digest(eval_model))
           for rk in ranks):
        bad.append("the processes' initial weights differ from this one's")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gates = ts.Gates.for_epoch(voc, 0)
    state = ts.TrainState(model, AdamW3(model.named_parameters(), voc, 1))
    normalisers, totals, sups = ts.num_boxes_per_stage, [], []
    model.train()
    state.optimizer.zero_grad()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for r, rk in enumerate(ranks):
        def processes_nb(*args, nb=rk["nb"], **kw):
            return [torch.tensor(v, device=dev) for v in nb]

        ts.num_boxes_per_stage = processes_nb
        try:
            total, _, sup = ts.compute_losses(
                model, {k: v[2 * r:2 * r + 2].to(dev)
                        for k, v in batch.items()},
                voc, gates, torch.Generator(dev).manual_seed(r))
        finally:
            ts.num_boxes_per_stage = normalisers
        (total / world).backward()
        totals.append(total.detach())
        sups.append(sup)
    acc_loss = sum(totals) / world
    acc_norm, _ = state.optimizer.step(acc_loss)
    torch.cuda.synchronize()
    acc_ms = (time.perf_counter() - t1) * 1e3
    acc_loss, acc_norm = float(acc_loss), float(acc_norm)
    loss_rel = abs(r0["loss"] - acc_loss) / abs(acc_loss)
    norm_rel = abs(r0["grad_norm"] - acc_norm) / acc_norm
    if len({rk["loss"] for rk in ranks}) != 1 or loss_rel > DIST_SAME_TOL \
            or norm_rel > DIST_GRAD_TOL:
        bad.append(f"losses {sorted({rk['loss'] for rk in ranks})} vs "
                   f"{acc_loss}, grad_norm {r0['grad_norm']} vs {acc_norm} "
                   f"(micro-batches)")
    gaps = _grad_gaps(ours, _dense_grads(model))
    g_worst = max(gaps, key=gaps.get)
    bad += [f"{n}: the averaged gradient {v:.3e} of its largest apart from "
            f"the micro-batches'" for n, v in gaps.items()
            if v > DIST_GRAD_TOL]
    differ, worst = [], ("", 0.0, 0.0, 0.0)
    for n, p in model.named_parameters():
        delta = (r0["params"][n].to(dev) - p.detach()).abs()
        top = float(p.detach().abs().max())
        err = float(delta.max())
        if err:
            differ.append(n)
        if err > DIST_SAME_TOL * top:
            bad.append(f"{n}: after the update {err:.3e} apart, its largest "
                       f"magnitude {top:.3e}")
        if top and err / top > worst[1]:
            x = p.detach().flatten()[int(delta.argmax())]
            ulp = float(torch.nextafter(x, x.new_tensor(math.inf)) - x)
            move = float((p.detach() - before[n]).abs().max())
            worst = (n, err / top, err / ulp, err / move)
    if len({rk["after"] for rk in ranks}) != 1:
        bad.append("the processes' parameters differ after the step")
    del state, model, before

    seen, runs, given = [], {}, _cat_supervision(sups)

    def one_nb(*args, **kw):
        seen.append([v.clamp(min=float(world))
                     for v in normalisers(*args, **kw)])
        return seen[-1]

    ts.num_boxes_per_stage = one_nb
    whole = {k: v.to(dev) for k, v in batch.items()}
    model = _dist_models(spec, dev)[1].train()
    try:
        for how, sup_in in (("own", None), ("given", given), ("f32", given)):
            if how == "f32":
                del model
                model = build_model(voc.replace(
                    use_fused_block=False, use_fused_layers=False,
                    use_pallas_attention=False, compute_dtype="float32"),
                    dev).train()
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            total, _, sup = ts.compute_losses(
                model, whole, voc, gates, torch.Generator(dev).manual_seed(0),
                supervision=sup_in)
            total.backward()
            torch.cuda.synchronize()
            runs[how] = (float(total.detach()), sup, _dense_grads(model),
                         (time.perf_counter() - t2) * 1e3)
    finally:
        ts.num_boxes_per_stage = normalisers
    del model
    one_nb = [[float(v) for v in nb] for nb in seen]
    diff = _supervision_diff(runs["own"][1], given)
    own_gaps = _grad_gaps(ours, runs["own"][2])
    own_worst = max(own_gaps, key=own_gaps.get)
    views = grad_views(ours)
    held = _hold(views, grad_views(runs["given"][2]),
                 grad_views(runs["f32"][2]), NOISY)
    bad += _report("distributed", "the processes' averaged gradients vs one "
                   f"forward on the {2 * world} images given their "
                   "supervision", {"loss": r0["loss"]},
                   {"loss": runs["given"][0]}, len(views), held, NOISY)
    if one_nb[1] != [world * v for v in r0["nb"]]:
        bad.append(f"one forward given the micro-batches' supervision: "
                   f"normalisers {one_nb[1]} vs {world} x {r0['nb']}")
    rel = [abs(r0["loss"] - runs[h][0]) / abs(runs[h][0])
           for h in ("own", "given")]
    text = (
        f"loss {r0['loss']:.6f} (every process), grad_norm "
        f"{r0['grad_norm']:.6f}, normalisers {r0['nb']}; one process on the "
        f"{2 * world} as {world} micro-batches with them: loss relative "
        f"{loss_rel:.3e} (limit {DIST_SAME_TOL}), grad_norm relative "
        f"{norm_rel:.3e} (limit {DIST_GRAD_TOL}), averaged gradients apart "
        f"by at most {gaps[g_worst]:.3e} of the tensor's largest ({g_worst}; "
        f"limit {DIST_GRAD_TOL}; {sum(v > 0 for v in gaps.values())} of "
        f"{len(gaps)} tensors not bit for bit equal), parameters after the "
        f"update: {len(differ)} tensors not bit for bit equal {differ[:4]} "
        f"(largest difference {worst[1]:.3e} of the tensor's largest "
        f"magnitude, {worst[0]}: {worst[2]:.1f} ulp of the parameter there, "
        f"{worst[3]:.3e} of the tensor's largest update; limit "
        f"{DIST_SAME_TOL}); the processes' parameters bit for bit equal "
        f"{len({rk['after'] for rk in ranks}) == 1}; one process in one "
        f"forward with max(N, {world}) = {one_nb[0]}: its supervision "
        f"against the micro-batches' (differing / all) {diff}, loss "
        f"{runs['own'][0]:.6f} (relative {rel[0]:.3e}), the averaged "
        f"gradients apart by at most {own_gaps[own_worst]:.3e} of the "
        f"tensor's largest ({own_worst}; not held: other targets); given "
        f"the micro-batches' supervision: loss {runs['given'][0]:.6f} "
        f"(relative {rel[1]:.3e}), the gradients held by the same-grads "
        f"rule (above)")
    return text, runs["own"][3], acc_ms


def phase_distributed(world=2, backend="gloo"):
    """Phase 11: `world` processes, over gloo on cuda:0 (one card: NCCL
    refuses two ranks on one device) or over NCCL on a card each (`python3
    chip_smoke.py --nccl`). (a) One step of the stock voc0712 preset at
    full width (dropout 0, hung_match_ratio 1), 2 generated images a
    process, against one process's step on all of them (_same_update):
    as world micro-batches of 2 with the processes' normalisers, so every
    kernel at the processes' shapes, the loss, grad_norm, every gradient
    and every parameter after the update held tight; in one forward with
    the normaliser max(N, world), given the micro-batches' supervision,
    the loss and the gradients by phase 8's same-grads rule; every
    process's parameters bit for bit equal and its launches those of a
    stock step. (b) The coco17 COCO eval of 8 generated images, one a
    batch, shared and merged, against one process's eval of the 8: the
    merged detections equal bit for bit, every stage's AP/AR within 1e-3
    and eval losses within 1e-4 relative. (c) On one card `python -m
    spe_tpu_torch.cli.accuracy rehearse --epochs 2`; over NCCL the CLI
    under torchrun (env://) for one epoch of the stock preset at full
    width, process 0 alone writing."""
    import dataclasses

    import torch

    from spe_tpu_torch.cli.main import parse_config
    from spe_tpu_torch.data import eval_data, train_data

    line = card()
    where = "cuda:0" if backend == "gloo" else f"cuda:0-{world - 1}"
    tag = f"{world} processes on {where} over {backend}"
    tmp = tempfile.TemporaryDirectory()
    voc = parse_config(DIST_TRAIN_ARGV)
    voc = voc.replace(batch_size=2 * world, **write_data(
        voc, f"{tmp.name}/voc", 2 * world, 1, seed=4))
    coco = parse_config(COCO_TRAIN_ARGV)
    coco = coco.replace(batch_size=1, **write_data(coco, f"{tmp.name}/coco",
                                                   0, 8, seed=6))
    _, loader = train_data(voc)
    batch = {k: torch.as_tensor(v) for k, v in next(iter(loader.epoch(0))).items()
             if k in ("images", "pad_mask", "img_label")}
    spec = {"voc": dataclasses.asdict(voc.replace(batch_size=2)),
            "coco": dataclasses.asdict(coco), "batch": batch}
    torch.save(spec, f"{tmp.name}/spec.pt")
    ranks, wall = _launch(world, backend, tmp.name)
    bad = []

    # (a) the step
    found, one_ms, acc_ms = _same_update(spec, ranks, world, bad)
    for r, rk in enumerate(ranks):
        want = {"pallas_cc": 1, "pallas_auction": 1}
        for k, n in rk["per"].items():
            want[f"{k}.train_launches"] = want[f"{k}.bwd_launches"] = n
        bad += [f"rank {r} {k}: {rk['counts'][k]} launches, expected {n}"
                for k, n in want.items() if rk["counts"][k] != n]
        bad += [f"rank {r} {k}: no launch" for k, n in rk["toolkit"].items()
                if not n]
    (nbytes, ar_ms), = ranks[0]["all_reduce"]
    print(f"[distributed] {line}: (a) {tag} (devices "
          f"{[rk['device'] for rk in ranks]}), the stock voc0712 step at "
          f"full width, 2 of {2 * world} images each: {found}", flush=True)
    print(f"[distributed] {line}: {tag}: step host ms "
          f"{[round(rk['step_ms'], 1) for rk in ranks]} (first step: "
          f"warm-up included), one process on {2 * world} images "
          f"{one_ms:.1f} (forward and backward; {world} micro-batches and "
          f"the update {acc_ms:.1f}); the gradient "
          f"all-reduce {nbytes} bytes in "
          f"{[round(rk['all_reduce'][0][1], 2) for rk in ranks]} ms (CUDA "
          f"events{': to the host, gloo, back' if backend == 'gloo' else ''}"
          f"); launches per process "
          f"{ {k: v for k, v in ranks[0]['counts'].items() if v} }; the "
          f"processes' wall {wall:.1f}s", flush=True)

    # (b) the merged COCO eval
    dev = torch.device("cuda", 0)
    _, _, spec_coco, eval_model = _dist_models(spec, dev)
    ds, loader = eval_data(spec_coco)
    want, one_s, one_dets = _coco_stages(eval_model, loader, ds, spec_coco,
                                         dev)
    coco_err, loss_err, same_dets = 0.0, 0.0, True
    for r, rk in enumerate(ranks):
        if sorted(rk["coco"]) != sorted(want):
            bad.append(f"rank {r}: COCO stats {sorted(rk['coco'])}")
            continue
        for k, v in want.items():
            if "eval_" in k:
                loss_err = max(loss_err, abs(rk["coco"][k] - v) / abs(v))
            else:
                coco_err = max(coco_err, abs(rk["coco"][k] - v))
        same_dets &= len(rk["dets"]) == len(one_dets) and all(
            a.shape == b.shape and bool((a == b).all())
            for a, b in zip(rk["dets"], one_dets))
    shares = [rk["images"] for rk in ranks]
    if coco_err > 1e-3 or loss_err > 1e-4 or not same_dets or \
            shares != [8 // world] * world:
        bad.append(f"COCO eval: merged vs one process: AP/AR {coco_err:.3e} "
                   f"(limit 1e-3), eval losses {loss_err:.3e} relative "
                   f"(limit 1e-4), the same detections {same_dets}, images "
                   f"a process {shares}")
    print(f"[distributed] {line}: (b) {tag}: coco17 COCO eval, both stages, "
          f"of 8 generated images, one a batch, {shares} a process, merged, "
          f"against one process's eval of the 8: the merged detections "
          f"(each stage {[len(d) for d in one_dets]}) equal bit for bit "
          f"{same_dets}; AP/AR largest difference {coco_err:.3e} (limit "
          f"1e-3; stage0 AP {ranks[0]['coco']['stage0_AP']:.4f} / "
          f"{want['stage0_AP']:.4f}, AR100 "
          f"{ranks[0]['coco']['stage0_AR100']:.4f} / "
          f"{want['stage0_AR100']:.4f}: random weights); eval losses "
          f"{loss_err:.3e} relative (limit 1e-4); eval seconds "
          f"{[round(rk['eval_s'], 2) for rk in ranks]}, one process "
          f"{one_s:.2f}", flush=True)

    # (c) the rehearsal on the card, or the CLI under torchrun
    root = os.path.dirname(os.path.abspath(__file__))
    t2 = time.perf_counter()
    if backend == "gloo":
        what = "accuracy rehearse --epochs 2 on the card"
        cmd = [sys.executable, "-m", "spe_tpu_torch.cli.accuracy",
               "rehearse", "--epochs", "2", "--workdir",
               f"{tmp.name}/rehearsal", *NATIVE_OFF]
    else:
        what = f"torchrun of the CLI on {world} cards, one epoch"
        cli = parse_config(STOCK_TRAIN_ARGV)
        data = write_data(cli, f"{tmp.name}/cli", 4 * world, 4, seed=7)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(world), "-m", "spe_tpu_torch.cli.main",
               "--world_size", str(world), *STOCK_TRAIN_ARGV,
               "--batch_size", "2", "--output_dir", f"{tmp.name}/cli/out",
               *[a for k, v in data.items() for a in (f"--{k}", v)]]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=DIST_TIMEOUT, cwd=root)
    ok = proc.returncode == 0
    if backend == "gloo":
        ok &= "REHEARSAL OK" in proc.stdout
        tail = proc.stdout.strip().splitlines()[-1:]
    else:
        out = f"{tmp.name}/cli/out"
        files = sorted(os.listdir(out)) if os.path.isdir(out) else []
        ok &= files == ["checkpoint.pth", "checkpoint0000.pth",
                        "checkpoint_best.pth", "log.txt"]
        log = json.loads(open(f"{out}/log.txt").readline()) if ok else {}
        ok &= log.get("train_steps") == 2 and math.isfinite(
            log.get("train_loss", math.nan))
        tail = (f"{files}; train_steps {log.get('train_steps')}, "
                f"train_loss {log.get('train_loss')}, test_mAP "
                f"{log.get('test_mAP')}, train_step_ms "
                f"{log.get('train_step_ms')}")
    print(f"[distributed] {line}: (c) {what}: exit {proc.returncode} in "
          f"{time.perf_counter() - t2:.1f}s: {tail}", flush=True)
    if not ok:
        bad.append(f"(c): {proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    tmp.cleanup()
    if bad:
        fail("distributed: " + "; ".join(bad[:20]))


# phase 12: the segmentation path (--masks, --frozen_weights, the mask
# losses on the port's synthetic dataset with masks) and the pre-norm /
# learned-position detector, stock preset at full width and depth
MASKS_ARGV = STOCK_TRAIN_ARGV + ["--masks", "--dataset_file", "synthetic"]
PRENORM_ARGV = STOCK_TRAIN_ARGV + ["--pre_norm", "--position_embedding",
                                   "learned"]
# the timed --masks steps: the first batch size that fits the card (the
# head's activations at B=8, 2400 masks of 128^2, are tens of GB)
MASKS_BATCHES = (8, 4, 2)
# the CLI epoch on coco_panoptic: 2 steps of batch 2, 4 COCO val images
PANOPTIC_BATCH = 2


def _write_detector(cfg, path):
    """A detector checkpoint of cfg without the head (the port's format,
    {"model": state dict}) from seed 7: what --frozen_weights starts from."""
    import torch

    from spe_tpu_torch.models.build import build_model

    det = build_model(cfg.replace(masks=False, seed=7))
    torch.save({"model": det.state_dict()}, path)
    del det


def mask_auction_check(model, b, cfg):
    """The mask branch's auction on one batch's stage-0 outputs against
    its plain version on the same benefits: assignments, iteration and bid
    counts exactly (phase 5's rule); each timed (CUDA events)."""
    import torch

    from spe_tpu_torch.ops import auction as auc
    from spe_tpu_torch.train.criterion import matcher_cost

    with torch.no_grad():
        s0 = model(b["images"], pad_mask=b["pad_mask"],
                   generator=torch.Generator("cuda").manual_seed(6))[
                       "stages"][0]
        cost = matcher_cost(s0["pred_logits"], s0["pred_boxes"].float(),
                            b["gt_labels"], b["gt_boxes"].float(),
                            b["gt_mask"], cfg.set_cost_class,
                            cfg.set_cost_bbox, cfg.set_cost_giou)
        benefit = auc._normalize_benefit(cost, b["gt_mask"])
        got = auc.auction_phase(benefit, b["gt_mask"])
        want = auc.auction_phase_reference(benefit, b["gt_mask"])
        torch.cuda.synchronize()
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        ms = cuda_ms(lambda: auc.auction_phase(benefit, b["gt_mask"]))
        plain = cuda_ms(lambda: auc.auction_phase_reference(
            benefit, b["gt_mask"]), reps=3, warmup=1)
    print(f"[segm] mask matching: {tuple(cost.shape)} (problems, queries, "
          f"GT), {int(b['gt_mask'].sum())} GT: the auction kernel's "
          f"assignments, iterations ({int(got[1].max())} at most) and bids "
          f"equal to the plain version's {same}; {ms:.4f} ms vs plain "
          f"{plain:.2f} ms (CUDA events)", flush=True)
    if not same:
        fail("mask matching: the auction kernel disagrees with its plain "
             "version")


def masks_steps(cfg, ckpt, n_timed=3):
    """(a) --masks --frozen_weights ckpt, the stock preset's every kernel,
    on the synthetic dataset with masks: at MASKS_BATCHES' first batch
    size that fits, a warm-up step and n_timed timed steps with every
    counter set to 0 before them: the fused layers' launches per
    _per_forward, one CC and two auction launches (the box matching, the
    mask matching) a step; loss_mask and loss_dice finite; every
    parameter outside the head bit for bit its checkpoint value, every
    weight of the head moved; the mask matching's auction against its
    plain version; peak memory; then the step's split -> the summary."""
    import itertools

    import torch

    from spe_tpu_torch.data import train_data
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.models.segmentation import SEGM_PREFIXES
    from spe_tpu_torch.train import train_step as ts
    from spe_tpu_torch.train.checkpoint import load_params_lenient
    from spe_tpu_torch.train.engine import LOGGED, train_batch
    from spe_tpu_torch.train.optim import AdamW3

    for batch in MASKS_BATCHES:
        # a batch fits if its warm-up and its timed steps all do: the
        # allocator's cache fragments between steps
        bcfg = cfg.replace(batch_size=batch, frozen_weights=ckpt)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = state = batches = None
        try:
            model = build_model(bcfg).train()
            kept = load_params_lenient(ckpt, model)
            start = {n: p.detach().clone()
                     for n, p in model.named_parameters()}
            _, loader = train_data(bcfg)
            batches = [train_batch(x, torch.device("cuda")) for x in
                       itertools.islice(loader.epoch(0), 2)]
            state = ts.TrainState(model, AdamW3(model.named_parameters(),
                                                bcfg, 1 + n_timed))
            gates = ts.Gates.for_epoch(bcfg, 0)
            gen = torch.Generator("cuda").manual_seed(5)
            ts.train_step(state, batches[0], bcfg, gates, gen)
            torch.cuda.synchronize()
            _all_counts(reset=True)
            history, step_ms = [], []
            for i in range(n_timed):
                t0 = time.perf_counter()
                m = ts.train_step(state, batches[i % 2], bcfg, gates, gen)
                history.append({k: float(m[k]) for k in ("loss", *LOGGED)
                                if k in m})
                step_ms.append((time.perf_counter() - t0) * 1e3)
        except torch.cuda.OutOfMemoryError:
            del model, state, batches
            torch.cuda.empty_cache()
            print(f"[segm] masks: batch {batch} does not fit the card",
                  flush=True)
            continue
        break
    else:
        fail(f"masks: no batch of {MASKS_BATCHES} fits the card")
    counts = _all_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {f"{k}.{a}": n * n_timed for k, n in _per_forward(model).items()
            for a in ("train_launches", "bwd_launches")}
    want.update(pallas_cc=n_timed, pallas_auction=2 * n_timed)
    bad = [f"{k}: {counts[k]} launches, expected {n}"
           for k, n in want.items() if counts[k] != n]
    bad += [f"step {i}: a non-finite value or no mask loss" for i, h in
            enumerate(history) if not all(math.isfinite(v) for v in
                                          h.values())
            or not {"loss_mask", "loss_dice"} <= set(h)]
    if state.bad_steps:
        bad.append(f"bad_steps {state.bad_steps}")
    params = dict(model.named_parameters())
    head = [n for n in params if n.startswith(SEGM_PREFIXES)]
    changed = [n for n in params if n not in head
               and not torch.equal(params[n].detach(), start[n])]
    still = [n for n in head if n.endswith(".weight")
             and torch.equal(params[n].detach(), start[n])]
    if changed or still or sorted(kept) != sorted(head):
        bad.append(f"frozen parameters changed {changed[:5]}, head weights "
                   f"unmoved {still}, kept at init {kept[:5]}")
    for i, h in enumerate(history):
        print(f"[segm] masks step {i} (batch {batch}): " + " ".join(
            f"{k} {v:.4f}" for k, v in h.items()), flush=True)
    print(f"[segm] masks --frozen_weights: batch {batch}; ms a step "
          f"{[round(t, 1) for t in step_ms]} (host clock to the loss read "
          f"back) = {batch / (statistics.mean(step_ms) / 1e3):.2f} train "
          f"images/s; peak device memory {peak:.2f} GiB; launches {counts}; "
          f"{len(params) - len(head)} frozen parameters bit for bit their "
          f"checkpoint's, {len(head) - len(still)} of the head's {len(head)}"
          f" moved ({card()})", flush=True)
    if bad:
        fail("masks steps: " + "; ".join(bad))
    mask_auction_check(model, batches[0], bcfg)
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    step_split(model, bcfg, batches[0], gates, f"masks batch {batch}",
               batch)
    summary = {"batch": batch, "step_ms": step_ms, "peak_gib": peak,
               "step_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "busy_ms": profile_forward.last["busy_ms"],
               "idle": profile_forward.last["idle"]}
    del model, state, batches, start
    torch.cuda.empty_cache()
    return summary


def panoptic_cli(batch=PANOPTIC_BATCH):
    """(c) one CLI epoch of 2 steps with --masks --dataset_file
    coco_panoptic --dataset_eval coco on a generated mini-COCO of 20
    classes and its panoptic PNGs: mask losses finite, the checkpoints
    written, the COCO AP line, a CC and two auction launches a step and
    one auction an eval forward."""
    import torch

    from spe_tpu_torch.cli.main import main as cli_main
    from spe_tpu_torch.data import write_mini_coco, write_mini_coco_panoptic

    tmp = tempfile.TemporaryDirectory()
    coco = write_mini_coco(tmp.name, n_train=2 * batch, n_val=4,
                           num_classes=20, seed=8)
    pan = write_mini_coco_panoptic(coco)
    out = f"{tmp.name}/out"
    _all_counts(reset=True)
    t0 = time.perf_counter()
    res = cli_main(STOCK_TRAIN_ARGV + [
        "--masks", "--dataset_file", "coco_panoptic", "--dataset_eval",
        "coco", "--coco_path", str(coco), "--coco_panoptic_path", str(pan),
        "--batch_size", str(batch), "--output_dir", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _all_counts()
    (epoch,) = res["epochs"]
    hist, ev = epoch["train"]["history"], epoch["eval"]
    files = sorted(os.listdir(out))
    print(f"[segm] coco_panoptic CLI: {len(hist)} steps of batch {batch}, "
          f"{wall:.1f}s wall; losses " + "; ".join(
              f"loss {h['loss']:.4f} loss_mask {h['loss_mask']:.4f} "
              f"loss_dice {h['loss_dice']:.4f}" for h in hist)
          + f"; COCO AP {ev['AP']:.4f} AP50 {ev['AP50']:.4f} (random "
          f"weights); launches CC {counts['pallas_cc']}, auction "
          f"{counts['pallas_auction']} ({ev['forwards']} eval forwards); "
          f"wrote {files}", flush=True)
    bad = [] if len(hist) == 2 else [f"{len(hist)} steps"]
    bad += [f"step {i}: {h}" for i, h in enumerate(hist)
            if not all(math.isfinite(h[k]) for k in
                       ("loss", "loss_mask", "loss_dice"))]
    if not {"checkpoint.pth", "checkpoint0000.pth", "log.txt"} <= set(files):
        bad.append(f"output {files}")
    if not (0 <= ev["AP"] <= 1 or ev["AP"] == -1):
        bad.append(f"AP {ev['AP']}")
    if (counts["pallas_cc"], counts["pallas_auction"]) != (
            len(hist), 2 * len(hist) + ev["forwards"]):
        bad.append(f"launches {counts}")
    tmp.cleanup()
    if bad:
        fail("coco_panoptic CLI: " + "; ".join(bad))
    return {"seconds": wall, "AP": ev["AP"]}


def phase_segmentation():
    """Phase 12: (a) --masks from a detector checkpoint the phase writes,
    with --frozen_weights (masks_steps), then one step without frozen
    weights at B=4 under phase 8's same-grads rule (the plain run's
    supervision and mask matching replayed; the head's gradients held
    too); (b) --pre_norm --position_embedding learned: one eval batch
    with flip against the plain model (phase 4's 5%), one step's
    same-grads (phase 8's rule), and the launches: no fused-encoder
    launch, fused_mha (B4) 3 + 3 a step in the encoder; (c) the
    coco_panoptic CLI epoch (panoptic_cli)."""
    from spe_tpu_torch.cli.main import parse_config
    from spe_tpu_torch.data import eval_data, write_mini_voc
    from spe_tpu_torch.models.build import build_model

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    cfg = parse_config(MASKS_ARGV + ["--output_dir", f"{tmp.name}/out"])
    ckpt = f"{tmp.name}/detector.pth"
    _write_detector(cfg, ckpt)
    summary = {"masks": masks_steps(cfg, ckpt)}
    # B=4: at B=2 on this data the decoder's linear1 gradients are bf16
    # noise on both paths, mask losses or not (PERF.md §6)
    phase_same_grads(cfg, "masks", NOISY, batch=4)
    summary["masks"]["seconds"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    devkit = write_mini_voc(tmp.name, n_test=8, n_trainval=8, seed=9)
    cfg = parse_config(PRENORM_ARGV + ["--test_path", str(devkit),
                                       "--output_dir", f"{tmp.name}/pre"])
    per = _per_forward(build_model(cfg))
    print(f"[segm] pre-norm learned: launches a forward {per} (a training "
          f"step launches each as often in its backward)", flush=True)
    if per["pallas_encoder"] or per["pallas_mha"] != cfg.enc_layers:
        fail(f"pre-norm: the encoder runs {per}, expected no fused encoder "
             f"layer and fused_mha in each of its {cfg.enc_layers} layers")
    _, loader = eval_data(cfg)
    b = _flipped(next(iter(loader.epoch(0))))
    _, _, _, bad = kernel_vs_plain(cfg, b, "pre-norm eval", _stage_pairs)
    if bad:
        fail("pre-norm eval vs plain model: " + "; ".join(bad))
    phase_same_grads(cfg, "pre-norm learned", NOISY)
    summary["prenorm"] = {"seconds": time.perf_counter() - t1,
                          "busy_ms": profile_forward.last["busy_ms"],
                          "idle": profile_forward.last["idle"]}
    tmp.cleanup()
    summary["panoptic_cli"] = panoptic_cli()
    summary["seconds"] = time.perf_counter() - t0
    print(f"[segm] {json.dumps(summary)} ({card()})", flush=True)


# phase 13: tensor and sequence parallelism, two processes on cuda:0 over
# gloo (one card: NCCL refuses two ranks on one device; gloo carries the
# card's tensors through the host), one model group of two
TP_ARGV = STOCK_TRAIN_ARGV + [
    "--no_use_fused_block", "--no_use_fused_layers", "--tp_attention",
    "--dropout", "0", "--backbone_drop_rate", "0", "--drop_path_rate", "0",
    "--drop_attn_rate", "0"]
TP_WORLD = 2
TP_BATCH, TP_EVAL_BATCH = 4, 8
TP_TIMEOUT = 420      # seconds the two processes may take
# (g)'s --masks --frozen_weights step: the largest of these batches at
# which both ranks fit the one card, judged by one process's peak at it
TP_MASKS_BATCHES = (4, 2)
TP_MASKS_MARGIN_GIB = 6.0   # the parent's context and the allocators' slack
SP_TOL = 1e-5         # (e): of the unsharded f32 attention's largest


def _tp_cfgs(root):
    """The one-process and the model-group configurations of phase 13 on
    a generated VOCdevkit under root."""
    from spe_tpu_torch.cli.main import parse_config

    one = parse_config(TP_ARGV)
    one = one.replace(batch_size=TP_BATCH, **write_data(
        one, root, TP_EVAL_BATCH, 1, seed=13))
    return one, one.replace(model_axis=TP_WORLD, world_size=TP_WORLD)


def _eval_model(cfg, device, tp=None):
    """Phase 4's model pair's side for cfg: LayerScale 1 and the last bbox
    layers drawn (kernel_vs_plain), the same on every rank: the bbox heads
    are replicated."""
    import torch

    from spe_tpu_torch.models.build import build_model

    model = build_model(cfg.replace(init_scale=1.0), device, tp=tp)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for head in model.bbox_embed:
            head.layers[-1].weight.copy_(
                0.02 * torch.randn(head.layers[-1].weight.shape,
                                   generator=gen))
    return model


def _eval_pairs(out):
    """The flipped eval forward's outputs phase 13 (c) compares."""
    pairs = {"cams_cls": out["backbone"]["cams_cls"],
             "x_logits": out["backbone"]["x_logits"]}
    for r, st in out["stages"].items():
        pairs.update({f"stage{r}_{k}": st[k]
                      for k in ("pred_logits", "pred_boxes")})
    return {k: v.detach().float().cpu() for k, v in pairs.items()}


def _head_cases():
    """(d)'s fused_mha cases: attention_cases' encoder self-attention and
    decoder cross-attention at rate 0 -> {label: (q, k, v, H, mask, cot)}."""
    from spe_tpu_torch.ops.kernel_checks import attention_cases

    return {label: (*args[:5], cot[0]) for name, _, _, args, cot, label in
            attention_cases(train=True, device="cuda")
            if name == "pallas_mha" and args[5]}


def tp_heads(rank, H_full=8):
    """(d) on this rank of the model group: B4 on its H/2 heads (head0 =
    rank * H/2) against the full-head kernel call's heads and the plain
    version, forward and backward at rate 0; then its in-kernel dropout
    masks (forward and attn_bwd_rows) at the recipe's rate against the
    torch formula keyed by global head, bit for bit. -> (lines, bad)."""
    import torch

    from spe_tpu_torch.ops import fused_mha as F
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import (TRANSFORMER_RATE, bf16_tol,
                                                 grad_tol, max_err)
    from spe_tpu_torch.ops.refmath import (SITE_MHA_ATTN, CounterDropout,
                                           no_dropout)

    lines, bad = [], []
    for label, (q, k, v, H, mask, cot) in _head_cases().items():
        h = H // TP_WORLD

        def mine(t, n=H):
            w = t.shape[-1] // n
            return t[..., rank * h * w:(rank + 1) * h * w]

        drop = CounterDropout(no_dropout("cuda").seed, head0=rank * h)
        with torch.no_grad():
            full, lse_f = F._train_cuda(q, k, v, H, mask)
            out, lse = F._train_cuda(mine(q), mine(k), mine(v), h, mask, drop)
            ref, lse_r = F.fused_mha_train_reference(mine(q), mine(k),
                                                     mine(v), h, mask, drop)
            gf = F._backward_cuda(cot, q, k, v, lse_f, H, mask)
            args = (mine(cot), mine(q), mine(k), mine(v), lse, h, mask, drop)
            g = F._backward_cuda(*args)
            gr = F.fused_mha_backward_reference(*args)
            torch.cuda.synchronize()
        same = torch.equal(out, mine(full)) and torch.equal(
            lse, lse_f[:, rank * h:(rank + 1) * h]) and all(
            torch.equal(a, mine(b)) for a, b in zip(g, gf))
        errs = [max_err(out, ref), max_err(lse, lse_r)]
        tols = [bf16_tol(ref), 1e-4]
        gerr = [max_err(a, b) for a, b in zip(g, gr)]
        gtol = [grad_tol(b) for b in gr]
        ok = same and all(e <= t for e, t in zip(errs + gerr, tols + gtol))
        lines.append(f"rank {rank}, {label}, heads {rank * h}-"
                     f"{(rank + 1) * h - 1} of {H}: forward and backward "
                     f"equal to the full-head call's heads bit for bit "
                     f"{same}; against the plain version: out, lse "
                     f"{[f'{e:.3e}' for e in errs]} (tol "
                     f"{[f'{t:.3e}' for t in tols]}), dq dk dv "
                     f"{[f'{e:.3e}' for e in gerr]} (tol "
                     f"{[f'{t:.3e}' for t in gtol]}) -> "
                     f"{'ok' if ok else 'BAD'}")
        if not ok:
            bad.append(f"rank {rank} {label} head-sharded B4")
    # the masks: Nk = dv = 24 keys and V the identity, so the output is
    # the dropped probabilities rounded to bf16, zero exactly where dropped
    gen = torch.Generator().manual_seed(rank + 31)
    rate = TRANSFORMER_RATE
    seed = torch.tensor([20240619], dtype=torch.int32, device="cuda")
    B, Nq, Nk, dv, h = 2, 256, 24, 24, H_full // TP_WORLD
    for dq in (24, 48):
        q = torch.randn((B, Nq, h * dq), generator=gen).to(
            torch.bfloat16).cuda()
        kk = torch.randn((B, Nk, h * dq), generator=gen).to(
            torch.bfloat16).cuda()
        v = torch.eye(Nk).repeat(1, h)[None].expand(B, -1, -1).to(
            torch.bfloat16).cuda().contiguous()
        drop = CounterDropout(seed, attn=rate, head0=rank * h)
        with torch.no_grad():
            out, lse = F._train_cuda(q, kk, v, h, None, drop)
            got = (out.float().reshape(B, Nq, h, dv).transpose(1, 2) != 0)
            want = K.attention_keep(seed, (SITE_MHA_ATTN, rate),
                                    (B, h, Nq, Nk), h, rank * h)
            s = torch.randn((B, h, Nq, Nk), generator=gen).cuda()
            zd, _ = K.attention_bwd_rows(
                s, torch.randn_like(s), torch.logsumexp(s, -1), None, seed,
                (SITE_MHA_ATTN, rate), num_heads=h, head0=rank * h)
        same = bool(torch.equal(got, want)) and bool(torch.equal(zd != 0,
                                                                 want))
        share = float(want.float().mean())
        sigma = (rate * (1 - rate) / want.numel()) ** 0.5
        ok = same and abs(share - (1 - rate)) <= 4 * sigma
        lines.append(f"rank {rank}, masks at rate {rate}, {dq} x {dv} "
                     f"heads {rank * h}-{(rank + 1) * h - 1}: attn_kernel "
                     f"and attn_bwd_rows_kernel == the torch formula keyed "
                     f"by global head {same}; kept {share:.5f} (4 sigma "
                     f"{4 * sigma:.5f}) -> {'ok' if ok else 'BAD'}")
        if not ok:
            bad.append(f"rank {rank} B4 masks with head0 ({dq} x {dv})")
    return lines, bad


def tp_sequence(rank, B=2, H=8, N=1024, dh=24):
    """(e): kv_sharded_attention and ring_kv_attention over the two ranks
    at the encoder's recipe shape (f32, each rank 512 of the 1024 keys and
    their padding mask) against the unsharded attention: the output and
    dq, dk, dv (this rank's keys) within SP_TOL of the largest of each.
    -> (lines, bad)."""
    import torch

    from spe_tpu_torch.ops.kernel_checks import max_err
    from spe_tpu_torch.ops.seq_parallel import (kv_sharded_attention,
                                                ring_kv_attention)

    gen = torch.Generator().manual_seed(29)
    q, k, v = (torch.randn((B, H, n, dh), generator=gen).cuda()
               for n in (N, N, N))
    mask = torch.zeros((B, N), dtype=torch.bool)
    mask[1, -200:] = True
    mask = mask.cuda()
    cot = torch.randn((B, H, N, dh), generator=gen).cuda()
    n = N // TP_WORLD
    keys = slice(rank * n, (rank + 1) * n)

    def ref(q, k, v):
        s = (q @ k.transpose(-1, -2)) * dh ** -0.5
        s = s.masked_fill(mask[:, None, None, :], -1e9)
        return torch.softmax(s, -1) @ v

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = ref(*leaves)
    want_g = torch.autograd.grad((want * cot).sum(), leaves)
    lines, bad = [], []
    for name, fn in (("kv_sharded_attention", kv_sharded_attention),
                     ("ring_kv_attention", ring_kv_attention)):
        ql = q.clone().requires_grad_()
        kl, vl = (t[:, :, keys].clone().requires_grad_() for t in (k, v))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(ql, kl, vl, key_padding_mask_local=mask[:, keys])
        g = torch.autograd.grad((got * cot).sum(), (ql, kl, vl))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rel = [max_err(a, b) / float(b.abs().max()) for a, b in
               zip((got.detach(), *g), (want.detach(), want_g[0],
                                        want_g[1][:, :, keys],
                                        want_g[2][:, :, keys]))]
        ok = all(r <= SP_TOL for r in rel)
        lines.append(f"rank {rank}, {name} at ({B}, {H}, {N}, {dh}) f32, "
                     f"{n} keys a rank: out, dq, dk, dv against the "
                     f"unsharded attention {[f'{r:.2e}' for r in rel]} of "
                     f"the largest (limit {SP_TOL}) -> "
                     f"{'ok' if ok else 'BAD'}; forward and backward "
                     f"{ms:.1f} ms (host clock, gloo through the host)")
        if not ok:
            bad.append(f"rank {rank} {name}")
    return lines, bad


def tp_worker(rank, port, tmp):
    """One of phase 13's processes (`python3 chip_smoke.py --tp-worker
    RANK PORT DIR`), rank RANK of a model group of two on cuda:0 over
    gloo: (a) the TP step's gradients on the one-process run's
    supervision, (f) a warm-up step, the counted, timed train_step and a
    profiled one, (b) the replicated parameters' digests, the CC labels
    and auction assignments, the gathered checkpoint, (c) the flipped eval
    forward at B=8, (d) tp_heads, (e) tp_sequence, (g) tp_masks; results
    to DIR/rank{RANK}.pt."""
    import torch

    from spe_tpu_torch.config import SPEConfig
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.ops import cam_boxes
    from spe_tpu_torch.parallel import dist
    from spe_tpu_torch.parallel.mesh import make_mesh
    from spe_tpu_torch.parallel.sharding_rules import (gather_model_state,
                                                       gather_tensors)
    from spe_tpu_torch.train import train_step as ts
    from spe_tpu_torch.train.checkpoint import save_checkpoint
    from spe_tpu_torch.train.optim import AdamW3

    os.environ.update(RANK=str(rank), LOCAL_RANK="0")
    dev = dist.init_distributed(TP_WORLD, f"tcp://127.0.0.1:{port}", "cuda",
                                backend="gloo")
    mesh = make_mesh(TP_WORLD, TP_WORLD)
    tp = mesh.tp
    spec = torch.load(f"{tmp}/spec.pt", weights_only=False)
    cfg = SPEConfig(**spec["tp"])
    batch = {k: v.to(dev) for k, v in spec["batch"].items()}
    gates = ts.Gates.for_epoch(cfg, 0)
    model = build_model(cfg, dev, tp=tp)
    out = {"init": _digest_state(gather_model_state(model))}

    def grads():
        return gather_tensors(
            [(n, p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()], tp)

    # (a) the one-process run's supervision replayed
    model.train()
    model.zero_grad(set_to_none=True)
    total, _, _ = ts.compute_losses(
        model, batch, cfg, gates, torch.Generator(dev).manual_seed(0),
        supervision=_to(spec["sup"], dev))
    total.backward()
    ts.reduce_model_group_grads(list(model.parameters()))
    out["replay_loss"] = float(total.detach())
    replay = {n: g.float().cpu() for n, g in grads().items()}
    if rank == 0:
        out["replay"] = replay
    del replay

    # (f) a warm-up step (its own supervision: the gap without replay),
    # then the counted, timed step; (b) what the ranks must share
    state = ts.TrainState(model, AdamW3(model.named_parameters(), cfg, 10))
    labels, used = [], []
    cc, losses = cam_boxes.connected_components, ts.compute_losses

    def connected_components(*a, **kw):
        res = cc(*a, **kw)
        labels.append(res[0] if isinstance(res, tuple) else res)
        return res

    def compute_losses(*a, **kw):
        res = losses(*a, **kw)
        used.append(res[2])
        return res

    cam_boxes.connected_components = connected_components
    ts.compute_losses = compute_losses
    try:
        m = ts.train_step(state, batch, cfg, gates,
                          torch.Generator(dev).manual_seed(0))
        own = {n: g.float().cpu() for n, g in grads().items()}
        if rank == 0:
            out["own"] = own
        del own
        out.update(own_loss=float(m["loss"]),
                   cc_labels=[t.cpu() for t in labels],
                   matching=[u["matching"][0].cpu() for u in used])
        torch.cuda.synchronize()
        _all_counts(reset=True)
        tp.calls = tp.bytes = 0
        tp.seconds = 0.0
        torch.cuda.reset_peak_memory_stats()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        a.record()
        m = ts.train_step(state, batch, cfg, gates,
                          torch.Generator(dev).manual_seed(1))
        b.record()
        torch.cuda.synchronize()
        out.update(step_ms=(time.perf_counter() - t0) * 1e3,
                   step_cuda_ms=a.elapsed_time(b), counts=_all_counts(),
                   collectives=(tp.calls, tp.bytes, tp.seconds * 1e3),
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   per=_per_forward(model))
        # a third step under torch.profiler: the device's busy time
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ts.train_step(state, batch, cfg, gates,
                          torch.Generator(dev).manual_seed(2))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if getattr(e, "device_type", None) ==
                   torch.autograd.DeviceType.CUDA) / 1e3
        out["profiled"] = (wall, busy)
    finally:
        cam_boxes.connected_components, ts.compute_losses = cc, losses
    out["replicated"] = {n: _digest_state({n: p}) for n, p in
                         model.named_parameters()
                         if not hasattr(p, "tp_shard")}
    after = gather_model_state(model)   # collective: every rank
    if rank == 0:
        out["after"] = {n: t.float().cpu() for n, t in after.items()}
    del after
    save_checkpoint(f"{tmp}/tp.pth", state, 0, cfg)   # collective
    del state, model
    torch.cuda.empty_cache()

    # (c) the flipped eval forward at B=8
    model = _eval_model(cfg, dev, tp).eval()
    images = spec["eval"]["images"].to(dev)
    pad = spec["eval"]["pad_mask"].to(dev)
    calls = tp.calls
    with torch.no_grad():
        model(images, pad_mask=pad)     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eo = model(images, pad_mask=pad)
        torch.cuda.synchronize()
    out.update(eval_ms=(time.perf_counter() - t0) * 1e3,
               eval_collectives=(tp.calls - calls) // 2,
               eval_out=_eval_pairs(eo))
    del model, eo
    torch.cuda.empty_cache()

    out["heads"] = tp_heads(rank)
    out["sequence"] = tp_sequence(rank)
    out["masks"] = tp_masks(spec["masks"], tp, dev)
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.shutdown()


def tp_masks(spec, tp, dev):
    """(g) on this rank: the --masks --frozen_weights model of the model
    group (MHAttentionMap on its heads, the mask head whole) loaded from
    the whole-tensor detector checkpoint by load_params_lenient (its
    shards), then (1) the one-process run's supervision and mask matching
    replayed: the gathered gradients; (2) one counted train_step on its
    own supervision: launches, peak memory, ms, the parameters' digests
    before and after."""
    import torch

    from spe_tpu_torch.config import SPEConfig
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.parallel.sharding_rules import gather_tensors
    from spe_tpu_torch.train import train_step as ts
    from spe_tpu_torch.train.checkpoint import load_params_lenient
    from spe_tpu_torch.train.optim import AdamW3

    cfg = SPEConfig(**spec["cfg"])
    batch = {k: v.to(dev) for k, v in spec["batch"].items()}
    gates = ts.Gates.for_epoch(cfg, 0)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, dev, tp=tp).train()
    kept = load_params_lenient(cfg.frozen_weights, model)
    start = {n: _digest_state({n: p}) for n, p in model.named_parameters()}
    out = {"kept": kept}
    model.zero_grad(set_to_none=True)
    total, _, _ = ts.compute_losses(
        model, batch, cfg, gates, torch.Generator(dev).manual_seed(0),
        supervision=_to(spec["sup"], dev))
    total.backward()
    ts.reduce_model_group_grads(list(model.parameters()))
    out["replay_loss"] = float(total.detach())
    replay = gather_tensors(
        [(n, p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in model.named_parameters()], tp)
    if tp.index == 0:
        out["replay"] = {n: g.float().cpu() for n, g in replay.items()}
    del replay, total
    model.zero_grad(set_to_none=True)
    state = ts.TrainState(model, AdamW3(model.named_parameters(), cfg, 10))
    torch.cuda.synchronize()
    _all_counts(reset=True)
    tp.calls = tp.bytes = 0
    tp.seconds = 0.0
    t0 = time.perf_counter()
    m = ts.train_step(state, batch, cfg, gates,
                      torch.Generator(dev).manual_seed(1))
    torch.cuda.synchronize()
    out.update(step_ms=(time.perf_counter() - t0) * 1e3, counts=_all_counts(),
               collectives=(tp.calls, tp.bytes, tp.seconds * 1e3),
               per=_per_forward(model), bad_steps=state.bad_steps,
               metrics={k: float(v) for k, v in m.items()},
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               start=start,
               after={n: _digest_state({n: p})
                      for n, p in model.named_parameters()},
               replicated=sorted(n for n, p in model.named_parameters()
                                 if not hasattr(p, "tp_shard")))
    del state, model
    torch.cuda.empty_cache()
    return out


def _to(tree, device):
    """A nest of dicts, lists and tuples of tensors on `device`."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def _digest_state(named):
    import hashlib

    h = hashlib.sha256()
    for n, t in named.items():
        h.update(n.encode())
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _tp_reference(cfg, batch, dev, enough=None):
    """The one-process side of (a) and (g) on cuda:0: the model of cfg
    (model_axis 1, the same kernels; with frozen_weights loaded from it by
    load_params_lenient) on its own supervision -> (loss, gradients, the
    supervision, the state's digest, the peak GiB), and as "f32" the
    gradients of the plain f32 model given that supervision, unless
    enough(the peak GiB) is false."""
    import torch

    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.train import train_step as ts
    from spe_tpu_torch.train.checkpoint import load_params_lenient

    gates = ts.Gates.for_epoch(cfg, 0)
    runs = {}
    for how, c in (("one", cfg), ("f32", cfg.replace(
            use_pallas_attention=False, tp_attention=False,
            compute_dtype="float32"))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(c, dev).train()
        if c.frozen_weights:
            load_params_lenient(c.frozen_weights, model)
        total, _, sup = ts.compute_losses(
            model, batch, c, gates, torch.Generator(dev).manual_seed(0),
            supervision=runs["one"][2] if how == "f32" else None)
        total.backward()
        runs[how] = (float(total.detach()), _dense_grads(model), sup,
                     _digest_state(model.state_dict()),
                     torch.cuda.max_memory_allocated() / 2 ** 30)
        del model, total
        torch.cuda.empty_cache()
        if enough is not None and not enough(runs["one"][4]):
            break
    return runs


def _tp_masks_reference(one_cfg, root, dev):
    """(g)'s one-process side: phase 13's configuration with --masks on the
    synthetic dataset with masks and --frozen_weights of a whole-tensor
    detector checkpoint it writes (seed 7, no head); at the first batch of
    TP_MASKS_BATCHES at which two processes of one process's peak fit the
    card, the one-process runs (_tp_reference) -> (the ranks' spec, the
    runs, the batch, the card's GiB)."""
    import dataclasses

    import torch

    from spe_tpu_torch.data import train_data
    from spe_tpu_torch.train.engine import train_batch

    ckpt = f"{root}/masks_detector.pth"
    cfg = one_cfg.replace(masks=True, dataset_file="synthetic",
                          frozen_weights=ckpt)
    _write_detector(cfg, ckpt)
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30

    def fits(peak):
        return 2 * peak + TP_MASKS_MARGIN_GIB <= card_gib

    _, loader = train_data(cfg.replace(batch_size=max(TP_MASKS_BATCHES)))
    full = train_batch(next(iter(loader.epoch(0))), dev)
    for b in TP_MASKS_BATCHES:
        bcfg = cfg.replace(batch_size=b)
        batch = {k: v[:b] for k, v in full.items()}
        try:
            runs = _tp_reference(bcfg, batch, dev, fits)
        except torch.cuda.OutOfMemoryError:
            runs = None
            torch.cuda.empty_cache()
        if runs is not None and "f32" in runs:
            break
        peak = ("out of memory" if runs is None
                else f"{runs['one'][4]:.2f} GiB")
        print(f"[tensor-parallel] (g) --masks at B={b}: two processes of "
              f"one process's peak ({peak}) do not fit the card's "
              f"{card_gib:.1f} GiB", flush=True)
    else:
        fail(f"tensor parallel (g): --masks fits no batch of "
             f"{TP_MASKS_BATCHES} on two processes")
    spec = {"cfg": dataclasses.asdict(bcfg.replace(model_axis=TP_WORLD,
                                                   world_size=TP_WORLD)),
            "batch": {k: v.cpu() for k, v in batch.items()},
            "sup": _to(runs["one"][2], "cpu")}
    return spec, runs, b, card_gib


def _tp_launch(tmp):
    import socket

    import torch

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-worker", str(r),
         str(port), tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(TP_WORLD)]
    try:
        outs = [p.communicate(timeout=TP_TIMEOUT)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        fail(f"tensor parallel: the processes outlasted {TP_TIMEOUT}s")
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(o[-4000:], flush=True)
            fail(f"tensor parallel: process {r} exited {p.returncode}")
    return ([torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
             for r in range(TP_WORLD)], time.perf_counter() - t0)


def sdpa_backward_times(results):
    """Row 7b's library yardstick: scaled_dot_product_attention forward and
    backward (timed apart) at rate 0 on attention_cases' encoder and
    cross-attention shapes (B=2), beside fused_mha's training forward and
    backward kernels on the same inputs. The port never calls SDPA."""
    import torch
    import torch.nn.functional as Fn

    from spe_tpu_torch.ops import fused_mha as F
    from spe_tpu_torch.ops.refmath import key_bias, split_heads

    found = {}
    for label, (q, k, v, H, mask, cot) in _head_cases().items():
        with torch.no_grad():
            out, lse = F._train_cuda(q, k, v, H, mask)
        kf = cuda_ms(lambda: F._train_cuda(q, k, v, H, mask))
        kb = cuda_ms(lambda: F._backward_cuda(cot, q, k, v, lse, H, mask))
        bias = key_bias(mask, k.shape[0], k.shape[1], q.device)
        bias = None if bias is None else bias[:, None, None, :].to(q.dtype)
        leaves = [split_heads(t, H).detach().requires_grad_()
                  for t in (q, k, v)]
        dy = split_heads(cot, H).contiguous()

        def fwd():
            return Fn.scaled_dot_product_attention(*leaves, attn_mask=bias)

        y = fwd()
        lf = cuda_ms(lambda: fwd().detach())
        lb = cuda_ms(lambda: torch.autograd.grad(y, leaves, dy,
                                                 retain_graph=True))
        found[label] = {"kernel_fwd_ms": kf, "kernel_bwd_ms": kb,
                        "sdpa_fwd_ms": lf, "sdpa_bwd_ms": lb}
        print(f"[tensor-parallel] {card()}: {label} at rate 0, q "
              f"{tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}: "
              f"fused_mha training forward {kf:.3f} ms, backward "
              f"{kb:.3f} ms; scaled_dot_product_attention forward "
              f"{lf:.3f} ms, backward {lb:.3f} ms (CUDA events)", flush=True)
        del y, leaves
    entry = results.get("pallas_mha_bwd")
    if entry is not None:
        entry["library_ms"] = found[MAIN_SHAPE["pallas_mha"]]["sdpa_bwd_ms"]
        entry["library_shapes"] = found


def phase_tensor_parallel(results):
    """Phase 13: `--model_axis 2 --tp_attention --no_use_fused_block
    --no_use_fused_layers` on the stock voc0712 model at full width, two
    processes on cuda:0 over gloo (`--tp-worker`), through build_model,
    train_step, save_checkpoint and the model's eval forward as the CLI
    calls them. (a) One TP step at B=4, dropout 0, against one process
    (the same kernels, model_axis 1): given the one-process supervision,
    the gathered gradients by phase 8's same-grads rule (NOISY held to the
    plain f32 model); the gap on the TP run's own supervision reported.
    (b) The ranks' replicated parameters bit for bit equal after three
    steps, their CC labels and auction assignments equal; the gathered
    checkpoint loads into the one-process model. (c) The flipped eval forward at
    B=8 against one process (phase 4's 5%). (d) B4 head-sharded
    (tp_heads), (e) sequence parallelism (tp_sequence). (f) Each rank's
    launches of the counted step (B4 3 + 3 encoder and 6 + 6 cross, no
    class-attention B4, one CC and one auction), its model-group
    collectives, their bytes and host ms, ms a step (host clock and CUDA
    events), a profiled step's device busy time and peak GiB; SDPA's
    forward and backward beside B4's (row 7b). (g) --masks
    --frozen_weights in the model group (_tp_masks_reference, tp_masks,
    tp_masks_checks)."""
    import dataclasses

    import torch

    from spe_tpu_torch.data import train_data
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.ops.kernel_checks import (MAP_KEYS, grad_views,
                                                 max_err, model_tol)
    from spe_tpu_torch.train import train_step as ts
    from spe_tpu_torch.train.checkpoint import restore_checkpoint
    from spe_tpu_torch.train.optim import AdamW3

    t_phase = time.perf_counter()
    line = card()
    dev = torch.device("cuda", 0)
    sdpa_backward_times(results)
    tmp = tempfile.TemporaryDirectory()
    one_cfg, tp_cfg = _tp_cfgs(f"{tmp.name}/voc")
    _, loader = train_data(one_cfg.replace(batch_size=TP_EVAL_BATCH))
    full = next(iter(loader.epoch(0)))
    batch = {k: torch.as_tensor(full[k][:TP_BATCH])
             for k in ("images", "pad_mask", "img_label")}
    flip = _flipped(full)
    runs = _tp_reference(one_cfg, {k: v.to(dev) for k, v in batch.items()},
                         dev)
    eval_one = _eval_pairs(_eval_model(one_cfg, dev).eval()(
        torch.as_tensor(flip["images"], device=dev),
        pad_mask=torch.as_tensor(flip["pad_mask"], device=dev)))
    torch.cuda.empty_cache()
    masks_spec, masks_runs, masks_b, card_gib = _tp_masks_reference(
        one_cfg, tmp.name, dev)
    torch.save({"tp": dataclasses.asdict(tp_cfg), "batch": batch,
                "sup": _to(runs["one"][2], "cpu"),
                "eval": {k: torch.as_tensor(flip[k])
                         for k in ("images", "pad_mask")},
                "masks": masks_spec},
               f"{tmp.name}/spec.pt")
    ranks, wall = _tp_launch(tmp.name)
    r0 = ranks[0]
    bad = []

    # (a) the step against one process
    if any(rk["init"] != runs["one"][3] for rk in ranks):
        bad.append("the gathered initial weights differ from one process's")
    views = grad_views(r0["replay"])
    gp = {n: g.cpu() for n, g in runs["one"][1].items()}
    g32 = {n: g.cpu() for n, g in runs["f32"][1].items()}
    held = _hold(views, grad_views(gp), grad_views(g32), NOISY)
    bad += _report("tensor parallel", "the model group's gathered gradients "
                   "vs one process, given its supervision",
                   {"loss": r0["replay_loss"]}, {"loss": runs["one"][0]},
                   len(views), held, NOISY)
    own = _grad_gaps(r0["own"], gp)
    own_worst = max(own, key=own.get)
    # (b) what the ranks share; the checkpoint in one process
    differ = sorted(n for n, d in r0["replicated"].items()
                    if any(rk["replicated"][n] != d for rk in ranks))
    same_rep = not differ
    same_cc = all(len(rk["cc_labels"]) == len(r0["cc_labels"]) and all(
        torch.equal(a, b) for a, b in zip(rk["cc_labels"], r0["cc_labels"]))
        for rk in ranks)
    same_match = all(all(torch.equal(a, b) for a, b in
                         zip(rk["matching"], r0["matching"])) for rk in ranks)
    if not (same_rep and same_cc and same_match and r0["cc_labels"]):
        bad.append(f"the ranks' replicated parameters equal {same_rep} "
                   f"({len(differ)} differ: {differ[:6]}), CC labels "
                   f"{same_cc}, auction assignments {same_match}")
    model = build_model(one_cfg, dev)
    state = ts.TrainState(model, AdamW3(model.named_parameters(), one_cfg, 10))
    epoch = restore_checkpoint(f"{tmp.name}/tp.pth", state)
    ck = all(torch.equal(p.detach().float().cpu(), r0["after"][n])
             for n, p in model.named_parameters())
    if not (ck and epoch == 0 and state.optimizer.count == 3):
        bad.append(f"the gathered checkpoint in one process: parameters "
                   f"equal {ck}, epoch {epoch}, optimizer count "
                   f"{state.optimizer.count}")
    del model, state
    torch.cuda.empty_cache()
    # (c) eval
    eval_bad, errs = [], {}
    for k, w in eval_one.items():
        g = r0["eval_out"][k]
        errs[k] = (max_err(g, w), model_tol(k, w))
        if not (bool(torch.isfinite(g).all()) and errs[k][0] <= errs[k][1]):
            eval_bad.append(k)
        if not torch.equal(g, ranks[1]["eval_out"][k]):
            eval_bad.append(f"{k} (the ranks differ)")
    if eval_bad:
        bad.append(f"eval with flip vs one process: {eval_bad}")
    # (f) launches
    per = r0["per"]
    for r, rk in enumerate(ranks):
        want = {"pallas_cc": 1, "pallas_auction": 1,
                "pallas_mha.train_launches": per["pallas_mha"],
                "pallas_mha.bwd_launches": per["pallas_mha"]}
        want.update({k: 0 for k in rk["counts"] if k not in want})
        bad += [f"rank {r} {k}: {rk['counts'][k]} launches, expected {n}"
                for k, n in want.items() if rk["counts"][k] != n]
    if per["pallas_mha"] != one_cfg.enc_layers + one_cfg.dec_layers:
        bad.append(f"B4 in {per['pallas_mha']} layers a forward, expected "
                   f"the {one_cfg.enc_layers} encoder and "
                   f"{one_cfg.dec_layers} decoder layers (no class "
                   f"attention)")
    for rk in ranks:
        for text in rk["heads"][0] + rk["sequence"][0]:
            print(f"[tensor-parallel] {line}: {text}", flush=True)
        bad += rk["heads"][1] + rk["sequence"][1]
    results.setdefault("pallas_mha", {})["tp"] = {
        "launches_per_step": {k: v for k, v in r0["counts"].items() if v},
        "collectives_per_step": r0["collectives"][0],
        "collective_bytes_per_step": r0["collectives"][1],
        "collective_host_ms_per_step": r0["collectives"][2],
        "profiled_step_ms": r0["profiled"][0],
        "device_busy_ms": r0["profiled"][1],
        "step_ms": r0["step_ms"], "step_cuda_ms": r0["step_cuda_ms"],
        "peak_gib": r0["peak_gib"], "eval_ms": r0["eval_ms"]}
    print(f"[tensor-parallel] {line}: (a) {TP_WORLD} processes on cuda:0 "
          f"over gloo, a model group of {TP_WORLD}, the stock voc0712 model "
          f"at full width with --tp_attention, B={TP_BATCH}: loss "
          f"{r0['replay_loss']:.6f} vs one process {runs['one'][0]:.6f} "
          f"given its supervision (gradients by the same-grads rule, "
          f"above); on its own supervision the TP loss {r0['own_loss']:.6f} "
          f"and the gradients apart by at most {own[own_worst]:.3e} of the "
          f"tensor's largest ({own_worst}; reported, not held)", flush=True)
    print(f"[tensor-parallel] {line}: (b) the {len(r0['replicated'])} "
          f"replicated parameters bit for bit equal on both ranks after 3 "
          f"steps {same_rep}; CC labels ({len(r0['cc_labels'])} calls) "
          f"equal {same_cc}; auction assignments equal {same_match}; the "
          f"gathered checkpoint in one process: parameters equal {ck}",
          flush=True)
    print(f"[tensor-parallel] {line}: (c) eval with flip at "
          f"B={TP_EVAL_BATCH} against one process: " + ", ".join(
              f"{k} {e:.3e} (tol {t:.3e}, 0.05 x "
              f"{'range' if k in MAP_KEYS else 'max|one|'})"
              for k, (e, t) in errs.items()) + f"; TP eval forward "
          f"{r0['eval_ms']:.1f} ms (host clock), {r0['eval_collectives']} "
          f"model-group collectives", flush=True)
    print(f"[tensor-parallel] {line}: (f) per rank a step: launches "
          f"{ {k: v for k, v in r0['counts'].items() if v} }; model-group "
          f"collectives {[rk['collectives'][0] for rk in ranks]}, "
          f"{r0['collectives'][1] / 2 ** 20:.1f} MiB (gloo, through the "
          f"host), {[round(rk['collectives'][2], 1) for rk in ranks]} ms "
          f"inside them (host clock, the device-to-host copy's wait for "
          f"the queued kernels included); step "
          f"{[round(rk['step_ms'], 1) for rk in ranks]} ms host clock, "
          f"{[round(rk['step_cuda_ms'], 1) for rk in ranks]} ms CUDA "
          f"events; a profiled step: wall "
          f"{[round(rk['profiled'][0], 1) for rk in ranks]} ms, device busy "
          f"{[round(rk['profiled'][1], 1) for rk in ranks]} ms (idle share "
          f"{[round(1 - rk['profiled'][1] / rk['profiled'][0], 3) for rk in ranks]}"
          f"); peak {[round(rk['peak_gib'], 2) for rk in ranks]} GiB; loss "
          f"{r0['loss']:.6f}, grad_norm {r0['grad_norm']:.4f}; the "
          f"processes' wall {wall:.1f} s, the phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    bad += tp_masks_checks(ranks, masks_runs, masks_b, card_gib, line)
    tmp.cleanup()
    if bad:
        fail("tensor parallel: " + "; ".join(bad[:20]))


def tp_masks_checks(ranks, runs, batch, card_gib, line):
    """(g) --masks --frozen_weights in the model group at B=batch: the
    gathered gradients on the one-process supervision and mask matching
    by phase 8's same-grads rule against one process; every rank a CC and
    two auction launches (the box matching, the mask matching) and B4's in
    its step; the replicated parameters (the mask head's among them) bit
    for bit equal on both ranks, every parameter outside the head its
    checkpoint's, the head's weights moved; each rank's peak GiB. ->
    failures."""
    from spe_tpu_torch.models.segmentation import SEGM_PREFIXES
    from spe_tpu_torch.ops.kernel_checks import grad_views

    r0 = ranks[0]["masks"]
    mk = [rk["masks"] for rk in ranks]
    gp = {n: g.cpu() for n, g in runs["one"][1].items()}
    g32 = {n: g.cpu() for n, g in runs["f32"][1].items()}
    noisy = NOISY if batch > 2 else NOISY_B2
    views = grad_views(r0["replay"])
    held = _hold(views, grad_views(gp), grad_views(g32), noisy)
    bad = _report("tensor parallel masks", "the model group's gathered "
                  "gradients with --masks --frozen_weights vs one process, "
                  "given its supervision and mask matching",
                  {"loss": r0["replay_loss"]}, {"loss": runs["one"][0]},
                  len(views), held, noisy)
    head = [n for n in r0["start"] if n.startswith(SEGM_PREFIXES)]
    for r, m in enumerate(mk):
        want = {"pallas_cc": 1, "pallas_auction": 2,
                "pallas_mha.train_launches": m["per"]["pallas_mha"],
                "pallas_mha.bwd_launches": m["per"]["pallas_mha"]}
        want.update({k: 0 for k in m["counts"] if k not in want})
        bad += [f"(g) rank {r} {k}: {m['counts'][k]} launches, expected {n}"
                for k, n in want.items() if m["counts"][k] != n]
        frozen_moved = [n for n in m["start"] if n not in head
                        and m["after"][n] != m["start"][n]]
        still = [n for n in head if n.endswith(".weight")
                 and m["after"][n] == m["start"][n]]
        if frozen_moved or still or sorted(m["kept"]) != sorted(head) \
                or m["bad_steps"] or not all(
                    math.isfinite(m["metrics"][k])
                    for k in ("loss", "loss_mask", "loss_dice")):
            bad.append(f"(g) rank {r}: frozen parameters moved "
                       f"{frozen_moved[:4]}, head weights unmoved {still}, "
                       f"kept at init {m['kept'][:4]}, bad_steps "
                       f"{m['bad_steps']}, metrics {m['metrics']}")
    differ = [n for n in r0["replicated"]
              if any(m["after"][n] != r0["after"][n] for m in mk)]
    if differ or not any(n.startswith("mask_head.")
                         for n in r0["replicated"]):
        bad.append(f"(g) replicated parameters differ between the ranks: "
                   f"{differ[:6]}")
    print(f"[tensor-parallel] {line}: (g) --masks --frozen_weights in the "
          f"model group at B={batch} (one process's peak "
          f"{runs['one'][4]:.2f} GiB, the card {card_gib:.1f} GiB): replayed "
          f"loss {r0['replay_loss']:.6f} vs one process "
          f"{runs['one'][0]:.6f}; a step's launches "
          f"{ {k: v for k, v in r0['counts'].items() if v} }; loss_mask "
          f"{r0['metrics']['loss_mask']:.4f} loss_dice "
          f"{r0['metrics']['loss_dice']:.4f}; the {len(r0['replicated'])} "
          f"replicated parameters (the mask head's among them) bit for bit "
          f"equal on both ranks {not differ}; {len(r0['start']) - len(head)}"
          f" frozen parameters unmoved, {len(head)} head parameters; "
          f"model-group collectives {[m['collectives'][0] for m in mk]} "
          f"({r0['collectives'][1] / 2 ** 20:.1f} MiB); step "
          f"{[round(m['step_ms'], 1) for m in mk]} ms host clock; peak "
          f"{[round(m['peak_gib'], 2) for m in mk]} GiB a rank", flush=True)
    return bad


# phase 14: the fused-off step's memory rise with --remat (its peak less
# what was allocated before it: earlier phases leave their own) must stay
# below this share of the rise without (the plain blocks' saved
# activations dominate it)
REMAT_PEAK_SHARE = 0.5
REMAT_GRAD_TOL = 1e-3   # of each gradient's largest magnitude


def _checkpointed(model):
    """{kernel: launches per forward} of the patch and det-branch blocks
    that run under checkpoint (`remat`): each launches its training
    forward once more, in the backward's recompute."""
    from spe_tpu_torch.models.cait import LayerScaleBlock
    from spe_tpu_torch.ops.talking_heads import block_attention

    per = {"pallas_block": 0, "pallas_attention": 0}
    for m in model.modules():
        if isinstance(m, LayerScaleBlock) and m.remat:
            if m.use_fused:
                per["pallas_block"] += 1
            elif m.attention is block_attention:
                per["pallas_attention"] += 1
    return per


def _busy(fn):
    """fn() under torch.profiler with device activity only (no host op
    events: a few seconds less a step than profile_forward) -> {busy_ms:
    the device's kernel time, idle: its idle share of the wall time}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if getattr(e, "device_type", None)
               == torch.autograd.DeviceType.CUDA)
    return {"busy_ms": busy / 1e3, "idle": max(0.0, 1 - busy / wall_us)}


def phase_remat(results, flag_sets, batch=8):
    """Phase 14: `--remat` at full width (voc0712 preset, 512^2, B=8, the
    preset's dropout rates) in each of flag_sets ((label, cfg): the stock
    preset, the standalone attention, the fused flags off): one training
    step with --remat and one without, from the same weights, batch and
    generator seed. The metrics (losses, grad norm) equal bit for bit,
    every gradient within REMAT_GRAD_TOL of its tensor's largest
    magnitude (the largest difference printed), the launch counts read off
    the model (_per_forward; the checkpointed blocks' training forwards
    twice, _checkpointed), the peak device memory both ways and its rise
    above what was allocated before the step; the fused-off rise with
    --remat below REMAT_PEAK_SHARE of the one without; a later step's
    device busy time both ways (torch.profiler). The
    --remat launch counts of 1f, 1b and B5 go into their JSON entries."""
    import torch

    from spe_tpu_torch.data import train_data, write_mini_voc
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.train import train_step as ts
    from spe_tpu_torch.train.engine import train_batch
    from spe_tpu_torch.train.optim import AdamW3

    tmp = tempfile.TemporaryDirectory()
    devkit = str(write_mini_voc(tmp.name, n_test=1, n_trainval=batch,
                                seed=14))
    line, b, bad, peaks = card(), None, [], {}
    for label, cfg in flag_sets:
        t0 = time.perf_counter()
        cfg = cfg.replace(test_path=devkit, batch_size=batch)
        if b is None:
            _, loader = train_data(cfg)
            b = train_batch(next(iter(loader.epoch(0))), torch.device("cuda"))
        models = {False: build_model(cfg).train(),
                  True: build_model(cfg.replace(remat=True)).train()}
        models[True].load_state_dict(models[False].state_dict())
        per, twice = _per_forward(models[True]), _checkpointed(models[True])
        runs = {}
        for remat, model in models.items():
            state = ts.TrainState(model, AdamW3(model.named_parameters(),
                                                cfg, 1))
            gates = ts.Gates.for_epoch(cfg, 0)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _all_counts(reset=True)
            t1 = time.perf_counter()
            m = ts.train_step(state, b, cfg, gates,
                              torch.Generator("cuda").manual_seed(7))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            runs[remat] = dict(
                metrics={k: v.clone() for k, v in m.items()
                         if isinstance(v, torch.Tensor)},
                grads={n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None},
                counts=_all_counts(), ms=ms,
                peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                step=(torch.cuda.max_memory_allocated() - base) / 2 ** 30)
            # the device time of a later step (the weights have moved)
            pgen = torch.Generator("cuda").manual_seed(8)
            runs[remat].update(_busy(
                lambda: ts.train_step(state, b, cfg, gates, pgen)))
            del state
        off, on = runs[False], runs[True]
        peaks[label] = {"peak": (off["peak"], on["peak"]),
                        "step": (off["step"], on["step"])}
        unequal = [k for k in off["metrics"]
                   if not torch.equal(off["metrics"][k], on["metrics"][k])]
        worst, worst_rel = "", -1.0
        if off["grads"].keys() != on["grads"].keys():
            bad.append(f"{label}: the gradients' names differ")
        for n, g in off["grads"].items():
            if n not in on["grads"]:
                continue
            top = float(g.abs().max())
            rel = float((on["grads"][n] - g).abs().max()) / max(top, 1e-30)
            if rel > worst_rel:
                worst, worst_rel = n, rel
        counted = ("train_launches", "bwd_launches")
        want = {remat: {f"{k}.{a}": n + (twice.get(k, 0) if remat and
                                         a == "train_launches" else 0)
                        for k, n in per.items() for a in counted}
                for remat in runs}
        wrong = {(remat, k): (runs[remat]["counts"][k], n)
                 for remat, w in want.items() for k, n in w.items()
                 if runs[remat]["counts"][k] != n}
        launched = [{k: v for k, v in runs[remat]["counts"].items()
                     if v and k.endswith(counted)} for remat in (False, True)]
        slower = on["busy_ms"] / max(off["busy_ms"], 1e-9) - 1
        print(f"[remat] {label}: batch {batch}, dropout "
              f"{cfg.backbone_drop_rate}/{cfg.drop_attn_rate}/"
              f"{cfg.drop_path_rate}/{cfg.dropout}: loss "
              f"{float(off['metrics']['loss']):.9f} without, "
              f"{float(on['metrics']['loss']):.9f} with --remat; metrics "
              f"equal bit for bit: {not unequal} "
              f"{unequal if unequal else ''}; gradients: "
              f"{len(off['grads'])}, largest difference / max|g| "
              f"{worst_rel:.3e} ({worst or 'none'}; limit {REMAT_GRAD_TOL}); "
              f"peak device memory {off['peak']:.2f} GiB without, "
              f"{on['peak']:.2f} GiB with --remat ({off['step']:.2f} / "
              f"{on['step']:.2f} GiB above what was allocated before the "
              f"step); the first step {off['ms']:.1f} / {on['ms']:.1f} ms "
              f"(host clock); a later step's device busy time "
              f"{off['busy_ms']:.1f} / {on['busy_ms']:.1f} ms "
              f"({100 * slower:+.1f}%), idle share {off['idle']:.3f} / "
              f"{on['idle']:.3f} (profiled); {line}", flush=True)
        print(f"[remat] {label}: training launches a step without / with "
              f"--remat {launched[0]} / {launched[1]}; mismatches (got, "
              f"expected) {wrong}", flush=True)
        if unequal:
            bad.append(f"{label}: metrics differ: {unequal}")
        if worst_rel > REMAT_GRAD_TOL:
            bad.append(f"{label}: gradient {worst} off by {worst_rel:.3e} "
                       "of its largest magnitude")
        if wrong:
            bad.append(f"{label}: launches (got, expected) {wrong}")
        kernel = {"stock preset": "pallas_block",
                  "standalone attention": "pallas_attention"}.get(label)
        if kernel is not None:
            results[kernel]["remat_train_launches"] = on["counts"][
                f"{kernel}.train_launches"]
            results[f"{kernel}_bwd"]["remat_launches"] = on["counts"][
                f"{kernel}.bwd_launches"]
        del models, runs, off, on
        torch.cuda.empty_cache()
        print(f"[remat] {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    off_peak, on_peak = peaks["fused flags off"]["step"]
    print(f"[remat] GiB without / with --remat (peak; the step's rise above "
          f"what was allocated before it): {json.dumps(peaks)}; fused off: "
          f"the step's rise {on_peak / off_peak:.3f} of the one without "
          f"(limit {REMAT_PEAK_SHARE}); {line}", flush=True)
    if on_peak >= REMAT_PEAK_SHARE * off_peak:
        bad.append(f"fused off: the --remat step's rise {on_peak:.2f} GiB "
                   f"not below {REMAT_PEAK_SHARE} x {off_peak:.2f} GiB")
    tmp.cleanup()
    if bad:
        fail("remat: " + "; ".join(bad))


T_START = time.perf_counter()


def timed(name, fn, *args, **kw):
    """fn(*args, **kw), its seconds printed on a line of their own."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    now = time.perf_counter()
    print(f"[seconds] {name}: {now - t0:.1f} s ({now - T_START:.1f} s since "
          f"the start)", flush=True)
    return out


def main():
    import torch

    timed("1 device", phase_device)
    timed("2 build", phase_build)
    timed("2 native", phase_native)
    results, recorded = timed("3 kernels", phase_kernels)
    timed("3 masks", phase_masks)
    timed("3 train kernels", phase_train_kernels, results)
    timed("3 supervision kernels", phase_supervision_kernels, results)
    timed("4 slice", phase_slice, results)
    cfg, _ = timed("5 train", phase_train, results, "off")
    timed("5 same step", phase_same_step, cfg)
    fused_cfg, _ = timed("6 fused", phase_train, results, "backbone")
    timed("6 same grads", phase_same_grads, fused_cfg, "fused backbone")
    stock_cfg, _ = timed("7 stock", phase_train, results, "stock")
    timed("7 same grads", phase_same_grads, stock_cfg, "stock preset", NOISY)
    attn_cfg, _ = timed("8 attention", phase_train, results, "attention")
    timed("8 same grads", phase_same_grads, attn_cfg, "standalone attention",
          NOISY)
    timed("9 coco", phase_coco, results)
    timed("10 backbones", phase_backbones, results, recorded)
    timed("11 distributed", phase_distributed)
    timed("12 segmentation", phase_segmentation)
    timed("13 tensor parallel", phase_tensor_parallel, results)
    timed("14 remat", phase_remat, results,
          [("stock preset", stock_cfg), ("standalone attention", attn_cfg),
           ("fused flags off", cfg)])
    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax", "spe_tpu"))
    if jax_mods:
        fail(f"JAX or the JAX package was imported: {jax_mods[:5]}")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        # one process of phase 11: RANK WORLD BACKEND PORT DIR
        dist_worker(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    elif sys.argv[1:2] == ["--tp-worker"]:
        # one process of phase 13: RANK PORT DIR
        tp_worker(int(sys.argv[2]), *sys.argv[3:5])
    elif sys.argv[1:2] == ["--nccl"]:
        # phase 11 over NCCL, a process on each card of the machine
        import torch

        phase_device()
        phase_build()
        phase_native()
        phase_distributed(torch.cuda.device_count(), "nccl")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
    elif sys.argv[1:2] == ["--against"]:
        # python3 chip_smoke.py --against <root of another checkout>
        phase_device()
        phase_build()
        phase_against(sys.argv[2])
    else:
        main()
