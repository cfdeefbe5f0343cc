"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA device
    python3 chip_smoke.py --against DIR   # the toolkit classes and CC on
                                     # DIR's kernels and on these, in turns
                                     # (the other wrappers', th_bwd_rows'
                                     # and CC's outputs compared bit for
                                     # bit)

Phases, each printing its own lines; any failure exits non-zero:
  1. device  — the card's name and power limit (nvidia-smi); no card fails.
  2. build   — nvcc builds spe_tpu_torch/csrc/*.cu into build/spe_tpu_torch/
               (one nvcc per source, all at once); cuobjdump counts the
               tensor-core instructions (HMMA/HGMMA) in every
               instantiation of attn_kernel, gemm_kernel and linear_kernel,
               with their registers and local memory, and fails on none;
               it prints the registers and local memory of every
               instantiation of th_bwd_rows_kernel, th_fwd_rows_kernel,
               attn_bwd_rows_kernel, colsum_kernel, th_fold_kernel,
               colsum_f32_kernel, ln_bwd_kernel, branch_bwd_kernel,
               th_dq_kernel, layernorm_kernel, th_mix_kernel and cc_kernel
               and fails if an H=4 one of the first two or any of the
               others uses local memory.
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
               plus an overfull shape), which must equal their plain
               versions exactly; CUDA-event times (CC's also in a CUDA
               graph, per sweep of the slowest mask), and each kernel's
               bound (least time on the card).
               Then the toolkit's kernels, gemm_kernel, attn_kernel,
               linear_kernel, th_bwd_rows_kernel, th_fwd_rows_kernel and
               attn_bwd_rows_kernel, at every shape class one stock
               training step, one standalone-attention training step and
               one stock eval forward give them (B=8; a recorder around
               their kernels.* wrappers): each class replayed on fresh
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
               attention step; the CC masks of each recorded run replayed
               against the plain version (labels and sweep counts,
               exactly) and timed; mask_kernel's byte bound beside each
               mask check.
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
Each profile also sums the device time of the product kernels by family
(attn_kernel<192, 192, ...> apart) and of every __global__ function in
spe_tpu_torch/csrc. About 5 minutes of command time on an
H100.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.

Imports only the port, spe_tpu_torch; the run fails if jax, jaxlib, flax
or the JAX package (spe_tpu) was loaded by its end.
"""

from __future__ import annotations

import contextlib
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
    tensor_core_check(kernels)


# the product kernels that must run on the tensor cores
TENSOR_CORE_KERNELS = ("attn_kernel", "gemm_kernel", "linear_kernel")
# the row kernels whose per-row arrays must stay in registers: by the
# template arguments of an instantiation, must it use no local memory?
ROW_KERNELS = {"th_bwd_rows_kernel": lambda a: a[0] == "4",
               "th_fwd_rows_kernel": lambda a: a[0] == "4",
               "attn_bwd_rows_kernel": lambda a: True,
               "colsum_kernel": lambda a: True,
               "th_fold_kernel": lambda a: True,
               "colsum_f32_kernel": lambda a: True,
               "ln_bwd_kernel": lambda a: True,
               "branch_bwd_kernel": lambda a: True,
               "th_dq_kernel": lambda a: True,
               "layernorm_kernel": lambda a: True,
               "th_mix_kernel": lambda a: True,
               "cc_kernel": lambda a: True}


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
    ok &= attention_kernels(results)
    if not ok:
        fail("a kernel disagrees with its plain version")
    phase_toolkit(results)
    return results


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
    every CC launch in classes[("cc_kernel", masks' shape)], keeping a copy
    of each run's first masks under "masks"."""
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import tensor_meta

    gemm, attention, ln_linear, th_bwd_rows, th_fwd_rows, attn_rows, cc = (
        K.gemm, K.attention, K.ln_linear, K.th_bwd_rows, K.th_fwd_rows,
        K.attention_bwd_rows, K.connected_components)

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

    def rec_cc(masks, max_sweeps):
        entry = classes.setdefault(("cc_kernel", tuple(masks.shape)),
                                   {"launches": {}, "masks": {}})
        entry["launches"][run] = entry["launches"].get(run, 0) + 1
        entry["masks"].setdefault(run, masks.clone())
        return cc(masks, max_sweeps)

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
    orig["connected_components"], recs["connected_components"] = cc, rec_cc
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


RECORDED_RUNS = ("stock step", "attention step", "eval forward")


def record_classes(batch=8, extra=()):
    """One training step of the stock preset and of the standalone-attention
    configuration, and one stock eval forward (flip: 2 x batch images),
    through the kernels at B=batch, with every call of a WRAPPER or SMALL
    wrapper recorded by class -> {(kernel or wrapper, class): {"launches":
    {run: n}, "call", and for a SMALL one "bytes"}}."""
    import torch

    from spe_tpu_torch.cli.main import parse_config
    from spe_tpu_torch.data import eval_data, train_data, write_mini_voc
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.train import train_step as ts
    from spe_tpu_torch.train.engine import infer_voc, train_batch
    from spe_tpu_torch.train.optim import AdamW3

    tmp = tempfile.TemporaryDirectory()
    devkit = write_mini_voc(tmp.name, n_test=batch, n_trainval=batch, seed=3)
    classes = {}
    for run, argv in (("stock step", STOCK_TRAIN_ARGV),
                      ("attention step", ATTN_TRAIN_ARGV)):
        cfg = parse_config(argv + ["--test_path", str(devkit),
                                   "--output_dir", f"{tmp.name}/o", *extra])
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


def small_kernels(classes, results):
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
    are timed too, and their stock-step sums go into `results`. Fails on
    a mismatch."""
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
        ms = graph_ms(lambda: fn(*args, **kw))
        plain_ms = None
        if name in SMALL_ENTRIES:
            timer = cuda_ms if name in PLAIN_HOST else graph_ms
            plain_ms = timer(lambda: plain(*args, **kw))
        cold = cold_ms(lambda: fn(*args, **kw)) if name in COLD else None
        lib = _small_library(name, args, kw)
        lib_ms = graph_ms(lib) if lib is not None else None
        lib_cold = cold_ms(lib) if lib is not None and name in COLD else None
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
    for run in RECORDED_RUNS:
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
    and under "per_run". Then the SMALL wrappers' classes (small_kernels)."""
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
        if kernel in SMALL or kernel == "cc_kernel":
            continue
        case = _replay(kernel, rec["call"], gen)
        errs, same, finite, fn, plain, bound, lib, extra_note = \
            _toolkit_case(K, kc, kernel, case)
        passed = finite and same and all(e <= t for e, t in errs.values())
        host_ms = cuda_ms(fn)
        ms = graph_ms(fn)
        # the plain versions make their dropout keys on the host: timed
        # from the host
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        lib_ms = graph_ms(lib) if lib is not None else None
        if ms is None:
            fail(f"{kernel} {cls}: not captured in a CUDA graph")
        if lib_ms and kernel in ratios:
            ratios[kernel].append(ms / lib_ms)
        ok &= passed
        e = entries[kernel]
        e["max_abs_err"] = max(e["max_abs_err"], *(v[0] for v in errs.values()))
        e["classes"].append({
            "class": repr(cls), "launches": rec["launches"], "ms": ms,
            "host_ms": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": lib_ms, "max_abs_err": {n: v[0] for n, v in
                                                  errs.items()}})
        lib_note = (f"library {lib_ms:.4f} ms (kernel / library "
                    f"{ms / lib_ms:.2f})" if lib_ms is not None else
                    "no single PyTorch call computes it")
        print(f"[toolkit] {kernel} {cls}: launches {rec['launches']}; "
              f"max_abs_err/tol "
              f"{ {n: f'{v[0]:.3e}/{v[1]:.3e}' for n, v in errs.items()} } "
              f"identical {same} finite {finite} -> "
              f"{'ok' if passed else 'MISMATCH'}; on the device (CUDA graph): "
              f"kernel {ms:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]}), "
              f"{lib_note}; one call from the host: kernel {host_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms{extra_note}", flush=True)
        del case, fn, plain, lib
        torch.cuda.empty_cache()
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
    recorded_cc(classes, results)


def recorded_cc(classes, results):
    """The CC masks each recorded run gave the kernel (record_toolkit):
    labels and sweep counts against the plain version, exactly; the
    kernel's device time (CUDA graph) and its bound; under the "recorded"
    key of the pallas_cc entry. Fails on a mismatch."""
    from spe_tpu_torch.ops import connected_components as cc
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.kernel_checks import cc_bound_ms

    out = {}
    for (kernel, shape), rec in classes.items():
        if kernel != "cc_kernel":
            continue
        for run, masks in rec["masks"].items():
            labels, sweeps = K.connected_components(masks, cc.MAX_SWEEPS)
            want, want_sweeps = cc.connected_components_reference(
                masks, with_sweeps=True)
            same, err = _exact((labels, sweeps), (want, want_sweeps))
            ms = graph_ms(lambda: K.connected_components(masks, cc.MAX_SWEEPS))
            bound, bound_by = cc_bound_ms(masks, want_sweeps)
            print(f"[toolkit] cc_kernel {shape} of one {run}: launches "
                  f"{rec['launches']}; sweeps {sorted(set(sweeps.tolist()))};"
                  f" labels and sweeps equal {same} (max_abs_err {err}); on "
                  f"the device (CUDA graph): kernel {_ms(ms)}, bound "
                  f"{bound:.5f} ms ({bound_by})", flush=True)
            if not same:
                fail(f"cc_kernel {shape} of one {run}: labels or sweeps "
                     "differ from the plain version")
            out[run] = {"shape": list(shape), "ms": ms, "bound_ms": bound,
                        "max_sweeps": int(sweeps.max())}
    if not out:
        fail("no CC launch recorded")
    results.setdefault("pallas_cc", {})["recorded"] = out


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
        if kernel == "cc_kernel":
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
    against_cc(other, classes, sums)
    for (kernel, run), (o, t) in sorted(sums.items()):
        print(f"[against] {kernel}: one {run}, launches x time (mean of the "
              f"two turns): other {o:.3f} ms, this {t:.3f} ms", flush=True)


def against_cc(other, classes, sums):
    """CC on cc_masks() (two mazes at the sweep cap) and on each recorded
    run's masks, on the other checkout's kernel and on this one in turns
    (CUDA graph), the labels and sweep counts of the two compared; the
    recorded runs' launches x time added to sums."""
    import torch

    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.ops.connected_components import MAX_SWEEPS
    from spe_tpu_torch.ops.kernel_checks import cc_masks

    cases = [("cc_masks()", cc_masks().cuda(), None, 0)]
    for (kernel, _), rec in classes.items():
        if kernel == "cc_kernel":
            cases += [(f"one {run}'s", m, run, rec["launches"][run])
                      for run, m in rec["masks"].items()]
    for label, masks, run, n in cases:
        mine, theirs = (m.connected_components(masks, MAX_SWEEPS)
                        for m in (K, other))
        same = all(torch.equal(a, b) for a, b in zip(mine, theirs))
        times = {}
        for mod in (other, K, K, other):
            times.setdefault(mod is K, []).append(graph_ms(
                lambda m=mod: m.connected_components(masks, MAX_SWEEPS)))
        print(f"[against] cc_kernel {label} {tuple(masks.shape)} masks "
              f"(sweeps up to {int(mine[1].max())}): on the device (CUDA "
              f"graph), other then this then this then other: "
              f"{times[False][0]:.4f} {times[True][0]:.4f} "
              f"{times[True][1]:.4f} {times[False][1]:.4f} ms; labels and "
              f"sweeps equal to DIR's: {same}", flush=True)
        if run is not None:
            tot = sums.setdefault(("cc_kernel", run), [0.0, 0.0])
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
# the fused flags off with the preset's use_pallas_attention: every
# attention but the decoder self-attention through the standalone kernels
ATTN_TRAIN_ARGV = STOCK_TRAIN_ARGV + ["--no_use_fused_block",
                                      "--no_use_fused_layers"]


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


def phase_train(kernel_results, mode, n_train=24, n_test=8, batch=8):
    """The CLI trains the recipe at full width for 3 steps and evaluates:
    with the fused flags off (mode "off"), with the fused backbone
    ("backbone": 48 patch blocks and 2 class-attention blocks through their
    training kernels), as the stock preset ("stock": every fused layer
    through its training kernels) or with the fused flags off and
    use_pallas_attention on ("attention": the 48 patch blocks' attention
    through the talking-heads kernels, the class attention, the encoder
    and the decoder cross-attention through fused_mha)."""
    import torch

    from spe_tpu_torch.cli.main import main as cli_main
    from spe_tpu_torch.cli.main import parse_config
    from spe_tpu_torch.data import write_mini_voc
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.ops import kernels as K
    from spe_tpu_torch.train.checkpoint import restore_checkpoint
    from spe_tpu_torch.train.optim import AdamW3
    from spe_tpu_torch.train.train_step import TrainState

    tag, argv = {"off": ("train", TRAIN_ARGV),
                 "backbone": ("train-fused", FUSED_TRAIN_ARGV),
                 "stock": ("train-stock", STOCK_TRAIN_ARGV),
                 "attention": ("train-attention", ATTN_TRAIN_ARGV)}[mode]
    # the kernels each mode's model runs (each a number of times per
    # forward that _per_forward reads off the built model)
    runs = {"off": (), "backbone": ("pallas_block", "pallas_ca_block"),
            "stock": tuple(_counters()),
            "attention": tuple(_attention_counters())}[mode]
    tmp = tempfile.TemporaryDirectory()
    devkit = write_mini_voc(tmp.name, n_test=n_test, n_trainval=n_train)
    out = f"{tmp.name}/out"
    argv = argv + ["--test_path", str(devkit), "--output_dir", out]
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
    both sides (the backbone's nonzero). Where `cfg` runs the standalone
    attention kernels, one more run takes their plain versions in their
    place (_plain_attention); the kernels are held to it, and it to the
    plain model, by the same rule: whether a miss comes from the kernels
    or from their math. Then the fused configuration's step split."""
    import torch

    from spe_tpu_torch.data import train_data, write_mini_voc
    from spe_tpu_torch.models.build import build_model
    from spe_tpu_torch.ops.kernel_checks import grad_views
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
    attention = any(_per_forward(build_model(cfg))[k]
                    for k in _attention_counters())
    if attention:
        order.append(("kernel math", cfg))
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
        if run == "fused":
            fused_model = model
        else:
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
        if any(cm.values()):
            bad.append(f"the kernel-math run launched kernels: {cm}")
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


# kernels summed over their instantiations in each profile
PROFILE_FAMILIES = ("attn_kernel<192, 192", "attn_kernel", "gemm_kernel",
                    "th_bwd_rows_kernel", "th_fwd_rows_kernel",
                    "attn_bwd_rows_kernel", "linear_kernel")


def csrc_kernels():
    """The names of the __global__ functions in spe_tpu_torch/csrc/*.cu."""
    from spe_tpu_torch.ops import kernels

    names = []
    for src in sorted(kernels.CSRC.glob("*.cu")):
        # past the attributes: __launch_bounds__(...), __cluster_dims__(...)
        names += re.findall(r"__global__\s+void\s+(?:__\w+__\("
                            r"(?:[^()]|\([^()]*\))*\)\s*)*(\w+)\s*\(",
                            src.read_text())
    return names


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
    attn_cfg = phase_train(results, "attention")
    phase_same_grads(attn_cfg, "standalone attention", NOISY)
    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax", "spe_tpu"))
    if jax_mods:
        fail(f"JAX or the JAX package was imported: {jax_mods[:5]}")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--against"]:
        # python3 chip_smoke.py --against <root of another checkout>
        phase_device()
        phase_build()
        phase_against(sys.argv[2])
    else:
        main()
