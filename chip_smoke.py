"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --phases build,kernel,grad,train   # the training slice
    python3 chip_smoke.py --phases dsn,dataset,pipeline      # stages 1 and 2, and all three
    python3 chip_smoke.py --phases bank                      # the banked fast path

Phases, each of which exits non-zero on failure (nothing falls back to the
CPU or to a plain version):

1. build  - nvcc builds dasr_tpu_torch/csrc into build/dasr_tpu_torch/.
2. kernel - the shared-memory plan compiled into the bf16 kernel vs
            ops/rdb.py:WgmmaPlan, which the CPU tests emulate; fused_rdb on
            the card vs its plain PyTorch version on the same tensors (nc
            64, gc 32; f32 and bf16; the test shapes and every shape the
            serve and train phases give the kernel, which take both of the
            bf16 kernel's tiles; 5-px border band), and the bf16 kernel
            also vs the f32 computation on the same bf16-rounded inputs.
            At TIMED_SHAPES the bf16 kernel's time per RDB and per level,
            TFLOP/s, bound and share of it, timed in turns with cuDNN's
            bf16 dense chain.
3. serve  - the port's srn_test CLI on a synthetic LRHR set with a
            full-width x4 RRDB_net (nf 64, nb 23, gc 32, seeded weights
            written to a reference-named .pth), plain, chopped, and plain
            with --device_metrics (against the host report: 1e-3 dB, 1e-4
            SSIM); the
            kernel's launch count over those runs, and a check that every
            shape they gave it was checked in phase 2; the full network with
            the kernel vs the plain version at f32; ms/image, output Mpix/s,
            the RDB kernels' device time inside the forward and the
            device's idle share (torch.profiler), and peak memory; for
            information, the same forward replayed from a CUDA graph, in
            turns with the eager one. It needs phase 2, which it then runs
            too.
4. grad   - fused_rdb's autograd Function on the card (kernel forward, VJP
            of the stock dense chain) vs autograd through the plain version
            on the same tensors: the output, dL/dx and the ten parameter
            gradients, f32 and bf16, at the three test shapes and every
            shape the train phase gives the kernel; fwd+bwd times.
5. train  - the port's srn_train CLI on a synthetic DASR corpus written from
            the seed, at the full width of
            dasr_tpu/configs/train_DASR_auto_reproduce.json (nf 64, nb 23,
            batch 6 + 6, HR 128, bf16), TRAIN_STEPS steps with one
            validation (LPIPS on) and one save: every loss finite, 345 kernel
            launches per generator forward, every shape it gave the kernel
            checked in phases 2 and 4; three f32 steps at nb 2 with the
            kernel vs with the plain version on the card (losses, updates,
            Adam's first moments); train ms/step (CUDA events, median) and
            the host's time to issue a step, images/s, peak memory, and,
            in turns with it for information, the same step on the stock
            bf16 chain; the host's time per step inside the kernel's launch
            wrapper; the device's busy time per step (torch.profiler),
            the RDB kernels' share and the idle share.
            It needs phases 2 and 4, which it then runs too.
6. dsn    - the port's dsn_train CLI (stage 1) at the aim2019 launcher set
            (DeResnet nf 64 nb 8 x4, FSD on the avg-pool high-pass, w_tex
            0.006, batch 8, crop 256, bf16) with --transfer_uint8
            --device_bicubic on a seeded synthetic corpus, DSN_STEPS steps,
            one validation and one save: every logged loss finite; three f32
            steps at nb 2 on the card vs the same steps of the port on the
            CPU (losses, updates, Adam's first moments); DSN ms/step (CUDA
            events, median), the host's time to issue a step, images/s, the
            idle share (torch.profiler) and peak memory.
7. dataset - the port's dsn_create_dataset CLI (stage 2) from phase 6's
            checkpoint over seeded targets of 2040x1356 (the tiled path),
            1020x678 (whole) and 511x383 (ragged), with source DDMs: LR PNG
            and DDM shapes, DDM values in [0, 1], the tiled generator forward
            vs the whole-image one on the 1020x678 image; s/image. It needs
            phase 6, which it then runs too.
8. pipeline - the port's auto_reproduce CLI, all three stages at reduced
            depth (DSN nb 2, crop 128; SRN nf 64 nb 2, batch 6 + 6, HR 128, a
            few iterations) on the JAX package's fast path (device banks,
            K-step windows, uint8 batches, device val metrics): every stage's
            output tree, finite losses, the stage wall-clock lines, both
            training stages on the bank, the RDB kernel's launches and
            shapes (it needs phases 2 and 4, which it then runs too).
9. bank   - the fast path of stages 1 and 3 on the device banks: the fast
            gathers against their plain per-item versions on card draws
            (exact); srn_train --device_bank --steps_per_call 8
            --transfer_uint8 with val_device_metrics and
            val_metrics_pad_bucket 128 at the train phase's full width,
            BANK_STEPS steps, one validation and one save: the kernel's
            launches and shapes, finite losses, the device val metrics
            against the host f64 protocol on the saved PNGs (1e-3 dB, 1e-4
            SSIM); three f32 banked steps at nb 2 against train_step on the
            plain gather's batches of the same draws; dsn_train
            --device_bank --steps_per_call 4 at the dsn phase's launcher
            set; both steps banked and host-loader in turns (ms/step, host
            ms/step, idle share, peak memory), the bank's decode and upload
            time, and the upload rate at 1 GiB. It needs phases 2 and 4.

Every port CLI runs as a user runs it: before each call the TF32 flags are
set on, and the call must turn them off (core/device.py:f32_numerics).
The line before the last is the kernel report as JSON, and the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
NC, GC, NB = 64, 32, 23  # the published DASR generator's widths
# the test shapes: ragged with the 8x8 tile, B > 1, ragged with B > 1 and the
# 16x16 tile, and the kernel-report shape
KERNEL_SHAPES = ((1, 37, 53), (2, 64, 64), (4, 100, 90), (8, 128, 128))
# what the serve phase gives the kernel: the 256x256 and 339x510 images whole,
# and chopped into 160x160 tiles (128 + 2 x 16 halo), 2 x 2 and 3 x 4 of them
SERVE_SHAPES = ((1, 256, 256), (1, 339, 510), (4, 160, 160), (12, 160, 160))
LR_SIZES = ((256, 256),) * 4 + ((339, 510),)  # (h, w) of the synthetic LR set
# what the train phase gives the kernel: the step's 6 fake + 6 real LR crops
# of 32x32 (HR 128), and the 64x64 validation images whole
TRAIN_SHAPES = ((12, 32, 32), (1, 64, 64))
# where the bf16 kernel is timed: the kernel-report shape, a serve image,
# the train step's crops
TIMED_SHAPES = ((8, 128, 128), (1, 256, 256), (12, 32, 32))
TRAIN_STEPS = 30
DSN_STEPS = 30  # 48 source images, batch 8: 6 steps an epoch, 5 epochs
# phase dataset: (h, w) of the targets, DIV2K-sized (tiled), half (whole), ragged
DATASET_SIZES = ((1356, 2040), (678, 1020), (383, 511))
PIPELINE_ITERS = 4
TRAIN_CONFIG = os.path.join("dasr_tpu_torch", "configs", "train_DASR_auto_reproduce.json")
SEED = 0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def run_cli(main, argv):
    """A port CLI's ``main(argv)`` as a user runs it: the TF32 flags are on
    before the call (torch's cuDNN default, and cuBLAS's opt-in) and the CLI
    must turn them off; fails if it did not."""
    import torch

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    out = main(argv)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail(f"{main.__module__} left TF32 on: f32 must mean f32 on the card")
    return out


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rdb_inputs(rng, b, h, w):
    x = rng.random((b, h, w, NC), dtype=np.float32)
    ks = [rng.normal(0, 0.05, (3, 3, NC + k * GC, GC if k < 4 else NC)).astype(np.float32)
          for k in range(5)]
    bs = [rng.normal(0, 0.01, (GC if k < 4 else NC,)).astype(np.float32) for k in range(5)]
    return x, ks, bs


def compare(got, want, atol, rtol, what):
    """(max |got - want|, the same in the 5-px border band, the atol that
    beside rtol would have been enough) of NHWC tensors; fail past
    atol + rtol |want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool(got.isfinite().all()) or bool((err > atol + rtol * want.abs()).any()):
        fail(f"{what}: max |err| {err.max().item():.3e} exceeds atol {atol} rtol {rtol}")
    band = max(
        err[:, :5].max().item(), err[:, -5:].max().item(),
        err[:, :, :5].max().item(), err[:, :, -5:].max().item(),
    )
    needed = max((err - rtol * want.abs()).max().item(), 0.0)
    return err.max().item(), band, needed


def phase_build():
    from dasr_tpu_torch.kernels import build

    t0 = time.perf_counter()
    _, compiled = build.build(verbose=True)
    build.load()
    secs = time.perf_counter() - t0
    how = "nvcc compile and load" if compiled else "load only: the library was already built"
    print(f"build: {secs:.2f} s ({how})", flush=True)
    return secs


def cudnn_bf16_chain(x, kernels, biases):
    """The RDB as stock PyTorch would run it in bf16: F.conv2d (cuDNN) over
    the concatenated prefix, channels_last. Timed for context only."""
    import torch
    import torch.nn.functional as F

    feats = [x.permute(0, 3, 1, 2)]
    for k in range(5):
        w = kernels[k].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        v = F.conv2d(torch.cat(feats, 1), w, biases[k].to(x.dtype), padding=1)
        if k < 4:
            feats.append(F.leaky_relu(v, 0.2))
    return feats[0] + 0.2 * v


def phase_kernel(gpu):
    import torch

    from dasr_tpu_torch.ops.rdb import (
        TILES, TOLERANCES, WgmmaPlan, bound_ms, fused_rdb, fused_rdb_reference, kernel_plan,
        prepare_weights, rdb_cost)

    for cout in (GC, NC):
        for tile in range(len(TILES)):
            if kernel_plan(cout, tile) != WgmmaPlan(cout, tile).vector():
                fail(f"the bf16 kernel's compiled plan (cout {cout}, tile {TILES[tile]}) differs "
                     f"from ops/rdb.py:WgmmaPlan, which the CPU tests emulate")
    print(f"kernel plan: the bf16 kernel's compiled shared-memory plan and descriptor offsets "
          f"equal ops/rdb.py:WgmmaPlan for cout {GC} and {NC}, tiles {TILES}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    report = {"max_abs_err": 0.0, "max_abs_err_f32": 0.0, "max_abs_err_vs_f32": 0.0}
    checked = set()
    with torch.no_grad():
        for b, h, w in KERNEL_SHAPES + SERVE_SHAPES + TRAIN_SHAPES:
            x_np, ks_np, bs_np = rdb_inputs(rng, b, h, w)
            x = torch.from_numpy(x_np).to(dev)
            ks = [torch.from_numpy(k).to(dev) for k in ks_np]
            bs = [torch.from_numpy(v).to(dev) for v in bs_np]
            for dt, tol in ((torch.float32, "kernel_f32"), (torch.bfloat16, "kernel_bf16")):
                xd = x.to(dt)
                kd, bd = prepare_weights(ks, bs, dt)
                got = fused_rdb(xd, kd, bd)
                torch.cuda.synchronize()
                # the plain version on the same tensors (f32 convs, TF32 off),
                # which rounds x1..x4 and the output where the kernel does
                want = fused_rdb_reference(xd, kd, bd)
                atol, rtol = TOLERANCES[tol]
                err, band, needed = compare(got, want, atol, rtol, f"fused_rdb {dt} {(b, h, w)}")
                key = "max_abs_err_f32" if dt == torch.float32 else "max_abs_err"
                report[key] = max(report[key], err)
                checked.add((b, h, w, dt))
                print(f"kernel {str(dt):15s} {(b, h, w)}: max|err| {err:.3e} "
                      f"(5-px band {band:.3e}; atol {atol} rtol {rtol:.4g}, atol needed "
                      f"{needed:.3e})", flush=True)
                if dt == torch.bfloat16:
                    # and against the f32 computation on the same bf16-rounded
                    # inputs, which rounds neither x1..x4 nor the output
                    want32 = fused_rdb_reference(xd.float(), [k.float() for k in kd], bd)
                    atol, rtol = TOLERANCES["bf16_vs_f32"]
                    err32, band32, _ = compare(got, want32, atol, rtol,
                                               f"fused_rdb bf16 vs f32 {(b, h, w)}")
                    report["max_abs_err_vs_f32"] = max(report["max_abs_err_vs_f32"], err32)
                    print(f"kernel bf16 vs f32 plain {(b, h, w)}: max|err| {err32:.3e} "
                          f"(5-px band {band32:.3e}; atol {atol} rtol {rtol})", flush=True)
                if dt == torch.float32 and (b, h, w) == TIMED_SHAPES[0]:
                    ms = cuda_ms(lambda: fused_rdb(xd, kd, bd))
                    plain_ms = cuda_ms(lambda: fused_rdb_reference(xd, kd, bd))
                    flop, nbytes = rdb_cost(b, h, w, itemsize=4)
                    bound, by = bound_ms(flop, nbytes, dt)
                    print(f"time torch.float32 {(b, h, w)}: kernel {ms:.4f} ms "
                          f"({flop / ms / 1e9:.2f} TFLOP/s; bound {bound:.4f} ms by {by}), "
                          f"plain {plain_ms:.4f} ms [{gpu}]", flush=True)
                    report["ms_f32"], report["plain_ms_f32"] = ms, plain_ms
                if dt == torch.bfloat16 and (b, h, w) in TIMED_SHAPES:
                    timed = time_bf16(xd, kd, bd, gpu)
                    if (b, h, w) == TIMED_SHAPES[0]:
                        report.update(timed)
    return report, checked


def time_bf16(x, kd, bd, gpu):
    """The bf16 kernel at x's shape: per RDB (CUDA events, so at small shapes
    the host's launch cost shows) in turns with cuDNN's chain (kernel,
    chain, chain, kernel); per level on the device (torch.profiler), against
    the bound; the plain version once."""
    from dasr_tpu_torch.ops.rdb import (
        bound_ms, fused_rdb, fused_rdb_reference, level_costs, rdb_cost)

    b, h, w, _ = x.shape
    fns = {"kernel": lambda: fused_rdb(x, kd, bd), "chain": lambda: cudnn_bf16_chain(x, kd, bd)}
    times = {name: [] for name in fns}
    for name in ("kernel", "chain", "chain", "kernel"):
        times[name].append(cuda_ms(fns[name]))
    ms, chain_ms = (float(np.mean(times[k])) for k in ("kernel", "chain"))
    host = {name: host_us(fn) for name, fn in fns.items()}
    plain_ms = cuda_ms(lambda: fused_rdb_reference(x, kd, bd))
    flop, nbytes = rdb_cost(b, h, w)
    bound, by = bound_ms(flop, nbytes)
    print(f"time bf16 {(b, h, w)}: kernel {ms:.4f} ms per RDB ({flop / ms / 1e9:.2f} TFLOP/s), "
          f"bound {bound:.4f} ms by {by} ({flop / 1e9:.2f} GFLOP at 989 TFLOP/s vs "
          f"{nbytes / 1e6:.2f} MB at 3.35 TB/s), {100 * bound / ms:.1f}% of the bound; "
          f"in turns: cuDNN bf16 dense chain (yardstick, not the plain version) "
          f"{chain_ms:.4f} ms; plain version {plain_ms:.4f} ms; each of kernel/chain: "
          + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f}" for k, v in times.items()) + f"; host time "
          f"to issue one RDB: kernel {host['kernel']:.1f} us (five launches, one library call), "
          f"chain {host['chain']:.1f} us [{gpu}]", flush=True)
    report = {"ms": ms, "host_us_per_rdb": host["kernel"], "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
              "roofline_share": bound / ms, "library_ms": chain_ms,
              "library": "cuDNN bf16 dense chain (five F.conv2d over the concatenated prefix); "
                         "no single PyTorch call computes an RDB"}
    levels, traces = level_device_ms(lambda: fused_rdb(x, kd, bd))
    if levels is None:
        fail(f"time bf16 {(b, h, w)}: torch.profiler recorded the kernel's launches in none of "
             f"three traces")
    parts = []
    for k, ((lf, lb), lms) in enumerate(zip(level_costs(b, h, w), levels)):
        lbound, lby = bound_ms(lf, lb)
        parts.append(f"level {k + 1} {lms * 1e3:.1f} us ({lf / lms / 1e9:.1f} TFLOP/s; bound "
                     f"{lbound * 1e3:.1f} us by {lby})")
    report["device_ms"] = sum(levels)
    print(f"time bf16 {(b, h, w)} device time per level (torch.profiler, trace {traces} of at "
          f"most 3; each from the end of the launch before): " + "; ".join(parts) + f"; {report['device_ms']:.4f} ms per RDB "
          f"on the device, {100 * bound / report['device_ms']:.1f}% of the bound [{gpu}]",
          flush=True)
    return report


def host_us(fn, iters=50):
    """Host time in us to issue one ``fn`` call, without waiting for the
    device (few enough calls that the launch queue does not fill)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def level_device_ms(fn, calls=5):
    """Median device time in ms of each of the five level launches of one
    ``fn`` call (an RDB), from torch.profiler's kernel events. A level's
    span opens while the level before it still runs (programmatic dependent
    launch), so each level is given the time from the end of the launch
    before it, or from its own start if that is later, to its own end: the
    five sum to the RDB's device time. Returns (those times, the number of
    traces taken), the times None when three traces in a row do not hold
    the 5 * ``calls`` kernels (one trace in one run held none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for traces in range(1, 4):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA and "rdb_level" in e.name)
        if len(spans) == 5 * calls:
            break
    else:
        return None, traces
    own = [[s1 - (s0 if i == 0 else max(s0, spans[i - 1][1]))
            for i, (s0, s1) in enumerate(spans) if i % 5 == k] for k in range(5)]
    return [float(np.median(t)) / 1e3 for t in own], traces


def write_corpus(root, rng):
    """Synthetic LRHR set: LR_SIZES LR images and their 4x HR images."""
    from dasr_tpu_torch.data.io import save_img

    for d in ("lr", "hr"):
        os.makedirs(os.path.join(root, d))
    for i, (h, w) in enumerate(LR_SIZES):
        lr = rng.random((h, w, 3), dtype=np.float32)
        hr = np.clip(np.kron(lr, np.ones((4, 4, 1), np.float32))
                     + rng.normal(0, 0.05, (4 * h, 4 * w, 3)).astype(np.float32), 0, 1)
        save_img(lr, os.path.join(root, "lr", f"img_{i}.png"))
        save_img(hr, os.path.join(root, "hr", f"img_{i}.png"))


def serve_config(root, name, chop, pth):
    cfg = {
        "name": name, "model": "sr", "scale": 4, "chop": chop, "val_lpips": False,
        "datasets": {"test_1": {"name": "synth", "mode": "LRHR",
                                "dataroot_HR": os.path.join(root, "hr"),
                                "dataroot_LR": os.path.join(root, "lr")}},
        "path": {"root": root, "pretrain_model_G": pth},
        "network_G": {"which_model_G": "RRDB_net", "norm_type": None, "mode": "CNA",
                      "nf": NC, "nb": NB, "gc": GC, "in_nc": 3, "out_nc": 3},
    }
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def device_profile(fn, iters=3):
    """torch.profiler's device events over ``iters`` calls of ``fn`` after one
    untraced call, per call: ``busy`` ms (a kernel, copy or memset ran),
    ``span`` ms (first device event to last) and ``idle`` = 1 - busy / span,
    ``rdb`` ms of the RDB kernel, ``events`` (device events), and ``top``, the
    six kernel names with the most device time. The tracer slows the host,
    so where the host bounds a call the traced span is longer than an
    untraced one; busy time is not. None when the profiler records no
    device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    # device events, without the annotations the profiler mirrors onto the
    # device's timeline (Optimizer.step#Adam.step spans its kernels and gaps)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith("Optimizer."))
    if not spans:
        return None
    busy = union_us(spans)
    span = max(s1 for _, s1, _ in spans) - spans[0][0]
    by_name = {}
    for s0, s1, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (s1 - s0) / iters / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    # the RDB kernels' time as the union of their spans: each level is a
    # programmatic dependent launch whose span opens while the level before
    # it still runs, so a sum of spans would count that time twice
    rdb = union_us([sp for sp in spans if "rdb_level" in sp[2]])
    return {"idle": 1 - busy / span, "span": span / iters / 1e3, "busy": busy / iters / 1e3,
            "rdb": rdb / iters / 1e3, "events": len(spans) / iters, "top": top}


def union_us(spans):
    """Length of the union of (start, end, ...) spans sorted by start."""
    if not spans:
        return 0.0
    total, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, s1, *_ in spans[1:]:
        if s0 > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s0, s1
        else:
            cur_e = max(cur_e, s1)
    return total + cur_e - cur_s


def phase_serve(gpu, checked):
    import copy

    import torch
    from torch.nn.modules.module import register_module_forward_pre_hook

    from dasr_tpu_torch.cli import srn_test
    from dasr_tpu_torch.nn.blocks import RDB5C
    from dasr_tpu_torch.nn.generators import RRDBNet
    from dasr_tpu_torch.ops.rdb import (
        LAUNCHES_PER_RDB, TOLERANCES, fused_rdb, fused_rdb_reference)

    rng = np.random.default_rng(SEED)
    report = {}
    with tempfile.TemporaryDirectory() as root:
        write_corpus(root, rng)
        pth = os.path.join(root, "rrdb_x4_G.pth")
        net = RRDBNet(nf=NC, nb=NB, gc=GC).init_weights(torch.Generator().manual_seed(SEED))
        torch.save(net.state_dict(), pth)
        # (name, its config, extra flags, how its metrics are computed)
        runs = [("smoke_plain", serve_config(root, "smoke_plain", False, pth), [], "host"),
                ("smoke_chop", serve_config(root, "smoke_chop", True, pth), [], "host"),
                ("smoke_devmetrics", serve_config(root, "smoke_devmetrics", False, pth),
                 ["--device_metrics"], "device")]

        # the main path: three srn_test runs through the port's CLI, counted,
        # with the (B, H, W, dtype) of every RDB5C input recorded
        seen = set()

        def record(mod, args):
            if isinstance(mod, RDB5C):
                b, _, h, w = args[0].shape
                seen.add((b, h, w, args[0].dtype))

        torch.cuda.reset_peak_memory_stats()
        fused_rdb.launches = 0
        secs, avgs = [], []
        handle = register_module_forward_pre_hook(record)
        try:
            for _, cfg, flags, _ in runs:
                t0 = time.perf_counter()
                avgs.append(run_cli(srn_test.main, ["-opt", cfg, "--device", "cuda", *flags]))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        finally:
            handle.remove()
        launches = fused_rdb.launches
        peak = torch.cuda.max_memory_allocated()

        forwards = len(runs) * len(LR_SIZES)  # one per image and run (chop batches its tiles)
        expected = 3 * NB * LAUNCHES_PER_RDB * forwards
        print(f"serve: fused_rdb launches {launches}, expected {3 * NB} x {LAUNCHES_PER_RDB} x "
              f"{forwards} = {expected}", flush=True)
        if launches != expected:
            fail(f"fused_rdb launched {launches} times, expected {expected}")
        print(f"serve: kernel input shapes {sorted((*k[:3], str(k[3])) for k in seen)}",
              flush=True)
        if seen - checked:
            fail(f"the serve runs gave the kernel shapes phase 2 did not check: {seen - checked}")
        for (name, _, _, how), avg, sec in zip(runs, avgs, secs):
            pngs = sorted(os.listdir(os.path.join(root, "results", name, "synth")))
            if len(pngs) != len(LR_SIZES):
                fail(f"{name}: {len(pngs)} PNGs, expected {len(LR_SIZES)}")
            vals = avg.get("synth", {})
            if set(vals) != {"psnr", "ssim", "psnr_y", "ssim_y"} or not all(
                    np.isfinite(v) for v in vals.values()):
                fail(f"{name}: metrics not finite or missing: {vals}")
            print(f"serve {name}: {len(pngs)} PNGs, {vals}, {sec:.2f} s "
                  f"({sec / len(LR_SIZES):.3f} s/image with {how} metrics and PNG IO) [{gpu}]",
                  flush=True)
            report[f"serve_cli_s_per_image_{how}" + ("_chop" if "chop" in name else "")] = (
                sec / len(LR_SIZES))
        # --device_metrics against the host f64 report of the same forward
        host, dev = avgs[0]["synth"], avgs[2]["synth"]
        errs = {k: abs(dev[k] - host[k]) for k in host}
        print("serve --device_metrics vs the host report: " + ", ".join(
            f"{k} |err| {v:.2e}" for k, v in errs.items()) + " (limits 1e-3 dB, 1e-4 SSIM)",
            flush=True)
        if any(not v <= (1e-3 if k.startswith("psnr") else 1e-4) for k, v in errs.items()):
            fail(f"serve: --device_metrics is off the host report: {errs}")
        print(f"serve: peak device memory {peak / 2**30:.3f} GiB [{gpu}]", flush=True)
    report["launches_serve"] = launches

    # the full network with the kernel vs the plain version, f32, 64x64: the
    # plain version runs on the same card (every RDB5C calls
    # fused_rdb_reference in place of the kernel) and, for information, on the CPU
    import dasr_tpu_torch.nn.blocks as blocks

    x = torch.from_numpy(rng.random((1, 3, 64, 64), dtype=np.float32))
    net_gpu = copy.deepcopy(net).to("cuda", memory_format=torch.channels_last)
    with torch.no_grad():
        cpu_plain = net(x)
        before = fused_rdb.launches
        got = net_gpu(x.cuda())
        launched = fused_rdb.launches - before
        blocks.fused_rdb = fused_rdb_reference
        try:
            want = net_gpu(x.cuda())
        finally:
            blocks.fused_rdb = fused_rdb
    if launched != 3 * NB * LAUNCHES_PER_RDB:
        fail("the f32 network did not run through the kernel")
    atol, rtol = TOLERANCES["network_f32"]
    err, _, _ = compare(got.permute(0, 2, 3, 1), want.permute(0, 2, 3, 1), atol, rtol,
                        f"RRDBNet nb {NB} f32 kernel vs plain")
    cpu_err = (got.cpu() - cpu_plain).abs().max().item()
    print(f"network f32 (1, 3, 64, 64) nb {NB}: max|err| {err:.3e} vs the plain version on "
          f"the card (atol {atol}), {cpu_err:.3e} vs it on the CPU; output range "
          f"[{want.min().item():.3f}, {want.max().item():.3f}]", flush=True)
    report["network_max_abs_err_f32"] = err

    # serving rate at 256x256 LR, bf16, batch 1, and the RDBs' share of it
    net_bf16 = RRDBNet(nf=NC, nb=NB, gc=GC, dtype=torch.bfloat16)
    net_bf16.load_state_dict(net.state_dict())
    net_bf16.to("cuda", memory_format=torch.channels_last).eval()
    x = torch.rand((1, 3, 256, 256), device="cuda")
    with torch.no_grad():
        ms = cuda_ms(lambda: net_bf16(x), warmup=2, iters=10)
    x8 = torch.rand((8, 3, 128, 128), device="cuda")
    with torch.no_grad():
        ms8 = cuda_ms(lambda: net_bf16(x8), warmup=2, iters=10)
    print(f"serve rate: batch 8 x 128x128 LR, bf16: {ms8:.3f} ms/batch, "
          f"{8 * 512 * 512 / (ms8 / 1e3) / 1e6:.3f} output Mpix/s [{gpu}]", flush=True)
    mpix = 1024 * 1024 / (ms / 1e3) / 1e6
    print(f"serve rate: 256x256 LR -> 1024x1024, bf16, batch 1: {ms:.3f} ms/image, "
          f"{mpix:.3f} output Mpix/s [{gpu}]", flush=True)
    def forward():
        with torch.no_grad():
            net_bf16(x)

    prof = device_profile(forward)
    if prof is None:
        print("serve 256x256: torch.profiler recorded no device events; idle share not "
              "measured", flush=True)
    else:
        idle, dev_ms, kern_ms = prof["idle"], prof["span"], prof["rdb"]
        print(f"serve 256x256 (torch.profiler): device span {dev_ms:.3f} ms per forward, "
              f"busy {prof['busy']:.3f} ms, idle share {100 * idle:.2f}%, rdb_level kernels "
              f"{kern_ms:.3f} ms ({100 * kern_ms / dev_ms:.1f}% of the span) [{gpu}]", flush=True)
    # for information, not the CLI's path: the same forward replayed from a
    # CUDA graph, which takes the host's per-op cost out, in turns with it
    graph_ms, eager_ms = serve_graph_ms(net_bf16, x)
    print(f"serve rate 256x256, bf16, batch 1, in turns: eager {eager_ms:.3f} ms/image, the "
          f"forward replayed from a CUDA graph (information, not the CLI's path) "
          f"{graph_ms:.3f} ms/image [{gpu}]", flush=True)
    report.update({"serve_ms_per_image": ms, "serve_out_mpix_s": mpix,
                   "serve_graph_ms_per_image": graph_ms, "peak_mem_bytes": peak})
    return report


def serve_graph_ms(net, x):
    """(ms per forward replayed from a CUDA graph, ms per eager forward),
    timed in turns (eager, graph, graph, eager); fails if the replay's
    output differs from the eager forward's."""
    import torch

    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                net(x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = net(x)
        want = net(x)
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            fail("serve: the CUDA graph's forward differs from the eager forward")
        times = {"eager": [], "graph": []}
        for name in ("eager", "graph", "graph", "eager"):
            fn = graph.replay if name == "graph" else (lambda: net(x))
            times[name].append(cuda_ms(fn, warmup=2, iters=10))
    del graph
    return float(np.mean(times["graph"])), float(np.mean(times["eager"]))


GRAD_NAMES = ["x"] + [f"kernel{k + 1}" for k in range(5)] + [f"bias{k + 1}" for k in range(5)]


def phase_grad(gpu):
    """fused_rdb under autograd vs autograd through the plain version."""
    import torch

    from dasr_tpu_torch.ops.rdb import (
        LAUNCHES_PER_RDB, TOLERANCES, fused_rdb, fused_rdb_reference, rdb_chain)

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    report = {"grad_rel_err_f32": 0.0, "grad_rel_err_bf16": 0.0}
    checked = set()
    for b, h, w in KERNEL_SHAPES + TRAIN_SHAPES:
        x_np, ks_np, bs_np = rdb_inputs(rng, b, h, w)
        g_np = rng.normal(0, 1, (b, h, w, NC)).astype(np.float32)
        for dt, tol in ((torch.float32, "grad_f32"), (torch.bfloat16, "grad_bf16")):
            base = ([torch.from_numpy(x_np).to(dev, dt)]
                    + [torch.from_numpy(k).to(dev, dt) for k in ks_np]
                    + [torch.from_numpy(v).to(dev) for v in bs_np])
            g = torch.from_numpy(g_np).to(dev, dt)

            def leaves():
                return [t.clone().requires_grad_() for t in base]

            def fwd_bwd(fn, ls):
                out = fn(ls[0], ls[1:6], ls[6:])
                return out, torch.autograd.grad(out, ls, g)

            # the Function as on the main path (its chain on cuDNN); the plain
            # version's autograd with cuDNN off, whose f32 backward of these
            # convs measured up to 4.7e-3 off the f64 gradient on the H100
            # (TF32 off), the native path 4e-7
            before = fused_rdb.launches
            out, grads = fwd_bwd(fused_rdb, leaves())
            torch.cuda.synchronize()
            if fused_rdb.launches - before != LAUNCHES_PER_RDB:
                fail(f"fused_rdb under autograd did not launch the kernel at {(b, h, w)}")
            with torch.backends.cudnn.flags(enabled=False):
                out_p, grads_p = fwd_bwd(fused_rdb_reference, leaves())
            atol, rtol = TOLERANCES["kernel_f32" if dt == torch.float32 else "kernel_bf16"]
            compare(out.detach(), out_p.detach(), atol, rtol, f"fused_rdb fwd under grad {dt}")
            _, rtol = TOLERANCES[tol]
            worst = (0.0, "")
            for name, a, p in zip(GRAD_NAMES, grads, grads_p):
                a, p = a.float(), p.float()
                rel = ((a - p).norm() / p.norm()).item()
                if not bool(a.isfinite().all()) or not rel <= rtol:
                    fail(f"grad {name} {dt} {(b, h, w)}: |got - want| / |want| {rel:.3e} "
                         f"exceeds {rtol}")
                elem = ((a - p).abs().max() / p.abs().max()).item()
                worst = max(worst, (rel, f"{name}; largest element error {elem:.2e} of max|want|"))
            key = "grad_rel_err_f32" if dt == torch.float32 else "grad_rel_err_bf16"
            report[key] = max(report[key], worst[0])
            checked.add((b, h, w, dt))
            print(f"grad {str(dt):15s} {(b, h, w)}: worst |got - want| / |want| {worst[0]:.3e} "
                  f"({worst[1]}; limit {rtol}); output max|err| vs plain within "
                  f"{tol.replace('grad', 'kernel')}", flush=True)
            if (b, h, w) == TRAIN_SHAPES[0] and dt == torch.bfloat16:
                ls = leaves()
                times = {name: cuda_ms(lambda fn=fn: fwd_bwd(fn, ls))
                         for name, fn in (("kernel", fused_rdb), ("plain", fused_rdb_reference),
                                          ("chain", rdb_chain))}
                report["grad_ms"], report["plain_grad_ms"] = times["kernel"], times["plain"]
                print(f"time fwd+bwd bf16 {(b, h, w)}: kernel + chain VJP {times['kernel']:.4f} ms, "
                      f"plain version {times['plain']:.4f} ms, stock bf16 chain (context) "
                      f"{times['chain']:.4f} ms [{gpu}]", flush=True)
    return report, checked


def launch_host_ms(fn, calls=4):
    """Host ms per ``fn`` call spent inside ops/rdb.py:_launch, and of that
    inside the library's dasr_rdb_forward, timed by wrapping both."""
    import torch

    import dasr_tpu_torch.ops.rdb as rdb
    from dasr_tpu_torch.kernels import build

    lib = build.load()
    launch, forward = rdb._launch, lib.dasr_rdb_forward
    spent = [0.0, 0.0]

    def timed(f, i):
        def call(*args):
            t0 = time.perf_counter()
            out = f(*args)
            spent[i] += time.perf_counter() - t0
            return out
        return call

    rdb._launch, lib.dasr_rdb_forward = timed(launch, 0), timed(forward, 1)
    try:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    finally:
        rdb._launch, lib.dasr_rdb_forward = launch, forward
    return spent[0] / calls * 1e3, spent[1] / calls * 1e3


def write_train_corpus(root, rng):
    """12 HR images at 192x192, 12 fake LRs at 48x48, 12 real LRs at 64x64,
    12 DDMs (1, 1, 48, 48) in [0, 1], and 2 validation pairs (64x64 LR)."""
    from dasr_tpu_torch.data.io import save_img

    dirs = {d: os.path.join(root, d) for d in ("hr", "fake", "real", "ddm", "val_hr", "val_lr")}
    for d in dirs.values():
        os.makedirs(d)
    for i in range(12):
        hr = rng.random((192, 192, 3), dtype=np.float32)
        save_img(hr, os.path.join(dirs["hr"], f"{i:03d}.png"))
        save_img(hr.reshape(48, 4, 48, 4, 3).mean((1, 3)), os.path.join(dirs["fake"], f"{i:03d}.png"))
        save_img(rng.random((64, 64, 3), dtype=np.float32), os.path.join(dirs["real"], f"{i:03d}.png"))
        np.save(os.path.join(dirs["ddm"], f"{i:03d}.npy"),
                rng.random((1, 1, 48, 48), dtype=np.float32))
    for i in range(2):
        lr = rng.random((64, 64, 3), dtype=np.float32)
        save_img(lr, os.path.join(dirs["val_lr"], f"v{i}.png"))
        save_img(np.kron(lr, np.ones((4, 4, 1), np.float32)), os.path.join(dirs["val_hr"], f"v{i}.png"))
    return dirs


def train_config(root, dirs, name, niter, nb=NB, bf16=True, print_freq=1, **extra):
    """The shipped auto-reproduce configuration with the synthetic corpus
    (``extra``: more top-level options)."""
    with open(os.path.join(ROOT, TRAIN_CONFIG)) as f:
        cfg = json.load(f)
    cfg.update(name=name, bf16=bf16, **extra)
    cfg["path"] = {"root": root}
    cfg["datasets"]["train"].update(dataroot_HR=dirs["hr"], dataroot_fake_LR=dirs["fake"],
                                    dataroot_real_LR=dirs["real"],
                                    dataroot_fake_weights=dirs["ddm"], n_workers=6)
    cfg["datasets"]["val"].update(dataroot_HR=dirs["val_hr"], dataroot_LR=dirs["val_lr"])
    cfg["network_G"]["nb"] = nb
    cfg["train"].update(niter=niter, val_freq=niter)
    cfg["logger"] = {"print_freq": print_freq, "save_checkpoint_freq": niter}
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def flat(ns, moment=False):
    """One network's trainable params, or Adam's first moments of them."""
    import torch

    return torch.cat([(ns.opt.state[p]["exp_avg"] if moment else p.detach()).flatten()
                      for p in ns.params()])


def compare_three_steps(what, run, ref, loss_tol, update_tol, moment_tol):
    """Two runs of three f32 train steps from the same params, each (the
    metric dicts of the steps, {network: its params before}, {network: (its
    params after, Adam's first moments)}), against ``ref``. Fails where a
    loss differs past atol + rtol |loss| or the runs start apart. Returns the
    worst loss error as a share of its limit, one line per network, the
    networks whose update or first moments differ past ``update_tol`` /
    ``moment_tol`` of their norm, and the largest parameter difference."""
    import torch

    (traj, init, nets), (traj_r, init_r, nets_r) = run, ref
    atol, rtol = loss_tol
    worst = 0.0
    for i, (a, b) in enumerate(zip(traj, traj_r)):
        for k in b:
            if k.startswith("loss/"):
                err = abs(a[k] - b[k])
                worst = max(worst, err / (atol + rtol * abs(b[k])))
                if err > atol + rtol * abs(b[k]):
                    fail(f"{what} step {i} {k}: {a[k]:.6e} vs {b[k]:.6e}")
    parts, bad, perr = [], [], 0.0
    for name in nets_r:
        if not torch.equal(init[name], init_r[name]):
            fail(f"{what}: the two runs start from different {name} params")
        (p, m), (pr, mr) = nets[name], nets_r[name]
        # p - pr is the difference of the two three-step updates
        upd = ((p - pr).norm() / (pr - init_r[name]).norm()).item()
        mom = ((m - mr).norm() / mr.norm()).item()
        err = (p - pr).abs()
        perr = max(perr, err.max().item())
        parts.append(f"{name} update {upd:.3e}, first moment {mom:.3e}, params max|err| "
                     f"{err.max().item():.3e} ({int((err > 2e-5).sum())} of {err.numel()} past "
                     f"2e-5)")
        if not (upd <= update_tol and mom <= moment_tol):
            bad.append(name)
    return worst, parts, bad, perr


def phase_train(gpu, checked, checked_grad):
    import torch
    from torch.nn.modules.module import register_module_forward_pre_hook

    import dasr_tpu_torch.nn.blocks as blocks
    from dasr_tpu_torch.cli import srn_train
    from dasr_tpu_torch.core.config import parse_srn_options
    from dasr_tpu_torch.data.datasets import create_dataset
    from dasr_tpu_torch.data.pipeline import Loader
    from dasr_tpu_torch.models.registry import create_model
    from dasr_tpu_torch.nn.blocks import RDB5C
    from dasr_tpu_torch.ops.rdb import (
        LAUNCHES_PER_RDB, TOLERANCES, fused_rdb, fused_rdb_reference, rdb_chain)

    rng = np.random.default_rng(SEED)
    report = {}
    with tempfile.TemporaryDirectory() as root:
        dirs = write_train_corpus(root, rng)
        cfg = train_config(root, dirs, "smoke_train", TRAIN_STEPS)

        # the main path: srn_train through the port's CLI, counted, with the
        # (B, H, W, dtype, grad mode) of every RDB5C input recorded
        seen = set()

        def record(mod, args):
            if isinstance(mod, RDB5C):
                b, _, h, w = args[0].shape
                seen.add((b, h, w, args[0].dtype, torch.is_grad_enabled()))

        fused_rdb.launches = 0
        handle = register_module_forward_pre_hook(record)
        try:
            t0 = time.perf_counter()
            steps, _ = run_cli(srn_train.main, ["-opt", cfg, "--device", "cuda"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            handle.remove()
        launches = fused_rdb.launches
        forwards = TRAIN_STEPS + 2  # one G forward per step, one per validation image
        expected = 3 * NB * LAUNCHES_PER_RDB * forwards
        print(f"train: {steps} steps in {secs:.2f} s through the CLI (host loader, one "
              f"validation with LPIPS, one save); fused_rdb launches {launches}, expected "
              f"{3 * NB} x {LAUNCHES_PER_RDB} x {forwards} = {expected}", flush=True)
        if steps != TRAIN_STEPS or launches != expected:
            fail(f"train: {steps} steps and {launches} launches, expected {TRAIN_STEPS} "
                 f"and {expected}")
        print(f"train: kernel input shapes {sorted((*k[:3], str(k[3]), k[4]) for k in seen)}",
              flush=True)
        missing = {k[:4] for k in seen} - checked
        missing |= {k[:4] for k in seen if k[4]} - checked_grad
        if missing:
            fail(f"the train run gave the kernel shapes phases 2 and 4 did not check: {missing}")
        run_dir = os.path.join(root, "smoke_train")
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [r for r in recs if "loss/l_g_total" in r]
        val = [r for r in recs if "val/psnr" in r]
        if len(losses) != TRAIN_STEPS or not all(
                np.isfinite(v) for r in losses for k, v in r.items() if k.startswith("loss/")):
            fail(f"train: losses missing or not finite in metrics.jsonl ({len(losses)} steps)")
        if len(val) != 1 or not all(np.isfinite(val[0][f"val/{k}"])
                                    for k in ("psnr", "ssim", "lpips")):
            fail(f"train: validation missing or not finite: {val}")
        if not os.path.exists(os.path.join(run_dir, "training_state", f"{TRAIN_STEPS}.pt")):
            fail("train: the train state was not saved")
        first, lastr = losses[0], losses[-1]
        print("train losses, step 1 -> %d: %s" % (TRAIN_STEPS, ", ".join(
            f"{k.split('/')[-1]} {first[k]:.4e} -> {lastr[k]:.4e}"
            for k in sorted(first) if k.startswith("loss/"))), flush=True)
        print(f"train validation: {({k: v for k, v in val[0].items() if k.startswith('val/')})}",
              flush=True)
        report["launches_train"] = launches

        # the device step alone: one host batch on the card, CUDA events
        def build(config):
            opt = parse_srn_options(config, is_train=True)
            model = create_model(opt, torch.device("cuda"))
            model.init()
            loader = Loader(create_dataset(opt["datasets"]["train"]), batch_size=6,
                            num_workers=6, seed=0)
            return model, loader

        model, loader = build(cfg)
        host = next(iter(loader))
        batch = {k: torch.from_numpy(host[k]).cuda().permute(0, 3, 1, 2)
                 for k in ("LR_fake", "LR_real", "HR", "HR_unpair", "fake_w")}
        tr = model.trainer

        def step_times(rdb, n):
            # n steps with ``rdb`` in every RDB5C: (CUDA-event ms, host ms to
            # issue the step) of each
            out = []
            blocks.fused_rdb = rdb
            try:
                for _ in range(n):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    t0 = time.perf_counter()
                    tr.train_step(batch)
                    host = (time.perf_counter() - t0) * 1e3
                    end.record()
                    torch.cuda.synchronize()
                    out.append((start.elapsed_time(end), host))
            finally:
                blocks.fused_rdb = fused_rdb
            return out

        # the main path and, for information, the RDBs on the stock bf16
        # chain, in turns: the host bounds the step and its speed drifts
        torch.cuda.reset_peak_memory_stats()
        step_times(fused_rdb, 3)
        peak = torch.cuda.max_memory_allocated()
        step_times(rdb_chain, 3)
        times = {fused_rdb: [], rdb_chain: []}
        for _ in range(3):
            for rdb in times:
                times[rdb] += step_times(rdb, 4)
        (ms, host_ms), (chain_ms, chain_host_ms) = (
            tuple(float(v) for v in np.median(times[rdb], axis=0)) for rdb in times)
        imgs = 12 / (ms / 1e3)
        print(f"train step, nf {NC} nb {NB} gc {GC}, batch 6 + 6, HR 128, bf16: {ms:.3f} ms/step "
              f"(median of 12, CUDA events, in turns with the chain below), {imgs:.2f} effective "
              f"images/s, host {host_ms:.3f} ms to issue a step, peak device memory "
              f"{peak / 2**30:.3f} GiB [{gpu}]", flush=True)
        print(f"train step with the RDBs on the stock bf16 chain (cuDNN; information, not the "
              f"main path): {chain_ms:.3f} ms/step, host {chain_host_ms:.3f} ms to issue a step "
              f"[{gpu}]", flush=True)
        wrapper_ms, library_ms = launch_host_ms(lambda: tr.train_step(batch))
        print(f"train step: the host spends {wrapper_ms:.3f} ms of a step inside fused_rdb's "
              f"launch wrapper (ops/rdb.py:_launch; {3 * NB} RDB forwards, "
              f"{3 * NB * LAUNCHES_PER_RDB} launches), {library_ms:.3f} ms of it in the library "
              f"call (tensor maps and launches) [{gpu}]", flush=True)
        prof = device_profile(lambda: tr.train_step(batch))
        if prof is None:
            print("train step: torch.profiler recorded no device events; idle share not "
                  "measured", flush=True)
        else:
            # the host bounds this step, and the tracer slows the host: the
            # idle share is also read against the untraced step time above
            idle, dev_ms, busy_ms, kern_ms = prof["idle"], prof["span"], prof["busy"], prof["rdb"]
            idle_untraced = max(0.0, 1 - busy_ms / ms)
            print(f"train step (torch.profiler): device busy {busy_ms:.3f} ms per step, of "
                  f"which rdb_level kernels {kern_ms:.3f} ms ({100 * kern_ms / busy_ms:.1f}% "
                  f"of busy, {100 * kern_ms / ms:.1f}% of the untraced {ms:.3f} ms step); "
                  f"idle share {100 * idle_untraced:.2f}% of the untraced step, "
                  f"{100 * idle:.2f}% of the traced span of {dev_ms:.3f} ms; "
                  f"{prof['events']:.0f} device events per step; most device time: "
                  + ", ".join(f"{name[:60]} {t:.3f} ms" for name, t in prof["top"])
                  + f" [{gpu}]", flush=True)
            report.update(train_idle_share=idle_untraced, train_rdb_share=kern_ms / ms,
                          train_device_busy_ms=busy_ms)
        report.update(train_ms_per_step=ms, train_host_ms_per_step=host_ms,
                      train_launch_host_ms_per_step=wrapper_ms,
                      train_images_per_s=imgs, train_peak_mem_bytes=peak,
                      train_chain_ms_per_step=chain_ms)
        del model, tr, batch

        # three f32 steps at nb 2, full width: the kernel vs the plain version
        cfg32 = train_config(root, dirs, "smoke_f32", 3, nb=2, bf16=False)
        batches = None
        runs = []

        for plain in (False, True):
            # cuDNN off in both runs (see phase_grad): they differ only in the
            # RDB forward and its backward
            with torch.backends.cudnn.flags(enabled=False):
                model, loader = build(cfg32)
                while batches is None or len(batches) < 3:  # 2 batches an epoch
                    loader.set_epoch(len(batches or []) // len(loader))
                    batches = (batches or []) + list(loader)[:3 - len(batches or [])]
                st = model.trainer.state
                nets = {"G": st.g, "D_target": st.d_target}
                init = {name: flat(ns).clone() for name, ns in nets.items()}
                before = fused_rdb.launches
                if plain:
                    blocks.fused_rdb = fused_rdb_reference
                try:
                    traj = [model.train_step(b) for b in batches]
                finally:
                    blocks.fused_rdb = fused_rdb
            launched = fused_rdb.launches - before
            if launched != (0 if plain else 3 * 2 * LAUNCHES_PER_RDB * 3):
                fail(f"train f32 ({'plain' if plain else 'kernel'}): {launched} kernel launches")
            runs.append((traj, init, {name: (flat(ns), flat(ns, True))
                                      for name, ns in nets.items()}))
        (traj_k, _, _), _ = runs
        atol, rtol = TOLERANCES["train_loss_f32"]
        _, utol = TOLERANCES["train_update_f32"]
        _, mtol = TOLERANCES["train_moment_f32"]
        worst_loss, parts, bad, perr = compare_three_steps("train f32", *runs, (atol, rtol),
                                                           utol, mtol)
        print(f"train f32 nb 2 (nf {NC}, gc {GC}), 3 steps, kernel vs plain version on the card, "
              f"cuDNN off in both: losses within {worst_loss:.3f} of their limit (atol {atol}, "
              f"rtol {rtol}); |dtheta_kernel - dtheta_plain| / |dtheta_plain| and the same of "
              f"Adam's first moments (limits {utol}, {mtol}): {'; '.join(parts)}; l_g_total "
              f"{[round(t['loss/l_g_total'], 6) for t in traj_k]}", flush=True)
        if bad:
            fail(f"train f32: the kernel run's updates or moments of {bad} are off the plain run's")
        report.update(train_f32_param_max_abs_err=perr)
    return report


def write_images(d, rng, n, hw, prefix):
    """``n`` seeded RGB PNGs of (h, w) = ``hw`` into ``d``."""
    from dasr_tpu_torch.data.io import save_img

    os.makedirs(d, exist_ok=True)
    for i in range(n):
        save_img(rng.random((*hw, 3), dtype=np.float32), os.path.join(d, f"{prefix}{i:03d}.png"))
    return d


def dsn_argv(root, dirs, *extra):
    """dsn_train's argv at the aim2019 launcher set (auto_reproduce.py's
    LAUNCHER_ARGS) on the synthetic corpus, with the launcher's fast path."""
    from dasr_tpu_torch.cli.auto_reproduce import LAUNCHER_ARGS

    return LAUNCHER_ARGS["aim2019"] + [
        "--device", "cuda", "--transfer_uint8", "--device_bicubic", "--seed", str(SEED),
        "--source_dir", dirs["source"], "--target_dir", dirs["target"],
        "--valid_hr_dir", dirs["valid_hr"], "--valid_lr_dir", dirs["valid_lr"],
        "--experiments_root", root, *extra]


# three f32 DSN steps on the card vs on the CPU: losses within atol + rtol
# |loss|; updates and Adam's first moments within these shares of their
# norms. The SRN step's limits (TOLERANCES["train_*"]), kept: on the H100 the losses came
# within 0.08 of theirs, the moments 3.7e-4 (G) and 2.2e-3 (D), the updates
# 1.0e-2 and 7.4e-3. Adam steps an element whose gradient is rounding noise
# by up to lr either way (17 of G's 225096 params, 264 of D's 1029505 past
# 2e-5), which the update's norm holds and an element-wise limit would not;
# D's moments carry the InstanceNorm backward's f32 cancellation.
DSN_F32_LIMITS = {"loss": (2e-5, 2e-3), "update": 5e-2, "moment": 1e-2}


def phase_dsn(gpu, root):
    """Stage 1 through the port's dsn_train CLI, then its device step alone."""
    import torch

    from dasr_tpu_torch.cli import dsn_train

    rng = np.random.default_rng(SEED)
    corpus = os.path.join(root, "dsn_corpus")
    dirs = {"source": write_images(os.path.join(corpus, "source"), rng, 48, (80, 80), "s"),
            "target": write_images(os.path.join(corpus, "target"), rng, 8, (320, 320), "t"),
            "valid_hr": write_images(os.path.join(corpus, "valid_hr"), rng, 4, (256, 256), "v"),
            "valid_lr": write_images(os.path.join(corpus, "valid_lr"), rng, 4, (64, 64), "v")}
    argv = dsn_argv(root, dirs, "--save_path", "dsn", "--num_epochs", "5",
                    "--num_decay_epochs", "2", "--val_interval", "5", "--val_img_interval", "5",
                    "--save_model_interval", "5")
    report = {}
    # the CLI reads the metrics at every LOG_EVERY-th step, one step late, and
    # checks them finite there: three reads in 30 steps
    log_every, dsn_train.LOG_EVERY = dsn_train.LOG_EVERY, 10
    try:
        t0 = time.perf_counter()
        steps = run_cli(dsn_train.main, argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        dsn_train.LOG_EVERY = log_every
    run = os.path.join(root, "dsn")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r for r in recs if "loss/d_tex_loss" in r]
    val = [r for r in recs if "val/psnr_vs_bicubic" in r]
    if steps != DSN_STEPS or [r["step"] for r in losses] != [10, 20, 30] or not all(
            np.isfinite(v) for r in losses for k, v in r.items() if "/" in k):
        fail(f"dsn: {steps} steps; losses missing or not finite: {losses}")
    if len(val) != 1 or not np.isfinite(val[0]["val/psnr_vs_bicubic"]):
        fail(f"dsn: validation missing or not finite: {val}")
    for f in (f"{DSN_STEPS}.pt", "last_iteration.tar"):
        if not os.path.exists(os.path.join(run, "checkpoints", f)):
            fail(f"dsn: checkpoints/{f} was not saved")
    print(f"dsn: {steps} steps in {secs:.2f} s through the CLI (host loader, uint8 crops, "
          f"bicubic in the step, one validation, one save); read and finite at steps 10, 20 "
          f"and 30, g_overall_loss " + " -> ".join(f"{r['loss/g_overall_loss']:.4e}" for r in losses)
          + ", d_tex_loss " + " -> ".join(f"{r['loss/d_tex_loss']:.4e}" for r in losses)
          + "; at step 30: " + ", ".join(f"{k.split('/')[-1]} {losses[-1][k]:.4e}"
                                         for k in sorted(losses[-1]) if "/" in k
                                         and not k.startswith("perf/"))
          + f"; val PSNR vs bicubic {val[0]['val/psnr_vs_bicubic']:.3f} dB; TF32 off after "
          f"the CLI", flush=True)

    # the device step alone, at the launcher set, on one host batch
    dev = torch.device("cuda")
    opt = dsn_train.build_argparser().parse_args(argv)
    loader = dsn_train.make_loader(opt, dirs["source"], dirs["target"], dev)
    trainer = dsn_train.make_trainer(opt, dev, len(loader))
    trainer.init_state()
    batch = dsn_train.to_device(next(iter(loader)), dev)

    def step():
        return trainer.train_step(batch)

    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        step()
    times = []
    for _ in range(12):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        step()
        host = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        times.append((start.elapsed_time(end), host))
    ms, host_ms = (float(v) for v in np.median(times, axis=0))
    peak = torch.cuda.max_memory_allocated()
    imgs = opt.batch_size / (ms / 1e3)
    print(f"dsn step, DeResnet nf 64 nb {opt.num_res_blocks} x4 + FSD + LPIPS alex, batch "
          f"{opt.batch_size}, crop {opt.crop_size}, bf16, uint8 batch, bicubic in the step: "
          f"{ms:.3f} ms/step (median of 12, CUDA events), host {host_ms:.3f} ms to issue a "
          f"step, {imgs:.2f} HR crops/s, peak device memory {peak / 2**30:.3f} GiB [{gpu}]",
          flush=True)
    report.update(dsn_ms_per_step=ms, dsn_host_ms_per_step=host_ms, dsn_images_per_s=imgs,
                  dsn_peak_mem_bytes=peak)
    prof = device_profile(step)
    if prof is None:
        print("dsn step: torch.profiler recorded no device events; idle share not measured",
              flush=True)
    else:
        idle = max(0.0, 1 - prof["busy"] / ms)
        print(f"dsn step (torch.profiler): device busy {prof['busy']:.3f} ms per step, idle "
              f"share {100 * idle:.2f}% of the untraced {ms:.3f} ms step, "
              f"{100 * prof['idle']:.2f}% of the traced span of {prof['span']:.3f} ms; "
              f"{prof['events']:.0f} device events per step; most device time: "
              + ", ".join(f"{name[:60]} {t:.3f} ms" for name, t in prof["top"]) + f" [{gpu}]",
              flush=True)
        report.update(dsn_idle_share=idle, dsn_device_busy_ms=prof["busy"])
    del trainer, batch
    dsn_f32_check(root, dirs)
    return report, os.path.join(run, "checkpoints")


def dsn_f32_check(root, dirs):
    """Three f32 steps at nb 2 (batch 4, crop 128) on the card against the
    same steps of the port on the CPU, from the same init and batches."""
    import torch

    from dasr_tpu_torch.cli import dsn_train

    opt = dsn_train.build_argparser().parse_args(dsn_argv(
        root, dirs, "--no_bf16", "--num_res_blocks", "2", "--batch_size", "4",
        "--crop_size", "128"))
    loader = dsn_train.make_loader(opt, dirs["source"], dirs["target"], torch.device("cpu"))
    batches = list(loader)[:3]
    runs = {}
    for name in ("cuda", "cpu"):
        dev = torch.device(name)
        tr = dsn_train.make_trainer(opt, dev, len(loader))
        st = tr.init_state()
        nets = {"G": st.g, "D": st.d_target}
        init = {k: torch.cat([p.detach().flatten().cpu() for p in ns.params()])
                for k, ns in nets.items()}
        traj = [{k: float(v) for k, v in tr.train_step(dsn_train.to_device(b, dev)).items()}
                for b in batches]
        after = {k: (torch.cat([p.detach().flatten().cpu() for p in ns.params()]),
                     torch.cat([ns.opt.state[p]["exp_avg"].flatten().cpu() for p in ns.params()]))
                 for k, ns in nets.items()}
        runs[name] = (traj, init, after)
    lim = DSN_F32_LIMITS
    worst, parts, bad, _ = compare_three_steps("dsn f32", runs["cuda"], runs["cpu"], lim["loss"],
                                               lim["update"], lim["moment"])
    print(f"dsn f32 nb 2 (batch 4, crop 128), 3 steps, the card vs the CPU: losses within "
          f"{worst:.3f} of their limit (atol {lim['loss'][0]}, rtol {lim['loss'][1]}); "
          f"|dtheta_card - dtheta_cpu| / |dtheta_cpu| and the same of Adam's first moments "
          f"(limits {lim['update']}, {lim['moment']}): {'; '.join(parts)}", flush=True)
    if bad:
        fail(f"dsn f32: the card's updates or moments of {bad} are off the CPU's")


def phase_dataset(gpu, root, ckpt_dir):
    """Stage 2 through the port's dsn_create_dataset CLI from phase dsn's
    checkpoint, then the tiled generator forward against the whole one."""
    import math

    import torch

    from dasr_tpu_torch.cli import dsn_create_dataset
    from dasr_tpu_torch.data.io import read_img
    from dasr_tpu_torch.nn.generators import DeResnet

    rng = np.random.default_rng(SEED + 2)
    target = os.path.join(root, "dataset_corpus", "target")
    for i, hw in enumerate(DATASET_SIZES):
        write_images(target, rng, 1, hw, f"t{i}_")
    source = write_images(os.path.join(root, "dataset_corpus", "source"), rng, 2, (96, 128), "s")
    out = os.path.join(root, "dataset_out")
    t0 = time.perf_counter()
    run_cli(dsn_create_dataset.main, [
        "--device", "cuda", "--checkpoint", ckpt_dir, "--filter", "avg_pool",
        "--source_dir", source, "--target_dir", target, "--name", "lrs",
        "--results_root", out, "--including_source_ddm"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    lrs = os.path.join(out, "lrs")
    for i, (h, w) in enumerate(DATASET_SIZES):
        lr_hw = (math.ceil(h / 4), math.ceil(w / 4))
        img = read_img(os.path.join(lrs, "imgs_from_target", f"t{i}_000.png"))
        ddm = np.load(os.path.join(lrs, "ddm_target", f"t{i}_000.npy"))
        if img.shape != (*lr_hw, 3) or ddm.shape != (1, 1, *lr_hw):
            fail(f"dataset: {(h, w)} gave an LR of {img.shape} and a DDM of {ddm.shape}, "
                 f"expected {lr_hw}")
        if not (np.isfinite(ddm).all() and 0 <= ddm.min() and ddm.max() <= 1):
            fail(f"dataset: the DDM of {(h, w)} leaves [0, 1]: [{ddm.min()}, {ddm.max()}]")
        print(f"dataset {w}x{h} ({'tiled' if h * w > dsn_create_dataset.TILE_ABOVE else 'whole'}"
              f"): LR {lr_hw[1]}x{lr_hw[0]}, DDM {ddm.shape} in [{ddm.min():.4f}, "
              f"{ddm.max():.4f}]", flush=True)
    for i in range(2):
        ddm = np.load(os.path.join(lrs, "ddm_source", f"s{i:03d}.npy"))
        if ddm.shape != (1, 1, 96, 128) or not (0 <= ddm.min() and ddm.max() <= 1):
            fail(f"dataset: source DDM {i} has shape {ddm.shape}, range "
                 f"[{ddm.min()}, {ddm.max()}]")
    n = len(DATASET_SIZES) + 2
    print(f"dataset: {len(DATASET_SIZES)} targets and 2 source DDMs in {secs:.2f} s through the "
          f"CLI, {secs / len(DATASET_SIZES):.3f} s per target image (f32 nets, PNG and NPY "
          f"writes included; {secs / n:.3f} s per image of either kind); TF32 off after the "
          f"CLI [{gpu}]", flush=True)

    # the tiled G forward vs the whole-image one on the 1020x678 image, away
    # from the border (reflect padding at the tile grid's edge, zero padding
    # in the whole forward)
    saved = torch.load(os.path.join(ckpt_dir, f"{DSN_STEPS}.pt"), map_location="cpu",
                       weights_only=True)
    g = DeResnet(8, 4)
    g.load_state_dict(saved["G"]["net"])
    g.to("cuda", memory_format=torch.channels_last).eval()
    x = torch.from_numpy(read_img(os.path.join(target, "t1_000.png"))).cuda().permute(2, 0, 1)[None]
    ms = {}
    with torch.no_grad():
        whole = dsn_create_dataset.generate_lr(g, x, 4)
        tiled = dsn_create_dataset.generate_lr(g, x, 4, above=0)
        for name, above in (("whole", dsn_create_dataset.TILE_ABOVE), ("tiled", 0)):
            ms[name] = cuda_ms(lambda: dsn_create_dataset.generate_lr(g, x, 4, above=above),
                               warmup=1, iters=3)
    band = 8  # LR pixels: G's receptive field reaches 24 HR pixels (6 LR) at nb 8
    err = (tiled - whole)[..., band:-band, band:-band].abs().max().item()
    print(f"dataset: the tiled G forward (tile {dsn_create_dataset.TILE}, halo 64) vs the whole "
          f"one on 1020x678, f32, {band} LR px from the border: max|err| {err:.3e} (limit "
          f"{DATASET_TILE_ATOL}); G forward {ms['whole']:.2f} ms whole, {ms['tiled']:.2f} ms "
          f"tiled [{gpu}]", flush=True)
    if not err <= DATASET_TILE_ATOL:
        fail(f"dataset: the tiled G forward is {err:.3e} off the whole one")
    return {"dataset_s_per_image": secs / len(DATASET_SIZES), "dataset_tile_max_abs_err": err}


# the tiled forward vs the whole one: the same f32 convs over other batch
# shapes, sigmoid outputs in [0, 1]
DATASET_TILE_ATOL = 1e-5


class Tee:
    """Writes to stdout and keeps a copy."""

    def __init__(self):
        self.parts, self.out = [], sys.stdout

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def phase_pipeline(gpu, root, checked, checked_grad):
    """All three stages through the port's auto_reproduce CLI at reduced
    depth, with the RDB kernel's launches and shapes of stage 3."""
    import contextlib

    import torch
    from torch.nn.modules.module import register_module_forward_pre_hook

    from dasr_tpu_torch.cli import auto_reproduce
    from dasr_tpu_torch.nn.blocks import RDB5C
    from dasr_tpu_torch.ops.rdb import LAUNCHES_PER_RDB, fused_rdb

    rng = np.random.default_rng(SEED + 3)
    corpus = os.path.join(root, "pipeline_corpus")
    dirs = {"source": write_images(os.path.join(corpus, "source"), rng, 16, (36, 36), "s"),
            "target": write_images(os.path.join(corpus, "target"), rng, 8, (144, 144), "t"),
            "valid_hr": write_images(os.path.join(corpus, "valid_hr"), rng, 2, (256, 256), "v"),
            "valid_lr": write_images(os.path.join(corpus, "valid_lr"), rng, 2, (64, 64), "v")}
    paths_yml = os.path.join(root, "pipeline_paths.yml")
    with open(paths_yml, "w") as f:
        f.write("aim2019:\n  tdsr:\n" + "".join(f"    {k}: '{v}'\n" for k, v in dirs.items()))
    with open(os.path.join(ROOT, TRAIN_CONFIG)) as f:
        cfg = json.load(f)
    cfg["network_G"]["nb"] = 2  # depth cut; the widths and batch are the shipped ones
    cfg["max_val_images"] = 2
    cfg["logger"]["print_freq"] = 1  # every step's losses read and logged
    template = os.path.join(root, "pipeline_template.json")
    with open(template, "w") as f:
        json.dump(cfg, f)
    work = os.path.join(root, "pipeline_work")
    argv = ["--dataset", "aim2019", "--artifact", "tdsr", "--device", "cuda",
            "--paths_yml", paths_yml, "--work_root", work, "--num_epochs", "1",
            "--niter", str(PIPELINE_ITERS), "--srn_template", template,
            "--dsn_extra", "--num_res_blocks 2 --crop_size 128",
            "--dsn_create_extra", "--num_res_blocks 2"]
    seen = set()

    def record(mod, args):
        if isinstance(mod, RDB5C):
            b, _, h, w = args[0].shape
            seen.add((b, h, w, args[0].dtype, torch.is_grad_enabled()))

    tee = Tee()
    fused_rdb.launches = 0
    handle = register_module_forward_pre_hook(record)
    try:
        with contextlib.redirect_stdout(tee):
            times = run_cli(auto_reproduce.main, argv)
        torch.cuda.synchronize()
    finally:
        handle.remove()
    launches = fused_rdb.launches
    printed = "".join(tee.parts)
    if list(times) != ["dsn_train", "dsn_create_dataset", "srn_train"] or not all(
            f"stage '{s}' wall-clock" in printed for s in times):
        fail(f"pipeline: stage wall-clock lines missing: {times}")
    dsn = os.path.join(work, "DSN_experiments", "0603_DSN_aim2019")
    lrs = os.path.join(work, "DSN_results", "0603_DSN_LRs_aim2019")
    srn = os.path.join(work, "SRN_experiments", "0603_DASR_SRN_auto_reproduce_aim2019")
    want = {os.path.join(dsn, "checkpoints", "last_iteration.tar"),
            os.path.join(srn, "training_state", f"{PIPELINE_ITERS}.pt")}
    want |= {os.path.join(lrs, "imgs_from_target", f"t{i:03d}.png") for i in range(8)}
    want |= {os.path.join(lrs, "ddm_target", f"t{i:03d}.npy") for i in range(8)}
    missing = sorted(p for p in want if not os.path.exists(p))
    if missing:
        fail(f"pipeline: missing outputs {missing}")
    losses = {}
    for stage, run in (("dsn_train", dsn), ("srn_train", srn)):
        with open(os.path.join(run, "metrics.jsonl")) as f:
            losses[stage] = [v for r in map(json.loads, f) for k, v in r.items()
                             if k.startswith("loss/")]
        if not losses[stage] or not all(np.isfinite(losses[stage])):
            fail(f"pipeline: {stage}'s losses missing or not finite")
    # the fast path: both training stages on the device bank
    if printed.count("device bank: ") != 2 or "using the host loader" in printed:
        fail("pipeline: stages 1 and 3 did not both train on the device bank")
    # stage 3's G forwards: one a step, and one per validation image at the
    # end of its one window of PIPELINE_ITERS steps (--steps_per_call 8)
    forwards = PIPELINE_ITERS + 2
    expected = 3 * 2 * LAUNCHES_PER_RDB * forwards
    missing = {k[:4] for k in seen} - checked
    missing |= {k[:4] for k in seen if k[4]} - checked_grad
    print(f"pipeline: {', '.join(f'{k} {v:.1f} s' for k, v in times.items())}; "
          f"logged losses finite ({', '.join(f'{k} {len(v)}' for k, v in losses.items())}); "
          f"fused_rdb launches {launches}, expected "
          f"3 x 2 x {LAUNCHES_PER_RDB} x {forwards} = {expected}; kernel input shapes "
          f"{sorted((*k[:3], str(k[3]), k[4]) for k in seen)}; TF32 off after the CLI [{gpu}]",
          flush=True)
    if launches != expected:
        fail(f"pipeline: fused_rdb launched {launches} times, expected {expected}")
    if missing:
        fail(f"pipeline: stage 3 gave the kernel shapes phases 2 and 4 did not check: {missing}")
    return {"launches_pipeline": launches,
            "pipeline_stage_s": {k: round(v, 3) for k, v in times.items()}}


BANK_STEPS, BANK_K = 32, 8  # the banked SRN run: four windows of 8 steps
DSN_BANK_K = 4


def window_times(fns, steps, rounds=2):
    """{name: (CUDA-event ms per step, host ms per step to issue it)} of
    each window function in ``fns`` (``steps`` steps a call), medians over
    ``rounds`` turns of (a, b, b, a)."""
    import torch

    times = {name: [] for name in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(rounds):
        for name in order:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fns[name]()
            host = (time.perf_counter() - t0) * 1e3
            end.record()
            torch.cuda.synchronize()
            times[name].append((start.elapsed_time(end) / steps, host / steps))
    return {name: tuple(float(v) for v in np.median(t, axis=0)) for name, t in times.items()}


def time_arms(what, fns, steps, gpu):
    """The in-turns times, idle share (torch.profiler over one call) and peak
    memory of each arm, printed; returns them by arm."""
    import torch

    peaks = {}
    for name, fn in fns.items():  # the first call of each arm: its peak memory
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
    out = {}
    for name, (ms, host_ms) in window_times(fns, steps).items():
        peak = peaks[name]
        prof = device_profile(fns[name], iters=1)
        busy = prof["busy"] / steps if prof else float("nan")
        idle = max(0.0, 1 - busy / ms) if prof else float("nan")
        out[name] = {"ms_per_step": ms, "host_ms_per_step": host_ms, "busy_ms_per_step": busy,
                     "idle_share": idle, "peak_mem_bytes": peak}
        print(f"{what} {name}: {ms:.3f} ms/step (CUDA events, median of 4 windows of {steps} "
              f"steps in turns), host {host_ms:.3f} ms/step to issue, device busy "
              f"{busy:.3f} ms/step (torch.profiler), idle share {100 * idle:.2f}%, peak "
              f"device memory {peak / 2**30:.3f} GiB [{gpu}]", flush=True)
    return out


def bank_gather_check(gpu):
    """The fast gathers against their plain versions on the same card draws,
    exact, at the main path's shapes: SRN batch 6, HR 128, over banks of
    ragged true sizes; DSN batch 8, crop 256."""
    import torch

    from dasr_tpu_torch.data import device_bank as bank

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 4)

    def mk(n, hmax, wmax, lo, c=3, f32=False, sizes=None):
        data = (rng.random((n, hmax, wmax, c), dtype=np.float32) if f32
                else rng.integers(0, 256, (n, hmax, wmax, c), dtype=np.uint8))
        if sizes is None:
            sizes = np.stack([rng.integers(lo, hmax + 1, n), rng.integers(lo, wmax + 1, n)], 1)
        return bank.ImageBank(torch.from_numpy(data).to(dev),
                              torch.from_numpy(sizes.astype(np.int32)).to(dev)), sizes

    fake, fsz = mk(12, 48, 48, 32)
    hr, _ = mk(12, 192, 192, 0, sizes=fsz * 4)
    real, _ = mk(12, 64, 64, 32)
    ddm, _ = mk(12, 48, 48, 0, c=1, f32=True, sizes=fsz)
    srn = bank.SrnBanks(fake, hr, real, ddm)
    clean, _ = mk(8, 320, 320, 256)
    noisy, _ = mk(48, 80, 80, 64)
    checked = 0
    for s in range(4):
        gen = bank.window_generator(SEED, s, dev)
        idx = torch.randint(0, 12, (6,), generator=gen, device=dev)
        d = bank.draw_dasr(gen, 6, 12, 12)
        got, want = (f(srn, idx, d, 128, 4) for f in (bank.gather_dasr, bank.gather_dasr_plain))
        nidx = torch.randint(0, 48, (8,), generator=gen, device=dev)
        dn = bank.draw_dsn(gen, 8, 8)
        got_n, want_n = (f(clean, noisy, nidx, dn, 256, 4, True, True)
                         for f in (bank.gather_dsn, bank.gather_dsn_plain))
        for k in want:
            if not torch.equal(got[k], want[k]):
                fail(f"bank: the DASR gather's {k} differs from the plain version (draw {s})")
        for k in want_n:
            if not torch.equal(got_n[k], want_n[k]):
                fail(f"bank: the DSN gather's {k} differs from the plain version (draw {s})")
        checked += 1
    ms = {name: cuda_ms(fn) for name, fn in (
        ("dasr", lambda: bank.gather_dasr(srn, idx, d, 128, 4)),
        ("dasr_plain", lambda: bank.gather_dasr_plain(srn, idx, d, 128, 4)),
        ("dsn", lambda: bank.gather_dsn(clean, noisy, nidx, dn, 256, 4, True, True)),
        ("dsn_plain", lambda: bank.gather_dsn_plain(clean, noisy, nidx, dn, 256, 4, True,
                                                    True)))}
    print(f"bank gather on the card: the DASR batch (6 + 6, HR 128, five tensors, ragged "
          f"banks) and the DSN batch (8, crop 256, flips and rotations) equal their plain "
          f"per-item versions exactly on {checked} card draws each; one batch: DASR "
          f"{ms['dasr']:.3f} ms (plain {ms['dasr_plain']:.3f}), DSN {ms['dsn']:.3f} ms (plain "
          f"{ms['dsn_plain']:.3f}) [{gpu}]", flush=True)
    return {"gather_ms_dasr": ms["dasr"], "gather_ms_dsn": ms["dsn"]}


def phase_bank(gpu, root, checked, checked_grad):
    """The fast path of stages 1 and 3 on the device banks: gathers on the
    card, the banked full-width srn_train CLI, banked against host-loader
    steps at f32, the banked dsn_train CLI, and both steps' times banked and
    host-loader in turns."""
    import contextlib

    import torch
    from torch.nn.modules.module import register_module_forward_pre_hook

    from dasr_tpu_torch.cli import dsn_train, srn_train
    from dasr_tpu_torch.cli.srn_test import make_lpips
    from dasr_tpu_torch.core.config import parse_srn_options
    from dasr_tpu_torch.data import device_bank as bank
    from dasr_tpu_torch.data.datasets import create_dataset
    from dasr_tpu_torch.data.io import list_images, read_img
    from dasr_tpu_torch.data.pipeline import Loader
    from dasr_tpu_torch.eval.evaluate import average, sr_metrics, to_uint8
    from dasr_tpu_torch.models.registry import create_model
    from dasr_tpu_torch.nn.blocks import RDB5C
    from dasr_tpu_torch.ops.rdb import LAUNCHES_PER_RDB, TOLERANCES, fused_rdb

    dev = torch.device("cuda")
    report = bank_gather_check(gpu)
    rng = np.random.default_rng(SEED)
    base = os.path.join(root, "bank")
    dirs = write_train_corpus(base, rng)

    # the main path: srn_train's fast path through the CLI, counted, with the
    # (B, H, W, dtype, grad mode) of every RDB5C input recorded
    cfg = train_config(base, dirs, "smoke_bank", BANK_STEPS, print_freq=BANK_K,
                       val_device_metrics=True, val_metrics_pad_bucket=128)
    seen = set()

    def record(mod, args):
        if isinstance(mod, RDB5C):
            b, _, h, w = args[0].shape
            seen.add((b, h, w, args[0].dtype, torch.is_grad_enabled()))

    tee = Tee()
    fused_rdb.launches = 0
    handle = register_module_forward_pre_hook(record)
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            steps, _ = run_cli(srn_train.main, ["-opt", cfg, "--device", "cuda", "--device_bank",
                                                "--steps_per_call", str(BANK_K),
                                                "--transfer_uint8"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        handle.remove()
    launches = fused_rdb.launches
    printed = "".join(tee.parts)
    forwards = BANK_STEPS + 2  # one G forward per step, one per validation image
    expected = 3 * NB * LAUNCHES_PER_RDB * forwards
    print(f"bank: srn_train --device_bank --steps_per_call {BANK_K} --transfer_uint8, "
          f"val_device_metrics, val_metrics_pad_bucket 128: {steps} steps in {secs:.2f} s "
          f"(one validation, one save); fused_rdb launches {launches}, expected {3 * NB} x "
          f"{LAUNCHES_PER_RDB} x {forwards} = {expected}; TF32 off after the CLI", flush=True)
    if "device bank: " not in printed or "using the host loader" in printed:
        fail("bank: srn_train did not train on the device bank")
    if steps != BANK_STEPS or launches != expected:
        fail(f"bank: {steps} steps and {launches} launches, expected {BANK_STEPS} and {expected}")
    missing = {k[:4] for k in seen} - checked
    missing |= {k[:4] for k in seen if k[4]} - checked_grad
    if missing:
        fail(f"bank: the banked run gave the kernel shapes phases 2 and 4 did not check: "
             f"{missing}")
    run_dir = os.path.join(base, "smoke_bank")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r for r in recs if "loss/l_g_total" in r]
    val = [r for r in recs if "val/psnr" in r]
    if [r["step"] for r in losses] != list(range(BANK_K, BANK_STEPS + 1, BANK_K)) or not all(
            np.isfinite(v) for r in losses for k, v in r.items() if k.startswith("loss/")):
        fail(f"bank: losses missing or not finite: {losses}")
    if not os.path.exists(os.path.join(run_dir, "training_state", f"{BANK_STEPS}.pt")):
        fail("bank: the train state was not saved")
    # the device validation metrics against the host f64 protocol on the PNGs
    lpips = make_lpips(dev)
    host = average([sr_metrics(
        to_uint8(read_img(os.path.join(run_dir, "val_images", str(BANK_STEPS),
                                       f"v{i}_{BANK_STEPS}.png"))),
        to_uint8(read_img(os.path.join(dirs["val_hr"], f"v{i}.png"))), 4, lpips)
        for i in range(2)])
    if len(val) != 1:
        fail(f"bank: {len(val)} validations, expected 1")
    errs = {k: abs(val[0][f"val/{k}"] - v) for k, v in host.items()}
    limits = {k: 1e-3 if k.startswith("psnr") else 1e-4 for k in host}
    print(f"bank validation on the device (bucket 128) vs the host f64 protocol on its PNGs: "
          + ", ".join(f"{k} {val[0][f'val/{k}']:.6f} vs {host[k]:.6f} (|err| {errs[k]:.2e}, "
                      f"limit {limits[k]})" for k in host)
          + "; losses at " + ", ".join(f"{r['step']}: l_g_total {r['loss/l_g_total']:.4e}"
                                       for r in losses), flush=True)
    if any(not errs[k] <= limits[k] for k in host):
        fail(f"bank: the device validation metrics are off the host protocol: {errs}")
    report["launches_bank"] = launches
    report["bank_val_max_err"] = {k: errs[k] for k in host}

    # three f32 steps at nb 2: banked (K = 1 windows) vs train_step on the
    # plain gather's batches of the same draws
    cfg32 = train_config(base, dirs, "bank_f32", 3, nb=2, bf16=False)
    opt32 = parse_srn_options(cfg32, is_train=True)
    def host_banks():
        fake = bank.build_bank(dirs["fake"])
        return bank.SrnBanks(fake, bank.build_bank(dirs["hr"]), bank.build_bank(dirs["real"]),
                             bank.build_ddm_bank(list_images(dirs["ddm"]), fake.sizes))

    idx = np.stack(bank.epoch_rows(SEED, 0, 12, 6) * 2)[:3]
    runs = []
    for banked in (True, False):
        model = create_model(opt32, dev)
        model.init()
        model.setup_device_bank(*host_banks(), 128)
        tr = model.trainer
        nets = {"G": tr.state.g, "D_target": tr.state.d_target}
        init = {name: flat(ns).clone() for name, ns in nets.items()}
        traj = []
        for s in range(3):
            if banked:
                m = model.train_banked_window_async(idx[s:s + 1], s)
            else:
                gen = bank.window_generator(tr.cfg.seed, s, dev)
                d = bank.draw_dasr(gen, 6, 12, 12)
                b = bank.gather_dasr_plain(model._banks, torch.from_numpy(idx[s]).to(dev), d,
                                           128, 4)
                m = tr.train_step({k: v.permute(0, 3, 1, 2) for k, v in b.items()})
            traj.append(model.metrics_to_host(m))
        runs.append((traj, init, {name: (flat(ns), flat(ns, True)) for name, ns in nets.items()}))
    atol, rtol = TOLERANCES["train_loss_f32"]
    _, utol = TOLERANCES["train_update_f32"]
    _, mtol = TOLERANCES["train_moment_f32"]
    worst, parts, bad, _ = compare_three_steps("bank f32", *runs, (atol, rtol), utol, mtol)
    print(f"bank f32 nb 2, 3 steps, banked vs train_step on the plain gather's batches of the "
          f"same draws, on the card: losses within {worst:.3f} of their limit; {'; '.join(parts)}",
          flush=True)
    if bad:
        fail(f"bank f32: the banked run's updates or moments of {bad} are off")
    del model, tr

    # stage 1's fast path: dsn_train on the device bank through the CLI
    dsn_dirs = {
        "source": write_images(os.path.join(base, "dsn", "source"), rng, 48, (80, 80), "s"),
        "target": write_images(os.path.join(base, "dsn", "target"), rng, 8, (320, 320), "t"),
        "valid_hr": write_images(os.path.join(base, "dsn", "valid_hr"), rng, 4, (256, 256), "v"),
        "valid_lr": write_images(os.path.join(base, "dsn", "valid_lr"), rng, 4, (64, 64), "v")}
    argv = dsn_argv(base, dsn_dirs, "--save_path", "dsn_bank", "--num_epochs", "5",
                    "--num_decay_epochs", "2", "--val_interval", "5", "--val_img_interval", "5",
                    "--save_model_interval", "5", "--device_bank", "--steps_per_call",
                    str(DSN_BANK_K))
    tee = Tee()
    log_every, dsn_train.LOG_EVERY = dsn_train.LOG_EVERY, 10
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            steps = run_cli(dsn_train.main, argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        dsn_train.LOG_EVERY = log_every
    printed = "".join(tee.parts)
    run = os.path.join(base, "dsn_bank")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        dsn_losses = [r for r in map(json.loads, f) if "loss/d_tex_loss" in r]
    if "device bank: " not in printed or "using the host loader" in printed:
        fail("bank: dsn_train did not train on the device bank")
    # windows end at 4, 8, ..., 28 and the last partial one at 30: those that
    # cross a 10-step boundary are read, and the last
    if steps != DSN_STEPS or [r["step"] for r in dsn_losses] != [12, 20, 30] or not all(
            np.isfinite(v) for r in dsn_losses for k, v in r.items() if "/" in k):
        fail(f"bank: dsn_train {steps} steps; losses missing or not finite: {dsn_losses}")
    for f in (f"{DSN_STEPS}.pt", "last_iteration.tar"):
        if not os.path.exists(os.path.join(run, "checkpoints", f)):
            fail(f"bank: dsn_train's checkpoints/{f} was not saved")
    print(f"bank: dsn_train --device_bank --steps_per_call {DSN_BANK_K} at the aim2019 launcher "
          f"set: {steps} steps in {secs:.2f} s through the CLI; read and finite at steps 12, 20, "
          f"30, d_tex_loss " + " -> ".join(f"{r['loss/d_tex_loss']:.4e}" for r in dsn_losses)
          + "; " + [ln for ln in printed.splitlines() if ln.startswith("device bank: ")][0]
          + f" [{gpu}]", flush=True)

    # times, banked and host-loader in turns: the DASR step at full width
    opt = parse_srn_options(cfg, is_train=True)
    model = create_model(opt, dev)
    model.init()
    t0 = time.perf_counter()
    banks = host_banks()
    t1 = time.perf_counter()
    model.setup_device_bank(*banks, 128)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    opt["datasets"]["train"]["transfer_uint8"] = True
    loader = Loader(create_dataset(opt["datasets"]["train"]), batch_size=6, num_workers=6,
                    seed=0, pin_memory=True)
    batches = []
    while len(batches) < BANK_K:
        loader.set_epoch(len(batches))
        batches += list(loader)[:BANK_K - len(batches)]
    tr = model.trainer
    window = np.stack(bank.epoch_rows(SEED, 0, 12, 6) * 4)[:BANK_K]
    srn = time_arms("dasr step", {
        "host loader": lambda: [tr.train_step(model._to_device(b)) for b in batches],
        "device bank": lambda: model.train_banked_window_async(window, 0)}, BANK_K, gpu)
    print(f"dasr bank: {bank.nbytes(model._banks) / 2**30:.6f} GiB resident for the 12-image "
          f"synthetic corpus, decoded in {t1 - t0:.3f} s, uploaded in {t2 - t1:.3f} s [{gpu}]",
          flush=True)
    del model, tr, batches

    # the DSN step at the aim2019 launcher set
    opt = dsn_train.build_argparser().parse_args(argv)
    loader = dsn_train.make_loader(opt, dsn_dirs["source"], dsn_dirs["target"], dev)
    trainer = dsn_train.make_trainer(opt, dev, len(loader))
    trainer.init_state()
    batches = list(loader)[:DSN_BANK_K]
    clean, noisy = (bank.upload(bank.build_bank(dsn_dirs[k]), dev) for k in ("target", "source"))
    nwin = torch.from_numpy(np.stack(bank.epoch_rows(SEED, 1, 48, 8)[:DSN_BANK_K])).to(dev)
    dsn = time_arms("dsn step", {
        "host loader": lambda: [trainer.train_step(dsn_train.to_device(b, dev)) for b in batches],
        "device bank": lambda: trainer.train_banked_step(clean, noisy, nwin, 0, 256)},
        DSN_BANK_K, gpu)
    del trainer, batches, clean, noisy

    # the upload rate at corpus scale: 1 GiB of uint8 images of DIV2K's size
    big = np.random.default_rng(SEED).integers(0, 256, (128, 1356, 2040, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    up = bank.upload(bank.ImageBank(big, np.full((128, 2), (1356, 2040), np.int32)), dev)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    gib = big.nbytes / 2**30
    del up, big
    print(f"bank upload: {gib:.3f} GiB of 2040x1356 uint8 images in {up_s:.3f} s "
          f"({gib / up_s:.2f} GiB/s, pageable host memory, 256 MiB slabs) [{gpu}]", flush=True)
    report.update(dasr=srn, dsn=dsn, upload_gib_per_s=gib / up_s)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernel,serve,grad,train,dsn,dataset,pipeline,bank",
                    help="comma-separated subset of build,kernel,serve,grad,train,dsn,dataset,"
                         "pipeline,bank")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        import dasr_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the dasr_tpu_torch package is not next to this script ({e})")
    from dasr_tpu_torch.core.device import resolve_device

    resolve_device("cuda")  # the port's rule for the phases that call no CLI: TF32 off

    gpu = gpu_line()
    print(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)
    entry = {
        "name": "fused_rdb", "route": "cuda", "source": "dasr_tpu_torch/csrc/rdb.cu",
        "replaces": "dasr_tpu/ops/pallas_rdb.py:61", "launches": 0,
        "backward": "autograd Function: VJP of the stock dense chain (ops/rdb.py:rdb_chain), "
                    "as JAX's custom VJP; checked against the plain version in phase grad",
    }
    if "serve" in phases:
        phases.add("kernel")  # serve checks its shapes against phase 2's
    if phases & {"train", "pipeline", "bank"}:
        phases |= {"kernel", "grad"}  # and train, pipeline and bank against phases 2 and 4
    if "dataset" in phases:
        phases.add("dsn")  # stage 2 reads stage 1's checkpoint
    if "build" in phases or "kernel" in phases or "grad" in phases:
        phase_build()
    if "kernel" in phases:
        report, checked = phase_kernel(gpu)
        entry.update(report)
    if "serve" in phases:
        entry.update(phase_serve(gpu, checked))
    if "grad" in phases:
        report, checked_grad = phase_grad(gpu)
        entry.update(report)
    if "train" in phases:
        entry.update(phase_train(gpu, checked, checked_grad))
    stages = {}
    with tempfile.TemporaryDirectory() as root:
        if "dsn" in phases:
            report, ckpt_dir = phase_dsn(gpu, root)
            stages.update(report)
        if "dataset" in phases:
            stages.update(phase_dataset(gpu, root, ckpt_dir))
        if "pipeline" in phases:
            report = phase_pipeline(gpu, root, checked, checked_grad)
            entry["launches_pipeline"] = report.pop("launches_pipeline")
            stages.update(report)
        if "bank" in phases:
            report = phase_bank(gpu, root, checked, checked_grad)
            entry["launches_bank"] = report.pop("launches_bank")
            print(f"bank (the fast path of stages 1 and 3): {json.dumps(report)}", flush=True)
    # launches: the count from each main path's run, the counter set to 0
    # just before it; the total of the paths this run drove
    entry["launches"] = sum(entry.get(f"launches_{p}", 0)
                            for p in ("serve", "train", "pipeline", "bank"))

    if stages:
        print(f"stages (no kernel of theirs but fused_rdb in stage 3): {json.dumps(stages)}",
              flush=True)
    print(gpu, flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
