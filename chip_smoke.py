"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, each of which exits non-zero on failure (nothing falls back to the
CPU or to a plain version):

1. build  - nvcc builds dasr_tpu_torch/csrc into build/dasr_tpu_torch/.
2. kernel - fused_rdb on the card vs its plain PyTorch version on the same
            tensors (nc 64, gc 32; f32 and bf16; the three test shapes and
            every shape the serve phase gives the kernel; 5-px border band),
            and the bf16 kernel also vs the f32 computation on the same
            bf16-rounded inputs.
3. serve  - the port's srn_test CLI on a synthetic LRHR set with a
            full-width x4 RRDB_net (nf 64, nb 23, gc 32, seeded weights
            written to a reference-named .pth), plain and chopped; the
            kernel's launch count over those runs, and a check that every
            shape they gave it was checked in phase 2; the full network with
            the kernel vs the plain version at f32; ms/image, output Mpix/s,
            the RDB kernels' device time inside the forward and the
            device's idle share (torch.profiler), and peak memory. It
            needs phase 2, which it then runs too.

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
KERNEL_SHAPES = ((1, 37, 53), (2, 64, 64), (8, 128, 128))
# what the serve phase gives the kernel: the 256x256 and 339x510 images whole,
# and chopped into 160x160 tiles (128 + 2 x 16 halo), 2 x 2 and 3 x 4 of them
SERVE_SHAPES = ((1, 256, 256), (1, 339, 510), (4, 160, 160), (12, 160, 160))
LR_SIZES = ((256, 256),) * 4 + ((339, 510),)  # (h, w) of the synthetic LR set
SEED = 0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


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

    from dasr_tpu_torch.ops.rdb import TOLERANCES, fused_rdb, fused_rdb_reference, prepare_weights

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    report = {"max_abs_err": 0.0, "max_abs_err_f32": 0.0, "max_abs_err_vs_f32": 0.0}
    checked = set()
    with torch.no_grad():
        for b, h, w in KERNEL_SHAPES + SERVE_SHAPES:
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
                if (b, h, w) == KERNEL_SHAPES[-1]:
                    ms = cuda_ms(lambda: fused_rdb(xd, kd, bd))
                    plain_ms = cuda_ms(lambda: fused_rdb_reference(xd, kd, bd))
                    flop = 2 * 9 * b * h * w * sum(
                        (NC + k * GC) * (GC if k < 4 else NC) for k in range(5))
                    print(f"time {str(dt):15s} {(b, h, w)}: kernel {ms:.4f} ms "
                          f"({flop / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms "
                          f"[{gpu}]", flush=True)
                    if dt == torch.bfloat16:
                        report["ms"], report["plain_ms"] = ms, plain_ms
                        cudnn_ms = cuda_ms(lambda: cudnn_bf16_chain(xd, kd, bd))
                        print(f"time cuDNN bf16 dense chain {(b, h, w)} (context, not the "
                              f"plain version): {cudnn_ms:.4f} ms [{gpu}]", flush=True)
                    else:
                        report["ms_f32"], report["plain_ms_f32"] = ms, plain_ms
    return report, checked


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


def device_idle_share(net, x, iters=3):
    """(idle share, device ms per forward, RDB kernel ms per forward) from
    torch.profiler's device events over ``iters`` forwards: idle is the part
    of the span from the first device event to the last in which no kernel,
    copy or memset ran. None when the profiler records no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        net(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                net(x)
            torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, s1, _ in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, s1
        else:
            cur_e = max(cur_e, s1)
    busy += cur_e - cur_s
    span = max(s1 for _, s1, _ in spans) - spans[0][0]
    rdb_us = sum(s1 - s0 for s0, s1, name in spans if "rdb_level" in name)
    return 1 - busy / span, span / iters / 1e3, rdb_us / iters / 1e3


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
        cfgs = [serve_config(root, "smoke_plain", False, pth),
                serve_config(root, "smoke_chop", True, pth)]

        # the main path: two srn_test runs through the port's CLI, counted,
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
            for cfg in cfgs:
                t0 = time.perf_counter()
                avgs.append(srn_test.main(["-opt", cfg, "--device", "cuda"]))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        finally:
            handle.remove()
        launches = fused_rdb.launches
        peak = torch.cuda.max_memory_allocated()

        forwards = 2 * len(LR_SIZES)  # one forward per image and run (chop batches its tiles)
        expected = 3 * NB * LAUNCHES_PER_RDB * forwards
        print(f"serve: fused_rdb launches {launches}, expected {3 * NB} x {LAUNCHES_PER_RDB} x "
              f"{forwards} = {expected}", flush=True)
        if launches != expected:
            fail(f"fused_rdb launched {launches} times, expected {expected}")
        print(f"serve: kernel input shapes {sorted((*k[:3], str(k[3])) for k in seen)}",
              flush=True)
        if seen - checked:
            fail(f"the serve runs gave the kernel shapes phase 2 did not check: {seen - checked}")
        for name, avg, sec in zip(("smoke_plain", "smoke_chop"), avgs, secs):
            pngs = sorted(os.listdir(os.path.join(root, "results", name, "synth")))
            if len(pngs) != len(LR_SIZES):
                fail(f"{name}: {len(pngs)} PNGs, expected {len(LR_SIZES)}")
            vals = avg.get("synth", {})
            if set(vals) != {"psnr", "ssim", "psnr_y", "ssim_y"} or not all(
                    np.isfinite(v) for v in vals.values()):
                fail(f"{name}: metrics not finite or missing: {vals}")
            print(f"serve {name}: {len(pngs)} PNGs, {vals}, {sec:.2f} s "
                  f"({sec / len(LR_SIZES):.3f} s/image with host metrics and PNG IO)", flush=True)
        print(f"serve: peak device memory {peak / 2**30:.3f} GiB [{gpu}]", flush=True)
    report["launches"] = launches

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
        blocks.fused_rdb = lambda x, ks, bs, params=(): fused_rdb_reference(x, ks, bs)
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
    prof = device_idle_share(net_bf16, x)
    if prof is None:
        print("serve 256x256: torch.profiler recorded no device events; idle share not "
              "measured", flush=True)
    else:
        idle, dev_ms, kern_ms = prof
        print(f"serve 256x256 (torch.profiler): device span {dev_ms:.3f} ms per forward, "
              f"idle share {100 * idle:.2f}%, rdb_level kernels {kern_ms:.3f} ms "
              f"({100 * kern_ms / dev_ms:.1f}% of the span) [{gpu}]", flush=True)
    report.update({"serve_ms_per_image": ms, "serve_out_mpix_s": mpix,
                   "peak_mem_bytes": peak})
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernel,serve",
                    help="comma-separated subset of build,kernel,serve")
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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    gpu = gpu_line()
    print(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)
    entry = {
        "name": "fused_rdb", "route": "cuda", "source": "dasr_tpu_torch/csrc/rdb.cu",
        "replaces": "dasr_tpu/ops/pallas_rdb.py:61", "launches": 0,
    }
    if "serve" in phases:
        phases.add("kernel")  # serve checks its shapes against phase 2's
    if "build" in phases or "kernel" in phases:
        phase_build()
    if "kernel" in phases:
        report, checked = phase_kernel(gpu)
        entry.update(report)
    if "serve" in phases:
        entry.update(phase_serve(gpu, checked))

    print(gpu, flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
