"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --phases build,kernel,grad,train   # the training slice
    python3 chip_smoke.py --phases dsn,dataset,pipeline      # stages 1 and 2, and all three
    python3 chip_smoke.py --phases bank                      # the banked fast path
    python3 chip_smoke.py --phases tools                     # resume, val_batch, the tool CLIs
    python3 chip_smoke.py --phases adaptive                  # the DASR Adaptive model
    python3 chip_smoke.py --phases paired                    # sr, srgan/srragan, De_Resnet
    python3 chip_smoke.py --phases depatch,sft               # De_patch_wavelet_GAN, SFT-GAN
    python3 chip_smoke.py --phases lpips                     # LPIPS breadth, 2AFC, the tools
    python3 chip_smoke.py --phases ablation                  # the experiment tools
    python3 chip_smoke.py --phases dist                      # one NCCL rank, two ranks
    python3 chip_smoke.py --phases adam                      # the Adam kernel alone
    python3 chip_smoke.py --phases prep                      # the RDB weight plan alone
    python3 chip_smoke.py --phases wgrad --parent DIR        # the RDB wgrad vs DIR's, in turns

Phases, each of which exits non-zero on failure (nothing falls back to the
CPU or to a plain version):

1. build  - nvcc builds dasr_tpu_torch/csrc into build/dasr_tpu_torch/.
2. kernel - the shared-memory plans compiled into the bf16 and f32
            kernels vs ops/rdb.py:WgmmaPlan and F32Plan, which the CPU tests
            emulate; fused_rdb on the card vs its plain PyTorch version on
            the same tensors (nc 64, gc 32; f32 and bf16; the test shapes
            and every shape the serve and train phases give the kernel,
            which take both tiles; 5-px border band), the bf16 kernel also
            vs the f32 computation on the same bf16-rounded inputs, and at
            TIMED_SHAPES the f32 kernel and the plain version vs an f64 RDB
            (the kernel within twice the plain version's error). At
            TIMED_SHAPES each kernel's time per RDB and per level, TFLOP/s,
            bound and share of it, timed in turns with cuDNN's dense chain
            in its dtype.
3. serve  - the port's srn_test CLI on a synthetic LRHR set with a
            full-width x4 RRDB_net (nf 64, nb 23, gc 32, seeded weights
            written to a reference-named .pth), plain, chopped, and plain
            with --device_metrics (against the host report: 1e-3 dB, 1e-4
            SSIM); the
            kernel's launch count over those runs, and a check that every
            shape they gave it was checked in phase 2; the full network with
            the kernel vs the plain version at f32, and its forward's time
            with each, in turns; ms/image, output Mpix/s,
            the RDB kernels' device time inside the forward and the
            device's idle share (torch.profiler), and peak memory; for
            information, the same forward replayed from a CUDA graph, in
            turns with the eager one. It needs phase 2, which it then runs
            too.
4. grad   - fused_rdb's autograd Function on the card (kernel forward;
            backward: the backward kernels at bf16, bit-equal on a rerun,
            the VJP of the stock dense chain at f32) vs autograd through
            the plain version on the same tensors: the output, dL/dx and
            the ten parameter gradients, f32 and bf16, at the three test
            shapes and every shape the train phase gives the kernel, with
            the forward and backward launches counted, and the weight
            gradient's units compiled into rdb_wgrad vs ops/rdb.py:
            wgrad_units; fwd+bwd times, and the bf16 backward's times (dgrad
            and wgrad apart, beside their bound) at the three train cells'
            shapes and (8, 128, 128), with the plain version and the
            cuDNN/ATen VJP of the chain at (12, 32, 32) and (8, 128, 128).
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
            launches (the eager loop's count) and shapes, the steps
            replayed from the CUDA graph (all but the warm-up), finite
            losses, the device val metrics against the host f64 protocol
            on the saved PNGs (1e-3 dB, 1e-4 SSIM); three f32 banked steps
            at nb 2 against train_step on the plain gather's batches of the
            same draws; dsn_train --device_bank --steps_per_call 4 at the
            dsn phase's launcher set, its replays counted; two windows of
            GRAPH_K steps replayed from the graph against the eager loop
            from one state, and a run resumed at the window boundary
            against the straight one, for the DASR and DSN steps at f32 (nb
            2; the three-step limits) and bf16 at full width
            (BF16_STEP_LIMITS); both steps on host batches, on the bank by
            the eager loop and on the bank replayed, in turns (ms/step,
            host ms/step, busy ms, idle share, peak memory, the capture's
            seconds), the bank's decode and upload time, and the upload
            rate at 1 GiB. It needs phases 2 and 4.
10. tools - the rest of the user surface: the reference .state resume at the
            train phase's full width, f32 (two steps, save_reference_formats,
            a fresh model of another seed through check_resume and load:
            params and Adam moments equal, then one step of both on one
            batch within the three-step limits), then srn_train from that
            2.state through the CLI to step 4 at bf16 with a validation of
            val_batch TOOLS_VAL; test_batch_async against test_async per
            image (the serve limits); auto_test over the two {iter}_G.pth of
            that run on the serve corpus; evaluate on the sweep's SR images
            against their HR, host, --device_metrics and --pad_bucket 64
            (device vs host 1e-3 dB, 1e-4 SSIM; bucketed vs not 1e-5);
            dsn_test --save_realness from phase 6's checkpoint on phase 7's
            whole-image targets (PNGs equal, DDMs within DATASET_TILE_ATOL);
            add_corruptions in its three modes; the kernel's launches and
            shapes over the phase, s/pair, s/image and the phase's wall
            time. It needs phases 2, 4, 6 and 7.
11. adaptive - the DASR Adaptive model at the full width of
            dasr_tpu_torch/configs/train_DASR_Adaptive.json (RRDB_Residual_conv
            nf 64 nb 19 ada_nb 4 gc 32, NLayer D on 9 Haar bands, LPIPS alex
            seeded, batch 2 + 2, HR 192, bf16), its patch D the FSD of phase
            6's .tar (that .tar's filter and kernel size): srn_train on the
            host loader for ADAPTIVE_STEPS steps and with --device_bank
            --steps_per_call 8 --transfer_uint8 for ADAPTIVE_BANK_STEPS, each
            with one validation and one save, and srn_test plain and chopped
            on the serve set plus one 540x600 LR image past the chop gate,
            from the host run's save; each run counted (345 kernel launches
            per generator forward) and its kernel shapes checked in phases 2
            and 4; the forward's ms/image; the step's ms/step, host ms/step,
            busy ms, rdb_level ms, idle share, device events and peak memory,
            host loader and device bank in turns; at f32, nb 2, three steps
            with the kernel against the plain version (resconv; concat with
            the patch D trained) and banked windows against train_step on
            the same draws, within the three-step limits. It needs phases 2,
            4 and 6.
12. paired - the paired-data trainers ('sr' with RRDB_net and sr_resnet,
            'srgan' / 'srragan', 'De_Resnet') at the full width of the port's
            copies of their shipped configs: srn_train and srn_test, counted;
            test_x8; the srgan G gate; each step's times; three f32 srragan
            steps, the kernel against the plain version. It needs phases 2
            and 4.
13. depatch - 'De_patch_wavelet_GAN' at the full width of the port's copy of
            train_De_patch_wavelet_GAN.json (De_Resnet nf 64 nb 22, FSD on the
            9 Haar high bands, LPIPS alex seeded, batch 3, HR 512, bf16) on a
            seeded corpus (600x600 HR images, 160x160 real-LR references):
            srn_train for DEPATCH_STEPS steps with one validation and one save,
            and srn_test with save_RealorFake from that save (maps finite, (1,
            1, LR/2, LR/2)), each run counted (no RDB: 0 kernel launches); the
            step's ms/step, host ms, busy ms, idle share, device events and
            peak memory; at f32, nb 2: three steps on the card against the CPU
            (the three-step limits), a run resumed from its 2.pt against the
            straight run (2e-5), the card's realness maps against the CPU's
            (1e-5); s/image of the dump.
14. sft     - sftgan_test on the card with a seeded reference-format .pth (16
            blocks, 8-channel segmentation maps) over four images, counted (0
            launches); the PNGs against the CPU CLI's (one grey level), each
            f32 output against the CPU's (1e-4); ms/image of the forward.
15. lpips   - LPIPS breadth and the tools, on seeded reference-format weights
            (torchvision-layout alexnet, vgg16 and squeezenet1_1, heads) and
            a seeded BAPPS-layout corpus: LPIPS alex, vgg and squeeze at f32
            on the card against the CPU (1e-4 relative) at a batch of 50
            64x64 pairs and at one 1024x1024 pair, timed; lpips_train train
            --net vgg at the reference's defaults (batch 50, load_size 64, lr
            1e-4, beta1 0.5) over 600 triplets for 1 + 1 epochs, then eval
            2afc over them and jnd over 200 pairs; the 2AFC step's ms/step,
            host ms/step and idle share; three f32 steps on the card against
            the CPU (the three-step limits); compute_dists pair, dirs (-o,
            --html, vgg) and self over 1024x1024 pairs, s/pair; parity over
            four 256x256 LR images plain and --chop with a seeded nb-23 G,
            counted (345 launches a forward), its kernel shapes checked in
            phase 2, its PSNR/SSIM against srn_test's on the same weights
            and images (0.01 dB, 1e-4 SSIM), s/image; test_dataloader and each
            script once. It needs phase 2, which it then runs too.
16. ablation - the port's experiment tools (dasr_tpu_torch/tools) as a user
            runs them: make_synth_corpus --noise_mode textured (24 targets of
            512x512, 48 sources, 4 val pairs of 256x384); ddm_ablation with
            --skip_train (stage 1, dsn_train for ABLATION_DSN_EPOCHS epochs at
            the launcher's batch 8 and crop 256; stage 2; stage 3, the DDM
            localization), counted (no RDB: 0 launches), then with --skip_dsn
            --skip_dataset (stage 3 again, equal; stage 4, two srn_train runs
            of ABLATION_NITER iterations, multiweights on and off, at the full
            width of train_DASR_auto_reproduce.json, bf16; stage 5, the
            region-split eval from each run's {iter}.pt), counted (345
            launches a generator forward, each RDB5C forward a kernel run),
            its kernel shapes checked in phases 2 and 4; every stage's
            outputs, finite losses and finite PSNRs of both runs in
            ablation_results.json; parity_dryrun at nb 23 on a 256x256 and a
            540x600 LR image, the port's f32 SRModel (the f32 kernel) plain and
            chopped against the functional forward and the forward_chop
            replica (TF32 off) within the nb 23 f32 network limit, counted
            (all f32 launches). It needs phases 2 and 4, which it then runs
            too.
17. dist   - the multi-rank paths (core/dist.py), in children started by
            ``python -m torch.distributed.run``, each reporting its fused_rdb
            launches and kernel shapes on a DIST_CHILD line and in a file of
            its own: one NCCL rank
            runs srn_train at full width (nf 64, nb 23, batch 6 + 6, bf16)
            for DIST_STEPS banked steps, counted, with its [mesh] data=1
            spatial=1 line; its step with the one-rank group against the
            same step without it (bit-equal expected, cuDNN deterministic,
            beside the step without it run twice); the step's ms with and
            without the group, in turns. Two ranks (gloo sharing the card
            with CUDA tensors; NCCL on two cards where the machine has
            two): three f32 DASR steps (nf 64, nb 2) and one f32 srragan
            step (train_SRGAN.json at nb 2, its BatchNorm VGG D) on
            their rows of the global batches against one process on them
            (the three-step limits; for the one srragan step, Adam's first,
            its first moments, its update reported), and srn_test --mesh 2
            at nb 23 on a
            256x256 LR image, chopped and --spatial_shard, against one
            process's chopped and plain forwards (0.01 dB, 1e-4 SSIM). It
            needs phases 2 and 4, which it then runs too.
18. adam   - the Adam kernel (csrc/adam.cu, ops/adam.py) at dasr_srn's G
            (RRDBNet nf 64 nb 23 gc 32, channels_last) and D (NLayer, 668,737
            parameters), on real gradients of a bf16 forward and backward:
            one step against torch.optim.Adam(capturable=True) on the same
            gradients (params within 1e-3 x lr, moments 1e-6 relative, the
            counts exact); the update of both networks captured in a CUDA
            graph and timed by CUDA events and by the device trace (its
            kernels' time and count), against its byte bound (28 bytes a
            parameter at 3.35 TB/s) and in turns with torch's capturable
            foreach Adam captured alike; the host's time to issue one eager
            update of both against torch's (it fails if the kernel's is
            longer, or if the kernel is not the faster on the card). Needs
            phase 1, which it then runs too.
19. prep   - the RDB weight plan (ops/rdb.py:RDBWeightPlan, csrc/rdb.cu
            rdb_prep_weights) at dasr_srn's G (69 RDBs, channels_last): its
            one launch bit for bit the per-call path it replaces (345 casts
            to bf16 HWIO and 69 rdb_dgrad_weights launches) and the plain
            version (.to(bf16) and dgrad_weights) on the card, both captured
            in a CUDA graph and timed in turns by CUDA events and by the
            device trace, against the launch's byte bound (8 bytes a weight
            at 3.35 TB/s); it fails if the launch is not the faster. Needs
            phase 1, which it then runs too.

Every port CLI runs as a user runs it: before each call the TF32 flags are
set on, and the call must turn them off (core/device.py:f32_numerics).
The line before the last is the kernel report as JSON, one entry for each
of the two kernels (the bf16 rdb_level_wgmma and the f32 rdb_level_tf32x3,
each with its launches on the main paths), and the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import pathlib
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
# what the tools phase gives the kernel beyond those: srn_train's validation
# with val_batch TOOLS_VAL over TOOLS_VAL same-shape 64x64 val images, one forward
TOOLS_VAL = 4
TOOLS_SHAPES = ((TOOLS_VAL, 64, 64),)
# what the adaptive phase gives the kernel beyond those: the step's 2 fake + 2
# real LR crops of 48x48 (HR 192), and its serve set's 540x600 image (past
# the DASR chop gate of 320000 px) whole and chopped into 5 x 5 tiles of 160x160
ADAPTIVE_SHAPES = ((4, 48, 48), (1, 540, 600), (25, 160, 160))
ADAPTIVE_LR_SIZES = LR_SIZES + ((540, 600),)
ADAPTIVE_CONFIG = os.path.join("dasr_tpu_torch", "configs", "train_DASR_Adaptive.json")
ADAPTIVE_NB, ADAPTIVE_NB_ADA = 19, 4  # train_DASR_Adaptive.json's trunk
ADAPTIVE_STEPS = 30
# what the paired phase gives the kernel beyond those, under grad:
# train_sr.json's 3 LR crops of 48x48 (HR 192), train_SRGAN.json's 8
PAIRED_SHAPES = ((3, 48, 48), (8, 48, 48))
PAIRED_STEPS = 12
# run: (the port's config, its model, train options over the config's)
PAIRED_RUNS = {
    "sr": ("train_sr.json", "sr", {}),
    "srragan": ("train_SRGAN.json", "srragan", {}),
    "srgan": ("train_SRGAN.json", "srgan", {"D_update_ratio": 2, "D_init_iters": 2}),
    "sr_resnet": ("train_SRResNet.json", "sr", {}),
    "De_Resnet": ("train_De_Resnet.json", "De_Resnet", {}),
}
ADAPTIVE_BANK_K = 8
ADAPTIVE_BANK_STEPS = 16
TRAIN_STEPS = 10
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


# the f32 kernel's launches on each main path, read with the count of both
# kernels (read_launches); the bf16 kernel's are the rest
F32_LAUNCHES = {}


REPLAYS_AT_ZERO = 0  # the graph.replays counter at the last zero_launches


def zero_launches(fused_rdb):
    """Set the launch counts of both kernels, and of the f32 one alone, to 0,
    and start the count of train-step replays from a CUDA graph (the
    ``graph.replays`` counter), just before a main path."""
    from dasr_tpu_torch.utils import trace

    global REPLAYS_AT_ZERO
    fused_rdb.launches = 0
    fused_rdb.launches_f32 = 0
    REPLAYS_AT_ZERO = trace.counters().get("graph.replays", 0)


PLAN_COUNTERS = ("rdb_prep.launches", "fused_rdb.prepared", "fused_rdb.cast")


def check_weight_plan(what, before, steps, rdbs):
    """On a banked bf16 main path, since the counters ``before``: the
    generator's weight plan launched once a step (replays credited), each of
    its ``rdbs`` fused RDBs took the plan's kernels every step, and no RDB
    cast its own. Returns the counts."""
    from dasr_tpu_torch.utils import trace

    now = trace.counters()
    grown = {k: now.get(k, 0) - before.get(k, 0) for k in PLAN_COUNTERS}
    want = {"rdb_prep.launches": steps, "fused_rdb.prepared": rdbs * steps, "fused_rdb.cast": 0}
    if grown != want:
        fail(f"{what}: the RDB weight plan counted {grown}, expected {want} (one launch a step, "
             f"{rdbs} RDBs a step taking its kernels, none casting its own)")
    return grown


def read_replays():
    """Train steps replayed from a CUDA graph since ``zero_launches``."""
    from dasr_tpu_torch.utils import trace

    return trace.counters().get("graph.replays", 0) - REPLAYS_AT_ZERO


def capture_seconds(spans):
    """The seconds of each graph capture among the recorder's ``spans``."""
    return [(s.end_ns - s.start_ns) * 1e-9 for s in spans if s.name == "graph.capture"]


def read_launches(fused_rdb, path):
    """The launches of both kernels since ``zero_launches``, just after a
    main path; its f32 kernel's launches are added to ``F32_LAUNCHES``."""
    F32_LAUNCHES[path] = F32_LAUNCHES.get(path, 0) + fused_rdb.launches_f32
    return fused_rdb.launches


def phase_build():
    from dasr_tpu_torch.kernels import build

    t0 = time.perf_counter()
    _, compiled = build.build(verbose=True)
    build.load()
    secs = time.perf_counter() - t0
    how = "nvcc compile and load" if compiled else "load only: the library was already built"
    print(f"build: {secs:.2f} s ({how})", flush=True)
    return secs


def cudnn_chain(x, kernels, biases):
    """The RDB as stock PyTorch would run it in x's dtype: F.conv2d (cuDNN)
    over the concatenated prefix, channels_last (at f32 with TF32 off, the
    port's rule). Timed for context only."""
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
        TILES, TOLERANCES, F32Plan, WgmmaPlan, fused_rdb, fused_rdb_reference, kernel_plan,
        prepare_weights)

    for dt, plan in ((torch.bfloat16, WgmmaPlan), (torch.float32, F32Plan)):
        for cout in (GC, NC):
            for tile in range(len(TILES)):
                if kernel_plan(cout, tile, dt) != plan(cout, tile).vector():
                    fail(f"the {dt} kernel's compiled plan (cout {cout}, tile {TILES[tile]}) "
                         f"differs from ops/rdb.py:{plan.__name__}, which the CPU tests emulate")
    print(f"kernel plan: both kernels' compiled shared-memory plans and descriptor offsets "
          f"equal ops/rdb.py:WgmmaPlan (bf16) and F32Plan (f32) for cout {GC} and {NC}, tiles "
          f"{TILES}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    report = {"max_abs_err": 0.0, "max_abs_err_vs_f32": 0.0}
    report32 = {"max_abs_err": 0.0, "f64_err_ratio": 0.0}
    checked = set()
    with torch.no_grad():
        for b, h, w in (KERNEL_SHAPES + SERVE_SHAPES + TRAIN_SHAPES + TOOLS_SHAPES
                        + ADAPTIVE_SHAPES + PAIRED_SHAPES + DIST_SHAPES + ABLATION_SHAPES):
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
                rep = report32 if dt == torch.float32 else report
                rep["max_abs_err"] = max(rep["max_abs_err"], err)
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
                if (b, h, w) not in TIMED_SHAPES:
                    continue
                if dt == torch.float32:
                    # both f32 computations against f64: the split-TF32
                    # products must stay within twice the plain version's error
                    ref = fused_rdb_reference(x.double(), [k.double() for k in ks],
                                              [v.double() for v in bs])
                    e_kernel = (got.double() - ref).abs().max().item()
                    e_plain = (want.double() - ref).abs().max().item()
                    _, ratio = TOLERANCES["kernel_f32_f64"]
                    print(f"kernel f32 vs f64 {(b, h, w)}: max|err| {e_kernel:.3e}, the plain "
                          f"version's {e_plain:.3e}: {e_kernel / e_plain:.3f}x (limit {ratio}x)",
                          flush=True)
                    if not e_kernel <= ratio * e_plain:
                        fail(f"fused_rdb f32 {(b, h, w)}: max |err| against f64 {e_kernel:.3e} "
                             f"exceeds {ratio} x the plain version's {e_plain:.3e}")
                    report32["f64_err_ratio"] = max(report32["f64_err_ratio"],
                                                    e_kernel / e_plain)
                timed = time_kernel(xd, kd, bd, gpu)
                if (b, h, w) == TIMED_SHAPES[0]:
                    rep.update(timed)
    report["f32"] = report32
    return report, checked


def time_kernel(x, kd, bd, gpu):
    """The kernel at x's shape and dtype: per RDB (CUDA events, so at small
    shapes the host's launch cost shows) in turns with cuDNN's chain in that
    dtype (kernel, chain, chain, kernel); per level on the device
    (torch.profiler), against the bound; the plain version once."""
    import torch

    from dasr_tpu_torch.ops.rdb import (
        bound_ms, fused_rdb, fused_rdb_reference, level_costs, rdb_cost)

    b, h, w, _ = x.shape
    dt = x.dtype
    name = "bf16" if dt == torch.bfloat16 else "f32"
    size = x.element_size()
    peak = ("989 TFLOP/s" if dt == torch.bfloat16
            else "165 TFLOP/s, three TF32 products at 495")
    fns = {"kernel": lambda: fused_rdb(x, kd, bd), "chain": lambda: cudnn_chain(x, kd, bd)}
    times = {fn: [] for fn in fns}
    for fn in ("kernel", "chain", "chain", "kernel"):
        times[fn].append(cuda_ms(fns[fn]))
    ms, chain_ms = (float(np.mean(times[k])) for k in ("kernel", "chain"))
    host = {fn: host_us(f) for fn, f in fns.items()}
    plain_ms = cuda_ms(lambda: fused_rdb_reference(x, kd, bd))
    flop, nbytes = rdb_cost(b, h, w, itemsize=size)
    bound, by = bound_ms(flop, nbytes, dt)
    print(f"time {name} {(b, h, w)}: kernel {ms:.4f} ms per RDB ({flop / ms / 1e9:.2f} TFLOP/s), "
          f"bound {bound:.4f} ms by {by} ({flop / 1e9:.2f} GFLOP at {peak} vs "
          f"{nbytes / 1e6:.2f} MB at 3.35 TB/s), {100 * bound / ms:.1f}% of the bound; "
          f"in turns: cuDNN {name} dense chain (yardstick, not the plain version) "
          f"{chain_ms:.4f} ms; plain version {plain_ms:.4f} ms; each of kernel/chain: "
          + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f}" for k, v in times.items()) + f"; host time "
          f"to issue one RDB: kernel {host['kernel']:.1f} us (five launches, one library call), "
          f"chain {host['chain']:.1f} us [{gpu}]", flush=True)
    report = {"ms": ms, "host_us_per_rdb": host["kernel"], "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
              "roofline_share": bound / ms, "library_ms": chain_ms,
              "library": f"cuDNN {name} dense chain (five F.conv2d over the concatenated "
                         f"prefix{', TF32 off' if dt == torch.float32 else ''}); no single "
                         f"PyTorch call computes an RDB"}
    levels, traces = level_device_ms(lambda: fused_rdb(x, kd, bd))
    if levels is None:
        fail(f"time {name} {(b, h, w)}: torch.profiler recorded the kernel's launches in none of "
             f"three traces")
    parts = []
    for k, ((lf, lb), lms) in enumerate(zip(level_costs(b, h, w, itemsize=size), levels)):
        lbound, lby = bound_ms(lf, lb, dt)
        parts.append(f"level {k + 1} {lms * 1e3:.1f} us ({lf / lms / 1e9:.1f} TFLOP/s; bound "
                     f"{lbound * 1e3:.1f} us by {lby})")
    report["device_ms"] = sum(levels)
    report["level_device_ms"] = levels
    print(f"time {name} {(b, h, w)} device time per level (torch.profiler, trace {traces} of at "
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


def write_corpus(root, rng, sizes=LR_SIZES):
    """Synthetic LRHR set: LR images of ``sizes`` and their 4x HR images."""
    from dasr_tpu_torch.data.io import save_img

    for d in ("lr", "hr"):
        os.makedirs(os.path.join(root, d))
    for i, (h, w) in enumerate(sizes):
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
        zero_launches(fused_rdb)
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
        launches = read_launches(fused_rdb, "serve")
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
    # its forward's time with the kernel and with the plain version, in turns
    xg = x.cuda()
    times = {fused_rdb: [], fused_rdb_reference: []}
    with torch.no_grad():
        for rdb in (fused_rdb, fused_rdb_reference, fused_rdb_reference, fused_rdb):
            blocks.fused_rdb = rdb
            try:
                times[rdb].append(cuda_ms(lambda: net_gpu(xg), warmup=2, iters=10))
            finally:
                blocks.fused_rdb = fused_rdb
    ms, plain = (float(np.mean(times[r])) for r in (fused_rdb, fused_rdb_reference))
    print(f"network f32 (1, 3, 64, 64) nb {NB} forward: {ms:.3f} ms with the kernel, "
          f"{plain:.3f} ms with the plain version (CUDA events, in turns) [{gpu}]", flush=True)
    report.update(network_f32_ms=ms, network_f32_plain_ms=plain)

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


# the three train cells' RDB shapes (srn_train, adaptive_train, srragan_train), the kernel report's
BACKWARD_TIMED = ((12, 32, 32), (4, 48, 48), (8, 48, 48), (8, 128, 128))


def backward_times(gpu, x, kernels, biases, dy):
    """The bf16 backward at x's shape: the kernels alone (``_launch_backward``
    on the forward's growth buffer and dgrad weight images made beforehand,
    as a weight plan makes them, by CUDA events), their dgrad and wgrad
    launches apart (the union of each group's device spans, torch.profiler:
    the launches overlap by programmatic dependent launch), their bounds,
    the plain version (``rdb_backward_reference``) and, as the yardstick,
    the cuDNN/ATen VJP of ``rdb_chain`` that the backward was before."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import dasr_tpu_torch.ops.rdb as rdb

    b, h, w, _ = x.shape
    ks = [k.bfloat16() for k in kernels]
    with torch.no_grad():
        _, growth = rdb._launch(x, ks, biases)
    images = rdb.launch_images(ks)

    def kernels_bwd():
        return rdb._launch_backward(x, growth, ks, images, dy)

    def chain_vjp():
        leaves = [t.detach().requires_grad_() for t in [x, *ks, *biases]]
        return torch.autograd.grad(rdb.rdb_chain(leaves[0], leaves[1:6], leaves[6:]), leaves, dy)

    out = {"kernel_ms": cuda_ms(kernels_bwd)}
    if (b, h, w) in (BACKWARD_TIMED[0], BACKWARD_TIMED[-1]):
        out["plain_ms"] = cuda_ms(lambda: rdb.rdb_backward_reference(x, growth, ks, dy))
        out["chain_vjp_ms"] = cuda_ms(chain_vjp)
    calls = 10
    kernels_bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            kernels_bwd()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    flop, _ = rdb.rdb_cost(b, h, w)  # the dgrad and the wgrad each do the forward's products
    for part in ("dgrad", "wgrad"):
        sel = [sp for sp in spans if f"rdb_{part}" in sp[2]]
        out[f"{part}_ms"] = union_us(sel) / calls / 1e3 if sel else None
        out[f"{part}_bound_ms"] = flop / rdb.PEAK_FLOPS[torch.bfloat16] * 1e3
    print(f"time bwd bf16 {(b, h, w)}: kernels {out['kernel_ms']:.4f} ms (dgrad "
          f"{out['dgrad_ms']} ms, wgrad {out['wgrad_ms']} ms; bound each "
          f"{out['dgrad_bound_ms']:.4f} ms, operations), plain version {out.get('plain_ms')} ms, "
          f"cuDNN/ATen VJP of rdb_chain {out.get('chain_vjp_ms')} ms [{gpu}]", flush=True)
    return out


def phase_grad(gpu):
    """fused_rdb under autograd vs autograd through the plain version: at
    bf16 its backward is the kernels (launches and backward calls counted),
    at f32 the VJP of rdb_chain; then the bf16 backward's times."""
    import torch

    from dasr_tpu_torch.ops.rdb import (
        BACKWARD_LAUNCHES, IMAGE_LAUNCHES, LAUNCHES_PER_RDB, TOLERANCES, fused_rdb,
        fused_rdb_reference, rdb_chain)

    from dasr_tpu_torch.ops.rdb import kernel_wgrad_units, wgrad_units

    for nc in (64, 32):
        if kernel_wgrad_units(nc, GC) != wgrad_units(nc, GC):
            fail(f"the weight-gradient units compiled into rdb_wgrad at nc {nc} are not "
                 f"ops/rdb.py:wgrad_units: {kernel_wgrad_units(nc, GC)}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    report = {"grad_rel_err_f32": 0.0, "grad_rel_err_bf16": 0.0}
    checked = set()
    for b, h, w in KERNEL_SHAPES + TRAIN_SHAPES + ADAPTIVE_SHAPES[:1] + PAIRED_SHAPES:
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
            names = ("launches", "backward_launches", "bwd_kernel", "bwd_chain")
            before = [getattr(fused_rdb, n) for n in names]
            out, grads = fwd_bwd(fused_rdb, leaves())
            torch.cuda.synchronize()
            counts = tuple(getattr(fused_rdb, n) - c for n, c in zip(names, before))
            bf16 = dt == torch.bfloat16
            # a bare call: no weight plan, so the backward makes its images
            want_counts = (LAUNCHES_PER_RDB, BACKWARD_LAUNCHES + IMAGE_LAUNCHES if bf16 else 0,
                           int(bf16), int(not bf16))
            if counts != want_counts:
                fail(f"fused_rdb under autograd at {(b, h, w)} {dt}: counted {counts} "
                     f"(launches, backward launches, kernel and chain backwards), "
                     f"want {want_counts}")
            if bf16:
                _, again = fwd_bwd(fused_rdb, leaves())
                if not all(torch.equal(a, c) for a, c in zip(grads, again)):
                    fail(f"the bf16 backward kernels at {(b, h, w)} gave other bits on a rerun")
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
                print(f"time fwd+bwd bf16 {(b, h, w)}: kernels {times['kernel']:.4f} ms, "
                      f"plain version {times['plain']:.4f} ms, stock bf16 chain and its VJP "
                      f"(context) {times['chain']:.4f} ms [{gpu}]", flush=True)
            if (b, h, w) in BACKWARD_TIMED and dt == torch.bfloat16:
                report[f"bwd_{b}x{h}x{w}"] = backward_times(gpu, base[0], base[1:6], base[6:], g)
    return report, checked


# One checkout's bf16 backward at each shape, run in a process of its own
# from that checkout (PYTHONPATH and cwd), so that a parent's tree and this
# one are timed by the same code: its whole backward by CUDA events, called
# from Python and replayed from a CUDA graph of 10 calls (the device's time
# alone: a call's host work outlasts the kernels at the train shapes), its
# dgrad and wgrad launches as the union of each group's device spans
# (torch.profiler), on the same seeded inputs. Uses only what both trees
# have: ops/rdb.py's _launch, launch_images and _launch_backward.
WGRAD_TURN = r"""
import json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import dasr_tpu_torch.ops.rdb as rdb

def union_us(spans):
    spans = sorted(spans)
    total, cs, ce = 0.0, spans[0][0], spans[0][1]
    for s0, s1 in spans[1:]:
        if s0 > ce:
            total, cs, ce = total + ce - cs, s0, s1
        else:
            ce = max(ce, s1)
    return total + ce - cs

out = {}
for b, h, w in json.loads(sys.argv[1]):
    g = torch.Generator(device="cuda").manual_seed(b * h * w)
    x = torch.rand(b, h, w, 64, device="cuda", generator=g).bfloat16()
    ks = [(0.05 * torch.randn(3, 3, 64 + 32 * k, 32 if k < 4 else 64, device="cuda",
                              generator=g)).bfloat16() for k in range(5)]
    bs = [0.01 * torch.randn(32 if k < 4 else 64, device="cuda", generator=g) for k in range(5)]
    dy = torch.randn(b, h, w, 64, device="cuda", generator=g).bfloat16()
    with torch.no_grad():
        _, growth = rdb._launch(x, ks, bs)
    images = rdb.launch_images(ks)
    fn = lambda: rdb._launch_backward(x, growth, ks, images, dy)
    for _ in range(5):
        fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(50):
        fn()
    e1.record()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(10):
            fn()
    graph.replay()
    g0, g1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    g0.record()
    for _ in range(5):
        graph.replay()
    g1.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    out[f"{b}x{h}x{w}"] = {
        "bwd_ms": e0.elapsed_time(e1) / 50, "graph_bwd_ms": g0.elapsed_time(g1) / 50,
        **{f"{part}_ms": union_us([sp[:2] for sp in spans if f"rdb_{part}" in sp[2]]) / 20 / 1e3
           for part in ("dgrad", "wgrad")},
        "wgrad_kernels": sorted({sp[2][:40] for sp in spans if "rdb_wgrad" in sp[2]})}
print("WGRAD_TURN " + json.dumps(out), flush=True)
"""


def phase_wgrad(gpu, parent):
    """The bf16 backward's weight gradient of this tree against a parent
    checkout's (``--parent``, e.g. a ``git archive`` of the parent commit),
    at BACKWARD_TIMED, in turns (parent, this, this, parent), each turn a
    process of its own that builds and loads its tree's kernels: the wgrad
    and dgrad as the union of their device spans, the whole backward by
    CUDA events, each beside the wgrad's bound (its products at the bf16
    peak)."""
    import torch

    import dasr_tpu_torch.ops.rdb as rdb

    if not parent or not os.path.isdir(os.path.join(parent, "dasr_tpu_torch")):
        fail(f"phase wgrad needs --parent, a checkout with dasr_tpu_torch/ (got {parent!r})")
    trees = {"parent": os.path.abspath(parent), "this": ROOT}
    runs = {"parent": [], "this": []}
    for name in ("parent", "this", "this", "parent"):
        proc = subprocess.run(
            [sys.executable, "-c", WGRAD_TURN, json.dumps(BACKWARD_TIMED)], cwd=trees[name],
            env=dict(os.environ, PYTHONPATH=trees[name]), capture_output=True, text=True,
            timeout=900)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("WGRAD_TURN ")]
        if proc.returncode != 0 or not line:
            fail(f"phase wgrad: the {name} tree's turn failed ({proc.returncode}):\n"
                 f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        runs[name].append(json.loads(line[0].split(" ", 1)[1]))
    report = {}
    for b, h, w in BACKWARD_TIMED:
        key = f"{b}x{h}x{w}"
        bound = rdb.rdb_cost(b, h, w)[0] / rdb.PEAK_FLOPS[torch.bfloat16] * 1e3
        row = {"bound_ms": bound}
        for name in ("parent", "this"):
            for field in ("wgrad_ms", "dgrad_ms", "bwd_ms", "graph_bwd_ms"):
                row[f"{name}_{field}"] = [r[key][field] for r in runs[name]]
            row[f"{name}_wgrad_kernels"] = runs[name][0][key]["wgrad_kernels"]
        mean = {n: float(np.mean(row[f"{n}_wgrad_ms"])) for n in ("parent", "this")}
        row["wgrad_share_of_bound"] = {n: bound / mean[n] for n in mean}
        report[key] = row
        print(f"wgrad bf16 {(b, h, w)} in turns (parent, this, this, parent), union of spans: "
              f"parent {row['parent_wgrad_ms']} ms, this {row['this_wgrad_ms']} ms (bound "
              f"{bound:.4f} ms, operations: parent {100 * bound / mean['parent']:.1f}%, this "
              f"{100 * bound / mean['this']:.1f}%); dgrad parent {row['parent_dgrad_ms']}, this "
              f"{row['this_dgrad_ms']}; whole backward by CUDA events parent "
              f"{row['parent_bwd_ms']}, this {row['this_bwd_ms']} ms, replayed from a graph "
              f"parent {row['parent_graph_bwd_ms']}, this {row['this_graph_bwd_ms']} ms; kernels parent "
              f"{row['parent_wgrad_kernels']}, this {row['this_wgrad_kernels']} [{gpu}]",
              flush=True)
    if not all(mean_this <= mean_parent for mean_this, mean_parent in
               ((np.mean(r["this_wgrad_ms"]), np.mean(r["parent_wgrad_ms"]))
                for r in report.values())):
        print("phase wgrad: this tree's wgrad is slower than the parent's at some shape", flush=True)
    return report


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
    """One network's trainable params, or Adam's first moments of them (0
    before its first step)."""
    import torch

    if not moment:
        return torch.cat([p.detach().flatten() for p in ns.params()])
    return torch.cat([ns.opt.state[p]["exp_avg"].flatten() if p in ns.opt.state
                      else torch.zeros_like(p).flatten() for p in ns.params()])


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

        zero_launches(fused_rdb)
        handle = register_module_forward_pre_hook(record)
        try:
            t0 = time.perf_counter()
            steps, _ = run_cli(srn_train.main, ["-opt", cfg, "--device", "cuda"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            handle.remove()
        launches = read_launches(fused_rdb, "train")
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
    zero_launches(fused_rdb)
    handle = register_module_forward_pre_hook(record)
    try:
        with contextlib.redirect_stdout(tee):
            times = run_cli(auto_reproduce.main, argv)
        torch.cuda.synchronize()
    finally:
        handle.remove()
    launches = read_launches(fused_rdb, "pipeline")
    replays = read_replays()
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
          f"{sorted((*k[:3], str(k[3]), k[4]) for k in seen)}; {replays} steps of stages 1 "
          f"and 3 replayed from their CUDA graphs; TF32 off after the CLI [{gpu}]", flush=True)
    if launches != expected:
        fail(f"pipeline: fused_rdb launched {launches} times, expected {expected}")
    if not replays:
        fail("pipeline: no banked step was replayed from a CUDA graph")
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


def time_arms(what, fns, steps, gpu, rounds=2, profiled=None):
    """The in-turns times, idle share (torch.profiler over one call) and peak
    memory of each arm, printed; returns them by arm. ``profiled``: {arm:
    (a shorter call, its steps)} to trace in place of the arm's window
    (the tracer's cost grows with the events it records). The first calls
    run with the port's recorder on, for the seconds of each graph capture
    (``capture_s``); a graph captured there carries its phase marks."""
    import torch

    from dasr_tpu_torch.utils import trace

    t0 = time.perf_counter()
    peaks, reserved, captures = {}, {}, {}
    for name, fn in fns.items():  # the first call of each arm: its peak memory
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trace.enable()
        fn()
        trace.disable()
        captures[name] = capture_seconds(trace.drain())
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
        # a captured graph keeps its pool reserved; the allocated peak does not show it
        reserved[name] = torch.cuda.max_memory_reserved()
    t1 = time.perf_counter()
    times = window_times(fns, steps, rounds)
    t2 = time.perf_counter()
    out = {}
    for name, (ms, host_ms) in times.items():
        peak = peaks[name]
        fn, n = (profiled or {}).get(name, (fns[name], steps))
        prof = device_profile(fn, iters=1)
        busy = prof["busy"] / n if prof else float("nan")
        idle = max(0.0, 1 - busy / ms) if prof else float("nan")
        rdb = prof["rdb"] / n if prof else float("nan")
        events = prof["events"] / n if prof else float("nan")
        out[name] = {"ms_per_step": ms, "host_ms_per_step": host_ms, "busy_ms_per_step": busy,
                     "idle_share": idle, "rdb_ms_per_step": rdb, "device_events_per_step": events,
                     "peak_mem_bytes": peak, "peak_reserved_bytes": reserved[name],
                     "capture_s": captures[name]}
        print(f"{what} {name}: {ms:.3f} ms/step (CUDA events, median of {2 * rounds} windows "
              f"of {steps} steps in turns), host {host_ms:.3f} ms/step to issue, device busy "
              f"{busy:.3f} ms/step (torch.profiler over {n} steps), of which rdb_level kernels "
              f"{rdb:.3f} ms, idle share {100 * idle:.2f}%, {events:.0f} device events per "
              f"step, peak device memory {peak / 2**30:.3f} GiB allocated, "
              f"{reserved[name] / 2**30:.3f} GiB reserved [{gpu}]", flush=True)
    print(f"{what}: {t1 - t0:.2f} s first calls, {t2 - t1:.2f} s in turns, "
          f"{time.perf_counter() - t2:.2f} s traced", flush=True)
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


GRAPH_K = 8  # the replay checks' windows: the CLIs' --steps_per_call
# the bf16 replay checks: losses within the bf16 kernel's limits; updates and
# Adam's first moments within the f32 three-step limits of their norms
BF16_STEP_LIMITS = {"loss": (3e-3, 2.0**-7), "update": 5e-2, "moment": 1e-2}


def looped(tr, *args):
    """``tr.train_banked_step(*args)`` by the eager loop (a ``StepGraphs``
    without a capture), the plain version the replayed window is held
    against; ``tr`` keeps its captured steps."""
    from dasr_tpu_torch.train.step_graph import StepGraphs

    graphs, tr.graphs = tr.graphs, StepGraphs(tr.device, capture=None)
    try:
        return tr.train_banked_step(*args)
    finally:
        tr.graphs = graphs


def replay_check(what, make, window, windows, limits, ckpt_dir, gpu):
    """Two windows of GRAPH_K steps from one seeded state, replayed from the
    step's CUDA graph (``train_banked_step``) and by the eager loop
    (``looped``), then a run resumed from a train state
    saved at the window boundary against the straight replayed run: each
    window's last losses, and each network's params and Adam's first
    moments, within ``limits`` ({"loss": (atol, rtol), "update", "moment"}).
    ``make()`` is a fresh trainer from the seed, ``window(tr, eager, start,
    rows)`` runs one window. Returns the worst loss share of its limit and
    the largest parameter difference of each comparison, and the capture
    seconds."""
    from dasr_tpu_torch.train.checkpoints import load_train_state, save_train_state
    from dasr_tpu_torch.utils import trace

    def after(tr):
        return {name: (flat(ns).clone(), flat(ns, True).clone())
                for name, ns in (("G", tr.state.g), ("D", tr.state.d_target))}

    def run(tr, eager, wins, save=False):
        init = {name: p for name, (p, _) in after(tr).items()}
        traj, boundary = [], None
        for w, (start, rows) in enumerate(wins):
            traj.append({k: float(v) for k, v in window(tr, eager, start, rows).items()})
            if save and w == 0:
                save_train_state(ckpt_dir, tr.state, start + GRAPH_K)
                boundary = {name: p for name, (p, _) in after(tr).items()}
        return (traj, init, after(tr)), boundary

    before = trace.counters().get("graph.replays", 0)
    trace.enable()
    straight, eager = make(), make()
    replayed, boundary = run(straight, False, windows, save=True)
    looped, _ = run(eager, True, windows)
    resumed = make()
    load_train_state(ckpt_dir, resumed.state)
    again, _ = run(resumed, False, windows[1:])
    trace.disable()
    n_replays = trace.counters()["graph.replays"] - before
    want_replays = 3 * GRAPH_K - 2  # each trainer's first step of its key is its warm-up
    capture_s = capture_seconds(trace.drain())
    out = {}
    for name, run_a, run_b in (("replay_vs_eager", replayed, looped),
                               ("resume_vs_straight", again,
                                (replayed[0][1:], boundary, replayed[2]))):
        worst, parts, bad, perr = compare_three_steps(f"{what} {name}", run_a, run_b,
                                                      limits["loss"], limits["update"],
                                                      limits["moment"])
        print(f"{what} {name.replace('_', ' ')}, {len(run_b[0])} window(s) of {GRAPH_K} steps: "
              f"losses within {worst:.3f} of their limit (atol {limits['loss'][0]}, rtol "
              f"{limits['loss'][1]:.3g}); update and first-moment limits {limits['update']}, "
              f"{limits['moment']}: {'; '.join(parts)}; largest param difference {perr:.3e} "
              f"[{gpu}]", flush=True)
        if bad:
            fail(f"{what} {name}: the updates or moments of {bad} are off")
        out[name] = {"loss_share": worst, "param_max_diff": perr}
    print(f"{what}: {n_replays} replays (expected {want_replays}), capture "
          + ", ".join(f"{c:.3f}" for c in capture_s) + " s", flush=True)
    if n_replays != want_replays:
        fail(f"{what}: {n_replays} replays, expected {want_replays}")
    out["capture_s"] = capture_s
    return out


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
    from dasr_tpu_torch.utils import trace

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
    zero_launches(fused_rdb)
    before = trace.counters()
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
    launches = read_launches(fused_rdb, "bank")
    replays = read_replays()
    printed = "".join(tee.parts)
    forwards = BANK_STEPS + 2  # one G forward per step, one per validation image
    expected = 3 * NB * LAUNCHES_PER_RDB * forwards
    print(f"bank: srn_train --device_bank --steps_per_call {BANK_K} --transfer_uint8, "
          f"val_device_metrics, val_metrics_pad_bucket 128: {steps} steps in {secs:.2f} s "
          f"(one validation, one save); fused_rdb launches {launches}, expected {3 * NB} x "
          f"{LAUNCHES_PER_RDB} x {forwards} = {expected} (the eager loop's count); {replays} "
          f"steps replayed from the CUDA graph, expected {BANK_STEPS - 1} (the first step is "
          f"the warm-up); TF32 off after the CLI", flush=True)
    if "device bank: " not in printed or "using the host loader" in printed:
        fail("bank: srn_train did not train on the device bank")
    if steps != BANK_STEPS or launches != expected:
        fail(f"bank: {steps} steps and {launches} launches, expected {BANK_STEPS} and {expected}")
    if replays != BANK_STEPS - 1:
        fail(f"bank: srn_train replayed {replays} steps, expected {BANK_STEPS - 1}")
    plan = check_weight_plan("bank", before, BANK_STEPS, 3 * NB)
    print(f"bank: the RDB weight plan on srn_train's main path: {plan}", flush=True)
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
    zero_launches(fused_rdb)
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            steps = run_cli(dsn_train.main, argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        dsn_train.LOG_EVERY = log_every
    dsn_replays = read_replays()
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
          + f"; {dsn_replays} steps replayed from the CUDA graph, expected {DSN_STEPS - 1}; "
          + [ln for ln in printed.splitlines() if ln.startswith("device bank: ")][0]
          + f" [{gpu}]", flush=True)
    if dsn_replays != DSN_STEPS - 1:
        fail(f"bank: dsn_train replayed {dsn_replays} steps, expected {DSN_STEPS - 1}")
    report["replays_cli"] = {"srn_train": replays, "dsn_train": dsn_replays}

    # the replayed windows against the eager loop, and a resume at the window
    # boundary: f32 at nb 2, then bf16 at full width, DASR and DSN
    dasr_banks = bank.SrnBanks(*(bank.upload(b, dev) for b in host_banks()))
    dasr_rows = np.stack(bank.epoch_rows(SEED, 0, 12, 6) * 8)[:2 * GRAPH_K]
    dasr_windows = [(w * GRAPH_K, torch.from_numpy(dasr_rows[w * GRAPH_K:(w + 1) * GRAPH_K])
                     .to(dev)) for w in range(2)]
    dsn_banks = [bank.upload(bank.build_bank(dsn_dirs[k]), dev) for k in ("target", "source")]
    dsn_rows = np.stack(sum((bank.epoch_rows(SEED, e, 48, 8) for e in range(1, 4)), []))
    dsn_windows = [(w * GRAPH_K, torch.from_numpy(dsn_rows[w * GRAPH_K:(w + 1) * GRAPH_K])
                    .to(dev)) for w in range(2)]

    def dasr_trainer(config):
        def make():
            m = create_model(parse_srn_options(config, is_train=True), dev)
            m.init()
            return m.trainer
        return make

    def dasr_window(tr, eager, start, rows):
        args = (dasr_banks, rows, start, 128)
        return looped(tr, *args) if eager else tr.train_banked_step(*args)

    def dsn_trainer(*extra):
        dsn_opt = dsn_train.build_argparser().parse_args(dsn_argv(base, dsn_dirs, *extra))

        def make():
            tr = dsn_train.make_trainer(dsn_opt, dev, 6)
            tr.init_state()
            return tr
        return make, dsn_opt

    make_dsn32, _ = dsn_trainer("--no_bf16", "--num_res_blocks", "2")
    make_dsn, dsn_opt = dsn_trainer()

    def dsn_window(tr, eager, start, rows):
        args = (*dsn_banks, rows, start, dsn_opt.crop_size, dsn_opt.flips, dsn_opt.rotations)
        return looped(tr, *args) if eager else tr.train_banked_step(*args)

    f32_limits = {"loss": (atol, rtol), "update": utol, "moment": mtol}
    t0 = time.perf_counter()
    report["replay"] = {
        what: replay_check(what, make, window, windows, limits,
                           os.path.join(base, what.replace(" ", "_")), gpu)
        for what, make, window, windows, limits in (
            ("dasr f32 nb 2", dasr_trainer(cfg32), dasr_window, dasr_windows, f32_limits),
            ("dsn f32 nb 2", make_dsn32, dsn_window, dsn_windows, f32_limits),
            ("dasr bf16 nb 23", dasr_trainer(cfg), dasr_window, dasr_windows, BF16_STEP_LIMITS),
            ("dsn bf16 nb 8", make_dsn, dsn_window, dsn_windows, BF16_STEP_LIMITS))}
    print(f"bank replay checks: {time.perf_counter() - t0:.2f} s", flush=True)
    del dasr_banks, dsn_banks

    # times in turns: the DASR step at full width on host batches, on the bank
    # by the eager loop, and on the bank replayed from the graph
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
    rows = torch.from_numpy(window).to(dev)
    # the eager arms are traced over one step: the tracer takes ~25 s for
    # each eager step of ~16k ops (eight of them took 200.89 s on the H100's host)
    srn = time_arms("dasr step", {
        "host loader": lambda: [tr.train_step(model._to_device(b)) for b in batches],
        "bank eager": lambda: looped(tr, model._banks, rows, 0, 128),
        "bank replayed": lambda: model.train_banked_window_async(window, 0)}, BANK_K, gpu,
        profiled={"host loader": (lambda: tr.train_step(model._to_device(batches[0])), 1),
                  "bank eager": (lambda: looped(tr, model._banks, rows[:1], 0, 128), 1),
                  "bank replayed": (lambda: model.train_banked_window_async(window[:2], 0), 2)})
    print(f"dasr step bank replayed: capture {srn['bank replayed']['capture_s']} s (once a "
          f"key; the warm-up step before it is a real step) [{gpu}]", flush=True)
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
        "bank eager": lambda: looped(trainer, clean, noisy, nwin, 0, 256),
        "bank replayed": lambda: trainer.train_banked_step(clean, noisy, nwin, 0, 256)},
        DSN_BANK_K, gpu)
    print(f"dsn step bank replayed: capture {dsn['bank replayed']['capture_s']} s [{gpu}]",
          flush=True)
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


def phase_tools(gpu, root, checked, checked_grad, dsn_ckpt):
    """The rest of the user surface: the reference .state resume (full width,
    f32, model against model, then srn_train through the CLI), val_batch,
    evaluate, dsn_test, auto_test and add_corruptions, with the RDB kernel's
    launches and shapes over the phase."""
    import shutil

    import torch
    from torch.nn.modules.module import register_module_forward_pre_hook

    from dasr_tpu_torch.cli import (add_corruptions, auto_test, dsn_create_dataset, dsn_test,
                                    evaluate, srn_train)
    from dasr_tpu_torch.core.config import check_resume, parse_srn_options
    from dasr_tpu_torch.data.datasets import create_dataset
    from dasr_tpu_torch.data.io import read_img_u8, save_img
    from dasr_tpu_torch.data.pipeline import Loader
    from dasr_tpu_torch.eval.evaluate import sr_metrics, to_uint8
    from dasr_tpu_torch.models.registry import create_model
    from dasr_tpu_torch.nn.blocks import RDB5C
    from dasr_tpu_torch.ops.rdb import LAUNCHES_PER_RDB, TOLERANCES, fused_rdb

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 4)
    tools = os.path.join(root, "tools")
    dirs = write_train_corpus(tools, rng)
    for i in range(2, TOOLS_VAL):  # TOOLS_VAL same-shape val pairs in all
        lr = rng.random((64, 64, 3), dtype=np.float32)
        save_img(lr, os.path.join(dirs["val_lr"], f"v{i}.png"))
        save_img(np.kron(lr, np.ones((4, 4, 1), np.float32)),
                 os.path.join(dirs["val_hr"], f"v{i}.png"))
    report = {}
    seen = set()

    def record(mod, args):
        if isinstance(mod, RDB5C):
            b, _, h, w = args[0].shape
            seen.add((b, h, w, args[0].dtype, torch.is_grad_enabled()))

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    zero_launches(fused_rdb)
    handle = register_module_forward_pre_hook(record)
    try:
        # the reference .state resume at full width, f32: two steps, the
        # reference formats, a fresh model (another seed) through check_resume
        # and load, then one step of both on one batch
        cfg32 = train_config(tools, dirs, "tools_resume", 3, bf16=False)
        opt = parse_srn_options(cfg32, is_train=True)
        ref = create_model(opt, dev)
        ref.init()
        loader = Loader(create_dataset(opt["datasets"]["train"]), batch_size=6, num_workers=6,
                        seed=0)
        batches = []
        while len(batches) < 3:  # 2 batches an epoch
            loader.set_epoch(len(batches) // len(loader))
            batches += list(loader)[:3 - len(batches)]
        for b in batches[:2]:
            ref.train_step(b)
        models = opt["path"]["models"]
        ref.save_reference_formats(models, 2)
        opt_r = parse_srn_options(cfg32, is_train=True)
        opt_r["path"]["resume_state"] = os.path.join(models, "2.state")
        resumed = create_model(check_resume(opt_r), dev)
        resumed.init(seed=SEED + 1)
        resumed.load()
        nets = {m: {"G": m.trainer.state.g, "D_target": m.trainer.state.d_target}
                for m in (ref, resumed)}
        def adam_tensors(ns):
            return [t for p in ns.params() for t in (
                p.detach(), ns.opt.state[p]["exp_avg"], ns.opt.state[p]["exp_avg_sq"])]

        for name, ns in nets[ref].items():
            got = nets[resumed][name]
            same = all(torch.equal(a, b) for a, b in zip(adam_tensors(ns), adam_tensors(got)))
            counts = (got.sched.last_epoch, got.opt.param_groups[0]["lr"])
            if not same or counts != (2, ns.opt.param_groups[0]["lr"]):
                fail(f"tools: {name} after load differs from the saved model (params and "
                     f"moments equal: {same}; count and lr {counts})")
        if resumed.step != 2:
            fail(f"tools: the resumed model is at step {resumed.step}, not 2")
        init = {name: flat(ns).clone() for name, ns in nets[ref].items()}
        runs, step_s = [], {}
        for model, label in ((resumed, "resumed"), (ref, "straight")):
            metrics, step_s[label] = timed(model.train_step, batches[2])
            runs.append(([metrics], init, {name: (flat(ns), flat(ns, True))
                                           for name, ns in nets[model].items()}))
        _, utol = TOLERANCES["train_update_f32"]
        _, mtol = TOLERANCES["train_moment_f32"]
        worst, parts, bad, _ = compare_three_steps("tools resume", *runs,
                                                   TOLERANCES["train_loss_f32"], utol, mtol)
        print(f"tools resume: nf {NC} nb {NB} gc {GC}, batch 6 + 6, HR 128, f32: 2 steps, "
              f"{os.path.join('models', '2.state')} and the .pth files, a fresh model (seed "
              f"{SEED + 1}) through check_resume and load: params and both Adam moments equal, "
              f"counts 2; step 3 from both on one batch: losses within {worst:.3f} of their "
              f"limit; {'; '.join(parts)}; step 3 took {1e3 * step_s['resumed']:.3f} ms "
              f"resumed, {1e3 * step_s['straight']:.3f} ms straight (host clock, synced) "
              f"[{gpu}]", flush=True)
        if bad:
            fail(f"tools resume: the resumed run's updates or moments of {bad} are off")
        report["tools_resume_step_ms"] = 1e3 * step_s["resumed"]
        del ref, resumed, nets, runs, loader

        # srn_train from the saved 2.state through the CLI to step 4, bf16,
        # validating with val_batch TOOLS_VAL and saving the reference formats
        cli_cfg = train_config(tools, dirs, "tools_cli", 4, val_batch=TOOLS_VAL)
        with open(cli_cfg) as f:
            cfg = json.load(f)
        cli_models = os.path.join(tools, "tools_cli", "models")
        shutil.copytree(models, cli_models)
        cfg["path"]["resume_state"] = os.path.join(cli_models, "2.state")
        cfg["logger"]["save_ref_formats"] = True
        with open(cli_cfg, "w") as f:
            json.dump(cfg, f)
        (steps, _), secs = timed(run_cli, srn_train.main, ["-opt", cli_cfg, "--device", "cuda"])
        with open(os.path.join(tools, "tools_cli", "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [r for r in recs if "loss/l_g_total" in r]
        val = [r for r in recs if "val/psnr" in r]
        if steps != 4 or [r["step"] for r in losses] != [3, 4] or not all(
                np.isfinite(v) for r in losses for k, v in r.items() if k.startswith("loss/")):
            fail(f"tools: srn_train from 2.state ran to {steps} with losses {losses}")
        if len(val) != 1 or not all(np.isfinite(val[0][f"val/{k}"])
                                    for k in ("psnr", "ssim", "lpips")):
            fail(f"tools: the val_batch validation is missing or not finite: {val}")
        if (TOOLS_VAL, 64, 64, torch.bfloat16, False) not in seen:
            fail(f"tools: the validation did not batch its {TOOLS_VAL} images")
        print(f"tools srn_train: resumed from 2.state (bf16) to step {steps} in {secs:.2f} s "
              f"through the CLI, losses finite at steps 3 and 4, one validation with val_batch "
              f"{TOOLS_VAL} ({TOOLS_VAL} images in one forward): "
              f"{({k: v for k, v in val[0].items() if k.startswith('val/')})}; TF32 off after "
              f"the CLI [{gpu}]", flush=True)

        # val_batch: test_batch_async on TOOLS_VAL same-shape images against
        # one test_async each, bf16, per-image PSNR / SSIM
        test_cfg = os.path.join(tools, "tools_val.json")
        with open(test_cfg, "w") as f:
            json.dump({"name": "tools_val", "model": "DASR", "scale": 4,
                       "network_G": cfg["network_G"],
                       "path": {"root": tools,
                                "pretrain_model_G": os.path.join(cli_models, "2_G.pth")}}, f)
        model = create_model(parse_srn_options(test_cfg, is_train=False), dev).init().load()
        vset = create_dataset({"name": "val", "mode": "LRHR", "phase": "val", "scale": 4,
                               "data_type": "img", "dataroot_HR": dirs["val_hr"],
                               "dataroot_LR": dirs["val_lr"]})
        items = [vset[i] for i in range(TOOLS_VAL)]
        batched = model.test_batch_async([d["LR"] for d in items]).cpu().numpy()
        singles = [model.test_async(d["LR"]).cpu().numpy() for d in items]
        errs = []
        for d, a, b in zip(items, batched, singles):
            ma, mb = (sr_metrics(to_uint8(v), to_uint8(d["HR"]), 4) for v in (a, b))
            errs.append((abs(ma["psnr"] - mb["psnr"]), abs(ma["ssim"] - mb["ssim"]),
                         float(np.abs(a - b).max())))
        dpsnr, dssim, dsr = (max(e[i] for e in errs) for i in range(3))
        print(f"tools val_batch: test_batch_async on {TOOLS_VAL} x 64x64 vs {TOOLS_VAL} "
              f"test_async calls, bf16, nb {NB}: per-image PSNR |err| {dpsnr:.2e} dB, SSIM "
              f"|err| {dssim:.2e} (limits {TOLERANCES['psnr_db'][0]}, {TOLERANCES['ssim'][0]}), "
              f"SR max|err| {dsr:.3e}", flush=True)
        if not (dpsnr <= TOLERANCES["psnr_db"][0] and dssim <= TOLERANCES["ssim"][0]):
            fail("tools: the batched val forward's metrics are off the per-image ones")
        del model

        # auto_test: the two {iter}_G.pth of the CLI run (2 copied, 4 saved)
        # over the serve corpus at full width, SR PNGs only
        serve = os.path.join(tools, "serve")
        write_corpus(serve, np.random.default_rng(SEED))
        sweep_cfg = os.path.join(tools, "tools_sweep.json")
        with open(sweep_cfg, "w") as f:
            json.dump({"name": "tools_sweep", "model": "DASR", "scale": 4,
                       "network_G": cfg["network_G"], "path": {"root": tools},
                       "datasets": {"test_1": {"name": "synth", "mode": "LR",
                                               "dataroot_LR": os.path.join(serve, "lr")}}}, f)
        sweep, secs = timed(run_cli, auto_test.main, ["-opt", sweep_cfg, "--models_dir",
                                                      cli_models, "--device", "cuda"])
        outs = {it: os.path.join(tools, "results", f"tools_sweep_{it}", "synth")
                for it in ("2", "4")}
        if list(sweep) != ["2", "4"] or any(len(os.listdir(d)) != len(LR_SIZES)
                                            for d in outs.values()):
            fail(f"tools: auto_test swept {list(sweep)}, expected the SR images of 2 and 4")
        print(f"tools auto_test: checkpoints {list(sweep)} over {len(LR_SIZES)} serve images "
              f"in {secs:.2f} s ({secs / (2 * len(LR_SIZES)):.3f} s/image, PNG writes "
              f"included) [{gpu}]", flush=True)
        report["auto_test_s_per_image"] = secs / (2 * len(LR_SIZES))
    finally:
        handle.remove()
    launches = read_launches(fused_rdb, "tools")
    # G forwards: 4 resume steps, 2 CLI steps and one batched validation, the
    # val_batch comparison's 1 + TOOLS_VAL, the sweep's 2 x len(LR_SIZES)
    forwards = 4 + 3 + 1 + TOOLS_VAL + 2 * len(LR_SIZES)
    expected = 3 * NB * LAUNCHES_PER_RDB * forwards
    missing = {k[:4] for k in seen} - checked
    missing |= {k[:4] for k in seen if k[4]} - checked_grad
    print(f"tools: fused_rdb launches {launches}, expected {3 * NB} x {LAUNCHES_PER_RDB} x "
          f"{forwards} = {expected}; kernel input shapes "
          f"{sorted((*k[:3], str(k[3]), k[4]) for k in seen)}", flush=True)
    if launches != expected:
        fail(f"tools: fused_rdb launched {launches} times, expected {expected}")
    if missing:
        fail(f"tools: kernel shapes phases 2 and 4 did not check: {missing}")
    report["launches_tools"] = launches

    # evaluate: the sweep's SR images of step 4 against their HR, three ways
    hr_dir = os.path.join(serve, "hr")
    evals = {}
    for name, flags in (("host", []), ("device", ["--device_metrics"]),
                        ("bucket", ["--device_metrics", "--pad_bucket", "64"])):
        evals[name], secs = timed(run_cli, evaluate.main, [
            "--dir_a", outs["4"], "--dir_b", hr_dir, "--device", "cuda", *flags])
        report[f"evaluate_s_per_pair_{name}"] = secs / len(LR_SIZES)
    dev_err = {k: abs(evals["device"][k] - v) for k, v in evals["host"].items()}
    bucket_err = {k: abs(evals["bucket"][k] - v) for k, v in evals["device"].items()}
    print(f"tools evaluate over {len(LR_SIZES)} pairs (HR of the LR sizes "
          f"{sorted(set(LR_SIZES))} x 4): host "
          f"{evals['host']}; device vs host |err| {dev_err} (limits 1e-3 dB, 1e-4 SSIM and "
          f"LPIPS); bucket 64 vs device |err| {bucket_err} (limit 1e-5); s/pair host "
          f"{report['evaluate_s_per_pair_host']:.3f}, device "
          f"{report['evaluate_s_per_pair_device']:.3f}, bucket "
          f"{report['evaluate_s_per_pair_bucket']:.3f} [{gpu}]", flush=True)
    if any(not v <= (1e-3 if k.startswith("psnr") else 1e-4) for k, v in dev_err.items()):
        fail(f"tools: evaluate --device_metrics is off the host path: {dev_err}")
    if any(not v <= 1e-5 for v in bucket_err.values()):
        fail(f"tools: evaluate --pad_bucket is off the unbucketed device path: {bucket_err}")

    # dsn_test --save_realness from the dsn phase's checkpoint on the
    # targets the dataset phase ran whole: its PNGs and DDMs
    targets = os.path.join(root, "dataset_corpus", "target")
    lrs = os.path.join(root, "dataset_out", "lrs")
    small = [f"t{i}_000" for i, (h, w) in enumerate(DATASET_SIZES)
             if h * w <= dsn_create_dataset.TILE_ABOVE]
    src = os.path.join(tools, "dsn_test_in")
    os.makedirs(src)
    for name in small:
        shutil.copy(os.path.join(targets, f"{name}.png"), src)
    out = os.path.join(tools, "dsn_test_out")
    _, secs = timed(run_cli, dsn_test.main, [
        "--checkpoint", dsn_ckpt, "--input_dir", src, "--output_dir", out, "--filter",
        "avg_pool", "--save_realness", "--device", "cuda"])
    ddm_err = 0.0
    for name in small:
        if not np.array_equal(read_img_u8(os.path.join(out, f"{name}.png")),
                              read_img_u8(os.path.join(lrs, "imgs_from_target", f"{name}.png"))):
            fail(f"tools: dsn_test's {name}.png differs from dsn_create_dataset's")
        got = np.load(os.path.join(out, f"{name}_ddm.npy"))
        want = np.load(os.path.join(lrs, "ddm_target", f"{name}.npy"))
        if got.shape != want.shape:
            fail(f"tools: dsn_test's DDM of {name} has shape {got.shape}, not {want.shape}")
        ddm_err = max(ddm_err, float(np.abs(got - want).max()))
    print(f"tools dsn_test --save_realness: {small} from the dsn phase's checkpoint in "
          f"{secs:.2f} s ({secs / len(small):.3f} s/image, f32 nets, PNG and NPY writes "
          f"included); PNGs equal dsn_create_dataset's, DDMs within {ddm_err:.3e} (limit "
          f"{DATASET_TILE_ATOL}) [{gpu}]", flush=True)
    if not ddm_err <= DATASET_TILE_ATOL:
        fail(f"tools: dsn_test's DDMs are {ddm_err:.3e} off dsn_create_dataset's")
    report["dsn_test_s_per_image"] = secs / len(small)

    # add_corruptions, all three modes, on the serve LR images
    lr_dir = os.path.join(serve, "lr")
    for mode in ("noise", "blur", "jpeg"):
        out = os.path.join(tools, f"corrupt_{mode}")
        add_corruptions.main(["--input_dir", lr_dir, "--output_dir", out, "--corruption", mode])
        for name in sorted(os.listdir(lr_dir)):
            a, b = (read_img_u8(os.path.join(d, name)) for d in (lr_dir, out))
            if a.shape != b.shape or np.array_equal(a, b):
                fail(f"tools: add_corruptions {mode} gave {name} of {b.shape} from {a.shape}, "
                     f"or left it unchanged")
    secs = time.perf_counter() - t_phase
    print(f"tools: add_corruptions noise, blur and jpeg kept the sizes of "
          f"{len(LR_SIZES)} images; the phase took {secs:.2f} s [{gpu}]", flush=True)
    report["tools_s"] = secs
    return report


def adaptive_config(root, dirs, name, niter, tar, patchd, nb=ADAPTIVE_NB, bf16=True,
                    print_freq=1, **train):
    """The shipped DASR Adaptive configuration (dasr_tpu_torch/configs/
    train_DASR_Adaptive.json) with the synthetic corpus, no DDMs (its mode
    is LRHR_unpair), the patch D from ``tar`` with ``patchd`` (its filter and
    kernel size) and ``train`` as more train options."""
    with open(os.path.join(ROOT, ADAPTIVE_CONFIG)) as f:
        cfg = json.load(f)
    cfg.update(name=name, bf16=bf16, use_tb_logger=False)
    cfg["path"] = {"root": root, "Patch_Discriminator": tar}
    cfg["datasets"]["train"].update(dataroot_HR=dirs["hr"], dataroot_fake_LR=dirs["fake"],
                                    dataroot_real_LR=dirs["real"], n_workers=6)
    cfg["datasets"]["val"].update(dataroot_HR=dirs["val_hr"], dataroot_LR=dirs["val_lr"])
    cfg["network_G"]["nb"] = nb
    cfg["network_patchD"].update(patchd)
    cfg["train"].update(niter=niter, val_freq=niter, **train)
    cfg["logger"] = {"print_freq": print_freq, "save_checkpoint_freq": niter}
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def adaptive_serve_config(root, name, chop, g_path, tar, patchd):
    cfg = {"name": name, "model": "DASR_Adaptive_Model", "scale": 4, "chop": chop,
           "val_lpips": False,
           "datasets": {"test_1": {"name": "synth", "mode": "LRHR",
                                   "dataroot_HR": os.path.join(root, "hr"),
                                   "dataroot_LR": os.path.join(root, "lr")}},
           "path": {"root": root, "pretrain_model_G": g_path, "Patch_Discriminator": tar},
           "network_G": {"which_model_G": "RRDB_Residual_conv", "nf": NC, "nb": ADAPTIVE_NB,
                         "gc": GC, "ada_nb": ADAPTIVE_NB_ADA},
           "network_patchD": {"which_patchD": "FSD", "norm_layer": "Instance", **patchd}}
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def phase_adaptive(gpu, root, checked, checked_grad, dsn_ckpt):
    """The DASR Adaptive model at the full width of train_DASR_Adaptive.json
    (RRDB_Residual_conv nf 64 nb 19 ada_nb 4, batch 2 + 2, HR 192, bf16), its
    patch D from the dsn phase's .tar: srn_train on the host loader and on
    the device bank (every step but the first replayed from the step graph),
    srn_test plain and chopped, each counted (345 kernel
    launches per generator forward); the step's times, host loader and
    device bank in turns; three f32 steps with the kernel against the plain
    version (resconv, and concat with the patch D trained), and banked
    against train_step on the same draws."""
    import contextlib

    import torch
    from torch.nn.modules.module import register_module_forward_pre_hook

    import dasr_tpu_torch.nn.blocks as blocks
    from dasr_tpu_torch.cli import srn_test, srn_train
    from dasr_tpu_torch.core.config import parse_srn_options
    from dasr_tpu_torch.data import device_bank as bank
    from dasr_tpu_torch.data.datasets import create_dataset
    from dasr_tpu_torch.data.pipeline import Loader
    from dasr_tpu_torch.models.registry import create_model
    from dasr_tpu_torch.nn.blocks import RDB5C
    from dasr_tpu_torch.ops.rdb import (
        LAUNCHES_PER_RDB, TOLERANCES, fused_rdb, fused_rdb_reference)
    from dasr_tpu_torch.train.checkpoints import load_dsn_tar
    from dasr_tpu_torch.utils import trace

    t_phase = time.perf_counter()
    laps = [t_phase]

    def lap(part):
        laps.append(time.perf_counter())
        report.setdefault("part_s", {})[part] = laps[-1] - laps[-2]

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    base = os.path.join(root, "adaptive")
    dirs = write_train_corpus(base, rng)
    tar = os.path.join(dsn_ckpt, "last_iteration.tar")
    meta = load_dsn_tar(tar)
    patchd = {"FS_type": meta["fs_type"], "kernel_size": meta["fs_kernel_size"]}
    per_forward = 3 * (ADAPTIVE_NB + ADAPTIVE_NB_ADA) * LAUNCHES_PER_RDB
    report, launches, seen = {}, {}, set()

    def record(mod, args):
        if isinstance(mod, RDB5C):
            b, _, h, w = args[0].shape
            seen.add((b, h, w, args[0].dtype, torch.is_grad_enabled()))

    def counted(label, fn, forwards):
        # one run of the main path: the count set to 0 just before it, read
        # just after, and held against 345 launches per generator forward
        zero_launches(fused_rdb)
        handle = register_module_forward_pre_hook(record)
        tee = Tee()
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(tee):
                out = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            handle.remove()
        n = read_launches(fused_rdb, "adaptive")
        print(f"adaptive {label}: fused_rdb launches {n}, expected {per_forward} x {forwards} "
              f"= {per_forward * forwards}; {secs:.2f} s", flush=True)
        if n != per_forward * forwards:
            fail(f"adaptive {label}: {n} kernel launches, expected {per_forward * forwards}")
        launches[label] = n
        return out, secs, "".join(tee.parts)

    def losses_of(name, steps, every):
        with open(os.path.join(base, name, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [r for r in recs if "loss/l_g_total" in r]
        val = [r for r in recs if "val/psnr" in r]
        if [r["step"] for r in losses] != list(range(every, steps + 1, every)) or not all(
                np.isfinite(v) for r in losses for k, v in r.items() if k.startswith("loss/")):
            fail(f"adaptive {name}: losses missing or not finite: {losses}")
        if len(val) != 1 or not all(np.isfinite(val[0][f"val/{k}"]) for k in ("psnr", "lpips")):
            fail(f"adaptive {name}: validation missing or not finite: {val}")
        if not os.path.exists(os.path.join(base, name, "training_state", f"{steps}.pt")):
            fail(f"adaptive {name}: the train state was not saved")
        return losses, val[0]

    # the main path, 1: srn_train on the host loader, one validation, one save
    cfg = adaptive_config(base, dirs, "ada_train", ADAPTIVE_STEPS, tar, patchd)
    (steps, _), secs, out = counted(
        "train", lambda: run_cli(srn_train.main, ["-opt", cfg, "--device", "cuda"]),
        ADAPTIVE_STEPS + 2)  # one G forward per step, one per validation image
    if steps != ADAPTIVE_STEPS or f"patch D: loaded from {tar}" not in out:
        fail(f"adaptive train: {steps} steps, or the patch D was not loaded from {tar}")
    losses, val = losses_of("ada_train", ADAPTIVE_STEPS, 1)
    print(f"adaptive train: {steps} steps in {secs:.2f} s through the CLI (host loader, patch D "
          f"from the dsn phase's .tar, {patchd}); losses step 1 -> {ADAPTIVE_STEPS}: "
          + ", ".join(f"{k.split('/')[-1]} {losses[0][k]:.4e} -> {losses[-1][k]:.4e}"
                      for k in sorted(losses[0]) if k.startswith("loss/"))
          + f"; validation {({k: v for k, v in val.items() if k.startswith('val/')})}",
          flush=True)
    lap("train")

    # the main path, 2: srn_train on the device bank, windows of 8, uint8
    cfg_bank = adaptive_config(base, dirs, "ada_bank", ADAPTIVE_BANK_STEPS, tar, patchd,
                               print_freq=ADAPTIVE_BANK_K)
    before = trace.counters()
    (steps, _), secs, out = counted(
        "bank", lambda: run_cli(srn_train.main, [
            "-opt", cfg_bank, "--device", "cuda", "--device_bank", "--steps_per_call",
            str(ADAPTIVE_BANK_K), "--transfer_uint8"]), ADAPTIVE_BANK_STEPS + 2)
    if (steps != ADAPTIVE_BANK_STEPS or "device bank: " not in out
            or "using the host loader" in out):
        fail(f"adaptive bank: {steps} steps, or srn_train did not train on the device bank")
    replays = read_replays()
    grown = {k: v - before.get(k, 0) for k, v in trace.counters().items()
             if k in ("graph.captures", "fused_rdb.bwd_kernel", "fused_rdb.bwd_chain")}
    if (replays != ADAPTIVE_BANK_STEPS - 1 or grown["graph.captures"] != 1
            or not grown["fused_rdb.bwd_kernel"] or grown["fused_rdb.bwd_chain"]):
        fail(f"adaptive bank: {replays} steps replayed from the step graph, expected "
             f"{ADAPTIVE_BANK_STEPS - 1} (the first is the warm-up), and one capture with the "
             f"backward through the kernels alone: {grown}")
    grown.update(check_weight_plan("adaptive bank", before, ADAPTIVE_BANK_STEPS,
                                   3 * (ADAPTIVE_NB + ADAPTIVE_NB_ADA)))
    losses, _ = losses_of("ada_bank", ADAPTIVE_BANK_STEPS, ADAPTIVE_BANK_K)
    print(f"adaptive bank: srn_train --device_bank --steps_per_call {ADAPTIVE_BANK_K} "
          f"--transfer_uint8: {steps} steps in {secs:.2f} s, {replays} replayed, {grown}; l_g_total "
          + " -> ".join(f"{r['loss/l_g_total']:.4e}" for r in losses) + "; "
          + [ln for ln in out.splitlines() if ln.startswith("device bank: ")][0], flush=True)
    lap("bank")

    # the main path, 3: srn_test plain and chopped, the G of the host run's
    # save, on the serve phase's images and one past the chop gate
    serve_root = os.path.join(base, "serve")
    os.makedirs(serve_root)
    write_corpus(serve_root, rng, ADAPTIVE_LR_SIZES)
    g_pt = os.path.join(base, "ada_train", "training_state", f"{ADAPTIVE_STEPS}.pt")
    n_img = len(ADAPTIVE_LR_SIZES)
    for chop in (False, True):
        name = f"ada_serve_{'chop' if chop else 'plain'}"
        scfg = adaptive_serve_config(serve_root, name, chop, g_pt, tar, patchd)
        avg, secs, _ = counted(name, lambda: run_cli(srn_test.main, [
            "-opt", scfg, "--device", "cuda", "--device_metrics", "--metrics_pad_bucket",
            "128"]), n_img)
        pngs = os.listdir(os.path.join(serve_root, "results", name, "synth"))
        vals = avg.get("synth", {})
        if len(pngs) != n_img or not vals or not all(np.isfinite(v) for v in vals.values()):
            fail(f"adaptive {name}: {len(pngs)} PNGs, metrics {vals}")
        print(f"adaptive {name}: {n_img} images ({ADAPTIVE_LR_SIZES} LR) in {secs:.2f} s, "
              f"{secs / n_img:.3f} s/image with device metrics (bucket 128) and PNG IO; "
              f"{vals} [{gpu}]", flush=True)
        report[f"serve_s_per_image_{'chop' if chop else 'plain'}"] = secs / n_img
    lap("serve")
    report["launches_adaptive"] = sum(launches.values())
    report["launches_by_run"] = dict(launches)

    shapes = sorted((*k[:3], str(k[3]), k[4]) for k in seen)
    print(f"adaptive: kernel input shapes {shapes}", flush=True)
    missing = {k[:4] for k in seen} - checked
    missing |= {k[:4] for k in seen if k[4]} - checked_grad
    if missing:
        fail(f"adaptive: the runs gave the kernel shapes phases 2 and 4 did not check: {missing}")

    # the forward alone at a serve image: ms/image
    model = create_model(parse_srn_options(scfg, is_train=False), dev)
    model.init()
    with contextlib.redirect_stdout(Tee()):
        model.load()
    lr = np.random.default_rng(SEED).random((256, 256, 3), dtype=np.float32)
    ms = cuda_ms(lambda: model.test_async(lr), warmup=2, iters=10)
    print(f"adaptive serve rate: 256x256 LR -> 1024x1024, bf16, patch D + G: {ms:.3f} ms/image "
          f"[{gpu}]", flush=True)
    report["serve_ms_per_image"] = ms
    del model
    lap("serve_rate")

    # the step's times: host-loader batches and device-bank windows in turns
    opt = parse_srn_options(cfg, is_train=True)
    model = create_model(opt, dev)
    model.init()
    with contextlib.redirect_stdout(Tee()):
        model.load()
    banks = bank.SrnBanks(bank.build_bank(dirs["fake"]), bank.build_bank(dirs["hr"]),
                          bank.build_bank(dirs["real"]), None)
    model.setup_device_bank(*banks, 192)
    opt["datasets"]["train"]["transfer_uint8"] = True
    loader = Loader(create_dataset(opt["datasets"]["train"]), batch_size=2, num_workers=6,
                    seed=0, pin_memory=True)
    batches = []
    while len(batches) < ADAPTIVE_BANK_K:
        loader.set_epoch(len(batches))
        batches += list(loader)[:ADAPTIVE_BANK_K - len(batches)]
    tr = model.trainer
    window = np.stack(bank.epoch_rows(SEED, 0, 12, 2) * 2)[:ADAPTIVE_BANK_K]
    report["step"] = time_arms("adaptive step", {
        "host loader": lambda: [tr.train_step(model._to_device(b)) for b in batches],
        "device bank": lambda: model.train_banked_window_async(window, 0)},
        ADAPTIVE_BANK_K, gpu, rounds=1, profiled={
            "host loader": (lambda: tr.train_step(model._to_device(batches[0])), 1),
            "device bank": (lambda: model.train_banked_window_async(window[:1], 0), 1)})
    del model, tr, batches
    lap("step_times")

    # held at f32 on the card, nb 2 (cuDNN off in both runs, see phase_grad):
    # the kernel against the plain version, and the banked window against
    # train_step on the plain gather's batches of the same draws
    atol, rtol = TOLERANCES["train_loss_f32"]
    _, utol = TOLERANCES["train_update_f32"]
    _, mtol = TOLERANCES["train_moment_f32"]

    def nets_of(model):
        st = model.trainer.state
        nets = {"G": st.g, "D_target": st.d_target}
        if model.cfg.use_patchD_opt:
            nets["patchD"] = st.patchd
        return nets

    def three_steps(what, cfg32, arms):
        # arms: (run, whether it launches the kernel), the reference last
        runs = []
        for arm, on_kernel in arms:
            with torch.backends.cudnn.flags(enabled=False), contextlib.redirect_stdout(Tee()):
                model = create_model(parse_srn_options(cfg32, is_train=True), dev)
                model.init()
                model.load()
                nets = nets_of(model)
                init = {name: flat(ns).clone() for name, ns in nets.items()}
                before = fused_rdb.launches
                traj = arm(model)
            launched = fused_rdb.launches - before
            if launched != 3 * 3 * (2 + ADAPTIVE_NB_ADA) * LAUNCHES_PER_RDB * on_kernel:
                fail(f"{what}: {launched} kernel launches in a run that should launch "
                     f"{'it' if on_kernel else 'none'}")
            runs.append((traj, init, {name: (flat(ns), flat(ns, True))
                                      for name, ns in nets.items()}))
        worst, parts, bad, perr = compare_three_steps(what, *runs, (atol, rtol), utol, mtol)
        print(f"{what}, 3 steps, on the card, cuDNN off: losses within {worst:.3f} of their "
              f"limit (atol {atol}, rtol {rtol}); |dtheta - dtheta_ref| / |dtheta_ref| and the "
              f"same of Adam's first moments (limits {utol}, {mtol}): {'; '.join(parts)}; "
              f"l_g_total {[round(t['loss/l_g_total'], 6) for t in runs[0][0]]}", flush=True)
        if bad:
            fail(f"{what}: the updates or moments of {bad} are off the reference run's")
        return perr

    def host_batches(cfg32):
        o = parse_srn_options(cfg32, is_train=True)
        loader = Loader(create_dataset(o["datasets"]["train"]), batch_size=2, num_workers=6,
                        seed=0)
        loader.set_epoch(0)
        return list(loader)[:3]

    def kernel(model, batches):
        return [model.train_step(b) for b in batches]

    def plain(model, batches):
        blocks.fused_rdb = fused_rdb_reference
        try:
            return kernel(model, batches)
        finally:
            blocks.fused_rdb = fused_rdb

    for flavor, train in (("RRDB_Residual_conv", {}),
                          ("RRDB_Residual_conv_concat", {"use_patchD_opt": True})):
        cfg32 = adaptive_config(base, dirs, f"ada_f32_{flavor}", 3, tar, patchd, nb=2,
                                bf16=False, **train)
        with open(cfg32) as f:
            c = json.load(f)
        c["network_G"]["which_model_G"] = flavor
        with open(cfg32, "w") as f:
            json.dump(c, f)
        batches = host_batches(cfg32)
        perr = three_steps(f"adaptive f32 {flavor} nb 2 {train or ''} kernel vs plain", cfg32,
                           [(lambda m: kernel(m, batches), True),
                            (lambda m: plain(m, batches), False)])
        report[f"f32_param_max_abs_err_{flavor}"] = perr
        lap(f"f32_{flavor}")

    idx = np.stack(bank.epoch_rows(SEED, 0, 12, 2))[:3]

    def banked(model):
        model.setup_device_bank(*banks, 192)
        return [model.metrics_to_host(model.train_banked_window_async(idx[s:s + 1], s))
                for s in range(3)]

    def stepped(model):
        model.setup_device_bank(*banks, 192)
        out = []
        for s in range(3):
            gen = bank.window_generator(model.trainer.cfg.seed, s, dev)
            d = bank.draw_dasr(gen, 2, 12, 12)
            b = bank.gather_dasr_plain(model._banks, torch.from_numpy(idx[s]).to(dev), d, 192, 4)
            out.append(model.metrics_to_host(model.trainer.train_step(
                {k: v.permute(0, 3, 1, 2) for k, v in b.items() if k != "fake_w"})))
        return out

    cfg32 = adaptive_config(base, dirs, "ada_f32_bank", 3, tar, patchd, nb=2, bf16=False)
    three_steps("adaptive f32 nb 2 banked vs train_step on the same draws", cfg32,
                [(banked, True), (stepped, True)])
    lap("f32_bank")
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"adaptive: the phase took {report['phase_s']:.2f} s [{gpu}]", flush=True)
    return report


def paired_config(root, dirs, name, run, niter, nb=None, bf16=True, print_freq=1):
    """The port's copy of the run's shipped config (``PAIRED_RUNS``) on the
    synthetic corpus, ``dataroot_LR`` null (the host bicubic), one
    validation and one save at ``niter``."""
    config, model, train = PAIRED_RUNS[run]
    with open(os.path.join(ROOT, "dasr_tpu_torch", "configs", config)) as f:
        cfg = json.load(f)
    cfg.update(name=name, model=model, bf16=bf16, use_tb_logger=False)
    cfg["path"] = {"root": root}
    cfg["datasets"]["train"].update(dataroot_HR=dirs["hr"], dataroot_LR=None, n_workers=6)
    cfg["datasets"]["val"].update(dataroot_HR=dirs["val_hr"], dataroot_LR=dirs["val_lr"])
    if nb is not None:
        cfg["network_G"]["nb"] = nb
    cfg["train"].update(niter=niter, val_freq=niter, **train)
    cfg["logger"] = {"print_freq": print_freq, "save_checkpoint_freq": niter}
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def paired_serve_config(root, name, config, chop, g_path, net_g=None):
    """The port's copy of a shipped test config on the serve corpus (its
    first test set), G from ``g_path``; ``net_g``: another network_G."""
    with open(os.path.join(ROOT, "dasr_tpu_torch", "configs", config)) as f:
        cfg = json.load(f)
    cfg.update(name=name, chop=chop)
    cfg["datasets"] = {"test_1": {"name": "synth", "mode": "LRHR",
                                  "dataroot_HR": os.path.join(root, "hr"),
                                  "dataroot_LR": os.path.join(root, "lr")}}
    cfg["path"] = {"root": root, "pretrain_model_G": g_path}
    if net_g is not None:
        cfg["network_G"] = net_g
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def phase_paired(gpu, root, checked, checked_grad):
    """The paired-data trainers ('sr' with RRDB_net and sr_resnet, 'srgan' /
    'srragan', 'De_Resnet') at the full width of their shipped configs:
    srn_train and srn_test, counted; test_x8; the srgan G gate; each step's
    times; three f32 srragan steps, the kernel against the plain version."""
    import contextlib

    import torch
    from torch.nn.modules.module import register_module_forward_pre_hook

    import dasr_tpu_torch.nn.blocks as blocks
    from dasr_tpu_torch.cli import srn_test, srn_train
    from dasr_tpu_torch.core.config import parse_srn_options
    from dasr_tpu_torch.data.datasets import create_dataset
    from dasr_tpu_torch.data.io import save_img
    from dasr_tpu_torch.data.pipeline import Loader
    from dasr_tpu_torch.models.registry import create_model
    from dasr_tpu_torch.nn.blocks import RDB5C
    from dasr_tpu_torch.ops.rdb import LAUNCHES_PER_RDB, TOLERANCES, fused_rdb, fused_rdb_reference

    t_phase = time.perf_counter()
    laps = [t_phase]
    report, launches, seen = {}, {}, set()

    def lap(part):
        laps.append(time.perf_counter())
        report.setdefault("part_s", {})[part] = laps[-1] - laps[-2]

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    base = os.path.join(root, "paired")
    dirs = {d: os.path.join(base, d) for d in ("hr", "val_hr", "val_lr")}
    for d in dirs.values():
        os.makedirs(d)
    for i in range(16):
        save_img(rng.random((192, 192, 3), dtype=np.float32),
                 os.path.join(dirs["hr"], f"{i:03d}.png"))
    for i in range(2):
        lr = rng.random((64, 64, 3), dtype=np.float32)
        save_img(lr, os.path.join(dirs["val_lr"], f"v{i}.png"))
        save_img(np.kron(lr, np.ones((4, 4, 1), np.float32)),
                 os.path.join(dirs["val_hr"], f"v{i}.png"))
    per_forward = 3 * NB * LAUNCHES_PER_RDB

    def record(mod, args):
        if isinstance(mod, RDB5C):
            b, _, h, w = args[0].shape
            seen.add((b, h, w, args[0].dtype, torch.is_grad_enabled()))

    def counted(label, fn, forwards):
        # one run of the main path: the count set to 0 just before it, read
        # just after, and held against 345 launches per generator forward
        zero_launches(fused_rdb)
        handle = register_module_forward_pre_hook(record)
        tee = Tee()
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(tee):
                out = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            handle.remove()
        n = read_launches(fused_rdb, "paired")
        print(f"paired {label}: fused_rdb launches {n}, expected {per_forward} x {forwards} = "
              f"{per_forward * forwards}; {secs:.2f} s", flush=True)
        if n != per_forward * forwards:
            fail(f"paired {label}: {n} kernel launches, expected {per_forward * forwards}")
        launches[label] = n
        return out, secs, "".join(tee.parts)

    # the main path, 1: srn_train of each model, one validation, one save
    for run, (_, model_name, _) in PAIRED_RUNS.items():
        cfg = paired_config(base, dirs, f"train_{run}", run, PAIRED_STEPS)
        rrdb = json.load(open(cfg))["network_G"]["which_model_G"] == "RRDB_net"
        (steps, _), secs, _ = counted(
            f"train {run}", lambda: run_cli(srn_train.main, ["-opt", cfg, "--device", "cuda"]),
            (PAIRED_STEPS + 2) * rrdb)  # one G forward a step and a validation image
        with open(os.path.join(base, f"train_{run}", "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [r for r in recs if any(k.startswith("loss/") for k in r)]
        val = [r for r in recs if "val/psnr" in r]
        if (steps != PAIRED_STEPS or [r["step"] for r in losses] != list(range(1, steps + 1))
                or not all(np.isfinite(v) for r in losses for k, v in r.items()
                           if k.startswith("loss/"))):
            fail(f"paired train {run}: {steps} steps, losses missing or not finite")
        if len(val) != 1 or not all(np.isfinite(v) for k, v in val[0].items()
                                    if k.startswith("val/")):
            fail(f"paired train {run}: validation missing or not finite: {val}")
        if not os.path.exists(os.path.join(base, f"train_{run}", "training_state",
                                           f"{PAIRED_STEPS}.pt")):
            fail(f"paired train {run}: the train state was not saved")
        print(f"paired train {run} ({model_name}): {steps} steps in {secs:.2f} s through the "
              f"CLI (host loader, host bicubic LR); losses step 1 -> {steps}: "
              + ", ".join(f"{k.split('/')[-1]} {losses[0][k]:.4e} -> {losses[-1][k]:.4e}"
                          for k in sorted(losses[0]) if k.startswith("loss/"))
              + f"; validation {({k: v for k, v in val[0].items() if k.startswith('val/')})} "
              f"[{gpu}]", flush=True)
        report[f"train_s_{run}"] = secs
    lap("train")

    # the main path, 2: srn_test plain and chopped from the saves
    serve_root = os.path.join(base, "serve")
    os.makedirs(serve_root)
    write_corpus(serve_root, rng)
    n_img = len(LR_SIZES)

    def pt(run):
        return os.path.join(base, f"train_{run}", "training_state", f"{PAIRED_STEPS}.pt")

    with open(os.path.join(ROOT, "dasr_tpu_torch", "configs", "train_SRGAN.json")) as f:
        rrdb_g = json.load(f)["network_G"]
    serves = [(f"{m}_{'chop' if chop else 'plain'}", config, chop, pt(run), net_g, True)
              for m, config, run, net_g in (("sr", "test_sr.json", "sr", None),
                                            ("srgan", "test_SRGAN.json", "srragan", rrdb_g))
              for chop in (False, True)]
    serves.append(("sr_resnet_plain", "test_SRResNet.json", False, pt("sr_resnet"), None, False))
    for name, config, chop, g_path, net_g, rrdb in serves:
        scfg = paired_serve_config(serve_root, name, config, chop, g_path, net_g)
        avg, secs, _ = counted(f"serve {name}", lambda: run_cli(srn_test.main, [
            "-opt", scfg, "--device", "cuda", "--device_metrics", "--metrics_pad_bucket",
            "128"]), n_img * rrdb)
        pngs = os.listdir(os.path.join(serve_root, "results", name, "synth"))
        vals = avg.get("synth", {})
        if len(pngs) != n_img or not vals or not all(np.isfinite(v) for v in vals.values()):
            fail(f"paired serve {name}: {len(pngs)} PNGs, metrics {vals}")
        print(f"paired serve {name}: {n_img} images ({LR_SIZES} LR) in {secs:.2f} s, "
              f"{secs / n_img:.3f} s/image with device metrics (bucket 128) and PNG IO; {vals} "
              f"[{gpu}]", flush=True)
        report[f"serve_s_per_image_{name}"] = secs / n_img
    report["launches_paired"] = sum(launches.values())
    report["launches_by_run"] = dict(launches)
    lap("serve")

    shapes = sorted((*k[:3], str(k[3]), k[4]) for k in seen)
    print(f"paired: kernel input shapes {shapes}", flush=True)
    missing = {k[:4] for k in seen} - checked
    missing |= {k[:4] for k in seen if k[4]} - checked_grad
    if missing:
        fail(f"paired: the runs gave the kernel shapes phases 2 and 4 did not check: {missing}")

    # SRModel.test_x8 against the mean of its eight dihedral forwards
    model = create_model(parse_srn_options(
        paired_serve_config(serve_root, "x8", "test_sr.json", False, pt("sr")), is_train=False),
        dev).init().load()
    lr = np.random.default_rng(SEED).random((64, 48, 3), dtype=np.float32)
    got = model.test_x8(lr)
    outs = []
    for k in range(8):
        t = np.rot90(lr, k % 4)
        t = t[:, ::-1] if k >= 4 else t
        sr = model.test(np.ascontiguousarray(t))
        sr = sr[:, ::-1] if k >= 4 else sr
        outs.append(np.rot90(sr, -(k % 4)))
    err = float(np.abs(got - np.mean(outs, axis=0)).max())
    print(f"paired test_x8 (64x48 LR, bf16): max |test_x8 - mean of the eight dihedral "
          f"forwards| {err:.3e} (limit 1e-5)", flush=True)
    if not err <= 1e-5:
        fail(f"paired test_x8: {err:.3e} off the mean of its eight forwards")
    report["test_x8_max_abs_err"] = err
    del model
    lap("test_x8")

    def build(cfg):
        opt = parse_srn_options(cfg, is_train=True)
        model = create_model(opt, dev)
        model.init()
        bs = int(opt["datasets"]["train"]["batch_size"])
        loader = Loader(create_dataset(opt["datasets"]["train"]), batch_size=bs, num_workers=6,
                        seed=0)
        batches = []
        while len(batches) < 4:
            loader.set_epoch(len(batches))
            batches += list(loader)[:4 - len(batches)]
        return model, batches

    # the srgan facade's G gate, D_update_ratio 2 and D_init_iters 2: G
    # moves on the 1-based iterations 4, 6, ..., so not in the first three
    model, batches = build(os.path.join(base, "train_srgan.json"))
    moved = []
    for b in batches:
        before = flat(model.trainer.state.g).clone()
        model.train_step(b)
        moved.append(not torch.equal(flat(model.trainer.state.g), before))
    print(f"paired srgan gate (D_update_ratio 2, D_init_iters 2): G moved at iterations "
          f"1-4: {moved}", flush=True)
    if moved != [False, False, False, True]:
        fail(f"paired srgan gate: G moved at {moved}, expected only at iteration 4")
    del model, batches
    lap("gate")

    # each model's step: two steps a call on host batches on the card, one
    # traced; srgan's step is srragan's with one D forward less and is not
    # timed apart
    steps = {}
    for run in ("sr", "srragan", "sr_resnet", "De_Resnet"):
        model, batches = build(os.path.join(base, f"train_{run}.json"))
        tr = model.trainer
        dev_batches = [model._to_device(b) for b in batches[:2]]
        torch.cuda.empty_cache()
        steps[run] = time_arms(
            f"paired {run} step", {run: lambda: [tr.train_step(b) for b in dev_batches]}, 2,
            gpu, rounds=1, profiled={run: (lambda: tr.train_step(dev_batches[0]), 1)})[run]
        del model, tr, batches, dev_batches
    report["step"] = steps
    lap("step_times")

    # three f32 srragan steps at nb 2, the kernel against the plain version,
    # cuDNN off (see phase_grad). A GAN with train_SRGAN.json's D (twelve
    # BatchNorm conv blocks) is chaotic at the rounding level, so both
    # versions take each of four steps from one state, each held to the
    # three-step limits: the losses, Adam's first moments over every element
    # (at step 1 they are 0.1 x the gradient itself), and the update over
    # every element but those of gradient noise. Adam scales an element's
    # step by its own gradient's size, so an element whose gradient the two
    # versions put apart by as much as the gradient itself (f32 noise, e.g.
    # D's conv biases that BatchNorm cancels, of exact gradient 0) and whose
    # updates point opposite ways moves about 2 lr apart, most of all at
    # step 1, before the moments hold a shared history. Each step prints
    # those elements' count and share of the update difference, and the
    # update difference with them in; the free-running trajectories and a
    # control of the plain version on LR inputs one f32 ulp apart are
    # printed beside.
    atol, rtol = TOLERANCES["train_loss_f32"]
    _, utol = TOLERANCES["train_update_f32"]
    _, mtol = TOLERANCES["train_moment_f32"]
    cfg32 = paired_config(base, dirs, "f32_srragan", "srragan", 4, nb=2, bf16=False)

    def snapshot(model):
        st = model.trainer.state
        return copy.deepcopy({"step": st.step, **{
            label: (ns.net.state_dict(), ns.opt.state_dict(), ns.sched.state_dict())
            for label, ns in (("G", st.g), ("D_target", st.d_target))}})

    def restore(model, snap):
        st = model.trainer.state
        st.step = snap["step"]
        for label, ns in (("G", st.g), ("D_target", st.d_target)):
            net_sd, opt_sd, sched_sd = copy.deepcopy(snap[label])
            ns.net.load_state_dict(net_sd)
            ns.opt.load_state_dict(opt_sd)
            ns.sched.load_state_dict(sched_sd)

    def nets_of(model):
        st = model.trainer.state
        return {"G": st.g, "D_target": st.d_target}

    def run(model, batches, plain):
        before = fused_rdb.launches
        if plain:
            blocks.fused_rdb = fused_rdb_reference
        try:
            out = [model.train_step(b) for b in batches]
        finally:
            blocks.fused_rdb = fused_rdb
        if (fused_rdb.launches - before) != (0 if plain else 2 * 3 * LAUNCHES_PER_RDB
                                              * len(batches)):
            fail(f"paired f32 ({'plain' if plain else 'kernel'}): "
                 f"{fused_rdb.launches - before} kernel launches")
        return out

    steps32 = []
    with torch.backends.cudnn.flags(enabled=False), contextlib.redirect_stdout(Tee()):
        model, batches = build(cfg32)
        start = snapshot(model)
        for i, b in enumerate(batches):
            snap = snapshot(model)
            nets = nets_of(model)
            init = {name: flat(ns) for name, ns in nets.items()}
            m0 = {name: flat(ns, True) for name, ns in nets.items()}
            beta1 = {name: ns.opt.param_groups[0]["betas"][0] for name, ns in nets.items()}
            ref = (run(model, [b], True), init,
                   {name: (flat(ns), flat(ns, True)) for name, ns in nets.items()})
            restore(model, snap)
            got = (run(model, [b], False), init,
                   {name: (flat(ns), flat(ns, True)) for name, ns in nets.items()})
            steps32.append((got, ref, m0, beta1))
        kernel_path = [t for (traj, _, _), _, _, _ in steps32 for t in traj]
        free = {}
        for name, perturb in (("plain", False), ("plain, LR one ulp up", True)):
            restore(model, start)
            bs = [dict(b, LR=np.nextafter(b["LR"], np.float32(2))) if perturb else b
                  for b in batches]
            free[name] = run(model, bs, True)
    worst, perr, noise_report = 0.0, 0.0, []
    for i, (got, ref, m0, beta1) in enumerate(steps32):
        (traj, init, nets), nets_r = got, ref[2]
        held, notes, step_report = {}, [], {}
        for name in nets_r:
            (p, m), (pr, mr) = nets[name], nets_r[name]
            # this step's gradients, from the shared moments before it
            g = (m - beta1[name] * m0[name]) / (1 - beta1[name])
            gr = (mr - beta1[name] * m0[name]) / (1 - beta1[name])
            noise = ((g - gr).abs() >= gr.abs()) & ((p - init[name]) * (pr - init[name]) < 0)
            d2 = (p - pr).square()
            share = (d2[noise].sum() / d2.sum()).item()
            upd_all = ((p - pr).norm() / (pr - init[name]).norm()).item()
            notes.append(f"{name} {int(noise.sum())} of {noise.numel()} elements, "
                         f"{share:.3f} of the squared update difference, update "
                         f"{upd_all:.3e} with them")
            step_report[name] = {"noise_elements": int(noise.sum()), "noise_share": share,
                                 "update_rel_err_all": upd_all}
            held[name] = (torch.where(noise, pr, p), m)
        w, parts, bad, err = compare_three_steps(f"paired f32 srragan step {i + 1}",
                                                 (traj, init, held), ref,
                                                 (atol, rtol), utol, mtol)
        print(f"paired f32 srragan nb 2 (train_SRGAN.json's widths, batch 8, HR 192), step "
              f"{i + 1} from one state, kernel vs plain version on the card, cuDNN off: "
              f"losses within {w:.3f} of their limit (atol {atol}, rtol {rtol}); "
              f"|dtheta_kernel - dtheta_plain| / |dtheta_plain| but at gradient noise, and "
              f"the same of Adam's first moments (limits {utol}, {mtol}): {'; '.join(parts)}; "
              f"at gradient noise with updates of opposite sign: {'; '.join(notes)}",
              flush=True)
        worst, perr = max(worst, w), max(perr, err)
        noise_report.append(step_report)
        if bad:
            fail(f"paired f32 step {i + 1}: the kernel's update or moments of {bad} are off "
                 f"the plain version's")
    report["f32_gradient_noise_by_step"] = noise_report

    def apart(traj):
        return max(abs(a[k] - b[k]) / (atol + rtol * abs(b[k]))
                   for a, b in zip(traj, free["plain"]) for k in b if k.startswith("loss/"))

    print(f"paired f32 srragan, free-running 4 steps, the largest loss difference from the "
          f"plain version's as a share of the loss limit: kernel {apart(kernel_path):.3f}, "
          f"plain on LR one ulp up {apart(free['plain, LR one ulp up']):.3f} (information)",
          flush=True)
    report["f32_free_running_loss_share"] = {"kernel": apart(kernel_path),
                                             "plain_lr_one_ulp": apart(
                                                 free["plain, LR one ulp up"])}
    del model, batches
    report["f32_param_max_abs_err"] = perr
    report["f32_worst_loss_share"] = worst
    lap("f32")
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"paired: the phase took {report['phase_s']:.2f} s [{gpu}]", flush=True)
    return report


DEPATCH_CONFIG = os.path.join("dasr_tpu_torch", "configs", "train_De_patch_wavelet_GAN.json")
DEPATCH_TEST_CONFIG = os.path.join("dasr_tpu_torch", "configs", "test_De_patch_wavelet_GAN.json")
DEPATCH_STEPS = 12
# the depatch phase's corpus: HR images, the real-LR references, and the
# realness-map test set (LR (h, w), its HR 4x)
DEPATCH_HR_SIZE, DEPATCH_REF_SIZE = (600, 600), (160, 160)
DEPATCH_TEST_LR = ((64, 64), (64, 80), (48, 64))
SFT_IMAGES = ((512, 512), (512, 512), (384, 512), (520, 516))  # HR (h, w), modcropped to 8
SFT_ATOL = 1e-4


def depatch_config(root, dirs, name, niter, nb=None, bf16=True, batch=None, hr_size=None,
                   save_freq=None, resume=None):
    """The port's copy of train_De_patch_wavelet_GAN.json on the synthetic
    corpus (``dataroot_LR`` null: the host bicubic of the HR crop), one
    validation and one save at ``niter`` unless ``save_freq``."""
    with open(os.path.join(ROOT, DEPATCH_CONFIG)) as f:
        cfg = json.load(f)
    cfg.update(name=name, bf16=bf16, use_tb_logger=False)
    cfg["path"] = {"root": root, "resume_state": resume}
    cfg["datasets"]["train"].update(dataroot_HR=dirs["hr"], dataroot_LR=None,
                                    dataroot_Trans_refer=dirs["ref"], n_workers=6)
    if batch is not None:
        cfg["datasets"]["train"].update(batch_size=batch, HR_size=hr_size)
    cfg["datasets"]["val"].update(dataroot_HR=dirs["test_hr"], dataroot_LR=dirs["test_lr"])
    if nb is not None:
        cfg["network_G"]["nb"] = nb
    cfg["train"].update(niter=niter, val_freq=niter)
    cfg["logger"] = {"print_freq": 1, "save_checkpoint_freq": save_freq or niter}
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def depatch_test_config(root, dirs, name, pt, bf16=True):
    """The port's test_De_patch_wavelet_GAN.json (save_RealorFake) on the
    test set, G and D from the train state ``pt``."""
    with open(os.path.join(ROOT, DEPATCH_TEST_CONFIG)) as f:
        cfg = json.load(f)
    cfg.update(name=name, bf16=bf16)
    cfg["datasets"]["test_1"].update(dataroot_HR=dirs["test_hr"], dataroot_LR=dirs["test_lr"])
    cfg["path"] = {"root": root, "pretrain_model_G": pt}
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def no_rdb_launch(label, fn):
    """One run of a main path that has no RDB: the kernel's count set to 0
    just before it and read just after; fails unless it stayed 0. Returns
    (fn's result, wall s)."""
    import torch

    from dasr_tpu_torch.ops.rdb import fused_rdb

    zero_launches(fused_rdb)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if fused_rdb.launches:
        fail(f"{label}: fused_rdb launched {fused_rdb.launches} times on a path without RDBs")
    print(f"{label}: fused_rdb launches 0 (the path has no RDB); {secs:.2f} s", flush=True)
    return out, secs


def phase_depatch(gpu, root):
    """'De_patch_wavelet_GAN' at the full width of the port's copy of
    train_De_patch_wavelet_GAN.json: srn_train (one validation, one save)
    and srn_test with save_RealorFake, counted; the step's times; at f32,
    nb 2: three steps on the card against the CPU, a run resumed from its
    {iter}.pt against the straight one, and the card's realness maps
    against the CPU's."""
    import torch

    from dasr_tpu_torch.cli import srn_test, srn_train
    from dasr_tpu_torch.core.config import parse_srn_options
    from dasr_tpu_torch.data.datasets import create_dataset
    from dasr_tpu_torch.data.io import save_img
    from dasr_tpu_torch.data.pipeline import Loader
    from dasr_tpu_torch.models.registry import create_model

    t_phase = time.perf_counter()
    report = {}
    rng = np.random.default_rng(SEED)
    base = os.path.join(root, "depatch")
    dirs = {d: os.path.join(base, d) for d in ("hr", "ref", "test_hr", "test_lr")}
    for d in dirs.values():
        os.makedirs(d)
    for i in range(12):
        save_img(rng.random((*DEPATCH_HR_SIZE, 3), dtype=np.float32),
                 os.path.join(dirs["hr"], f"{i:03d}.png"))
    for i in range(8):
        save_img(rng.random((*DEPATCH_REF_SIZE, 3), dtype=np.float32),
                 os.path.join(dirs["ref"], f"r{i}.png"))
    for i, (h, w) in enumerate(DEPATCH_TEST_LR):
        hr = rng.random((4 * h, 4 * w, 3), dtype=np.float32)
        save_img(hr, os.path.join(dirs["test_hr"], f"t{i}.png"))
        save_img(hr.reshape(h, 4, w, 4, 3).mean((1, 3)), os.path.join(dirs["test_lr"], f"t{i}.png"))

    # the main path, 1: srn_train at full width, one validation, one save
    cfg = depatch_config(base, dirs, "train", DEPATCH_STEPS)
    (steps, _), secs = no_rdb_launch("depatch train", lambda: run_cli(
        srn_train.main, ["-opt", cfg, "--device", "cuda"]))
    with open(os.path.join(base, "train", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r for r in recs if any(k.startswith("loss/") for k in r)]
    val = [r for r in recs if "val/psnr" in r]
    if (steps != DEPATCH_STEPS or [r["step"] for r in losses] != list(range(1, steps + 1))
            or not all(np.isfinite(v) for r in losses for k, v in r.items()
                       if k.startswith("loss/"))):
        fail(f"depatch train: {steps} steps, losses missing or not finite")
    if len(val) != 1 or not all(np.isfinite(v) for k, v in val[0].items() if k.startswith("val/")):
        fail(f"depatch train: validation missing or not finite: {val}")
    pt = os.path.join(base, "train", "training_state", f"{DEPATCH_STEPS}.pt")
    if not os.path.exists(pt):
        fail("depatch train: the train state was not saved")
    print(f"depatch train (De_Resnet nf 64 nb 22, FSD on 9 Haar bands, LPIPS alex seeded, batch "
          f"3, HR 512, bf16): {steps} steps in {secs:.2f} s through the CLI (host loader, host "
          f"bicubic LR); losses step 1 -> {steps}: "
          + ", ".join(f"{k.split('/')[-1]} {losses[0][k]:.4e} -> {losses[-1][k]:.4e}"
                      for k in sorted(losses[0]) if k.startswith("loss/"))
          + f"; validation G(HR) vs LR "
          f"{({k: v for k, v in val[0].items() if k.startswith('val/')})} [{gpu}]", flush=True)
    report["train_s"] = secs

    # the main path, 2: srn_test with save_RealorFake from that save
    tcfg = depatch_test_config(base, dirs, "serve", pt)
    avg, secs = no_rdb_launch("depatch serve", lambda: run_cli(
        srn_test.main, ["-opt", tcfg, "--device", "cuda"]))
    out = os.path.join(base, "results", "serve", "val_RealSR")
    for i, (h, w) in enumerate(DEPATCH_TEST_LR):
        rmap = np.load(os.path.join(out, f"t{i}_ddm.npy"))
        if rmap.shape != (1, 1, h // 2, w // 2) or not np.isfinite(rmap).all():
            fail(f"depatch serve: t{i}_ddm.npy {rmap.shape}, finite {np.isfinite(rmap).all()}")
    n_img = len(DEPATCH_TEST_LR)
    print(f"depatch serve (srn_test, save_RealorFake, bf16): {n_img} images (LR "
          f"{DEPATCH_TEST_LR}, G(HR) held against LR) in {secs:.2f} s, {secs / n_img:.3f} "
          f"s/image with the realness maps, host metrics and PNG/NPY IO; "
          f"{avg.get('val_RealSR')} [{gpu}]", flush=True)
    report["serve_s_per_image"] = secs / n_img

    def build(cfg_path, dev):
        opt = parse_srn_options(cfg_path, is_train=True)
        model = create_model(opt, dev)
        model.init()
        bs = int(opt["datasets"]["train"]["batch_size"])
        loader = Loader(create_dataset(opt["datasets"]["train"]), batch_size=bs, num_workers=6,
                        seed=0)
        return model, list(loader)[:3]

    # the step's times: two steps a call on host batches, one traced
    model, batches = build(cfg, torch.device("cuda"))
    tr = model.trainer
    dev_batches = [model._to_device(b) for b in batches[:2]]
    torch.cuda.empty_cache()
    report["step"] = time_arms(
        "depatch step (nf 64 nb 22, batch 3, HR 512, bf16)",
        {"depatch": lambda: [tr.train_step(b) for b in dev_batches]}, 2, gpu, rounds=2,
        profiled={"depatch": (lambda: tr.train_step(dev_batches[0]), 1)})["depatch"]
    del model, tr, batches, dev_batches
    torch.cuda.empty_cache()

    # three f32 steps at nb 2 (batch 2, HR 128), the card against the CPU,
    # from the same seeded init and host batches
    cfg32 = depatch_config(base, dirs, "f32", 3, nb=2, bf16=False, batch=2, hr_size=128)
    runs = {}
    for name in ("cuda", "cpu"):
        model, batches = build(cfg32, torch.device(name))
        st = model.trainer.state
        nets = {"G": st.g, "D": st.d_target}
        init = {k: torch.cat([p.detach().flatten().cpu() for p in ns.params()])
                for k, ns in nets.items()}
        traj = [model.train_step(b) for b in batches]
        after = {k: (torch.cat([p.detach().flatten().cpu() for p in ns.params()]),
                     torch.cat([ns.opt.state[p]["exp_avg"].flatten().cpu() for p in ns.params()]))
                 for k, ns in nets.items()}
        runs[name] = (traj, init, after)
    lim = DSN_F32_LIMITS
    worst, parts, bad, _ = compare_three_steps("depatch f32", runs["cuda"], runs["cpu"],
                                               lim["loss"], lim["update"], lim["moment"])
    print(f"depatch f32 nb 2 (batch 2, HR 128), 3 steps, the card vs the CPU: losses within "
          f"{worst:.3f} of their limit (atol {lim['loss'][0]}, rtol {lim['loss'][1]}); "
          f"|dtheta_card - dtheta_cpu| / |dtheta_cpu| and the same of Adam's first moments "
          f"(limits {lim['update']}, {lim['moment']}): {'; '.join(parts)}", flush=True)
    if bad:
        fail(f"depatch f32: the card's updates or moments of {bad} are off the CPU's")
    report["f32_worst_loss_share"] = worst

    # a run resumed from 2.pt against the straight run to 4 (f32, nb 2,
    # cuDNN deterministic): the saved 4.pt's weights and Adam moments
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True), \
            contextlib.redirect_stdout(Tee()):
        for name, resume in (("straight", None), ("resumed", os.path.join(
                base, "straight", "training_state", "2.pt"))):
            c = depatch_config(base, dirs, name, 4, nb=2, bf16=False, batch=2, hr_size=128,
                               save_freq=2, resume=resume)
            if run_cli(srn_train.main, ["-opt", c, "--device", "cuda"])[0] != 4:
                fail(f"depatch resume: the {name} run did not end at step 4")
    saved = {name: torch.load(os.path.join(base, name, "training_state", "4.pt"),
                              weights_only=True) for name in ("straight", "resumed")}
    diff = 0.0
    for label in ("G", "D_target"):
        a, b = saved["straight"][label], saved["resumed"][label]
        for k, v in a["net"].items():
            diff = max(diff, (b["net"][k].float() - v.float()).abs().max().item())
        for idx, s in a["opt"]["state"].items():
            diff = max(diff, (b["opt"]["state"][idx]["exp_avg"] - s["exp_avg"]).abs().max().item())
    print(f"depatch resume (f32 nb 2, batch 2, HR 128): 4.pt of the run resumed from 2.pt vs "
          f"the straight run, G and D weights and Adam first moments: max |diff| {diff:.3e} "
          f"(limit 2e-5)", flush=True)
    if not diff <= 2e-5:
        fail(f"depatch resume: the resumed run's 4.pt is {diff:.3e} off the straight run's")
    report["resume_max_abs_diff"] = diff

    # the realness maps at f32 on the card against the CPU's, from the
    # full-width save
    maps = {}
    for name in ("cuda", "cpu"):
        c = depatch_test_config(base, dirs, f"maps_{name}", pt, bf16=False)
        with contextlib.redirect_stdout(Tee()):
            # run_cli holds a card run to TF32 off; the CPU has none
            (run_cli if name == "cuda" else lambda main, argv: main(argv))(
                srn_test.main, ["-opt", c, "--device", name])
        maps[name] = [np.load(os.path.join(base, "results", f"maps_{name}", "val_RealSR",
                                           f"t{i}_ddm.npy")) for i in range(n_img)]
    err = max(float(np.abs(a - b).max()) for a, b in zip(maps["cuda"], maps["cpu"]))
    print(f"depatch realness maps, f32, full width: the card vs the CPU max |err| {err:.3e} "
          "(limit 1e-5)", flush=True)
    if not err <= 1e-5:
        fail(f"depatch realness maps: the card's are {err:.3e} off the CPU's")
    report["map_max_abs_err"] = err
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"depatch: the phase took {report['phase_s']:.2f} s [{gpu}]", flush=True)
    return report


def sft_reference_pth(path, rng, n_blocks=16):
    """A seeded reference-format SFT_Net state dict (sft_arch.py:40-75
    names), weights of variance 1 / fan_in."""
    import torch

    sd = {}

    def conv(name, cin, cout, k):
        sd[name + ".weight"] = torch.from_numpy(
            rng.normal(0, 1 / np.sqrt(cin * k * k), (cout, cin, k, k)).astype(np.float32))
        sd[name + ".bias"] = torch.from_numpy(rng.normal(0, 0.01, (cout,)).astype(np.float32))

    def sft_layer(prefix):
        for kind in ("scale", "shift"):
            conv(f"{prefix}.SFT_{kind}_conv0", 32, 32, 1)
            conv(f"{prefix}.SFT_{kind}_conv1", 32, 64, 1)

    conv("conv0", 3, 64, 3)
    for i in range(n_blocks):
        sft_layer(f"sft_branch.{i}.sft0")
        conv(f"sft_branch.{i}.conv0", 64, 64, 3)
        sft_layer(f"sft_branch.{i}.sft1")
        conv(f"sft_branch.{i}.conv1", 64, 64, 3)
    sft_layer(f"sft_branch.{n_blocks}")
    conv(f"sft_branch.{n_blocks + 1}", 64, 64, 3)
    for name, cin, cout in (("HR_branch.0", 64, 256), ("HR_branch.3", 64, 256),
                            ("HR_branch.6", 64, 64), ("HR_branch.8", 64, 3)):
        conv(name, cin, cout, 3)
    conv("CondNet.0", 8, 128, 4)
    for j in (2, 4, 6):
        conv(f"CondNet.{j}", 128, 128, 1)
    conv("CondNet.8", 128, 32, 1)
    torch.save(sd, path)
    return path


def phase_sft(gpu, root):
    """sftgan_test on the card with a seeded reference-format .pth (16
    blocks, 8-channel segmentation maps) over four images, counted; each
    image's output against the CPU's at f32; ms/image of the forward."""
    import torch

    from dasr_tpu_torch.cli import sftgan_test
    from dasr_tpu_torch.data.io import list_images, read_img, save_img
    from dasr_tpu_torch.models.registry import create_model
    from dasr_tpu_torch.ops.metrics import modcrop
    from dasr_tpu_torch.ops.resize import imresize_np

    t_phase = time.perf_counter()
    report = {}
    rng = np.random.default_rng(SEED)
    base = os.path.join(root, "sft")
    img_dir, seg_dir = os.path.join(base, "img"), os.path.join(base, "seg")
    os.makedirs(img_dir)
    os.makedirs(seg_dir)
    for i, (h, w) in enumerate(SFT_IMAGES):
        save_img(rng.random((h, w, 3), dtype=np.float32), os.path.join(img_dir, f"s{i}.png"))
        seg = rng.random((8, h - h % 8, w - w % 8), dtype=np.float32)
        seg /= seg.sum(0, keepdims=True)  # probability maps
        if i % 2:
            np.save(os.path.join(seg_dir, f"s{i}_bic.npy"), seg)
        else:
            torch.save(torch.from_numpy(seg), os.path.join(seg_dir, f"s{i}_bic.pth"))
    pth = sft_reference_pth(os.path.join(base, "SFTGAN_seeded.pth"), rng)
    argv = ["--model", pth, "--img_dir", img_dir, "--seg_dir", seg_dir]

    # the main path: sftgan_test on the card
    written, secs = no_rdb_launch("sft serve", lambda: run_cli(
        sftgan_test.main, argv + ["--out", os.path.join(base, "out_cuda"), "--device", "cuda"]))
    if len(written) != len(SFT_IMAGES):
        fail(f"sft serve: {len(written)} of {len(SFT_IMAGES)} images written")
    with contextlib.redirect_stdout(Tee()):
        sftgan_test.main(argv + ["--out", os.path.join(base, "out_cpu"), "--device", "cpu"])
    png = max(float(np.abs(read_img(p) - read_img(p.replace("out_cuda", "out_cpu"))).max())
              for p in written)
    print(f"sft serve (SFTNet 16 blocks, seeded reference-format .pth, f32): "
          f"{len(written)} images (HR {SFT_IMAGES}) in {secs:.2f} s, "
          f"{secs / len(written):.3f} s/image with PNG IO; PNGs vs the CPU CLI's: max "
          f"{png * 255:.0f} grey levels [{gpu}]", flush=True)
    if png > 1 / 255 + 1e-6:
        fail(f"sft serve: the card's PNGs are {png * 255:.1f} grey levels off the CPU's")

    # each image's f32 output on the card against the CPU's, and the
    # forward's ms/image
    nets = {d: create_model(sftgan_test.options(pth), d).load().g.to(d).eval()
            for d in ("cuda", "cpu")}
    err, ms = 0.0, []
    for path in list_images(img_dir):
        base_name = os.path.splitext(os.path.basename(path))[0]
        lr = imresize_np(modcrop(read_img(path), 8), 0.25)
        x = torch.from_numpy(np.ascontiguousarray(lr)).permute(2, 0, 1)[None]
        seg = torch.from_numpy(sftgan_test.load_seg(seg_dir, base_name))[None]
        with torch.no_grad():
            out = {d: nets[d](x.to(d), seg.to(d)).float().cpu() for d in nets}
            xc, sc = x.cuda(), seg.cuda()
            ms.append(cuda_ms(lambda: nets["cuda"](xc, sc), warmup=2, iters=10))
        err = max(err, (out["cuda"] - out["cpu"]).abs().max().item())
    print(f"sft forward, f32: the card vs the CPU max |err| {err:.3e} (limit {SFT_ATOL}); "
          f"{', '.join(f'{m:.3f}' for m in ms)} ms/image (CUDA events, LR "
          f"{[((h - h % 8) // 4, (w - w % 8) // 4) for h, w in SFT_IMAGES]}) [{gpu}]",
          flush=True)
    if not err <= SFT_ATOL:
        fail(f"sft forward: the card's output is {err:.3e} off the CPU's")
    report.update(serve_s_per_image=secs / len(written), max_abs_err=err, ms_per_image=ms)
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"sft: the phase took {report['phase_s']:.2f} s [{gpu}]", flush=True)
    return report


LPIPS_NETS = ("alex", "vgg", "squeeze")
LPIPS_RTOL = 1e-4  # the port's f32 net limit, card against CPU
LPIPS_BATCH, LPIPS_PATCH = 50, 64  # a BAPPS batch at the reference's load_size
LPIPS_PAIR = 1024  # an x4 SR output of a 256x256 LR image
AFC_TRIPLETS, JND_PAIRS = 600, 200
PARITY_LR = 256
PARITY_IMAGES = 4
DISTS_PAIRS = 4


def write_bapps(base, rng):
    """A BAPPS-layout corpus of 64x64 PNGs: 2afc (ref/ p0/ p1/ judge/), p0 and
    p1 two noise levels of ref, and jnd (p0/ p1/ same/)."""
    from PIL import Image

    afc, jnd = os.path.join(base, "2afc"), os.path.join(base, "jnd")
    for d in ("ref", "p0", "p1", "judge"):
        os.makedirs(os.path.join(afc, d))
    for d in ("p0", "p1", "same"):
        os.makedirs(os.path.join(jnd, d))
    shape = (LPIPS_PATCH, LPIPS_PATCH, 3)
    for i in range(AFC_TRIPLETS):
        ref = rng.integers(0, 256, shape)
        for d, noise in (("ref", 0), ("p0", int(rng.integers(5, 40))),
                         ("p1", int(rng.integers(5, 40)))):
            img = np.clip(ref + rng.integers(-noise, noise + 1, shape), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(afc, d, f"{i:04d}.png"))
        np.save(os.path.join(afc, "judge", f"{i:04d}.npy"), np.array([rng.random()], np.float32))
    for i in range(JND_PAIRS):
        p0 = rng.integers(0, 256, shape)
        noise = int(rng.integers(0, 40))
        p1 = np.clip(p0 + rng.integers(-noise, noise + 1, shape), 0, 255)
        Image.fromarray(p0.astype(np.uint8)).save(os.path.join(jnd, "p0", f"{i:04d}.png"))
        Image.fromarray(p1.astype(np.uint8)).save(os.path.join(jnd, "p1", f"{i:04d}.png"))
        np.save(os.path.join(jnd, "same", f"{i:04d}.npy"),
                np.array([float(noise < 10)], np.float32))
    return afc, jnd


def phase_lpips(gpu, root, checked):
    """LPIPS breadth and the tools: the three nets on the card against the
    CPU and timed; lpips_train train (vgg, the reference's defaults) and
    eval, with the step's times and three f32 steps card vs CPU;
    compute_dists pair, dirs and self; parity plain and chopped over a
    full-width nb-23 G, counted, against srn_test; test_dataloader and each
    script once."""
    import shutil

    import torch
    from torch.nn.modules.module import register_module_forward_pre_hook

    from dasr_tpu_torch.cli import compute_dists, lpips_train, parity, srn_test, test_dataloader
    from dasr_tpu_torch.data.bapps import TwoAFCDataset
    from dasr_tpu_torch.data.io import save_img
    from dasr_tpu_torch.losses.lpips import LPIPS, create_dist_model, load_lpips_params
    from dasr_tpu_torch.losses.lpips_train import Dist2LogitLayer, TwoAFCTrainer
    from dasr_tpu_torch.nn.blocks import RDB5C
    from dasr_tpu_torch.nn.generators import RRDBNet
    from dasr_tpu_torch.ops.rdb import LAUNCHES_PER_RDB, fused_rdb
    from dasr_tpu_torch.scripts import (extract_subimgs_single, misc_tools, net_interp,
                                        transfer_params)

    t_phase = time.perf_counter()
    report = {}
    rng = np.random.default_rng(SEED + 9)
    base = os.path.join(root, "lpips")
    os.makedirs(base)
    # seeded reference-format weights: torchvision alexnet, vgg16 and
    # squeezenet1_1 backbones (variance 2 / fan_in) and heads, as the CPU tests use
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_lpips_weights import write as write_lpips_weights

    files = {net: write_lpips_weights(pathlib.Path(base), net) for net in LPIPS_NETS}
    dev = torch.device("cuda")

    # 1. the nets, f32, the card against the CPU, and timed (CUDA events)
    for net in LPIPS_NETS:
        fns = {d: create_dist_model("net-lin", net, lin_path=files[net][1],
                                    backbone_path=files[net][0], device=torch.device(d))
               for d in ("cuda", "cpu")}
        for label, (b, hw) in (("batch", (LPIPS_BATCH, LPIPS_PATCH)), ("pair", (1, LPIPS_PAIR))):
            x0, x1 = (torch.from_numpy(rng.random((b, 3, hw, hw), dtype=np.float32) * 2 - 1)
                      for _ in range(2))
            want = fns["cpu"](x0, x1).flatten()
            c0, c1 = x0.to(dev), x1.to(dev)
            got = fns["cuda"](c0, c1).flatten().cpu()
            rel = float(((got - want).abs() / want.abs()).max())
            ms = cuda_ms(lambda: fns["cuda"](c0, c1), warmup=2, iters=10)
            print(f"lpips {net} f32 {b} x {hw}x{hw} pairs: the card vs the CPU max rel err "
                  f"{rel:.3e} (limit {LPIPS_RTOL}); {ms:.3f} ms per call (CUDA events) "
                  f"[{gpu}]", flush=True)
            if not rel <= LPIPS_RTOL:
                fail(f"lpips {net} {label}: the card is {rel:.3e} off the CPU")
            report[f"{net}_{label}_ms"] = ms
            report[f"{net}_{label}_max_rel_err"] = rel
        del fns
    torch.cuda.empty_cache()

    # 2. lpips_train at the reference's defaults (vgg, batch 50, load_size 64,
    # lr 1e-4, beta1 0.5): 1 + 1 epochs of 600 triplets, then eval
    afc, jnd = write_bapps(base, rng)
    bpath, lpath = files["vgg"]
    save_dir = os.path.join(base, "train")
    (trainer, secs) = no_rdb_launch("lpips_train train", lambda: run_cli(lpips_train.main, [
        "train", "--datasets", afc, "--net", "vgg", "--nepoch", "1", "--nepoch_decay", "1",
        "--batch_size", str(LPIPS_BATCH), "--lin_path", lpath, "--backbone", bpath,
        "--print_freq", "12", "--save_dir", save_dir, "--device", "cuda"]))
    steps = 2 * (AFC_TRIPLETS // LPIPS_BATCH)
    heads = torch.load(os.path.join(save_dir, "latest_net_.pth"), weights_only=True)
    if (trainer.opt.state[trainer.lins[0]]["step"] != steps
            or sorted(heads) != [f"lin{k}.model.1.weight" for k in range(5)]
            or not all(bool((v >= 0).all()) and bool(v.isfinite().all()) for v in heads.values())):
        fail(f"lpips_train train: not {steps} steps, or latest_net_.pth is not five "
             f"nonnegative finite heads")
    print(f"lpips_train train (vgg, batch {LPIPS_BATCH}, load_size {LPIPS_PATCH}, "
          f"{AFC_TRIPLETS} triplets, 1 + 1 epochs): {steps} steps in {secs:.2f} s through the "
          f"CLI, host decode included [{gpu}]", flush=True)
    report["train_s"] = secs
    evals = {}
    for mode, d in (("2afc", afc), ("jnd", jnd)):
        res, secs = no_rdb_launch(f"lpips_train eval {mode}", lambda: run_cli(lpips_train.main, [
            "eval", "--datasets", d, "--dataset_mode", mode, "--net", "vgg", "--lin_path",
            os.path.join(save_dir, "latest_net_.pth"), "--backbone", bpath, "--device", "cuda"]))
        evals[mode] = res[d]
        if not 0.0 <= res[d] <= 1.0:
            fail(f"lpips_train eval {mode}: score {res[d]}")
        report[f"eval_{mode}_s"] = secs
    print(f"lpips_train eval (vgg, the trained heads): 2afc {evals['2afc']:.4f} over "
          f"{AFC_TRIPLETS}, jnd mAP {evals['jnd']:.4f} over {JND_PAIRS} [{gpu}]", flush=True)

    # the step's times on device batches of the corpus, and three f32 steps
    # (the card against the CPU, the same init and batches)
    data = TwoAFCDataset(afc, LPIPS_PATCH)

    def batch(lo, device):
        items = [data[i] for i in range(lo, lo + LPIPS_BATCH)]
        out = {k: torch.from_numpy(np.stack([it[k] for it in items])).permute(0, 3, 1, 2)
               .contiguous().to(device) for k in ("ref", "p0", "p1")}
        out["judge"] = torch.from_numpy(
            np.stack([it["judge"] for it in items]).reshape(-1, 1, 1, 1)).to(device)
        return out

    def make_trainer(device):
        lp = load_lpips_params(LPIPS(net="vgg"), lin_path=lpath, backbone_path=bpath)
        rank = Dist2LogitLayer().init_weights(torch.Generator().manual_seed(1))
        return TwoAFCTrainer(lp.to(device), rank.to(device), lr=1e-4, beta1=0.5)

    tr = make_trainer(dev)
    dev_batches = [batch(i * LPIPS_BATCH, dev) for i in range(2)]
    zero_launches(fused_rdb)
    report["step"] = time_arms(
        f"lpips 2afc step (vgg, batch {LPIPS_BATCH}, {LPIPS_PATCH}x{LPIPS_PATCH}, f32)",
        {"vgg": lambda: [tr.step(b) for b in dev_batches]}, 2, gpu, rounds=2)["vgg"]
    if fused_rdb.launches:
        fail("lpips 2afc step: fused_rdb launched on a path without RDBs")
    runs = {}
    for name in ("cuda", "cpu"):
        t = make_trainer(torch.device(name))
        params = {"heads": t.lins, "rank": list(t.rank.parameters())}
        init = {k: torch.cat([p.detach().flatten().cpu() for p in ps]) for k, ps in params.items()}
        traj = [{"loss/bce": float(t.step(batch(i * LPIPS_BATCH, torch.device(name)))["loss"])}
                for i in range(3)]
        after = {k: (torch.cat([p.detach().flatten().cpu() for p in ps]),
                     torch.cat([t.opt.state[p]["exp_avg"].flatten().cpu() for p in ps]))
                 for k, ps in params.items()}
        runs[name] = (traj, init, after)
    lim = DSN_F32_LIMITS
    worst, parts, bad, _ = compare_three_steps("lpips 2afc f32", runs["cuda"], runs["cpu"],
                                               lim["loss"], lim["update"], lim["moment"])
    print(f"lpips 2afc f32 (vgg, batch {LPIPS_BATCH}), 3 steps, the card vs the CPU: losses "
          f"within {worst:.3f} of their limit; {'; '.join(parts)} (limits {lim['update']}, "
          f"{lim['moment']})", flush=True)
    if bad:
        fail(f"lpips 2afc f32: the card's updates or moments of {bad} are off the CPU's")
    report["f32_worst_loss_share"] = worst
    del tr, dev_batches
    torch.cuda.empty_cache()

    # 3. compute_dists: pair, dirs (-o, --html, vgg) and self over 1024x1024 pairs
    d0, d1 = os.path.join(base, "d0"), os.path.join(base, "d1")
    os.makedirs(d0)
    os.makedirs(d1)
    for i in range(DISTS_PAIRS):
        a = rng.random((LPIPS_PAIR, LPIPS_PAIR, 3), dtype=np.float32)
        save_img(a, os.path.join(d0, f"p{i}.png"))
        save_img(np.clip(a + 0.05 * (i + 1) * rng.standard_normal(a.shape, dtype=np.float32),
                         0, 1), os.path.join(d1, f"p{i}.png"))
    d, secs = no_rdb_launch("compute_dists pair", lambda: run_cli(compute_dists.main, [
        "pair", "-p0", os.path.join(d0, "p0.png"), "-p1", os.path.join(d1, "p0.png"),
        "--backbone", files["alex"][0], "--device", "cuda"]))
    report["pair_s"] = secs
    mean, secs = no_rdb_launch("compute_dists dirs", lambda: run_cli(compute_dists.main, [
        "dirs", "-d0", d0, "-d1", d1, "-o", os.path.join(base, "dists.txt"), "--html",
        os.path.join(base, "html"), "--net", "vgg", "--backbone", bpath, "--device", "cuda"]))
    lines = open(os.path.join(base, "dists.txt")).read().splitlines()
    if (len(lines) != DISTS_PAIRS or not np.isfinite(mean) or not np.isfinite(d)
            or len(os.listdir(os.path.join(base, "html", "images"))) != 2 * DISTS_PAIRS):
        fail(f"compute_dists: {len(lines)} lines, mean {mean}, pair {d}, or the report is short")
    report["dirs_s_per_pair"] = secs / DISTS_PAIRS
    self_mean, secs = no_rdb_launch("compute_dists self", lambda: run_cli(compute_dists.main, [
        "self", "-d", d1, "--net", "squeeze", "--backbone", files["squeeze"][0],
        "--device", "cuda"]))
    report["self_s_per_pair"] = secs / (DISTS_PAIRS - 1)
    print(f"compute_dists (net-lin, seeded backbones, {LPIPS_PAIR}x{LPIPS_PAIR}): pair (alex) "
          f"{d:.4f} in {report['pair_s']:.3f} s; dirs (vgg, -o, --html) mean {mean:.6f}, "
          f"{report['dirs_s_per_pair']:.3f} s/pair; self (squeeze) mean {self_mean:.6f}, "
          f"{report['self_s_per_pair']:.3f} s/pair (PNG decode and model build included) "
          f"[{gpu}]", flush=True)

    # 4. parity over four 256x256 LR images, plain and --chop, a seeded nb-23
    # reference-format G, counted; srn_test on the same weights and images
    pdir = os.path.join(base, "parity")
    write_corpus(pdir, rng, sizes=((PARITY_LR, PARITY_LR),) * PARITY_IMAGES)
    g_pth = os.path.join(pdir, "rrdb_x4_G.pth")
    net = RRDBNet(nf=NC, nb=NB, gc=GC).init_weights(torch.Generator().manual_seed(SEED))
    torch.save(net.state_dict(), g_pth)
    del net
    seen = set()

    def record(mod, args):
        if isinstance(mod, RDB5C):
            b, _, h, w = args[0].shape
            seen.add((b, h, w, args[0].dtype))

    pargs = ["--g_pth", g_pth, "--lpips_backbone", files["alex"][0], "--lpips_lin",
             files["alex"][1], "--hr_dir", os.path.join(pdir, "hr"), "--lr_dir",
             os.path.join(pdir, "lr"), "--nb", str(NB), "--nf", str(NC), "--gc", str(GC),
             "--device", "cuda"]
    avgs, secs = {}, {}
    zero_launches(fused_rdb)
    handle = register_module_forward_pre_hook(record)
    try:
        for how, flags in (("plain", []), ("chop", ["--chop"])):
            t0 = time.perf_counter()
            avgs[how] = run_cli(parity.main, pargs + flags + [
                "--out", os.path.join(pdir, f"parity_{how}.md")])
            torch.cuda.synchronize()
            secs[how] = time.perf_counter() - t0
    finally:
        handle.remove()
    launches = read_launches(fused_rdb, "lpips")
    forwards = 2 * PARITY_IMAGES  # one per image and run (chop batches its tiles)
    expected = 3 * NB * LAUNCHES_PER_RDB * forwards
    print(f"parity: fused_rdb launches {launches}, expected {3 * NB} x {LAUNCHES_PER_RDB} x "
          f"{forwards} = {expected}; kernel input shapes "
          f"{sorted((*k[:3], str(k[3])) for k in seen)}", flush=True)
    if launches != expected:
        fail(f"parity: fused_rdb launched {launches} times, expected {expected}")
    if seen - checked:
        fail(f"parity: kernel shapes phase 2 did not check: {seen - checked}")
    report["launches_lpips"] = launches
    for how in avgs:
        if not all(np.isfinite(v) for v in avgs[how].values()):
            fail(f"parity {how}: metrics not finite: {avgs[how]}")
        cfg = serve_config(pdir, f"srn_{how}", how == "chop", g_pth)
        with contextlib.redirect_stdout(Tee()):
            want = run_cli(srn_test.main, ["-opt", cfg, "--device", "cuda"])["synth"]
        errs = {k: abs(avgs[how][k] - want[k]) for k in want}
        print(f"parity {how} (nb 23, bf16, LPIPS alex seeded): {avgs[how]}; "
              f"{secs[how] / PARITY_IMAGES:.3f} s/image with host metrics and LPIPS; against "
              f"srn_test on the same weights and images: "
              + ", ".join(f"{k} |err| {v:.2e}" for k, v in errs.items())
              + f" (limits 0.01 dB, 1e-4 SSIM) [{gpu}]", flush=True)
        if any(not v <= (0.01 if k.startswith("psnr") else 1e-4) for k, v in errs.items()):
            fail(f"parity {how}: PSNR/SSIM differ from srn_test's: {errs}")
        report[f"parity_{how}_s_per_image"] = secs[how] / PARITY_IMAGES

    # 5. test_dataloader and each script once, as entry points
    tdir = os.path.join(base, "dataloader")
    dirs = write_train_corpus(tdir, rng)
    with contextlib.redirect_stdout(Tee()):
        test_dataloader.main(["-opt", train_config(tdir, dirs, "vis", 1), "--out",
                              os.path.join(tdir, "vis"), "--n", "2"])
        hr, lr = os.path.join(pdir, "hr"), os.path.join(pdir, "lr")
        sdir = os.path.join(base, "scripts")
        extract_subimgs_single.main(["--input_dir", hr, "--save_dir", os.path.join(sdir, "sub"),
                                     "--crop_sz", "480", "--step", "240"])
        out = lambda name: os.path.join(sdir, name)  # noqa: E731
        shutil.copytree(lr, out("renamed"))
        tools = [["back_projection", "--sr_dir", hr, "--lr_dir", lr, "--out", out("bp"),
                  "--iters", "2"],
                 ["make_video", "--input_dir", hr, "--out", out("v.mp4")],
                 ["rename", "--input_dir", out("renamed")],
                 ["color2gray", "--input_dir", lr, "--out", out("gray")],
                 ["generate_mod_lr_bic", "--input_dir", hr, "--out", out("modbic")],
                 ["extract_enlarge_patches", "--input_dir", hr, "--out", out("figs"),
                  "--h_start", "16", "--w_start", "16"],
                 ["rf_table", "--net", "FSD"],
                 ["param_count"]]
        for argv in tools:
            misc_tools.main(argv)
        try:
            misc_tools.main(["create_lmdb", "--input_dir", lr, "--out", out("lr.lmdb")])
        except SystemExit as e:  # gated where the lmdb module is absent, as in JAX
            if "lmdb" not in str(e):
                raise
        psnr_g = os.path.join(sdir, "b_G.pth")
        torch.save(RRDBNet(nf=NC, nb=NB, gc=GC).init_weights(
            torch.Generator().manual_seed(SEED + 1)).state_dict(), psnr_g)
        net_interp.main(["--net_psnr", g_pth, "--net_gan", psnr_g, "--out", out("interp_G.pth")])
        x2 = os.path.join(sdir, "x2_G.pth")
        torch.save(RRDBNet(nf=NC, nb=NB, gc=GC, upscale=2).init_weights(
            torch.Generator().manual_seed(SEED)).state_dict(), x2)
        transfer_params.main(["--src", x2, "--out", out("x4_G.pth")])
    written = {name: len(os.listdir(p)) for name, p in (
        ("dataloader", os.path.join(tdir, "vis")), ("subimgs", out("sub")), ("bp", out("bp")),
        ("gray", out("gray")), ("figs/patch", out("figs/patch")))}
    print(f"lpips tools: test_dataloader and the scripts ran: files {written}", flush=True)
    if not all(written.values()):
        fail(f"lpips tools: an entry point wrote nothing: {written}")
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"lpips: the phase took {report['phase_s']:.2f} s [{gpu}]", flush=True)
    return report


# -- phase ablation: the experiment tools ---------------------------------------

# make_synth_corpus --noise_mode textured: 24 targets of 512x512, 48 sources
# (256x256 content downscaled to 128x128 LRs), 4 val pairs of 256x384
ABLATION_CORPUS = ("--n_target", "24", "--n_source", "48", "--n_valid", "4", "--hr_h", "512",
                   "--hr_w", "512", "--valid_h", "256", "--valid_w", "384")
ABLATION_DSN_EPOCHS = 2  # 48 sources, batch 8: 6 steps an epoch
ABLATION_NITER = 32  # a run: four windows of 8 steps, a validation after each
DRYRUN_LR = ((256, 256), (540, 600))  # the dry-run's LR images: one below, one past 320000 px
# what the ablation phase gives the kernel beyond the other phases: stage 4's
# validation and stage 5 on the 64x96 val LRs whole (bf16), and the f32
# dry-run's chop of its two images into 2 x 2 tiles of 148x148 and 290x320
ABLATION_SHAPES = ((1, 64, 96), (4, 148, 148), (4, 290, 320))


def phase_ablation(gpu, root, checked, checked_grad):
    """The experiment tools as a user runs them: make_synth_corpus (a
    textured corpus), ddm_ablation with --skip_train (stages 1-3, counted: no
    RDB) and then with --skip_dsn --skip_dataset (stages 3-5 at the
    template's full width, counted), and parity_dryrun at nb 23, f32,
    counted, within the nb 23 f32 network limit."""
    import torch
    from torch.nn.modules.module import register_module_forward_pre_hook

    from dasr_tpu_torch.nn.blocks import RDB5C
    from dasr_tpu_torch.ops.rdb import LAUNCHES_PER_RDB, TOLERANCES, fused_rdb
    from dasr_tpu_torch.tools import ddm_ablation, parity_dryrun

    t_phase = time.perf_counter()
    base = os.path.join(root, "ablation")
    corpus, work = os.path.join(base, "corpus"), os.path.join(base, "work")
    report = {}

    # 1. the corpus, through the module's entry point
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dasr_tpu_torch.tools.make_synth_corpus",
                           "--out", corpus, "--noise_mode", "textured", *ABLATION_CORPUS,
                           "--workers", "8"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    report["corpus_s"] = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"make_synth_corpus failed: {proc.stderr[-2000:]}")
    counts = {d: len(os.listdir(os.path.join(corpus, d)))
              for d in ("target", "source", "valid_hr", "valid_lr")}
    if counts != {"target": 24, "source": 48, "valid_hr": 4, "valid_lr": 4} or not \
            os.path.exists(os.path.join(corpus, "paths.yml")):
        fail(f"make_synth_corpus wrote {counts}")
    print(f"ablation corpus: {counts} in {report['corpus_s']:.2f} s", flush=True)

    # 2. stages 1-3 (--skip_train: stage 4 writes the configs, stage 5 finds
    # no run), counted: the DSN stages run no RDB
    seen = set()

    def record(mod, args):
        if isinstance(mod, RDB5C):
            b, _, h, w = args[0].shape
            seen.add((b, h, w, args[0].dtype, torch.is_grad_enabled()))

    argv = ["--corpus", corpus, "--work", work, "--dsn_epochs", str(ABLATION_DSN_EPOCHS),
            "--niter", str(ABLATION_NITER), "--device", "cuda"]
    zero_launches(fused_rdb)
    t0 = time.perf_counter()
    first = run_cli(ddm_ablation.main, argv + ["--skip_train"])
    report["stages_1_3_s"] = time.perf_counter() - t0
    launches = read_launches(fused_rdb, "ablation")
    if launches:
        fail(f"ablation stages 1-3: fused_rdb launched {launches} times (no RDB there)")
    ckpts = os.listdir(os.path.join(work, "DSN_experiments", "dsn_abl", "checkpoints"))
    res = os.path.join(work, "DSN_results", "abl")
    fakes = os.listdir(os.path.join(res, "imgs_from_target"))
    ddms = [np.load(os.path.join(res, "ddm_target", f))
            for f in sorted(os.listdir(os.path.join(res, "ddm_target")))]
    stats = first["ddm_stats"]
    if ("last_iteration.tar" not in ckpts or len(fakes) != 24 or len(ddms) != 24
            or not all(d.ndim == 4 and np.isfinite(d).all() and 0 <= d.min() and d.max() <= 1
                       for d in ddms)):
        fail(f"ablation stages 1-2: checkpoints {ckpts}, {len(fakes)} fake LRs, {len(ddms)} DDMs")
    if stats["corr_ddm_vs_texture_mean"] is None or not all(np.isfinite(v)
                                                           for v in stats.values()):
        fail(f"ablation stage 3: {stats}")
    if first["runs"]:
        fail(f"ablation --skip_train evaluated runs: {first['runs']}")
    print(f"ablation stages 1-3 (dsn_train {ABLATION_DSN_EPOCHS} epochs, dsn_create_dataset, "
          f"DDM localization over {len(fakes)} fake LRs): {json.dumps(stats)}; "
          f"{report['stages_1_3_s']:.2f} s, 0 kernel launches [{gpu}]", flush=True)

    # 3. stages 3-5: the two full-width DASR runs and their region-split eval,
    # counted: every RDB forward launched the kernel
    zero_launches(fused_rdb)
    handle = register_module_forward_pre_hook(record)
    t0 = time.perf_counter()
    try:
        results = run_cli(ddm_ablation.main, argv + ["--skip_dsn", "--skip_dataset"])
        torch.cuda.synchronize()
    finally:
        handle.remove()
    report["stages_3_5_s"] = time.perf_counter() - t0
    launches = read_launches(fused_rdb, "ablation")
    # stage 4's srn_train runs host-loader windows (train_multi_step_async,
    # as JAX's tool runs _train_multi), which no graph replays yet
    report["replays_stage_4"] = read_replays()
    forwards, vals = 0, {}
    for name in ("abl_mw_on", "abl_mw_off"):
        run = os.path.join(work, "SRN_experiments", name)
        with open(os.path.join(run, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        # the template logs losses every 200 steps: a short run is held by its
        # validations and its saved networks
        vals[name] = [r for r in recs if "val/psnr" in r]
        state = os.path.join(run, "training_state", f"{ABLATION_NITER}.pt")
        nets = torch.load(state, map_location="cpu", weights_only=True) \
            if os.path.exists(state) else {}
        if not vals[name] or not all(np.isfinite(v) for r in recs for k, v in r.items()
                                     if k.startswith(("val/", "loss/"))):
            fail(f"ablation stage 4 {name}: no validation, or a metric not finite")
        if not nets or not all(bool(t.isfinite().all()) for net in ("G", "D_target")
                               for t in nets[net]["net"].values() if t.is_floating_point()):
            fail(f"ablation stage 4 {name}: {state} missing, or a parameter not finite")
        # a G forward a step, one a val image a validation, one a val image in stage 5
        forwards += ABLATION_NITER + (len(vals[name]) + 1) * counts["valid_lr"]
    expected = 3 * NB * LAUNCHES_PER_RDB * forwards
    print(f"ablation stages 4-5: fused_rdb launches {launches}, expected {3 * NB} x "
          f"{LAUNCHES_PER_RDB} x {forwards} = {expected}; kernel input shapes "
          f"{sorted((*k[:3], str(k[3]), k[4]) for k in seen)}; {report['replays_stage_4']} "
          f"steps replayed (stage 4 trains on host-loader windows, not replayed yet)",
          flush=True)
    if launches != expected:
        fail(f"ablation stages 4-5: fused_rdb launched {launches} times, expected {expected}")
    missing = {k[:4] for k in seen} - checked
    missing |= {k[:4] for k in seen if k[4]} - checked_grad
    if missing:
        fail(f"ablation: kernel shapes phases 2 and 4 did not check: {missing}")
    if results["ddm_stats"] != stats:
        fail(f"ablation stage 3 differs between the calls: {results['ddm_stats']} vs {stats}")
    if set(results["runs"]) != {"abl_mw_on", "abl_mw_off"} or not all(
            np.isfinite(v) for agg in results["runs"].values() for v in agg.values()):
        fail(f"ablation stage 5: {results['runs']}")
    with open(os.path.join(work, "ablation_results.json")) as f:
        if json.load(f) != results:
            fail("ablation: ablation_results.json differs from the tool's results")
    report["launches_ablation"] = launches
    print(f"ablation stages 3-5 (two srn_train runs of {ABLATION_NITER} iterations at nf {NC} "
          f"nb {NB}, bf16; region-split eval): {json.dumps(results['runs'])}; last validation "
          + json.dumps({n: {k: v[-1][k] for k in v[-1] if k.startswith("val/")}
                        for n, v in vals.items()})
          + f"; {report['stages_3_5_s']:.2f} s [{gpu}]", flush=True)

    # 4. the parity dry-run at nb 23, f32, on two LR images, counted
    ddir = os.path.join(base, "dryrun")
    write_corpus(ddir, np.random.default_rng(SEED), sizes=DRYRUN_LR)
    seen.clear()
    zero_launches(fused_rdb)
    handle = register_module_forward_pre_hook(record)
    t0 = time.perf_counter()
    try:
        rows = run_cli(parity_dryrun.main, [
            "--lr_dir", os.path.join(ddir, "lr"), "--work", os.path.join(ddir, "work"),
            "--n", str(len(DRYRUN_LR)), "--nb", str(NB), "--device", "cuda"])
        torch.cuda.synchronize()
    finally:
        handle.remove()
    report["dryrun_s"] = time.perf_counter() - t0
    launches = read_launches(fused_rdb, "ablation")
    expected = 3 * NB * LAUNCHES_PER_RDB * 2 * len(DRYRUN_LR)  # plain and chopped
    if launches != expected or fused_rdb.launches_f32 != expected:
        fail(f"parity_dryrun: {launches} launches ({fused_rdb.launches_f32} f32), expected "
             f"{expected}, all f32")
    missing = {k[:4] for k in seen} - checked
    if missing:
        fail(f"parity_dryrun: kernel shapes phase 2 did not check: {missing}")
    atol, _ = TOLERANCES["network_f32"]
    worst = max(r[k]["max_abs"] for r in rows
                for k in ("ours_plain_vs_torch_full", "ours_chop_vs_torch_chop"))
    print(f"parity_dryrun (nb {NB}, f32, stand-in weights; SRModel on the f32 kernel against the "
          f"functional forward, TF32 off): "
          + "; ".join(f"{r['image']} {r['lr_shape'][:2]}: plain "
                      f"{r['ours_plain_vs_torch_full']['max_abs']:.3e}, chop "
                      f"{r['ours_chop_vs_torch_chop']['max_abs']:.3e}, |out| max "
                      f"{r['out_absmax']:.3e}" for r in rows)
          + f"; worst {worst:.3e} (limit {atol}); f32 launches {launches}; "
          f"{report['dryrun_s']:.2f} s [{gpu}]", flush=True)
    if not worst <= atol:
        fail(f"parity_dryrun: max |delta| {worst:.3e} exceeds {atol}")
    report["launches_ablation"] += launches
    report.update(ddm_stats=stats, runs=results["runs"], dryrun_worst_max_abs=worst,
                  phase_s=time.perf_counter() - t_phase)
    print(f"ablation: the phase took {report['phase_s']:.2f} s [{gpu}]", flush=True)
    return report


# -- phase dist: the multi-rank paths -------------------------------------------

DIST_STEPS = 8  # the one-NCCL-rank srn_train run: two banked windows of DIST_K
DIST_K = 4
DIST_TIMED = 4  # steps a turn when the step is timed with and without the group
DIST_LR = 256  # srn_test --mesh 2: one 256x256 LR image at nb 23
# what the two ranks give the kernel beyond the other phases' shapes: each
# rank's 2 of the 4 chop tiles of 160x160; its 128 rows of the image with two
# 20-row halos; the two 40-row edge strips
DIST_SHAPES = ((2, 160, 160), (1, 168, 256), (1, 40, 256))
DIST_B, DIST_HR = 4, 192  # the f32 steps: a global batch of 4 + 4 (DASR) or 4 (srragan), HR 192
DIST_CHILD = "DIST_CHILD "  # the line a child reports on


def dist_batches(kind, n):
    """``n`` seeded global batches (NHWC numpy) of the f32 steps of phase dist."""
    rng = np.random.default_rng(SEED + (7 if kind == "dasr" else 8))
    lr = DIST_HR // 4
    out = []
    for _ in range(n):
        if kind == "dasr":
            b = {k: rng.random((DIST_B, s, s, 3), dtype=np.float32)
                 for k, s in (("LR_fake", lr), ("LR_real", lr), ("HR", DIST_HR),
                              ("HR_unpair", DIST_HR))}
            b["fake_w"] = rng.random((DIST_B, lr // 2, lr // 2, 1), dtype=np.float32)
        else:
            b = {"LR": rng.random((2 * DIST_B, lr, lr, 3), dtype=np.float32),
                 "HR": rng.random((2 * DIST_B, DIST_HR, DIST_HR, 3), dtype=np.float32)}
        out.append(b)
    return out


def dist_steps(kind, world):
    """The f32 steps of phase dist in ``world``, each rank on its rows of the
    global batches: three DASR steps (nf 64, nb 2) or one srragan step
    (train_SRGAN.json at nb 2, its BatchNorm VGG D); (metrics of each step,
    {net: params before}, {net: (params after, Adam's first moments)})."""
    import torch

    from dasr_tpu_torch.models.registry import create_model
    from dasr_tpu_torch.train.srn_trainer import SRNConfig, SRNTrainer

    dev = torch.device("cuda")
    if kind == "dasr":
        tr = SRNTrainer(SRNConfig(nf=NC, nb=2, gc=GC, lr_steps=()), dev)
        tr.init_state()
        step, batches = tr.train_step, dist_batches(kind, 3)
    else:
        with open(os.path.join(ROOT, "dasr_tpu_torch", "configs", "train_SRGAN.json")) as f:
            opt = json.load(f)
        opt.update(model="srragan", bf16=False, is_train=True)
        opt["network_G"]["nb"] = 2
        tr = create_model(opt, dev).init().trainer
        step, batches = tr.train_step, dist_batches(kind, 1)
    nets = {"G": tr.state.g, "D_target": tr.state.d_target}
    init = {name: flat(ns).clone() for name, ns in nets.items()}
    traj = []
    for b in batches:
        dev_b = {k: torch.from_numpy(np.ascontiguousarray(world.shard(v))).to(dev)
                 .permute(0, 3, 1, 2) for k, v in b.items()}
        traj.append({k: float(v) for k, v in step(dev_b).items()})
    for name, ns in nets.items():
        world.check_replicated(ns.net.state_dict().items(), f"dist {kind} {name}")
    return traj, init, {name: (flat(ns), flat(ns, True)) for name, ns in nets.items()}


def dist_serve_configs(root):
    """The srn_test configs of phase dist (one 256x256 LR image and the
    seeded nb-23 .pth under ``root``/serve): {name: path} for one and two
    ranks, chopped and plain."""
    root = os.path.join(root, "serve")
    pth = os.path.join(root, "rrdb_x4_G.pth")
    return {name: serve_config(root, name, chop, pth)
            for name, chop in (("one_chop", True), ("two_chop", True), ("one_plain", False),
                               ("two_shard", False))}


def dist_child(kind, root):
    """A child of phase dist, started by torchrun: ``nccl``, the one NCCL rank
    (srn_train at full width through the CLI, its step against the step
    without the process group, the two timed in turns), or ``pair``, each
    of two ranks (gloo on the one card, or NCCL on two cards where there
    are two) (the f32 steps, srn_test --mesh 2 chopped
    and --spatial_shard). Reports its kernel launches, the kernel's input
    shapes and its numbers on a ``DIST_CHILD`` line and in
    ``root``/{kind}_{rank}.json; its results go to ``root``."""
    import torch
    from torch.nn.modules.module import register_module_forward_pre_hook

    from dasr_tpu_torch.cli import srn_test, srn_train
    from dasr_tpu_torch.core import dist
    from dasr_tpu_torch.core.device import resolve_device
    from dasr_tpu_torch.nn.blocks import RDB5C
    from dasr_tpu_torch.ops.rdb import fused_rdb

    resolve_device("cuda")
    backend = "gloo" if kind == "pair" and torch.cuda.device_count() < 2 else "nccl"
    world = dist.init_world("cuda", backend=backend)
    if world.size != (2 if kind == "pair" else 1) or world.backend != backend:
        fail(f"dist {kind}: a world of {world.size} on {world.backend}")
    seen = set()

    def record(mod, args):
        if isinstance(mod, RDB5C):
            b, _, h, w = args[0].shape
            seen.add((b, h, w, str(args[0].dtype), torch.is_grad_enabled()))

    handle = register_module_forward_pre_hook(record)
    out = {"rank": world.rank, "kind": kind, "backend": backend}
    if kind == "nccl":
        cfg = os.path.join(root, "dist_nccl.json")
        zero_launches(fused_rdb)
        out["steps"], _ = run_cli(srn_train.main, ["-opt", cfg, "--device", "cuda",
                                                   "--device_bank", "--steps_per_call",
                                                   str(DIST_K)])
        torch.cuda.synchronize()
        out["launches"], out["launches_f32"] = fused_rdb.launches, fused_rdb.launches_f32
        handle.remove()
        out.update(nccl_step_checks(world, cfg))
    else:
        zero_launches(fused_rdb)
        results = {k: dist_steps(k, world) for k in ("dasr", "srragan")}
        configs = dist_serve_configs(root)
        for name, flags in (("two_chop", []), ("two_shard", ["--spatial_shard"])):
            results[name] = run_cli(srn_test.main, ["-opt", configs[name], "--device", "cuda",
                                                    "--mesh", "2", *flags])
        torch.cuda.synchronize()
        out["launches"], out["launches_f32"] = fused_rdb.launches, fused_rdb.launches_f32
        handle.remove()
        if world.rank == 0:
            torch.save(results, os.path.join(root, "pair_results.pt"))
        world.barrier()
    out["shapes"] = sorted(seen)
    # the ranks share one stdout: the report also goes to a file of its own
    print(DIST_CHILD + json.dumps(out), flush=True)
    with open(os.path.join(root, f"{kind}_{world.rank}.json"), "w") as f:
        json.dump(out, f)


def nccl_step_checks(world, cfg):
    """One host batch's step with the one-rank NCCL group (gradients and
    metrics through all_reduce) against the same step without the group,
    and that step run twice (the card's own floor), from three models of
    one seeded init; then the step's ms with and without the group, in
    turns."""
    import torch

    from dasr_tpu_torch.core import dist
    from dasr_tpu_torch.core.config import parse_srn_options
    from dasr_tpu_torch.data.datasets import create_dataset
    from dasr_tpu_torch.data.pipeline import Loader
    from dasr_tpu_torch.models.registry import create_model

    opt = parse_srn_options(cfg, is_train=True)
    host = next(iter(Loader(create_dataset(opt["datasets"]["train"]), batch_size=6,
                            num_workers=6, seed=0)))
    batch = {k: torch.from_numpy(host[k]).cuda().permute(0, 3, 1, 2)
             for k in ("LR_fake", "LR_real", "HR", "HR_unpair", "fake_w")}
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    models = [create_model(parse_srn_options(cfg, is_train=True), torch.device("cuda")).init()
              for _ in range(3)]
    states = []
    for i, m in enumerate(models):
        with dist.using(world if i == 0 else dist.SINGLE):
            m.trainer.train_step(batch)
        torch.cuda.synchronize()
        st = m.trainer.state
        states.append(torch.cat([flat(st.g), flat(st.d_target), flat(st.g, True)]))
    grouped, alone, again = states
    out = {"step_bit_equal": bool(torch.equal(grouped, alone)),
           "step_max_abs_diff": float((grouped - alone).abs().max()),
           "floor_bit_equal": bool(torch.equal(alone, again)),
           "floor_max_abs_diff": float((alone - again).abs().max())}
    torch.backends.cudnn.deterministic = False
    tr = models[0].trainer
    times = {"group": [], "alone": []}
    for _ in range(3):
        for arm in times:
            with dist.using(world if arm == "group" else dist.SINGLE):
                for _ in range(DIST_TIMED):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    tr.train_step(batch)
                    end.record()
                    torch.cuda.synchronize()
                    times[arm].append(start.elapsed_time(end))
    out["ms_group"], out["ms_alone"] = (float(np.median(times[a])) for a in ("group", "alone"))
    return out


def run_dist_children(kind, root, nproc, timeout):
    """torchrun ``nproc`` children of kind ``kind``: their reports (one file
    a rank), the seconds they took and what they printed. Fails if a child
    fails or reports nothing."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
           "--master_port", str(port), os.path.join(ROOT, "chip_smoke.py"), "--dist_child",
           kind, "--dist_dir", root]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    with open(os.path.join(root, f"{kind}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    paths = [os.path.join(root, f"{kind}_{r}.json") for r in range(nproc)]
    reports = []
    for path in paths:
        if os.path.exists(path):
            with open(path) as f:
                reports.append(json.load(f))
    if proc.returncode != 0 or len(reports) != nproc:
        fail(f"dist: the {kind} children exited {proc.returncode} with {len(reports)} reports:\n"
             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return reports, secs, proc.stdout


def phase_dist(gpu, checked, checked_grad):
    """The multi-rank paths (core/dist.py): one NCCL rank through srn_train
    at full width, and two ranks (gloo on the one card, or NCCL on two)
    against one process on the global batches."""
    import torch

    from dasr_tpu_torch.cli import srn_test
    from dasr_tpu_torch.core import dist
    from dasr_tpu_torch.data.io import read_img_u8
    from dasr_tpu_torch.nn.generators import RRDBNet
    from dasr_tpu_torch.ops.rdb import LAUNCHES_PER_RDB, TOLERANCES

    report = {}
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory() as root:
        dirs = write_train_corpus(root, rng)
        train_config(root, dirs, "dist_nccl", DIST_STEPS)
        write_corpus(os.path.join(root, "serve"), rng, sizes=((DIST_LR, DIST_LR),))
        net = RRDBNet(nf=NC, nb=NB, gc=GC).init_weights(torch.Generator().manual_seed(SEED))
        torch.save(net.state_dict(), os.path.join(root, "serve", "rrdb_x4_G.pth"))
        configs = dist_serve_configs(root)

        # one NCCL rank: srn_train through the CLI, counted
        (nccl,), secs, log = run_dist_children("nccl", root, 1, 600)
        expected = 3 * NB * LAUNCHES_PER_RDB * (DIST_STEPS + 2)
        mesh = [ln for ln in log.splitlines() if ln.startswith("[mesh]")]
        print(f"dist nccl: torchrun child {secs:.2f} s; srn_train {nccl['steps']} banked steps "
              f"(K {DIST_K}), nf {NC} nb {NB}, {mesh}, fused_rdb launches "
              f"{nccl['launches']}, expected {expected}", flush=True)
        if (mesh != ["[mesh] data=1 spatial=1"] or "device bank:" not in log
                or nccl["steps"] != DIST_STEPS or nccl["launches"] != expected):
            fail(f"dist nccl: {nccl}")
        print(f"dist nccl: the step with the one-rank NCCL group vs without it, one seeded "
              f"init, cuDNN deterministic: bit-equal {nccl['step_bit_equal']} (max|diff| "
              f"{nccl['step_max_abs_diff']:.3e}); the step without it run twice: bit-equal "
              f"{nccl['floor_bit_equal']} (max|diff| {nccl['floor_max_abs_diff']:.3e})",
              flush=True)
        if not nccl["step_bit_equal"] and (
                nccl["floor_bit_equal"] or nccl["step_max_abs_diff"]
                > 2 * nccl["floor_max_abs_diff"]):
            fail("dist nccl: the grouped step is off the step without the group")
        print(f"dist nccl: train step, batch 6 + 6, HR 128, bf16: {nccl['ms_group']:.3f} ms/step "
              f"with the NCCL group, {nccl['ms_alone']:.3f} ms/step without (median of "
              f"{3 * DIST_TIMED} each, CUDA events, in turns) [{gpu}]", flush=True)

        # two ranks: the f32 steps and srn_test --mesh 2
        ranks, secs, _ = run_dist_children("pair", root, 2, 600)
        got = torch.load(os.path.join(root, "pair_results.pt"), weights_only=False)
        pair = f"pair ({ranks[0]['backend']}, {min(2, torch.cuda.device_count())} card(s))"
        print(f"dist {pair}: torchrun children {secs:.2f} s; fused_rdb launches "
              f"{[r['launches'] for r in ranks]}", flush=True)
        atol, rtol = TOLERANCES["train_loss_f32"]
        _, utol = TOLERANCES["train_update_f32"]
        _, mtol = TOLERANCES["train_moment_f32"]
        for kind in ("dasr", "srragan"):
            want = dist_steps(kind, dist.SINGLE)
            # one srragan step is Adam's first, which moves every element by
            # lr whatever its gradient's size: the conv biases before D's
            # BatchNorms, whose gradient is rounding noise, move 2 lr apart
            # between any two runs. Its first moments, linear in the
            # gradients, are held; its update is reported
            worst, parts, bad, _ = compare_three_steps(
                f"dist {kind}", got[kind], want, (atol, rtol),
                utol if kind == "dasr" else float("inf"), mtol)
            print(f"dist {pair} {kind} f32 (nf {NC}, nb 2), {len(want[0])} step(s), two ranks "
                  f"vs one process on the global batch: losses within {worst:.3f} of their "
                  f"limit; {'; '.join(parts)}", flush=True)
            if bad:
                fail(f"dist {kind}: two ranks' updates or moments of {bad} are off one process's")
        psnr_tol, ssim_tol = TOLERANCES["psnr_db"][0], TOLERANCES["ssim"][0]
        for two, one in (("two_chop", "one_chop"), ("two_shard", "one_plain")):
            want = run_cli(srn_test.main, ["-opt", configs[one], "--device", "cuda"])["synth"]
            have = got[two]["synth"]
            errs = {k: abs(have[k] - v) for k, v in want.items()}
            pngs = [read_img_u8(os.path.join(root, "serve", "results", n, "synth", "img_0.png"))
                    .astype(int) for n in (two, one)]
            print(f"dist {pair} srn_test --mesh 2 {two} vs {one}, nb {NB} bf16, {DIST_LR}x"
                  f"{DIST_LR}: |metric err| {errs} (limits {psnr_tol} dB, {ssim_tol}), PNG "
                  f"max|diff| {np.abs(pngs[0] - pngs[1]).max()} grey levels", flush=True)
            if any(not e <= (psnr_tol if k.startswith("psnr") else ssim_tol)
                   for k, e in errs.items()):
                fail(f"dist: srn_test {two} is off {one}")
        seen = {(b, h, w, getattr(torch, dt.split(".")[1]), grad)
                for r in [nccl] + ranks for b, h, w, dt, grad in r["shapes"]}
        missing = {k[:4] for k in seen} - checked
        missing |= {k[:4] for k in seen if k[4]} - checked_grad
        if missing:
            fail(f"dist: the children gave the kernel shapes phases 2 and 4 did not check: "
                 f"{missing}")
        launches = nccl["launches"] + sum(r["launches"] for r in ranks)
        F32_LAUNCHES["dist"] = nccl["launches_f32"] + sum(r["launches_f32"] for r in ranks)
        if not all(r["launches"] > 0 for r in ranks):
            fail(f"dist: a rank of the pair launched no kernel: {ranks}")
        report.update(launches_dist=launches, dist_ms_group=nccl["ms_group"],
                      dist_ms_alone=nccl["ms_alone"])
    return report


def adam_grads(nets, seed):
    """Each network's gradients of a seeded bf16 forward's weighted sum (G's
    RDB kernels' as the backward kernels write them)."""
    import torch

    gen = torch.Generator("cuda").manual_seed(seed)
    out = []
    for net, shape in zip(nets, ((2, 3, 24, 24), (2, 9, 64, 64))):
        x = torch.rand(shape, device="cuda", generator=gen, dtype=torch.bfloat16)
        y = net(x.contiguous(memory_format=torch.channels_last)).float()
        loss = (y * torch.randn(y.shape, device="cuda", generator=gen)).mean()
        out.append(list(torch.autograd.grad(loss, list(net.parameters()))))
    return out


def graph_of(fn):
    """``fn`` captured in a CUDA graph on a side stream after one eager
    call; returns the replay."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    torch.cuda.synchronize()
    return graph.replay


def kernel_trace(fn, calls, names=None):
    """(device ms a call summed over the kernels, kernels a call) of ``calls``
    calls of ``fn`` by torch.profiler; ``names``: only kernels whose name
    holds one of them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and (names is None or any(n in e.name for n in names))]
    total = sum(e.time_range.end - e.time_range.start for e in evs)
    return total / calls / 1e3, len(evs) / calls


def phase_adam(gpu):
    import torch

    from dasr_tpu_torch.nn.discriminators import NLayerDiscriminator
    from dasr_tpu_torch.nn.generators import RRDBNet
    from dasr_tpu_torch.ops import adam
    from dasr_tpu_torch.train.schedules import multistep
    from dasr_tpu_torch.train.state import net_state

    print(f"adam: {gpu}; constants {adam.kernel_constants()}", flush=True)
    torch.manual_seed(SEED)
    nets = [RRDBNet(nf=NC, nb=NB, gc=GC, upscale=4, dtype=torch.bfloat16),
            NLayerDiscriminator(in_ch=9, ndf=64, n_layers=2, norm_layer="Instance", stride=2,
                                use_bias_middle=False)]
    nets = [n.to("cuda", memory_format=torch.channels_last) for n in nets]
    refs = [copy.deepcopy(n) for n in nets]
    lr = 1e-4
    states = [net_state(n, lr, 0.9, lambda opt: multistep(opt, (), 1.0)) for n in nets]
    ref_opts = [torch.optim.Adam(r.parameters(), lr=torch.tensor(lr, device="cuda"),
                                 betas=(0.9, 0.999), eps=1e-8, capturable=True) for r in refs]
    grads = adam_grads(nets, SEED)
    n_params = sum(p.numel() for n in nets for p in n.parameters())
    n_tensors = sum(len(list(n.parameters())) for n in nets)
    strided = sum(g.stride() != p.stride() for n, gs in zip(nets, grads)
                  for p, g in zip(n.parameters(), gs))

    def kernel_step():
        for ns, gs in zip(states, grads):
            ns.update(gs)

    def torch_step():
        for opt in ref_opts:
            opt.step()

    for ref, gs in zip(refs, grads):
        for p, g in zip(ref.parameters(), gs):
            p.grad = g.clone()
    kernel_step()
    torch_step()
    torch.cuda.synchronize()
    worst_p = worst_m = 0.0
    for ns, ref, opt in zip(states, refs, ref_opts):
        for p, pr in zip(ns.params(), ref.parameters()):
            worst_p = max(worst_p, (p - pr).abs().max().item() / lr)
            st, sr = ns.opt.state[p], opt.state[pr]
            if float(st["step"]) != float(sr["step"]):
                fail(f"adam: step count {float(st['step'])} != torch's {float(sr['step'])}")
            for name in ("exp_avg", "exp_avg_sq"):
                err = (st[name] - sr[name]).abs()
                worst_m = max(worst_m, torch.where(err == 0, 0.0, err / sr[name].abs()).max()
                              .item())
    if worst_p > 1e-3 or worst_m > 1e-6:
        fail(f"adam: the kernel's step is off torch's: params {worst_p:.3e} lr, moments "
             f"{worst_m:.3e} relative")

    host = {"kernel": [], "torch": []}
    for _ in range(10):  # one eager update of both networks, issue time only
        for what, fn in (("kernel", kernel_step), ("torch", torch_step),
                         ("torch", torch_step), ("kernel", kernel_step)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host[what].append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    host = {k: float(np.median(v)) for k, v in host.items()}

    replay = {"kernel": graph_of(kernel_step), "torch": graph_of(torch_step)}
    times = {"kernel": [], "torch": []}
    for _ in range(3):
        for what in ("kernel", "torch", "torch", "kernel"):
            times[what].append(cuda_ms(replay[what], warmup=2, iters=20))
    times = {k: float(np.median(v)) for k, v in times.items()}
    traced = {"kernel": kernel_trace(replay["kernel"], 5, ("adam_update", "adam_count")),
              "kernel_update": kernel_trace(replay["kernel"], 5, ("adam_update",)),
              "torch": kernel_trace(replay["torch"], 5)}
    bound = adam.bound_ms(n_params)
    report = {
        "tensors": n_tensors, "params": n_params, "strided_grads": strided,
        "bound_ms": bound, "graph_ms": times, "roofline": bound / times["kernel"],
        "trace_ms": {k: v[0] for k, v in traced.items()},
        "trace_kernels": {k: v[1] for k, v in traced.items()},
        "trace_roofline": bound / traced["kernel"][0],
        "host_ms": host, "worst_param_over_lr": worst_p, "worst_moment_rel": worst_m,
    }
    print(f"adam (the kernel at dasr_srn's G + D, against torch's capturable Adam): "
          f"{json.dumps(report)}", flush=True)
    if times["kernel"] >= times["torch"]:
        fail(f"adam: the kernel ({times['kernel']:.4f} ms) is not faster than torch's "
             f"({times['torch']:.4f} ms)")
    if host["kernel"] > host["torch"]:
        fail(f"adam: one eager update takes the host {host['kernel']:.3f} ms, torch's "
             f"{host['torch']:.3f} ms")
    return report


def phase_prep(gpu):
    """The RDB weight plan at dasr_srn's G (RRDBNet nf 64 nb 23: 69 RDBs,
    345 parameters, channels_last): one launch of rdb_prep_weights bit for
    bit the per-call path it replaces (each RDB's five casts to bf16 HWIO,
    then rdb_dgrad_weights on them) and the plain version on the card
    (ops/rdb.py:prepare_reference, .to(bf16) and dgrad_weights), so
    rdb_dgrad_weights is held to the plain version too; the launch and the
    per-call path captured in a CUDA graph and timed in turns (CUDA events
    and the device trace), the launch against its byte bound."""
    import torch

    from dasr_tpu_torch.nn.blocks import fused_rdbs
    from dasr_tpu_torch.nn.generators import RRDBNet
    from dasr_tpu_torch.ops import rdb

    torch.manual_seed(SEED)
    net = RRDBNet(nf=NC, nb=NB, gc=GC, upscale=4, dtype=torch.bfloat16)
    net.init_weights(torch.Generator().manual_seed(SEED))
    net = net.to("cuda", memory_format=torch.channels_last)
    weights = [tuple(c.weight for c in m.convs()) for m in fused_rdbs(net)]
    n = sum(w.numel() for ws in weights for w in ws)
    plan = rdb.RDBWeightPlan(weights)

    def per_call():
        out = []
        for ws in weights:
            ks = [torch.empty((3, 3) + tuple(w.shape[1::-1]), dtype=torch.bfloat16,
                              device="cuda").copy_(w.permute(2, 3, 1, 0)) for w in ws]
            out.append((ks, rdb.launch_images(ks)))
        return out

    plan.prepare()
    want = per_call()
    plain = rdb.RDBWeightPlan(weights)
    rdb.prepare_reference(plain)
    torch.cuda.synchronize()

    def same(a, b):
        return torch.equal(a.view(torch.int16), b.view(torch.int16))

    for r, ((ks, img), (ks_w, img_w), (ks_p, img_p)) in enumerate(
            zip(plan.slots, want, plain.slots)):
        for what, (k_w, i_w) in (("the per-call path", (ks_w, img_w)),
                                 ("the plain version", (ks_p, img_p))):
            if not (all(same(a, b) for a, b in zip(ks, k_w)) and same(img, i_w)):
                fail(f"prep: RDB {r}'s prepared kernels or images differ from {what}")
    del plain
    replay = {"prep": graph_of(plan.prepare), "per_call": graph_of(per_call)}
    times = {"prep": [], "per_call": []}
    for _ in range(3):
        for what in ("prep", "per_call", "per_call", "prep"):
            times[what].append(cuda_ms(replay[what], warmup=2, iters=20))
    times = {k: float(np.median(v)) for k, v in times.items()}
    traced = {"prep": kernel_trace(replay["prep"], 5, ("rdb_prep_weights",)),
              "per_call": kernel_trace(replay["per_call"], 5),
              "per_call_images": kernel_trace(replay["per_call"], 5, ("rdb_dgrad_weights",))}
    bound = rdb.prep_bytes(n) / rdb.PEAK_BYTES_PER_S * 1e3
    report = {
        "rdbs": len(weights), "weights": n, "bytes": rdb.prep_bytes(n), "bound_ms": bound,
        "graph_ms": times, "roofline": bound / times["prep"],
        "trace_ms": {k: v[0] for k, v in traced.items()},
        "trace_kernels": {k: v[1] for k, v in traced.items()},
        "trace_roofline": bound / traced["prep"][0],
    }
    print(f"prep (one rdb_prep_weights launch at dasr_srn's G, against the per-call casts and "
          f"rdb_dgrad_weights) [{gpu}]: {json.dumps(report)}", flush=True)
    if times["prep"] >= times["per_call"]:
        fail(f"prep: the launch ({times['prep']:.4f} ms) is not faster than the per-call path "
             f"({times['per_call']:.4f} ms)")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="build,kernel,serve,grad,train,dsn,dataset,pipeline,bank,tools,"
                            "adaptive,paired,depatch,sft,lpips,ablation,dist,adam,prep",
                    help="comma-separated subset of build,kernel,serve,grad,train,dsn,dataset,"
                         "pipeline,bank,tools,adaptive,paired,depatch,sft,lpips,ablation,dist,"
                         "adam,prep, and wgrad (not a default: needs --parent)")
    ap.add_argument("--dist_child", choices=("nccl", "pair"), default=None,
                    help=argparse.SUPPRESS)  # phase dist starts its children with it
    ap.add_argument("--dist_dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--parent", default=None,
                    help="phase wgrad: a checkout of the parent commit to time against")
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
    if args.dist_child:
        dist_child(args.dist_child, args.dist_dir)
        return

    gpu = gpu_line()
    print(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)
    backward = ("autograd Function: the backward kernels on the saved growth buffer "
                "(csrc/rdb.cu dasr_rdb_backward: rdb_dgrad_wgmma x 5, rdb_wgrad; the dgrad "
                "weight images from the generator's weight plan, "
                "rdb_prep_weights, or else rdb_dgrad_weights); checked against the plain "
                "version in phase grad")
    backward32 = ("autograd Function: VJP of the stock dense chain (ops/rdb.py:rdb_chain), as "
                  "JAX's custom VJP; checked against the plain version in phase grad")
    entry = {
        "name": "fused_rdb", "kernel": "rdb_level_wgmma", "dtype": "bfloat16", "route": "cuda",
        "source": "dasr_tpu_torch/csrc/rdb.cu", "replaces": "dasr_tpu/ops/pallas_rdb.py:61",
        "launches": 0, "backward": backward,
    }
    entry32 = dict(entry, name="fused_rdb_f32", kernel="rdb_level_tf32x3", dtype="float32",
                   backward=backward32)
    if phases & {"serve", "lpips"}:
        phases.add("kernel")  # serve and parity check their shapes against phase 2's
    if phases & {"train", "pipeline", "bank", "tools", "adaptive", "paired", "ablation", "dist"}:
        phases |= {"kernel", "grad"}  # and these against phases 2 and 4
    if "adaptive" in phases:
        phases.add("dsn")  # its patch D is stage 1's discriminator
    if "tools" in phases:
        phases.add("dataset")  # dsn_test reads stage 1's checkpoint and stage 2's outputs
    if "dataset" in phases:
        phases.add("dsn")  # stage 2 reads stage 1's checkpoint
    if phases & {"build", "kernel", "grad", "adam", "prep", "wgrad"}:
        phase_build()
    if "adam" in phases:
        phase_adam(gpu)
    if "prep" in phases:
        phase_prep(gpu)
    if "wgrad" in phases:
        entry["wgrad_turns"] = phase_wgrad(gpu, args.parent)
    if "kernel" in phases:
        report, checked = phase_kernel(gpu)
        entry32.update(report.pop("f32"))
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
        if "tools" in phases:
            report = phase_tools(gpu, root, checked, checked_grad, ckpt_dir)
            entry["launches_tools"] = report.pop("launches_tools")
            print(f"tools (resume, val_batch, evaluate, dsn_test, auto_test, add_corruptions): "
                  f"{json.dumps(report)}", flush=True)
        if "adaptive" in phases:
            report = phase_adaptive(gpu, root, checked, checked_grad, ckpt_dir)
            entry["launches_adaptive"] = report.pop("launches_adaptive")
            print(f"adaptive (DASR_Adaptive_Model, train, bank, serve): {json.dumps(report)}",
                  flush=True)
        if "paired" in phases:
            report = phase_paired(gpu, root, checked, checked_grad)
            entry["launches_paired"] = report.pop("launches_paired")
            print(f"paired (sr, srgan / srragan, De_Resnet: train, serve): {json.dumps(report)}",
                  flush=True)
        # the DePatch and SFT paths run no RDB: their runs count 0 launches
        if "depatch" in phases:
            report = phase_depatch(gpu, root)
            entry["launches_depatch"] = 0
            print(f"depatch (De_patch_wavelet_GAN: train, resume, serve with save_RealorFake): "
                  f"{json.dumps(report)}", flush=True)
        if "sft" in phases:
            report = phase_sft(gpu, root)
            entry["launches_sft"] = 0
            print(f"sft (sftgan_test): {json.dumps(report)}", flush=True)
        if "lpips" in phases:
            report = phase_lpips(gpu, root, checked)
            entry["launches_lpips"] = report.pop("launches_lpips")
            print(f"lpips (LPIPS nets, lpips_train, compute_dists, parity, the scripts): "
                  f"{json.dumps(report)}", flush=True)
        if "ablation" in phases:
            report = phase_ablation(gpu, root, checked, checked_grad)
            entry["launches_ablation"] = report.pop("launches_ablation")
            print(f"ablation (make_synth_corpus, ddm_ablation, parity_dryrun): "
                  f"{json.dumps(report)}", flush=True)
    if "dist" in phases:
        report = phase_dist(gpu, checked, checked_grad)
        entry["launches_dist"] = report.pop("launches_dist")
        print(f"dist (one NCCL rank through srn_train; two ranks against one process): "
              f"{json.dumps(report)}", flush=True)
    # launches: the count from each main path's run, the counters set to 0
    # just before it; the total of the paths this run drove, the f32
    # kernel's apart
    entry32["launches"] = sum(F32_LAUNCHES.values())
    entry["launches"] = sum(entry.get(f"launches_{p}", 0)
                            for p in ("serve", "train", "pipeline", "bank", "tools", "adaptive",
                                      "paired", "depatch", "sft", "lpips", "ablation", "dist")
                            ) - entry32["launches"]
    if phases & {"tools", "ablation", "dist"} and not entry32["launches"]:
        fail("the f32 paths of phases tools, ablation and dist launched the f32 kernel no time")

    if stages:
        print(f"stages (no kernel of theirs but fused_rdb in stage 3): {json.dumps(stages)}",
              flush=True)
    print(gpu, flush=True)
    print(json.dumps({"kernels": [entry, entry32]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
