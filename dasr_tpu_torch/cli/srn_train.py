"""SRN training CLI of the port — ``python -m dasr_tpu_torch.cli.srn_train
-opt options/train/train_DASR.json [--device cuda]`` (mirroring
codes/SRN/train.py:20-249 and ``dasr_tpu.cli.srn_train``).

Iteration-based loop: data loaders, ``create_model``, train steps (the LR
schedules step with the optimizers), log lines and ``metrics.jsonl`` every
``print_freq`` steps, validation every ``val_freq``, sample dumps every
``save_tsamples``, and the whole train state saved every
``save_checkpoint_freq`` steps and at the end. Returns ``(steps run, last
logged metrics)``.

The JAX package's fast path, with its semantics:

* ``--steps_per_call K``: windows of K steps, metrics averaged over the
  window (host loader) or the window's last step (device bank), read only
  for a window that crosses a print boundary and one window late, so the
  host never waits for the card between windows;
* ``--transfer_uint8``: host batches as uint8, cast on the card (exact);
* ``--device_bank``: the four stage-3 corpora resident on the card (three
  for 'DASR_Adaptive_Model', whose DDM is computed online), each window
  sampled there from a (K, B) index window (``_bank_gate`` says when the
  host loader serves instead); epochs draw their order by
  ``np.random.default_rng((manual_seed, epoch)).permutation(n)`` with
  ``drop_last``;
* ``val_device_metrics`` (and ``val_metrics_pad_bucket``): the validation
  PSNR/SSIM (+Y, LPIPS) on the card, one image behind the forward;
* ``--profile DIR``: a ``torch.profiler`` trace of steps 10-20 (rank 0's);
* ``resume_state``: the port's own ``{iter}.pt``, or a reference
  ``{iter}.state`` (``check_resume`` points the pretrain paths at its
  ``{iter}_G.pth`` / ``_D_target.pth`` / ``_D_source.pth``; its Adam states
  set each network's moments and update count); the run continues inside
  the epoch where the save left it (the JAX CLI restarts the epoch order);
* ``val_batch`` K > 1: consecutive same-shape val images share one forward,
  as in the JAX CLI.

'DASR_Adaptive_Model' trains through the same loop, and so do the paired
trainers 'sr', 'srgan' / 'srragan' and 'De_Resnet', and the DePatch wavelet
GAN 'De_patch_wavelet_GAN' (dataset mode 'LRHR_Trans_Wavelet_GAN'), on the
host loader one step a call (``--steps_per_call`` and ``--device_bank`` fall
back, with the JAX CLI's lines); 'De_Resnet' and 'De_patch_wavelet_GAN'
validate G(HR) against the LR image. As the
JAX CLI has no path for these models' reference formats, a ``.state``
``resume_state`` and ``save_ref_formats`` are refused for them.

On N cards: ``python -m torch.distributed.run --nproc_per_node N -m
dasr_tpu_torch.cli.srn_train -opt ...`` (``core/dist.py``). Each rank
loads (or, with ``--device_bank``, gathers from its whole copy of the
banks) its rows of each global batch of ``batch_size``, which N must
divide; an N-rank step equals the 1-rank step on the global batch. Rank 0
prints the ``[mesh] data=N spatial=1`` line, and alone writes the logs,
the metrics and the saves and validates, the others waiting; as in the JAX
CLI on a mesh, ``val_batch`` and the unbucketed ``val_device_metrics`` are
off there. As JAX shards only them, only 'DASR', 'DASR_Adaptive_Model',
'srgan' and 'srragan' train on more than one rank.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True, help="Path to options JSON file.")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="train on the GPU (hand-written kernels) or on the CPU "
                             "(plain PyTorch versions)")
    parser.add_argument("--decode_cache_gb", type=float, default=None,
                        help="in-RAM decoded-image cache budget (GiB); also via "
                             "DASR_DECODE_CACHE_GB")
    parser.add_argument("--profile", type=str, default=None,
                        help="directory for a torch.profiler trace of steps 10-20")
    parser.add_argument("--steps_per_call", type=int, default=1,
                        help="train K steps a window; metrics are read once a window, "
                             "one window late")
    parser.add_argument("--transfer_uint8", action="store_true",
                        help="ship image tensors to the device as uint8 and cast to "
                             "f32/255 there (exact for 8-bit sources); same as "
                             "datasets.train.transfer_uint8")
    parser.add_argument("--device_bank", action="store_true",
                        help="keep the decoded train corpus (HR, fake LR, real LR, DDMs) "
                             "on the device and sample each batch there; the DASR model with "
                             "the LRHR_wavelet_unpair_fake_weights_EQ mode, or "
                             "DASR_Adaptive_Model with LRHR_unpair (no DDMs), only; else, "
                             "or over --device_bank_gb, or with images smaller than the "
                             "crop, the host loader serves")
    parser.add_argument("--device_bank_gb", type=float, default=12.0,
                        help="device memory budget for --device_bank (padded bytes, all "
                             "four banks)")
    args = parser.parse_args(argv)

    import numpy as np

    from dasr_tpu_torch.core import dist
    from dasr_tpu_torch.core.config import check_resume, dict2str, parse_srn_options
    from dasr_tpu_torch.core.device import resolve_device
    from dasr_tpu_torch.data.datasets import create_dataset
    from dasr_tpu_torch.data.pipeline import Loader
    from dasr_tpu_torch.models.registry import create_model
    from dasr_tpu_torch.utils import guards
    from dasr_tpu_torch.utils.metrics_writer import MetricsWriter

    opt = parse_srn_options(args.opt, is_train=True)
    name = opt.get("model")
    if name in _NO_REFERENCE_FORMATS:
        # as the JAX CLI, which resumes a reference .state only for a model
        # with resume_reference_state and saves the reference formats only
        # for one with save_reference_formats
        if (opt["path"].get("resume_state") or "").endswith(".state"):
            raise NotImplementedError(f"resume_state: a reference .state is not a {name} "
                                      "checkpoint; resume from the port's {iter}.pt "
                                      "(dasr_tpu has no reference format for this model)")
        if (opt.get("logger") or {}).get("save_ref_formats"):
            raise NotImplementedError(f"logger.save_ref_formats: {name} has no reference "
                                      "formats; its train state saves as {iter}.pt "
                                      "(dasr_tpu has no reference format for this model)")
    opt = check_resume(opt)
    rstate = opt["path"].get("resume_state")
    world = dist.init_world(resolve_device(args.device))
    device = world.device
    if args.decode_cache_gb is not None:
        from dasr_tpu_torch.data.io import enable_decode_cache

        enable_decode_cache(args.decode_cache_gb)
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    logger = logging.getLogger("base")
    # rank 0 alone logs; the others say only what goes wrong
    logger.setLevel(logging.INFO if world.is_main else logging.WARNING)
    logger.info(dict2str(opt))
    if world.is_main:
        print(world.mesh_line(), flush=True)
        for d in ("experiments_root", "models", "training_state", "val_images", "log"):
            if opt["path"].get(d):
                os.makedirs(opt["path"][d], exist_ok=True)

    train_opt = opt["train"] or {}
    logger_opt = opt["logger"] or {}
    niter = int(train_opt.get("niter", 350000))
    val_freq = int(train_opt.get("val_freq", 2500) or 2500)
    print_freq = int(logger_opt.get("print_freq", 200) or 200)
    save_freq = int(logger_opt.get("save_checkpoint_freq", 2500) or 2500)
    tsample_freq = int(opt.get("save_tsamples") or 0)
    seed = int(train_opt.get("manual_seed", 0) or 0)

    train_loader = val_set = train_ds_opt = bank_dirs = None
    for phase, dataset_opt in (opt.get("datasets") or {}).items():
        if phase == "train":
            if args.transfer_uint8:
                dataset_opt["transfer_uint8"] = True
            train_ds_opt = dataset_opt
            bs = int(dataset_opt.get("batch_size", 6) or 6)
            world.batch_slice(bs)  # refuses a batch the world does not divide
            if args.device_bank:
                bank_dirs = _bank_gate(opt, dataset_opt, args.device_bank_gb)
            if bank_dirs:
                from dasr_tpu_torch.data.io import list_images

                n_train_imgs = len(list_images(bank_dirs[0]))
                steps_per_epoch = n_train_imgs // bs
                logger.info(f"Number of train images: {n_train_imgs}, iters per epoch: "
                            f"{steps_per_epoch} (device bank)")
            else:
                train_set = create_dataset(dataset_opt)
                train_loader = Loader(
                    train_set, batch_size=bs,
                    shuffle=bool(dataset_opt.get("use_shuffle", True)),
                    num_workers=int(dataset_opt.get("n_workers", 6) or 6),
                    drop_last=True, seed=seed, pin_memory=device.type == "cuda", world=world,
                    # two windows of batches in flight: a window never waits on decode
                    prefetch=max(4, 2 * max(1, args.steps_per_call)),
                )
                steps_per_epoch = len(train_loader)
                logger.info(f"Number of train images: {len(train_set)}, iters per epoch: "
                            f"{steps_per_epoch}")
        elif phase == "val":
            val_set = create_dataset(dataset_opt)
            logger.info(f"Number of val images: {len(val_set)}")
    if train_ds_opt is None:
        raise ValueError("Train dataset is required.")
    if steps_per_epoch == 0:
        raise ValueError("the train set holds fewer images than one batch (drop_last)")

    model = create_model(opt, device)
    model.init()
    model.load()  # a reference .state resumes here
    start_iter = 0
    if rstate:
        start_iter = model.step if rstate.endswith(".state") else model.resume(rstate)
        logger.info(f"Resuming training from iteration: {start_iter}.")
    world.check_replicated(model.g.state_dict().items(), "srn_train")

    if bank_dirs:
        import time

        from dasr_tpu_torch.data.device_bank import build_bank, build_ddm_bank, epoch_rows, nbytes
        from dasr_tpu_torch.data.io import list_images

        fake_dir, hr_dir, real_dir, ddm_dir = bank_dirs
        hr_size = int(train_ds_opt.get("HR_size", 128) or 128)
        lr_size = hr_size // int(opt.get("scale", 4))
        t0 = time.perf_counter()
        fake_h = build_bank(fake_dir, min_size=lr_size)
        banks = (fake_h, build_bank(hr_dir, min_size=hr_size),
                 build_bank(real_dir, min_size=lr_size),
                 build_ddm_bank(list_images(ddm_dir), fake_h.sizes) if ddm_dir else None)
        t1 = time.perf_counter()
        model.setup_device_bank(*banks, hr_size,
                                use_flip=bool(train_ds_opt.get("use_flip", True)),
                                use_rot=bool(train_ds_opt.get("use_rot", True)))
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
        del banks, fake_h
        if world.is_main:
            print(f"device bank: {nbytes(model._banks) / 2**30:.3f} GiB resident (decode "
                  f"{t1 - t0:.2f} s, upload {time.perf_counter() - t1:.2f} s)", flush=True)

    tb_dir = None
    if opt.get("use_tb_logger") and "debug" not in (opt.get("name") or ""):
        tb_dir = os.path.join(opt["path"]["experiments_root"], "tb_logger")
    writer = (MetricsWriter(os.path.join(opt["path"]["log"], "metrics.jsonl"), tb_dir=tb_dir)
              if world.is_main else None)
    total_epochs = int(math.ceil(niter / steps_per_epoch))
    logger.info(f"Total epochs needed: {total_epochs} for iters {niter}")
    lpips_fn = None
    if opt.get("val_lpips"):
        from dasr_tpu_torch.cli.srn_test import make_lpips

        lpips_fn = make_lpips(device)

    k_steps = max(1, args.steps_per_call)
    if k_steps > 1 and not model.supports_multi_step:
        logger.info("steps_per_call > 1 requires a multi-step-capable model with "
                    "G/D_update_inter == 1; falling back to per-step dispatch")
        k_steps = 1
    windowed = k_steps > 1 or bool(bank_dirs)

    def crossed(step, k, freq):
        return step // freq > (step - k) // freq

    last = {}

    def report(step, k, epoch, host):
        nonlocal last
        if crossed(step, k, print_freq):
            guards.check_finite(host, step)
            logger.info(f"<epoch:{epoch:3d}, iter:{step:8,d}> " + ", ".join(
                f"{name.split('/')[-1]}: {v:.4e}" for name, v in host.items()))
            # imgs: effective images per step (fake + real halves)
            if writer:
                writer.write(step, host, imgs=bs * 2)
            last = host

    # a window's device metrics are read after the next window is issued, and
    # only for a window that crossed a print boundary; every 32 unread
    # windows one read bounds how far the host runs ahead of the card
    lagged = None  # (step, k, epoch, device metrics)
    runahead = 0
    profiler = None
    current_step = start_iter
    start_epoch, skip = divmod(start_iter, steps_per_epoch)
    pending = []
    try:
        for epoch in range(start_epoch, total_epochs):
            first = skip if epoch == start_epoch else 0
            if bank_dirs:
                source = epoch_rows(seed, epoch, n_train_imgs, bs,
                                    bool(train_ds_opt.get("use_shuffle", True)))[first:]
            else:
                train_loader.set_epoch(epoch, skip=first)
                source = train_loader
            for batch in source:
                if current_step >= niter:
                    break
                if windowed:
                    pending.append(batch)
                    if len(pending) < k_steps and current_step + len(pending) < niter:
                        continue
                if args.profile and world.is_main and profiler is None and (
                        current_step < start_iter + 10 <= current_step + max(1, len(pending))):
                    profiler = guards.profile(args.profile)
                    profiler.__enter__()
                if bank_dirs:
                    k, metrics = len(pending), None
                    dev_metrics = model.train_banked_window_async(np.stack(pending), current_step)
                elif windowed:
                    k, metrics = len(pending), None
                    dev_metrics = model.train_multi_step_async(pending)
                else:
                    k, metrics = 1, model.train_step(batch)
                pending = []
                current_step += k
                if profiler and current_step - k < start_iter + 20 <= current_step:
                    profiler.__exit__(None, None, None)
                    profiler = False
                    logger.info(f"wrote the profiler trace to {args.profile}")

                if metrics is not None:
                    report(current_step, k, epoch, metrics)
                else:
                    prev, lagged = lagged, (current_step, k, epoch, dev_metrics)
                    if prev is not None:
                        if crossed(prev[0], prev[1], print_freq):
                            report(*prev[:3], model.metrics_to_host(prev[3]))
                            runahead = 0
                        else:
                            runahead += 1
                            if runahead >= 32:
                                model.metrics_to_host(prev[3])
                                runahead = 0

                # rank 0 alone validates and saves; the others wait for it
                due = [val_set is not None and crossed(current_step, k, val_freq),
                       val_set is not None and tsample_freq
                       and crossed(current_step, k, tsample_freq),
                       crossed(current_step, k, save_freq)]
                if world.is_main:
                    if due[0]:
                        _validate(model, val_set, opt, current_step, logger, writer, lpips_fn,
                                  mesh=world.size > 1)
                    if due[1]:
                        _save_tsamples(model, val_set, opt, current_step, writer)
                    if due[2]:
                        _save(model, opt, logger_opt, current_step, logger)
                if any(due):
                    world.barrier()
            if current_step >= niter:
                break
        if lagged is not None:
            report(*lagged[:3], model.metrics_to_host(lagged[3]))
        if profiler:
            profiler.__exit__(None, None, None)
            logger.info(f"wrote the profiler trace to {args.profile}")
        logger.info("Saving the final model.")
        if world.is_main:
            _save(model, opt, logger_opt, current_step, logger)
        world.barrier()
        logger.info("End of training.")
    finally:
        if writer:
            writer.close()
    return current_step, last


# the models whose train state saves only as the port's {iter}.pt
_NO_REFERENCE_FORMATS = ("DASR_Adaptive_Model", "sr", "srgan", "srragan", "De_Resnet",
                         "De_patch_wavelet_GAN")


def _bank_gate(opt, dataset_opt, budget_gb):
    """The four dataroots (fake LR, HR, real LR, DDM; the DDM None for the
    Adaptive model, which computes its weights online) when
    ``--device_bank`` can serve this run, else None, printing why the host
    loader serves (counterpart of the JAX CLI's ``_bank_gate``, with its
    (model, mode) pairs). Besides the JAX gate's reasons (the model or mode,
    G/D_update_inter != 1, a missing dataroot, an image smaller than its
    crop, the budget), two repairs: the fake-LR, HR and DDM counts must be
    equal (the device gather would read an index that is not there, where
    the host loader fails), and the corpus must hold one batch (the host
    loader's ``drop_last`` yields none)."""
    from dasr_tpu_torch.data.device_bank import bank_min_hw, bank_nbytes
    from dasr_tpu_torch.data.io import list_images

    def fall(reason):
        print(f"--device_bank: {reason}; using the host loader", flush=True)
        return None

    pairs = {"DASR": "LRHR_wavelet_unpair_fake_weights_EQ",
             "DASR_Adaptive_Model": "LRHR_unpair"}
    model = opt.get("model")
    if model not in pairs:
        return fall(f"model [{model}] has no banked path")
    train = opt.get("train") or {}
    if (train.get("G_update_inter", 1) or 1) != 1 or (train.get("D_update_inter", 1) or 1) != 1:
        return fall("G/D_update_inter != 1")
    mode = dataset_opt.get("mode")
    if mode != pairs[model]:
        return fall(f"dataset mode [{mode}] unsupported for model [{model}]")
    keys = ("dataroot_fake_LR", "dataroot_HR", "dataroot_real_LR", "dataroot_fake_weights")
    with_ddm = model == "DASR"
    dirs = tuple(dataset_opt.get(k) for k in keys[:3 + with_ddm])
    if not all(dirs):
        return fall("missing a dataroot (fake_LR/HR/real_LR" + "/fake_weights" * with_ddm + ")")
    fake_dir, hr_dir, real_dir = dirs[:3]
    counts = [len(list_images(d)) for d in (fake_dir, hr_dir) + dirs[3:]]
    if len(set(counts)) != 1:
        return fall(f"{counts[0]} fake LRs, {counts[1]} HRs"
                    + (f" and {counts[2]} DDMs" if with_ddm else "") + " are not paired one to one")
    bs = int(dataset_opt.get("batch_size", 6) or 6)
    if counts[0] < bs:
        return fall(f"{counts[0]} train images hold no batch of {bs}")
    hr_size = int(dataset_opt.get("HR_size", 128) or 128)
    lr_size = hr_size // int(opt.get("scale", 4))
    if (min(bank_min_hw(fake_dir)) < lr_size or min(bank_min_hw(real_dir)) < lr_size
            or min(bank_min_hw(hr_dir)) < hr_size):
        return fall("corpus has images smaller than the crop")
    # the uint8 banks, and the f32 1-channel DDM bank at the fake LRs' sizes
    need = (bank_nbytes(fake_dir) * (7 if with_ddm else 3) // 3 + bank_nbytes(hr_dir)
            + bank_nbytes(real_dir))
    if need > budget_gb * 2**30:
        return fall(f"padded corpus needs {need / 2**30:.1f} GiB > budget {budget_gb} GiB")
    return dirs if with_ddm else dirs + (None,)


def _save(model, opt, logger_opt, step, logger):
    path = model.save(opt["path"]["training_state"], step)
    logger.info(f"Saved the train state to {path}.")
    if logger_opt.get("save_ref_formats"):
        model.save_reference_formats(opt["path"]["models"], step)


def _save_tsamples(model, val_set, opt, step, writer=None):
    """Fixed-image SR + gaussian high-pass dumps (reference:
    SRN/train.py:124-170): the same first val images every time."""
    import numpy as np
    import torch

    from dasr_tpu_torch.data.io import save_img
    from dasr_tpu_torch.ops.filters import filter_high

    def high(img):
        t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
        return filter_high(t, gaussian=True)[0].permute(1, 2, 0).numpy()

    out_dir = os.path.join(opt["path"]["experiments_root"], "tsamples")
    for i in range(min(2, len(val_set))):
        data = val_set[i]
        sr = model.test(data["LR"])
        hf = high(sr)
        save_img(sr, os.path.join(out_dir, f"{i}_{step}_SR.png"))
        save_img(hf, os.path.join(out_dir, f"{i}_{step}_SR_hf.png"))
        if writer is not None:
            writer.write_image(step, f"tsamples/{i}_SR", sr)
            writer.write_image(step, f"tsamples/{i}_SR_hf", hf)
        if "HR" in data:
            save_img(high(data["HR"]), os.path.join(out_dir, f"{i}_HR_hf.png"))


def _validate(model, val_set, opt, step, logger, writer, lpips_fn, mesh=False):
    """The reference's validation (codes/SRN/train.py:174-235): every val
    image (or ``max_val_images``), SR PNGs under val_images/<step>/,
    averages logged and written. Metrics on the host f64 path, or with
    ``val_device_metrics`` on the card (``val_metrics_pad_bucket``: padded
    to shared bucket shapes, LPIPS per shape); as in the JAX CLI, the chop
    and ``pad_bucket`` forwards keep the host metrics unless a bucket is
    given. Image i is read back after image i + 1 is issued.

    ``val_batch`` K > 1 (without chop or ``pad_bucket``, the JAX CLI's
    gate): runs of up to K consecutive same-shape images share one forward,
    chunk i read back after chunk i + 1 is issued; metrics stay per image.
    As in the JAX CLI it takes precedence over ``val_device_metrics``: the
    metrics run on the host f64 path, or on the bucketed device path where
    ``val_metrics_pad_bucket`` is set too.

    G's input and the image its output is held against are the model's
    ``val_keys`` (LR and HR; 'De_Resnet': HR and LR). ``mesh``: the run
    trains over several ranks, where, as the JAX CLI on a mesh, ``val_batch``
    and the unbucketed device metrics are off."""
    from dasr_tpu_torch.data.io import save_img
    from dasr_tpu_torch.eval.evaluate import average, sr_metrics_on

    cap = opt.get("max_val_images")
    n = min(len(val_set), int(cap)) if cap else len(val_set)
    if n < len(val_set):
        logger.info(f"Validating {n}/{len(val_set)} images (max_val_images={cap})")
    img_dir = os.path.join(opt["path"]["val_images"], str(step))
    device_metrics = bool(opt.get("val_device_metrics"))
    bucket = int(opt.get("val_metrics_pad_bucket") or 0)
    vb = int(opt.get("val_batch") or 1)
    batched = vb > 1 and not opt.get("chop") and not opt.get("pad_bucket") and not mesh
    per_chunk = vb if batched else 1
    if batched:
        if device_metrics:
            logger.info("val_batch > 1 takes precedence over val_device_metrics: "
                        "metrics run on the host f64 path for this validation")
        device_metrics = device_metrics and bucket > 0
    measure = sr_metrics_on(opt, lpips_fn, device_metrics, bucket, mesh=mesh)
    src, ref = model.val_keys
    results = []

    def issue(chunk):
        nonlocal inflight
        if batched:
            sr_dev = model.test_batch_async([d[src] for d in chunk])
        else:
            sr_dev = model.test_async(chunk[0][src])[None]
        finishes = [measure(sr_dev[j], d[ref]) for j, d in enumerate(chunk)]
        prev, inflight = inflight, (chunk, sr_dev, finishes)
        if prev is not None:
            drain(*prev)

    def drain(chunk, sr_dev, finishes):
        for data, sr, finish in zip(chunk, sr_dev.cpu().numpy(), finishes):
            results.append(finish(sr))
            base = os.path.splitext(os.path.basename(data["HR_path"]))[0]
            save_img(sr, os.path.join(img_dir, f"{base}_{step}.png"))

    inflight, chunk = None, []
    for i in range(n):
        data = val_set[i]
        if chunk and (len(chunk) == per_chunk or chunk[0][src].shape != data[src].shape):
            issue(chunk)
            chunk = []
        chunk.append(data)
    if chunk:
        issue(chunk)
    if inflight is not None:
        drain(*inflight)
    avg = average(results)
    msg = f"# Validation # PSNR: {avg['psnr']:.4e}"
    if "lpips" in avg:
        msg += f", LPIPS: {avg['lpips']:.4e}"
    logger.info(msg)
    writer.write(step, {f"val/{k}": v for k, v in avg.items()})
    return avg


if __name__ == "__main__":
    main()
