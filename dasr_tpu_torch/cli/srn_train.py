"""SRN training CLI of the port — ``python -m dasr_tpu_torch.cli.srn_train
-opt options/train/train_DASR.json [--device cuda]`` (mirroring
codes/SRN/train.py:20-249 and ``dasr_tpu.cli.srn_train``).

Iteration-based loop on the host loader, one train step per call: data
loaders, ``create_model``, ``train_step`` (the LR schedules step with the
optimizers), log lines and ``metrics.jsonl`` every ``print_freq`` steps,
validation every ``val_freq`` (PSNR/SSIM on the host f64 path, with LPIPS
when ``val_lpips``), sample dumps every ``save_tsamples``, and the whole
train state saved every ``save_checkpoint_freq`` steps and at the end.
Returns ``(steps run, last logged metrics)``.

Not ported yet, and refused rather than skipped: ``--device_bank``
(ROADMAP A.6), ``--steps_per_call > 1`` (a TPU dispatch amortisation;
ROADMAP A.5), ``--transfer_uint8`` and ``--profile`` (ROADMAP A.5),
``resume_state`` and ``val_device_metrics`` (ROADMAP A.5 / A.3).
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
    parser.add_argument("--profile", type=str, default=None, help="not yet ported (ROADMAP A.5)")
    parser.add_argument("--steps_per_call", type=int, default=1,
                        help="only 1: scanning K steps per dispatch is not yet ported "
                             "(ROADMAP A.5)")
    parser.add_argument("--transfer_uint8", action="store_true",
                        help="not yet ported (ROADMAP A.5)")
    parser.add_argument("--device_bank", action="store_true", help="not yet ported (ROADMAP A.6)")
    args = parser.parse_args(argv)
    for flag, on, item in (
        ("--profile", args.profile, "A.5"),
        ("--steps_per_call > 1", args.steps_per_call != 1, "A.5"),
        ("--transfer_uint8", args.transfer_uint8, "A.5"),
        ("--device_bank", args.device_bank, "A.6"),
    ):
        if on:
            raise NotImplementedError(f"{flag} is not yet ported (ROADMAP {item})")

    from dasr_tpu_torch.core.config import dict2str, parse_srn_options
    from dasr_tpu_torch.core.device import resolve_device
    from dasr_tpu_torch.data.datasets import create_dataset
    from dasr_tpu_torch.data.pipeline import Loader
    from dasr_tpu_torch.models.registry import create_model
    from dasr_tpu_torch.utils.guards import check_finite
    from dasr_tpu_torch.utils.metrics_writer import MetricsWriter

    opt = parse_srn_options(args.opt, is_train=True)
    if opt["path"].get("resume_state"):
        raise NotImplementedError("resume_state is not yet ported (ROADMAP A.5)")
    if opt.get("val_device_metrics"):
        raise NotImplementedError("val_device_metrics is not yet ported (ROADMAP A.3)")
    device = resolve_device(args.device)
    if args.decode_cache_gb is not None:
        from dasr_tpu_torch.data.io import enable_decode_cache

        enable_decode_cache(args.decode_cache_gb)
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    logger = logging.getLogger("base")
    logger.info(dict2str(opt))

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

    train_loader = val_set = None
    for phase, dataset_opt in (opt.get("datasets") or {}).items():
        if phase == "train":
            train_set = create_dataset(dataset_opt)
            train_loader = Loader(
                train_set,
                batch_size=int(dataset_opt.get("batch_size", 6) or 6),
                shuffle=bool(dataset_opt.get("use_shuffle", True)),
                num_workers=int(dataset_opt.get("n_workers", 6) or 6),
                drop_last=True,
                seed=int(train_opt.get("manual_seed", 0) or 0),
                pin_memory=device.type == "cuda",
            )
            logger.info(f"Number of train images: {len(train_set)}, iters per epoch: "
                        f"{len(train_loader)}")
        elif phase == "val":
            val_set = create_dataset(dataset_opt)
            logger.info(f"Number of val images: {len(val_set)}")
    if train_loader is None:
        raise ValueError("Train dataset is required.")
    if len(train_loader) == 0:
        raise ValueError("the train set holds fewer images than one batch (drop_last)")

    model = create_model(opt, device)
    model.init()
    model.load()

    tb_dir = None
    if opt.get("use_tb_logger") and "debug" not in (opt.get("name") or ""):
        tb_dir = os.path.join(opt["path"]["experiments_root"], "tb_logger")
    writer = MetricsWriter(os.path.join(opt["path"]["log"], "metrics.jsonl"), tb_dir=tb_dir)
    total_epochs = int(math.ceil(niter / len(train_loader)))
    logger.info(f"Total epochs needed: {total_epochs} for iters {niter}")
    lpips_fn = None
    if opt.get("val_lpips"):
        from dasr_tpu_torch.cli.srn_test import make_lpips

        lpips_fn = make_lpips(device)
    bs = train_loader.bs

    current_step, last = 0, {}
    try:
        for epoch in range(total_epochs):
            train_loader.set_epoch(epoch)
            for batch in train_loader:
                if current_step >= niter:
                    break
                metrics = model.train_step(batch)
                current_step += 1
                if current_step % print_freq == 0:
                    check_finite(metrics, current_step)
                    logger.info(f"<epoch:{epoch:3d}, iter:{current_step:8,d}> " + ", ".join(
                        f"{k.split('/')[-1]}: {v:.4e}" for k, v in metrics.items()))
                    # imgs: effective images per step (fake + real halves)
                    writer.write(current_step, metrics, imgs=bs * 2)
                    last = metrics
                if val_set is not None and current_step % val_freq == 0:
                    _validate(model, val_set, opt, current_step, logger, writer, lpips_fn)
                if val_set is not None and tsample_freq and current_step % tsample_freq == 0:
                    _save_tsamples(model, val_set, opt, current_step, writer)
                if current_step % save_freq == 0:
                    _save(model, opt, logger_opt, current_step, logger)
            if current_step >= niter:
                break
        logger.info("Saving the final model.")
        _save(model, opt, logger_opt, current_step, logger)
        logger.info("End of training.")
    finally:
        writer.close()
    return current_step, last


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


def _validate(model, val_set, opt, step, logger, writer, lpips_fn):
    """The reference's validation (codes/SRN/train.py:174-235) on the host
    f64 metric path: every val image (or ``max_val_images``), SR PNGs under
    val_images/<step>/, averages logged and written."""
    from dasr_tpu_torch.data.io import save_img
    from dasr_tpu_torch.eval.evaluate import average, sr_metrics, to_uint8

    cap = opt.get("max_val_images")
    n = min(len(val_set), int(cap)) if cap else len(val_set)
    if n < len(val_set):
        logger.info(f"Validating {n}/{len(val_set)} images (max_val_images={cap})")
    img_dir = os.path.join(opt["path"]["val_images"], str(step))
    results = []
    for i in range(n):
        data = val_set[i]
        sr = model.test(data["LR"])
        results.append(sr_metrics(to_uint8(sr), to_uint8(data["HR"]), opt.get("scale", 4),
                                  lpips_fn))
        base = os.path.splitext(os.path.basename(data["HR_path"]))[0]
        save_img(sr, os.path.join(img_dir, f"{base}_{step}.png"))
    avg = average(results)
    msg = f"# Validation # PSNR: {avg['psnr']:.4e}"
    if "lpips" in avg:
        msg += f", LPIPS: {avg['lpips']:.4e}"
    logger.info(msg)
    writer.write(step, {f"val/{k}": v for k, v in avg.items()})
    return avg


if __name__ == "__main__":
    main()
