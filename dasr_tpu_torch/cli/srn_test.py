"""SRN inference/eval CLI of the port — ``python -m
dasr_tpu_torch.cli.srn_test -opt options/test/test_sr.json [--device cuda]``.

Mirrors codes/SRN/test.py and ``dasr_tpu.cli.srn_test``: loads the
commented-JSON options, builds the model, runs every test dataset, saves SR
PNGs under results/<name>/<set>/, and reports per-image and average
PSNR/SSIM (+Y) with a scale-px border crop. Returns the per-set averages.

Not ported yet, and refused rather than skipped: ``--mesh``,
``--spatial_shard``, ``--device_metrics``, ``--metrics_pad_bucket`` and
``val_lpips: true``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True, help="Path to options JSON file.")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="run on the GPU (hand-written kernels) or on the CPU "
                             "(plain PyTorch versions)")
    parser.add_argument("--mesh", type=int, default=0, help="not yet ported (ROADMAP A.11)")
    parser.add_argument("--spatial_shard", action="store_true",
                        help="not yet ported (ROADMAP A.11)")
    parser.add_argument("--device_metrics", action="store_true",
                        help="not yet ported (ROADMAP A.3)")
    parser.add_argument("--metrics_pad_bucket", type=int, default=0,
                        help="not yet ported (ROADMAP A.3)")
    args = parser.parse_args(argv)
    for flag, on, item in (
        ("--mesh", args.mesh, "A.11"),
        ("--spatial_shard", args.spatial_shard, "A.11"),
        ("--device_metrics", args.device_metrics, "A.3"),
        ("--metrics_pad_bucket", args.metrics_pad_bucket, "A.3"),
    ):
        if on:
            raise NotImplementedError(f"{flag} is not yet ported (ROADMAP {item})")

    from dasr_tpu_torch.core.config import dict2str, parse_srn_options
    from dasr_tpu_torch.core.device import resolve_device
    from dasr_tpu_torch.data.datasets import create_dataset
    from dasr_tpu_torch.data.io import save_img
    from dasr_tpu_torch.eval.evaluate import average, sr_metrics, to_uint8
    from dasr_tpu_torch.models.registry import create_model

    opt = parse_srn_options(args.opt, is_train=False)
    if opt.get("val_lpips"):
        raise NotImplementedError(
            "val_lpips: true is not yet ported (ROADMAP A.4, losses/lpips.py); "
            "set val_lpips: false"
        )
    device = resolve_device(args.device)
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    logger = logging.getLogger("base")
    logger.info(dict2str(opt))

    model = create_model(opt, device)
    model.init()
    model.load()

    averages = {}
    for _, dataset_opt in sorted((opt.get("datasets") or {}).items()):
        test_set = create_dataset(dataset_opt)
        name = dataset_opt["name"]
        logger.info(f"\nTesting [{name}]...")
        dataset_dir = os.path.join(opt["path"]["results_root"], name)
        os.makedirs(dataset_dir, exist_ok=True)

        per_image = []
        for i in range(len(test_set)):
            data = test_set[i]
            sr = model.test(data["LR"])
            base = os.path.splitext(os.path.basename(data["LR_path"]))[0]
            save_img(sr, os.path.join(dataset_dir, base + ".png"))
            if "HR" not in data:
                logger.info(f"{i + 1:3d} - {base}")
                continue
            m = sr_metrics(to_uint8(sr), to_uint8(data["HR"]), opt.get("scale", 4))
            per_image.append(m)
            logger.info(
                f"{i + 1:3d} - {base:25s} PSNR: {m['psnr']:.6f} dB; "
                f"SSIM: {m['ssim']:.6f}"
                + (f"; PSNR_Y: {m['psnr_y']:.6f} dB; SSIM_Y: {m['ssim_y']:.6f}"
                   if "psnr_y" in m else "")
            )

        if per_image:
            avg = average(per_image)
            averages[name] = avg
            logger.info(
                f"----Average PSNR/SSIM results for {name}----\n"
                f"\tPSNR: {avg['psnr']:.6f} dB; SSIM: {avg['ssim']:.6f}"
            )
            if "psnr_y" in avg:
                logger.info(f"\tPSNR_Y: {avg['psnr_y']:.6f} dB; SSIM_Y: {avg['ssim_y']:.6f}")
    return averages


if __name__ == "__main__":
    main()
