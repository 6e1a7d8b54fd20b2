"""SRN inference/eval CLI of the port — ``python -m
dasr_tpu_torch.cli.srn_test -opt options/test/test_sr.json [--device cuda]``.

Mirrors codes/SRN/test.py and ``dasr_tpu.cli.srn_test``: loads the
commented-JSON options, builds the model, runs every test dataset, saves SR
PNGs under results/<name>/<set>/, and reports per-image and average
PSNR/SSIM (+Y) with a scale-px border crop. Returns the per-set averages.
Image i is read back, measured and written while image i + 1 runs.

With ``val_lpips: true`` it also reports LPIPS (alex) on the uint8 images,
on the device (``make_lpips``). ``--device_metrics`` computes PSNR/SSIM
(+Y) and LPIPS on the device as well (within 1e-3 dB and 1e-4 SSIM of the
host f64 protocol); the chop and ``pad_bucket`` forwards keep the host
metrics unless ``--metrics_pad_bucket N`` pads each pair to a multiple of
N for the masked metrics (exact; LPIPS per shape).

The models: 'sr' (``RRDB_net`` or ``sr_resnet``), 'srgan' / 'srragan',
'DASR', 'DASR_Adaptive_Model', 'De_Resnet' and 'De_patch_wavelet_GAN'. The
last two degrade the image they are given: with an HR image in the set they
take the HR image and are held against the LR one (their ``val_keys``),
else they take the LR image and report no metrics. With
``save_RealorFake: true`` a model with a realness map ('De_patch_wavelet_GAN')
also writes ``<base>_ddm.npy``, (1, 1, h / 2, w / 2), its D's map of the LR
image (codes/SRN/test.py:44-46, 77-79).

``--mesh N`` serves over the N ranks of a launcher's world (``python -m
torch.distributed.run --nproc_per_node N -m dasr_tpu_torch.cli.srn_test
-opt ... --mesh N``; any other world is refused): with the JSON's ``chop``
the tile batch fans out over the ranks, with ``--spatial_shard`` each
image's H axis is split over them with halo exchange
(``ops/spatial_shard.py``), as JAX's ``--mesh`` does over its devices.
Rank 0 alone writes the PNGs and reports the metrics, which fall back to
the host path unless ``--metrics_pad_bucket`` is given, as JAX's do.
Without ``--mesh``, ``--spatial_shard`` does nothing, as in JAX.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True, help="Path to options JSON file.")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="run on the GPU (hand-written kernels) or on the CPU "
                             "(plain PyTorch versions)")
    parser.add_argument("--mesh", type=int, default=0,
                        help="serve over the N ranks of a torchrun world: with the JSON's chop "
                             "flag the tile batch fans out over them; with --spatial_shard "
                             "the image's H axis is split over them with halo exchange")
    parser.add_argument("--spatial_shard", action="store_true",
                        help="split each image's H axis over the --mesh ranks (halo "
                             "exchange; exact for a receptive field <= 20 px, the "
                             "reference's forward_chop shave)")
    parser.add_argument("--device_metrics", action="store_true",
                        help="PSNR/SSIM (+Y) and LPIPS on the device instead of the host "
                             "f64 path (within 1e-3 dB / 1e-4 SSIM); with --mesh the host "
                             "path serves unless --metrics_pad_bucket is given")
    parser.add_argument("--metrics_pad_bucket", type=int, default=0,
                        help="with --device_metrics: zero-pad each SR/HR pair to a multiple "
                             "of N and mask (exact); works with any forward")
    args = parser.parse_args(argv)

    from dasr_tpu_torch.core import dist
    from dasr_tpu_torch.core.config import dict2str, parse_srn_options
    from dasr_tpu_torch.core.device import resolve_device
    from dasr_tpu_torch.data.datasets import create_dataset
    from dasr_tpu_torch.data.io import save_img
    from dasr_tpu_torch.eval.evaluate import average, sr_metrics_on
    from dasr_tpu_torch.models.registry import create_model

    opt = parse_srn_options(args.opt, is_train=False)
    dist.init_world(resolve_device(args.device))
    world = dist.refuse_mismatch(args.mesh, "dasr_tpu_torch.cli.srn_test")
    device, main_rank = world.device, world.is_main
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    logger = logging.getLogger("base")
    logger.setLevel(logging.INFO if main_rank else logging.WARNING)
    logger.info(dict2str(opt))

    model = create_model(opt, device)
    model.init()
    model.load()
    if args.mesh:
        model.prepare_mesh(world, spatial_shard=args.spatial_shard)
    lpips_fn = make_lpips(device) if opt.get("val_lpips") else None
    measure = sr_metrics_on(opt, lpips_fn, args.device_metrics, args.metrics_pad_bucket,
                            mesh=bool(args.mesh))
    realness = opt.get("save_RealorFake") and getattr(model, "realness_map", None)
    if opt.get("save_RealorFake") and not realness:
        logger.info(f"save_RealorFake: model [{opt.get('model')}] has no realness map; "
                    "no _ddm.npy is written")

    averages = {}
    for _, dataset_opt in sorted((opt.get("datasets") or {}).items()):
        test_set = create_dataset(dataset_opt)
        name = dataset_opt["name"]
        logger.info(f"\nTesting [{name}]...")
        dataset_dir = os.path.join(opt["path"]["results_root"], name)
        if main_rank:
            os.makedirs(dataset_dir, exist_ok=True)

        per_image = []

        def finish(i, data, sr_dev, done):
            sr = sr_dev.cpu().numpy()
            base = os.path.splitext(os.path.basename(data["LR_path"]))[0]
            save_img(sr, os.path.join(dataset_dir, base + ".png"))
            if realness and "LR" in data:
                np.save(os.path.join(dataset_dir, base + "_ddm.npy"),
                        realness(data["LR"])[None, None])
            if done is None:
                logger.info(f"{i + 1:3d} - {base}")
                return
            m = done(sr)
            per_image.append(m)
            logger.info(
                f"{i + 1:3d} - {base:25s} PSNR: {m['psnr']:.6f} dB; "
                f"SSIM: {m['ssim']:.6f}"
                + (f"; PSNR_Y: {m['psnr_y']:.6f} dB; SSIM_Y: {m['ssim_y']:.6f}"
                   if "psnr_y" in m else "")
                + (f"; LPIPS: {m['lpips']:.6f}" if "lpips" in m else "")
            )

        src, ref = model.val_keys
        inflight = None
        for i in range(len(test_set)):
            data = test_set[i]
            paired = src in data and ref in data
            sr_dev = model.test_async(data[src if paired else "LR"])
            if not main_rank:  # every rank serves, rank 0 alone writes and measures
                continue
            done = measure(sr_dev, data[ref]) if paired else None
            prev, inflight = inflight, (i, data, sr_dev, done)
            if prev is not None:
                finish(*prev)
        if inflight is not None:
            finish(*inflight)

        if per_image:
            avg = average(per_image)
            averages[name] = avg
            logger.info(
                f"----Average PSNR/SSIM results for {name}----\n"
                f"\tPSNR: {avg['psnr']:.6f} dB; SSIM: {avg['ssim']:.6f}"
            )
            if "psnr_y" in avg:
                logger.info(f"\tPSNR_Y: {avg['psnr_y']:.6f} dB; SSIM_Y: {avg['ssim_y']:.6f}")
            if "lpips" in avg:
                logger.info(f"\tLPIPS: {avg['lpips']:.6f}")
    return averages


def make_lpips(device):
    """``fn(a, b)`` -> LPIPS (alex, f32) of two (1, H, W, 3) numpy images in
    [-1, 1], computed on ``device`` (``default_lpips``'s weights);
    ``fn.raw(a, b)`` takes NCHW tensors on ``device`` and returns the
    LPIPS tensor without waiting for it."""
    import torch

    from dasr_tpu_torch.losses.lpips import default_lpips

    lpips = default_lpips("alex").to(device)

    @torch.no_grad()
    def raw(a, b):
        return lpips(a, b).reshape(())

    def compute(a, b):
        def t(v):
            return torch.from_numpy(np.ascontiguousarray(v)).permute(0, 3, 1, 2).to(device)

        return float(raw(t(a), t(b)))

    compute.raw = raw
    return compute


if __name__ == "__main__":
    main()
