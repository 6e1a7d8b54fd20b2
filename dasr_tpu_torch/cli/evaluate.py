"""Directory-against-directory evaluation CLI of the port — ``python -m
dasr_tpu_torch.cli.evaluate --dir_a <results> --dir_b <ground truth>
[--device cuda]`` (the port of ``dasr_tpu.cli.evaluate``, reference:
codes/DSN/evaluate.py:22-62).

Sorted file pairs, each cropped to their common size (and by
``--border_crop``), give PSNR, PSNR_col (the PSNR of the per-channel means
in [0, 1]) and SSIM on the uint8 images, and LPIPS (alex) on ``--device``;
it prints one line a pair and the ``== mean ==`` block, and returns the
averages. The host path computes PSNR, PSNR_col and SSIM in f64;
``--device_metrics`` computes them on the device (PSNR and SSIM in f32,
within 1e-3 dB and 1e-4 SSIM of the host; PSNR_col from exact integer sums,
``ops/metrics.py:psnr_col_device``), and ``--pad_bucket N`` there pads each
pair to multiples of N for the masked forms (exact; LPIPS on the unpadded
pair). Pair i is read back after pair i + 1 is issued.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate two image directories")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run LPIPS (and --device_metrics) on the GPU or on the CPU")
    p.add_argument("--dir_a", "--dir_gen", dest="dir_a", required=True)
    p.add_argument("--dir_b", "--dir_gt", dest="dir_b", required=True)
    p.add_argument("--no_lpips", action="store_true")
    p.add_argument("--border_crop", type=int, default=None,
                   help="pixels removed at the border before metrics "
                        "(reference: DSN/evaluate.py:19)")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device_metrics", action="store_true",
                   help="PSNR/PSNR_col/SSIM (and LPIPS) on the device, one stacked "
                        "result a pair (f32; within 1e-3 dB / 1e-4 SSIM of the host f64 "
                        "protocol)")
    p.add_argument("--pad_bucket", type=int, default=0,
                   help="with --device_metrics: zero-pad each pair to a multiple of N "
                        "and use the masked metrics (exact); LPIPS runs on the "
                        "unpadded pair")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from dasr_tpu_torch.core.device import resolve_device
    from dasr_tpu_torch.data.io import list_images, read_img
    from dasr_tpu_torch.eval.evaluate import average, pad_pair_to_bucket, to_uint8
    from dasr_tpu_torch.ops.metrics import (
        calculate_psnr, calculate_ssim, psnr_col_device, psnr_device_masked, ssim_device_masked)

    device = resolve_device(args.device)
    files_a = list_images(args.dir_a)
    files_b = list_images(args.dir_b)
    n = min(len(files_a), len(files_b))
    if args.limit:
        n = min(n, args.limit)

    lpips_raw = None
    if not args.no_lpips:
        from dasr_tpu_torch.cli.srn_test import make_lpips

        lpips_raw = make_lpips(device).raw

    def to_device(img_u8):
        """A uint8 HWC image as a (1, H, W, C) f32 tensor of 0..255 values."""
        return torch.from_numpy(np.ascontiguousarray(img_u8)).to(device).float()[None]

    def lpips_of(a, b):
        """LPIPS of two (1, H, W, C) tensors of 0..255 values, unsynchronised."""
        return lpips_raw(*(v.permute(0, 3, 1, 2) / 127.5 - 1.0 for v in (a, b))).reshape(())

    def device_pair(a_u8, b_u8):
        """[psnr, psnr_col, ssim (, lpips)] of a uint8 pair as one device
        tensor; with --pad_bucket, the masked metrics of the padded pair."""
        h, w = a_u8.shape[0], a_u8.shape[1]
        if args.pad_bucket:
            pa, pb, h, w = pad_pair_to_bucket(a_u8, b_u8, args.pad_bucket)
            a, b = to_device(pa), to_device(pb)
        else:
            a, b = to_device(a_u8), to_device(b_u8)
        vals = [psnr_device_masked(a, b, h, w, 255.0)[0], psnr_col_device(a, b, h, w)[0],
                ssim_device_masked(a, b, h, w)[0]]
        if lpips_raw is not None:
            if args.pad_bucket:  # LPIPS mixes padded pixels through its convs
                a, b = to_device(a_u8), to_device(b_u8)
            vals.append(lpips_of(a, b))
        return torch.stack([v.reshape(()) for v in vals])

    def host_pair(a_u8, b_u8):
        """The f64 metrics of a uint8 pair, with LPIPS as a device tensor."""
        a, b = a_u8.astype(np.float64), b_u8.astype(np.float64)
        mse_col = float(np.mean((a.mean(axis=(0, 1)) / 255.0 - b.mean(axis=(0, 1)) / 255.0) ** 2))
        m = {"psnr": calculate_psnr(a, b),
             "psnr_col": float("inf") if mse_col == 0 else 10 * np.log10(1.0 / mse_col),
             "ssim": calculate_ssim(a, b)}
        return m, None if lpips_raw is None else lpips_of(to_device(a_u8), to_device(b_u8))

    results = []

    def drain(name, host, dev):
        if args.device_metrics:
            vals = dev.tolist()
            m = dict(zip(("psnr", "psnr_col", "ssim", "lpips"), vals))
        else:
            m = dict(host)
            if dev is not None:
                m["lpips"] = float(dev)
        results.append(m)
        print(f"{name}: " + ", ".join(f"{k}={v:.4f}" for k, v in m.items()))

    inflight = None
    with torch.no_grad():
        for i in range(n):
            a = to_uint8(read_img(files_a[i]))
            b = to_uint8(read_img(files_b[i]))
            h, w = min(a.shape[0], b.shape[0]), min(a.shape[1], b.shape[1])
            a, b = a[:h, :w], b[:h, :w]
            if args.border_crop:
                c = args.border_crop
                a, b = a[c:-c, c:-c], b[c:-c, c:-c]
            host, dev = (None, device_pair(a, b)) if args.device_metrics else host_pair(a, b)
            prev, inflight = inflight, (os.path.basename(files_a[i]), host, dev)
            if prev is not None:
                drain(*prev)
        if inflight is not None:
            drain(*inflight)

    avg = average(results)
    print("== mean ==")
    for k, v in avg.items():
        print(f"{k}: {v:.6f}")
    return avg


if __name__ == "__main__":
    main()
