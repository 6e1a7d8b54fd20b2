"""Quality-parity harness of the port against the published reference
checkpoints: ``python -m dasr_tpu_torch.cli.parity --g_pth ... --hr_dir ...
--lr_dir ... [--device cuda]``.

Port of ``dasr_tpu.cli.parity``. Given the published weights (README.md:57-65
Google-Drive checkpoints, not in this repository) and a torchvision AlexNet
for LPIPS, it runs the reference eval protocol (codes/SRN/test.py:84-118:
uint8 roundtrip, scale-px border crop, LPIPS net-lin alex) over a val set
with the port's 'sr' ``SRModel`` (``RRDB_net``, bf16, the fused-RDB kernel
on the card) and emits the PSNR/SSIM/LPIPS table next to the BASELINE.md
target (<= 0.02 LPIPS delta vs the reference implementation's outputs).
Image i is read back and measured while image i + 1 runs.

    python -m dasr_tpu_torch.cli.parity \\
        --g_pth /weights/DASR_aim2019_G.pth \\
        --lpips_backbone /weights/alexnet-owt.pth \\
        --hr_dir /data/AIM2019/valid_hr --lr_dir /data/AIM2019/valid_lr \\
        --out parity_report.md

It runs end to end on random-init weights too (for pipeline validation),
with an unmissable banner that the numbers are then meaningless. The last
line is JSON: the averages, the image count and whether weights were given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--g_pth", default=None,
                   help="published {iter}_G.pth RRDBNet checkpoint (reference names)")
    p.add_argument("--lpips_backbone", default=None,
                   help="torchvision alexnet state dict (.pth)")
    p.add_argument("--lpips_lin", default=None,
                   help="LPIPS v0.1 lin heads (default: the reference's bundled copy, "
                        "where mounted)")
    p.add_argument("--hr_dir", required=True)
    p.add_argument("--lr_dir", required=True)
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--nb", type=int, default=23)
    p.add_argument("--nf", type=int, default=64)
    p.add_argument("--gc", type=int, default=32)
    p.add_argument("--chop", action="store_true")
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--out", default=None, help="write a markdown report here")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the GPU (hand-written kernels) or on the CPU (plain PyTorch)")
    return p.parse_args(argv)


def main(argv=None):
    opt = build_args(argv)
    import torch

    from dasr_tpu_torch.core.device import resolve_device
    from dasr_tpu_torch.data.datasets import PairedDataset
    from dasr_tpu_torch.eval.evaluate import average, sr_metrics, to_uint8
    from dasr_tpu_torch.losses.lpips import create_dist_model
    from dasr_tpu_torch.models.registry import SRModel

    device = resolve_device(opt.device)
    banners = []
    if not opt.g_pth:
        banners.append(
            "GENERATOR WEIGHTS NOT SUPPLIED — running random-init RRDBNet; "
            "PSNR/SSIM/LPIPS below do NOT measure parity. Pass --g_pth with "
            "the published checkpoint (reference README.md:57-65)."
        )
    if not opt.lpips_backbone:
        banners.append(
            "LPIPS BACKBONE NOT SUPPLIED — alexnet runs random-init; LPIPS "
            "values are structurally correct but numerically meaningless. "
            "Pass --lpips_backbone with a torchvision alexnet .pth."
        )
    for b in banners:
        print(f"!!! {b}", file=sys.stderr)

    model_opt = {
        "model": "sr", "scale": opt.scale, "chop": bool(opt.chop),
        "network_G": {"which_model_G": "RRDB_net", "nf": opt.nf,
                      "nb": opt.nb, "gc": opt.gc, "norm_type": None},
        "path": {"pretrain_model_G": opt.g_pth},
        "train": {},
    }
    model = SRModel(model_opt, device).init().load()

    lpips = create_dist_model("net-lin", "alex", lin_path=opt.lpips_lin,
                              backbone_path=opt.lpips_backbone, device=device)

    def lpips_fn(a, b):  # (1, H, W, 3) numpy images in [-1, 1]
        return float(lpips(*(torch.from_numpy(v).permute(0, 3, 1, 2) for v in (a, b))))

    ds = PairedDataset({"dataroot_HR": opt.hr_dir, "dataroot_LR": opt.lr_dir,
                        "phase": "val", "scale": opt.scale, "name": "parity"})
    n = len(ds) if opt.max_images is None else min(len(ds), opt.max_images)
    rows = []

    def drain(i, data, sr_dev):
        m = sr_metrics(to_uint8(sr_dev.cpu().numpy()), to_uint8(data["HR"]), opt.scale,
                       lpips_fn)
        name = os.path.basename(data.get("HR_path", str(i)))
        rows.append((name, m))
        print(f"{i+1:3d}/{n} {name}: PSNR {m['psnr']:.4f} SSIM {m['ssim']:.4f}"
              + (f" LPIPS {m['lpips']:.4f}" if "lpips" in m else ""))

    inflight = None
    for i in range(n):
        data = ds[i]
        prev, inflight = inflight, (i, data, model.test_async(data["LR"]))
        if prev is not None:
            drain(*prev)
    if inflight is not None:
        drain(*inflight)
    avg = average([m for _, m in rows])

    lines = ["# Parity report", ""]
    for b in banners:
        lines.append(f"**WARNING:** {b}")
        lines.append("")
    lines += [
        f"- images: {n}  (HR: `{opt.hr_dir}`)",
        f"- generator: RRDBNet nf={opt.nf} nb={opt.nb} gc={opt.gc}"
        + (f" from `{opt.g_pth}`" if opt.g_pth else " RANDOM-INIT"),
        "",
        "| metric | value | target |",
        "|---|---|---|",
        f"| PSNR | {avg['psnr']:.4f} | reference-run PSNR +- 0.1 dB |",
        f"| SSIM | {avg['ssim']:.4f} | reference-run SSIM |",
    ]
    if "lpips" in avg:
        lines.append(
            f"| LPIPS | {avg['lpips']:.4f} | <= reference-run LPIPS + 0.02 "
            "(BASELINE.md) |"
        )
    report = "\n".join(lines) + "\n"
    if opt.out:
        with open(opt.out, "w") as f:
            f.write(report)
    print(report)
    print(json.dumps({"parity_avg": {k: round(float(v), 5) for k, v in avg.items()},
                      "n": n, "weights_supplied": bool(opt.g_pth)}))
    return avg


if __name__ == "__main__":
    main()
