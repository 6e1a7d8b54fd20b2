"""Dataloader smoke-visualizer of the port (reference:
codes/SRN/test_dataloader.py): ``python -m dasr_tpu_torch.cli.test_dataloader
-opt <train json> [--out DIR] [--n N]``.

Port of ``dasr_tpu.cli.test_dataloader``, host only: builds the train
dataset of an options JSON and writes the first N items' images as PNGs
(LRs, HRs, and weight maps as heatmaps) so the crop, augment and DDM
alignment can be checked before training. Item i draws from
``np.random.default_rng(i)``, as the JAX CLI's does.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-opt", required=True, help="train options JSON")
    p.add_argument("--out", default="./dataloader_vis")
    p.add_argument("--n", type=int, default=4)
    args = p.parse_args(argv)

    from dasr_tpu_torch.core.config import parse_srn_options
    from dasr_tpu_torch.data.datasets import create_dataset
    from dasr_tpu_torch.data.io import save_img

    opt = parse_srn_options(args.opt, is_train=True)
    ds = create_dataset(opt["datasets"]["train"])
    os.makedirs(args.out, exist_ok=True)
    for i in range(min(args.n, len(ds))):
        item = ds.__getitem__(i, rng=np.random.default_rng(i))
        for k, v in item.items():
            if not isinstance(v, np.ndarray):
                continue
            if v.ndim == 3 and v.shape[2] == 1:  # weight map -> heatmap
                lo, hi = float(v.min()), float(v.max())
                vis = np.repeat((v - lo) / (hi - lo + 1e-8), 3, axis=2)
                save_img(vis, os.path.join(args.out, f"{i:02d}_{k}.png"))
            elif v.ndim == 3:
                save_img(v, os.path.join(args.out, f"{i:02d}_{k}.png"))
        print(f"item {i}: " + ", ".join(
            f"{k}{tuple(v.shape)}" for k, v in item.items() if isinstance(v, np.ndarray)))
    print(f"wrote visualizations to {args.out}")


if __name__ == "__main__":
    main()
