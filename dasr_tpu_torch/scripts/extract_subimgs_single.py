"""Crop large training images into overlapping sub-images
(reference: codes/SRN/scripts/extract_subimgs_single.py) — parallelized
with a thread pool instead of multiprocessing. Host code, copied from
``dasr_tpu.scripts.extract_subimgs_single``:

    python -m dasr_tpu_torch.scripts.extract_subimgs_single --input_dir D --save_dir S
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np


def worker(path, save_dir, crop_sz, step, thres_sz):
    img_name = os.path.basename(path)
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    h, w = img.shape[0], img.shape[1]
    h_space = np.arange(0, max(h - crop_sz, 0) + 1, step)
    if h - (h_space[-1] + crop_sz) > thres_sz:
        h_space = np.append(h_space, h - crop_sz)
    w_space = np.arange(0, max(w - crop_sz, 0) + 1, step)
    if w - (w_space[-1] + crop_sz) > thres_sz:
        w_space = np.append(w_space, w - crop_sz)
    index = 0
    for x in h_space:
        for y in w_space:
            index += 1
            crop = img[x : x + crop_sz, y : y + crop_sz, ...]
            name = img_name.replace(".png", f"_s{index:03d}.png")
            cv2.imwrite(
                os.path.join(save_dir, name), crop,
                [cv2.IMWRITE_PNG_COMPRESSION, 3],
            )
    return img_name


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", required=True)
    p.add_argument("--save_dir", required=True)
    p.add_argument("--crop_sz", type=int, default=480)
    p.add_argument("--step", type=int, default=240)
    p.add_argument("--thres_sz", type=int, default=48)
    p.add_argument("--n_threads", type=int, default=8)
    args = p.parse_args(argv)

    from dasr_tpu_torch.data.io import list_images

    os.makedirs(args.save_dir, exist_ok=True)
    paths = list_images(args.input_dir)
    with ThreadPoolExecutor(max_workers=args.n_threads) as pool:
        for name in pool.map(
            lambda f: worker(f, args.save_dir, args.crop_sz, args.step, args.thres_sz),
            paths,
        ):
            print("Processing", name)
    print("All subprocesses done.")


if __name__ == "__main__":
    main()
