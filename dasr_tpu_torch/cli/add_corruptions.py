"""Synthetic corruption tool of the port — ``python -m
dasr_tpu_torch.cli.add_corruptions --input_dir ... --output_dir ...
[--corruption noise|blur|jpeg]`` (a copy of ``dasr_tpu.cli.add_corruptions``,
reference: codes/DSN/add_corruptions.py).

Adds gaussian noise, gaussian blur or JPEG artifacts to clean images to
build synthetic source domains, with the reference's defaults (noise std 8,
blur sigma 1.6, JPEG quality 30; add_corruptions.py:10-21) and the noise
drawn from ``np.random.default_rng(seed)``: the output equals the JAX
package's byte for byte. Host only (cv2 and numpy): it has no ``--device``.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="Corrupt clean images")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--corruption", choices=["noise", "blur", "jpeg"], default="noise")
    p.add_argument("--noise_std", type=float, default=8.0)
    p.add_argument("--blur_sigma", type=float, default=1.6)
    p.add_argument("--jpeg_quality", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import cv2
    import numpy as np

    from dasr_tpu_torch.data.io import list_images

    rng = np.random.default_rng(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    for path in list_images(args.input_dir):
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if args.corruption == "noise":
            noise = np.rint(rng.normal(0.0, args.noise_std, img.shape))
            out = np.clip(img.astype(np.float64) + noise, 0, 255).astype(np.uint8)
        elif args.corruption == "blur":
            out = cv2.GaussianBlur(img, (0, 0), args.blur_sigma)
        else:
            _, enc = cv2.imencode(".jpg", img, [int(cv2.IMWRITE_JPEG_QUALITY), args.jpeg_quality])
            out = cv2.imdecode(enc, cv2.IMREAD_COLOR)
        cv2.imwrite(os.path.join(args.output_dir, os.path.basename(path)), out)
    print(f"wrote corrupted images to {args.output_dir}")
    return args.output_dir


if __name__ == "__main__":
    main()
