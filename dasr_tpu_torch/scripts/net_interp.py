"""Network interpolation (reference: codes/SRN/scripts/net_interp.py):

    python -m dasr_tpu_torch.scripts.net_interp --net_psnr A_G.pth --net_gan B_G.pth \
        --alpha 0.8 --out interp_G.pth

Blends a PSNR-oriented and a GAN-oriented generator,
theta = (1 - alpha) * theta_PSNR + alpha * theta_GAN, the ESRGAN trick for
trading fidelity against perceptual quality. The port of
``dasr_tpu.scripts.net_interp`` on torch state dicts: each input is a
reference-format ``*_G.pth`` or the port's ``{iter}.pt`` (its G), and the
output is a reference-format ``.pth``. Orbax checkpoint directories are the
JAX package's, and are refused.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np


def interpolate_params(sd_a: Dict[str, np.ndarray], sd_b: Dict[str, np.ndarray],
                       alpha: float) -> Dict[str, np.ndarray]:
    """(1 - alpha) * a + alpha * b of two state dicts with the same keys."""
    if set(sd_a) != set(sd_b):
        raise ValueError(f"the two networks differ in keys: {sorted(set(sd_a) ^ set(sd_b))}")
    return {k: (1.0 - alpha) * np.asarray(sd_a[k]) + alpha * np.asarray(sd_b[k]) for k in sd_a}


def load_g_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A generator's state dict as numpy: a reference ``.pth`` as it is, or
    the G of the port's ``{iter}.pt``."""
    import torch

    from dasr_tpu_torch.train.checkpoints import load_torch_state_dict

    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory: orbax checkpoints are JAX-only; interpolate them with "
            "dasr_tpu.scripts.net_interp")
    if path.endswith(".pt"):
        saved = torch.load(path, map_location="cpu", weights_only=True)
        return {k: v.numpy() for k, v in saved["G"]["net"].items()}
    return load_torch_state_dict(path)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--net_psnr", required=True, help="*_G.pth or the port's {iter}.pt")
    p.add_argument("--net_gan", required=True)
    p.add_argument("--alpha", type=float, default=0.8)
    p.add_argument("--out", required=True, help="output .pth (reference format)")
    args = p.parse_args(argv)

    import torch

    blended = interpolate_params(load_g_state_dict(args.net_psnr),
                                 load_g_state_dict(args.net_gan), args.alpha)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in blended.items()},
               args.out)
    print(f"wrote interpolated params (alpha={args.alpha}) to {args.out}")
    return blended


if __name__ == "__main__":
    main()
