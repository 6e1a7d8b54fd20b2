"""SFT-GAN test CLI of the port — ``python -m dasr_tpu_torch.cli.sftgan_test
--model SFTGAN.pth --img_dir HR --seg_dir SEG --out OUT [--device cuda]``
(the port of ``dasr_tpu.cli.sftgan_test``, reference:
codes/SRN/test_sftgan.py).

Each image of ``--img_dir`` is modcropped to a multiple of 8 and
MATLAB-bicubic downscaled x1/4 (unless ``--lr_input``), its segmentation
probability maps are read from ``--seg_dir`` (``<base>_bic.pth``, a torch
tensor as the reference saves them, or ``<base>_bic.npy``; CHW or HWC,
with or without a batch axis), and SFTNet's x4 output is written to
``<out>/<base>_rlt.png``. f32, as the JAX CLI. The images are served by
model 'sftgan' (``models/registry.py:SFTGANModel``, ``test_async(lr,
seg)``; ``options``). ``--model`` is a reference ``.pth`` (loaded by the
reference's names) or the port's ``.pt`` (an SFTNet state dict, or a train
state's ``G``); an orbax directory is JAX-only. Image i is written while
image i + 1 runs.
"""

from __future__ import annotations

import argparse
import os


def load_seg(seg_dir: str, base: str):
    """The segmentation maps of image ``base``, as float32 CHW."""
    import numpy as np
    import torch

    pth = os.path.join(seg_dir, base + "_bic.pth")
    npy = os.path.join(seg_dir, base + "_bic.npy")
    if os.path.exists(pth):
        seg = np.asarray(torch.load(pth, map_location="cpu", weights_only=True))
    elif os.path.exists(npy):
        seg = np.load(npy)
    else:
        raise FileNotFoundError(f"no seg map for {base} in {seg_dir}")
    if seg.ndim == 4:
        seg = seg[0]
    if not (seg.shape[0] <= 32 and seg.shape[0] < seg.shape[-1]):  # HWC -> CHW
        seg = np.transpose(seg, (2, 0, 1))
    return np.ascontiguousarray(seg, dtype=np.float32)


def options(model_path: str, n_blocks: int = 16) -> dict:
    """Model 'sftgan''s options for SFTNet of ``n_blocks`` blocks from
    ``model_path``, in f32."""
    return {"model": "sftgan", "scale": 4, "bf16": False,
            "network_G": {"which_model_G": "sft_arch", "nb": n_blocks},
            "path": {"pretrain_model_G": model_path}}


def main(argv=None):
    p = argparse.ArgumentParser(description="SFT-GAN x4 SR with segmentation maps")
    p.add_argument("--model", required=True,
                   help="SFTGAN .pth (reference format) or the port's .pt")
    p.add_argument("--img_dir", required=True, help="HR (or LR) image folder")
    p.add_argument("--seg_dir", required=True,
                   help="segmentation probability maps (<base>_bic.pth/.npy)")
    p.add_argument("--out", required=True)
    p.add_argument("--lr_input", action="store_true",
                   help="treat img_dir as already-LR inputs (no downscale)")
    p.add_argument("--n_blocks", type=int, default=16)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the GPU or on the CPU (plain PyTorch)")
    args = p.parse_args(argv)

    import torch

    from dasr_tpu_torch.core.device import resolve_device
    from dasr_tpu_torch.data.io import list_images, read_img, save_img
    from dasr_tpu_torch.models.registry import create_model
    from dasr_tpu_torch.ops.metrics import modcrop
    from dasr_tpu_torch.ops.resize import imresize_np

    device = resolve_device(args.device)
    model = create_model(options(args.model, args.n_blocks), device).load()
    model.g.to(device, memory_format=torch.channels_last).eval()
    os.makedirs(args.out, exist_ok=True)
    written = []

    def finish(path, out):
        save_img(out.cpu().numpy(), path)
        written.append(path)

    inflight = None
    for idx, path in enumerate(list_images(args.img_dir)):
        base = os.path.splitext(os.path.basename(path))[0]
        print(idx + 1, base, flush=True)
        img = read_img(path)
        if not args.lr_input:
            img = imresize_np(modcrop(img, 8), 0.25)
        out = model.test_async(img, load_seg(args.seg_dir, base))
        prev, inflight = inflight, (os.path.join(args.out, base + "_rlt.png"), out)
        if prev is not None:
            finish(*prev)
    if inflight is not None:
        finish(*inflight)
    print("done.", flush=True)
    return written


if __name__ == "__main__":
    main()
