"""DSN single-model test CLI of the port — ``python -m
dasr_tpu_torch.cli.dsn_test --checkpoint ... --input_dir ... --output_dir
... [--device cuda]`` (the port of ``dasr_tpu.cli.dsn_test``, reference:
codes/DSN/test.py:87-152, whose stale discriminator call is not copied).

A trained DSN generator runs over every image of a folder and its outputs
are saved under their names; with ``--save_realness`` the FSD also runs on
each output, and its patch scores, back-projected into a DDM
(``ops/rf_splat.py``), are saved as ``{name}_ddm.npy`` of shape (1, 1, h,
w). Both nets run in f32 in eval mode, whole images (as the JAX CLI).
``--checkpoint`` is the port's checkpoint directory (its latest
``{iter}.pt``) or a DSN ``.tar``; orbax directories are JAX-only. Image i is
written while image i + 1 runs.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="Apply a trained DSN model to a folder")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the GPU or on the CPU (plain PyTorch)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--generator", default="DeResnet")
    p.add_argument("--num_res_blocks", type=int, default=8)
    p.add_argument("--upscale_factor", type=int, default=4, choices=[4, 1, 2])
    p.add_argument("--save_realness", action="store_true",
                   help="also run the FSD discriminator and save DDMs")
    p.add_argument("--discriminator", default="FSD")
    p.add_argument("--filter", default="gau")
    p.add_argument("--norm_layer", default="Instance")
    p.add_argument("--kernel_size", type=int, default=5)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from dasr_tpu_torch.cli.dsn_create_dataset import copy_to_host, load_nets
    from dasr_tpu_torch.core.device import resolve_device
    from dasr_tpu_torch.data.io import list_images, read_img, save_img
    from dasr_tpu_torch.nn.discriminators import FSDiscriminator
    from dasr_tpu_torch.nn.generators import DeResnet, DSGANGenerator
    from dasr_tpu_torch.ops.rf_splat import CONVNETS, ddm_shape_for, ddm_splat

    device = resolve_device(args.device)
    if args.generator == "DSGAN":
        g = DSGANGenerator(args.num_res_blocks)
    else:
        g = DeResnet(args.num_res_blocks, args.upscale_factor)
    d = None
    if args.save_realness:
        d = FSDiscriminator(d_arch=args.discriminator, filter_type=args.filter,
                            kernel_size=args.kernel_size, norm_layer=args.norm_layer)
    load_nets(args.checkpoint, g, d)
    g.to(device, memory_format=torch.channels_last).eval()
    if d is not None:
        d.to(device, memory_format=torch.channels_last).eval()
    os.makedirs(args.output_dir, exist_ok=True)

    def run(path):
        x = torch.from_numpy(read_img(path)).to(device).permute(2, 0, 1)[None]
        out = g(x)
        ddm = None
        if d is not None:
            h, w = ddm_shape_for(args.filter, out.shape[-2], out.shape[-1])
            ddm = ddm_splat(d(out)[0, 0], h, w, CONVNETS[args.discriminator])
        return copy_to_host(device, out, ddm)

    def drain(path, copies, event):
        (out, ddm), base = copies, os.path.basename(path)
        if event is not None:
            event.synchronize()
        save_img(out[0].permute(1, 2, 0).numpy(), os.path.join(args.output_dir, base))
        if ddm is not None:
            np.save(os.path.join(args.output_dir, base.split(".")[0] + "_ddm"),
                    ddm.numpy()[None, None])
        print(base)

    inflight = None
    with torch.no_grad():
        for path in list_images(args.input_dir):
            prev, inflight = inflight, (path, *run(path))
            if prev is not None:
                drain(*prev)
        if inflight is not None:
            drain(*inflight)
    return args.output_dir


if __name__ == "__main__":
    main()
