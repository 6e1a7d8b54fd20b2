"""Pseudo-LR and domain-distance-map generation CLI of the port (stage 2) —
``python -m dasr_tpu_torch.cli.dsn_create_dataset --checkpoint ... --name ...
[--device cuda]``, with the flags of ``dasr_tpu.cli.dsn_create_dataset``
(mirroring codes/DSN/create_dataset_modified.py).

The trained DSN generator runs over every target HR image for the pseudo
LRs (``imgs_from_target/*.png``, ``ceil(h / scale) x ceil(w / scale)``),
and the discriminator's patch scores on each device-side fake are
back-projected into per-pixel DDMs (``ddm_target/*.npy``, shape
(1, 1, h, w) like the reference), optionally for the source images too
(``ddm_source/``). Both nets run in f32, D's BatchNorm in eval mode. Above
``TILE_ABOVE`` HR pixels G runs by tiles (``tiled_apply``, tile ``TILE``,
halo 16 x scale), where the reference pushes whole 2K images through. While
the card works on one image, the host writes the one before.

``--checkpoint`` is the port's checkpoint directory (its latest
``{iter}.pt``) or a reference-format DSN ``.tar`` (the port's or the JAX
package's ``last_iteration.tar``), which is copied into the output
directory.

``--mesh N`` runs over the N ranks of a launcher's world (``python -m
torch.distributed.run --nproc_per_node N -m
dasr_tpu_torch.cli.dsn_create_dataset ... --mesh N``; any other world is
refused), with JAX's mesh rule: G's tiles are ``MESH_TILE`` pixels, above
``MESH_TILE``^2 HR pixels, and fan out over the ranks (``tiled_apply``).
Rank 0 alone scores the fakes with D and writes; its outputs equal those
of ``--mesh 1``.
"""

from __future__ import annotations

import argparse
import math
import os
import shutil

TILE = 512  # G's tile side on large HR images, in HR pixels
TILE_ABOVE = 1024 * 1024  # HR pixels above which G runs by tiles
MESH_TILE = 256  # G's tile side with --mesh, tiled above MESH_TILE^2 HR pixels (JAX's rule)

# dataset name -> (registry dataset, artifact), as the reference CLI names them
_DATASET_KEYS = {
    "aim2019": ("aim2019", "tdsr"),
    "ntire2020": ("ntire2020", "tdsr"),
    "realsr_tddiv2k": ("realsr", "tddiv2k"),
    "realsr_tdrealsr": ("realsr", "tdrealsr"),
    "realsr_tdrealsr_2x": ("realsr", "tdrealsr_x2"),
    "camerasr": ("camerasr", "tdsr"),
}


def build_argparser():
    p = argparse.ArgumentParser(description="Apply the trained model to create a dataset")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the GPU or on the CPU (plain PyTorch)")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--generator", type=str, default="DeResnet")
    p.add_argument("--num_res_blocks", type=int, default=8)
    p.add_argument("--discriminator", type=str, default="FSD")
    p.add_argument("--kernel_size", type=int, default=5)
    p.add_argument("--wgan", action="store_true")
    p.add_argument("--no_highpass", dest="highpass", action="store_false")
    p.add_argument("--filter", type=str, default="gau")
    p.add_argument("--cat_or_sum", type=str, default="cat")
    p.add_argument("--norm_layer", type=str, default="Instance")
    p.add_argument("--artifacts", type=str, default="tdsr")
    p.add_argument("--name", type=str, default="0603_DSN_LRs")
    p.add_argument("--dataset", type=str, default="aim2019")
    p.add_argument("--including_source_ddm", action="store_true")
    p.add_argument("--no_ddm", action="store_true",
                   help="legacy FSSR mode: LRs only, no DDMs (codes/DSN/create_dataset.py)")
    p.add_argument("--transfer_uint8", action="store_true",
                   help="upload images as uint8, cast to f32/255 on the device (exact)")
    p.add_argument("--mesh", type=int, default=0,
                   help="fan G's tiles out over the N ranks of a torchrun world (tile 256 "
                        "above 256x256 HR pixels, as JAX's --mesh)")
    p.add_argument("--pad_bucket", type=int, default=0,
                   help="reflect-pad image sizes up to multiples of N before G (tiny "
                        "border deviations); 0 = exact")
    p.add_argument("--upscale_factor", type=int, default=4, choices=[4, 1, 2])
    p.add_argument("--paths_yml", type=str, default=None,
                   help="dataset registry (defaults to the repo's paths.yml)")
    p.add_argument("--results_root", type=str, default="../../DSN_results")
    p.add_argument("--source_dir", type=str, default=None,
                   help="override source dir (else from paths.yml)")
    p.add_argument("--target_dir", type=str, default=None)
    return p


def generate_lr(g, x, scale: int, tile: int = TILE, above: int = TILE_ABOVE, world=None):
    """G over one NCHW HR batch ``x``: whole up to ``above`` pixels, else by
    ``tile`` x ``tile`` tiles with a 16 x ``scale`` halo, fanned out over
    ``world``'s ranks; cropped to ceil(h / scale) x ceil(w / scale)."""
    from dasr_tpu_torch.ops.tiled import tiled_apply

    h, w = x.shape[-2], x.shape[-1]
    if h * w > above:
        out = tiled_apply(x, g, scale=1.0 / scale, tile=tile, halo=16 * scale, world=world)
    else:
        out = g(x)
    return out[..., : math.ceil(h / scale), : math.ceil(w / scale)]


def load_nets(checkpoint: str, g, d=None, verbose: bool = True) -> bool:
    """Load G (and D) from the port's checkpoint directory (its latest
    ``{iter}.pt``) or a DSN ``.tar``, saying which unless not ``verbose``;
    returns whether it was a ``.tar``."""
    import torch

    from dasr_tpu_torch.train.checkpoints import latest_train_state, load_dsn_tar

    if os.path.isdir(checkpoint):
        path = latest_train_state(checkpoint)
        if path is None:
            raise SystemExit(f"{checkpoint} holds no train state ({{iter}}.pt); orbax "
                             f"checkpoint directories are JAX-only")
        saved = torch.load(path, map_location="cpu", weights_only=True)
        g.load_state_dict(saved["G"]["net"])
        if d is not None:
            d.load_state_dict(saved["D_target"]["net"])
        if verbose:
            print(f"Using the train state at step {saved['step']} ({path})")
        return False
    ckpt = load_dsn_tar(checkpoint)
    g.load_state_dict(ckpt.get("model_g_state_dict", ckpt))
    if d is not None:
        d.load_state_dict(ckpt.get("models_d_state_dict", ckpt))
    if "epoch" in ckpt and verbose:
        print(f"Using model at epoch {ckpt['epoch']}")
    return True


def copy_to_host(device, *tensors):
    """Start copies of ``tensors`` (None passes through) to the host that do
    not wait; returns them and an event that says when they are done (None
    on the CPU)."""
    import torch

    out = [t.to("cpu", non_blocking=True) if t is not None else None for t in tensors]
    event = None
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record()
    return out, event


def main(argv=None):
    opt = build_argparser().parse_args(argv)
    if opt.checkpoint is None:
        raise SystemExit("Use --checkpoint to define the model parameters used")

    import numpy as np
    import torch

    from dasr_tpu_torch.core import dist
    from dasr_tpu_torch.core.config import dataset_paths
    from dasr_tpu_torch.core.device import resolve_device
    from dasr_tpu_torch.data.io import list_images, read_img, read_img_u8, save_img
    from dasr_tpu_torch.nn.discriminators import FSDiscriminator
    from dasr_tpu_torch.nn.generators import DeResnet, DSGANGenerator
    from dasr_tpu_torch.ops.rf_splat import CONVNETS, ddm_shape_for, ddm_splat
    from dasr_tpu_torch.ops.tiled import pad_reflect

    dist.init_world(resolve_device(opt.device))
    world = dist.refuse_mismatch(opt.mesh, "dasr_tpu_torch.cli.dsn_create_dataset")
    device, main_rank = world.device, world.is_main
    tile, above = (MESH_TILE, MESH_TILE**2) if opt.mesh else (TILE, TILE_ABOVE)
    if opt.source_dir and opt.target_dir:
        source_dir, target_dir = opt.source_dir, opt.target_dir
    else:
        key = _DATASET_KEYS.get(opt.dataset)
        if key is None:
            raise SystemExit(f"unknown --dataset {opt.dataset}")
        paths_yml = opt.paths_yml or os.path.join(os.path.dirname(__file__), "..", "..",
                                                  "paths.yml")
        reg = dataset_paths(paths_yml, *key)
        source_dir, target_dir = reg["source"], reg["target"]
    source_files = list_images(source_dir) if opt.including_source_ddm else []
    target_files = list_images(target_dir)

    out_dir = os.path.join(opt.results_root, opt.name)
    img_dir = os.path.join(out_dir, "imgs_from_target")
    ddm_t_dir = os.path.join(out_dir, "ddm_target")
    ddm_s_dir = os.path.join(out_dir, "ddm_source")
    if main_rank:
        for sub in (img_dir, ddm_t_dir, ddm_s_dir):
            os.makedirs(sub, exist_ok=True)

    if opt.generator == "DSGAN":
        g = DSGANGenerator(opt.num_res_blocks)
    elif opt.generator == "DeResnet":
        g = DeResnet(opt.num_res_blocks, opt.upscale_factor)
    else:
        raise SystemExit(f"Generator model [{opt.generator}] not recognized")
    d = FSDiscriminator(d_arch=opt.discriminator,
                        filter_type=opt.filter if opt.highpass else None,
                        kernel_size=opt.kernel_size, cs=opt.cat_or_sum,
                        norm_layer=opt.norm_layer, wgan=opt.wgan)
    if load_nets(opt.checkpoint, g, d, verbose=main_rank) and main_rank:
        shutil.copyfile(opt.checkpoint, os.path.join(out_dir, opt.name + ".tar"))
    world.check_replicated(g.state_dict().items(), "dsn_create_dataset")
    g.to(device, memory_format=torch.channels_last).eval()
    d.to(device, memory_format=torch.channels_last).eval()
    convnet = CONVNETS[opt.discriminator]
    scale = opt.upscale_factor
    reader = read_img_u8 if opt.transfer_uint8 else read_img

    def to_device(img):
        x = torch.from_numpy(img).to(device).permute(2, 0, 1)[None]
        return x.float() / 255.0 if x.dtype == torch.uint8 else x

    def run_g(img):
        x = to_device(img)
        h0, w0 = x.shape[-2], x.shape[-1]
        if opt.pad_bucket:
            x = pad_reflect(x, 0, -h0 % opt.pad_bucket, 0, -w0 % opt.pad_bucket)
        return generate_lr(g, x, scale, tile, above, world)[
            ..., : math.ceil(h0 / scale), : math.ceil(w0 / scale)]

    def ddm(lr):
        """D and the receptive-field splat on the device, from a (1, 3, h, w) LR."""
        scores = d(lr)[0, 0]
        h, w = ddm_shape_for(opt.filter if opt.highpass else "gau", lr.shape[-2], lr.shape[-1])
        return ddm_splat(scores, h, w, convnet)

    def drain(entry):
        (fake, ddm_arr), event, base = entry
        if event is not None:
            event.synchronize()
        save_img(fake[0].permute(1, 2, 0).numpy(), os.path.join(img_dir, base))
        if ddm_arr is not None:
            # (1, 1, h, w) like the reference
            np.save(os.path.join(ddm_t_dir, base.split(".")[0]), ddm_arr.numpy()[None, None])

    # the host reads image i and writes image i - 1 while the card works on i
    inflight = None
    with torch.no_grad():
        for i, path in enumerate(target_files):
            fake = run_g(reader(path))
            if not main_rank:  # the others only serve their tiles
                continue
            copies, event = copy_to_host(device, fake, None if opt.no_ddm else ddm(fake))
            prev, inflight = inflight, (copies, event, os.path.basename(path))
            if prev is not None:
                drain(prev)
            if (i + 1) % 50 == 0 or i == len(target_files) - 1:
                print(f"[target {i + 1}/{len(target_files)}]")
        if inflight is not None:
            drain(inflight)

        for i, path in enumerate(source_files if main_rank else ()):
            (ddm_arr,), event = copy_to_host(device, ddm(to_device(reader(path))))
            if event is not None:
                event.synchronize()
            np.save(os.path.join(ddm_s_dir, os.path.basename(path).split(".")[0]),
                    ddm_arr.numpy()[None, None])
            if (i + 1) % 50 == 0 or i == len(source_files) - 1:
                print(f"[source {i + 1}/{len(source_files)}]")
    world.barrier()
    return out_dir


if __name__ == "__main__":
    main()
