"""Small offline utilities, one flag-selected tool per reference script
(the port of ``dasr_tpu.scripts.misc_tools``; host code but param_count,
which builds the port's ``define_G`` on the CPU):

    python -m dasr_tpu_torch.scripts.misc_tools <tool> ...

  * gif/video assembly   (reference: codes/SRN/scripts/make_gif_video.py)
  * bulk rename          (reference: codes/SRN/scripts/rename.py)
  * color -> gray        (reference: codes/SRN/scripts/color2gray.py)
  * create_lmdb          (reference: codes/SRN/scripts/create_lmdb.py) —
    gated: the lmdb module isn't in this image; raises with instructions.
  * iterative back-projection refinement (replaces the MATLAB
    codes/SRN/scripts/back_projection/*.m): sr <- sr + resize_up(lr -
    resize_down(sr)) for N iterations with MATLAB-parity bicubic.
  * receptive-field table and parameter count of the repo's networks.
"""

from __future__ import annotations

import argparse
import os

import cv2
import numpy as np


def back_projection(sr: np.ndarray, lr: np.ndarray, scale: int, n_iters: int = 10):
    """IBP refinement with MATLAB-bicubic up/down (float [0,1] HWC)."""
    from dasr_tpu_torch.ops.resize import imresize_np

    sr = sr.astype(np.float64)
    for _ in range(n_iters):
        down = imresize_np(sr, 1.0 / scale, clip=False)
        err = lr.astype(np.float64) - down
        sr = sr + imresize_np(err, float(scale), clip=False)
    return np.clip(sr, 0, 1)


def _tool_back_projection(args):
    from dasr_tpu_torch.data.io import list_images, read_img, save_img

    os.makedirs(args.out, exist_ok=True)
    sr_files, lr_files = list_images(args.sr_dir), list_images(args.lr_dir)
    for s, l in zip(sr_files, lr_files):
        out = back_projection(read_img(s), read_img(l), args.scale, args.iters)
        save_img(out, os.path.join(args.out, os.path.basename(s)))
        print(os.path.basename(s))


def _tool_gif(args):
    from dasr_tpu_torch.data.io import list_images

    files = list_images(args.input_dir)
    first = cv2.imread(files[0])
    h, w = first.shape[:2]
    vw = cv2.VideoWriter(
        args.out, cv2.VideoWriter_fourcc(*"mp4v"), args.fps, (w, h)
    )
    for f in files:
        img = cv2.imread(f)
        if img.shape[:2] != (h, w):
            img = cv2.resize(img, (w, h))
        vw.write(img)
    vw.release()
    print(f"wrote {args.out} ({len(files)} frames)")


def _tool_rename(args):
    from dasr_tpu_torch.data.io import list_images

    for i, f in enumerate(sorted(list_images(args.input_dir))):
        ext = os.path.splitext(f)[1]
        new = os.path.join(args.input_dir, args.pattern.format(i=i) + ext)
        os.rename(f, new)
    print("renamed files in", args.input_dir)


def _tool_gray(args):
    from dasr_tpu_torch.data.io import list_images

    os.makedirs(args.out, exist_ok=True)
    for f in list_images(args.input_dir):
        g = cv2.cvtColor(cv2.imread(f), cv2.COLOR_BGR2GRAY)
        cv2.imwrite(os.path.join(args.out, os.path.basename(f)), g)
    print("wrote grayscale images to", args.out)


def _tool_mod_lr_bic(args):
    """HR -> (modcropped HR, MATLAB-bicubic LR, re-upscaled Bic) triplets
    (replaces the MATLAB codes/SRN/scripts/generate_mod_LR_bic.m)."""
    from dasr_tpu_torch.data.io import list_images, read_img, save_img
    from dasr_tpu_torch.ops.metrics import modcrop
    from dasr_tpu_torch.ops.resize import imresize_np

    for sub in ("HR", "LR", "Bic"):
        os.makedirs(os.path.join(args.out, sub), exist_ok=True)
    for f in list_images(args.input_dir):
        hr = modcrop(read_img(f), args.scale)
        lr = imresize_np(hr, 1.0 / args.scale)
        bic = imresize_np(lr, float(args.scale))
        base = os.path.basename(f)
        save_img(hr, os.path.join(args.out, "HR", base))
        save_img(lr, os.path.join(args.out, "LR", base))
        save_img(bic, os.path.join(args.out, "Bic", base))
        print(base)


_RECT_COLORS = {
    # BGR tuples in the reference (cv2); stored here as RGB
    "yellow": (255, 255, 0),
    "green": (0, 255, 0),
    "red": (255, 0, 0),
    "magenta": (255, 0, 255),
    "matlab_blue": (0, 114, 189),
    "matlab_orange": (217, 83, 25),
    "matlab_yellow": (237, 177, 32),
    "matlab_purple": (126, 47, 142),
    "matlab_green": (119, 172, 48),
    "matlab_liblue": (77, 190, 238),
    "matlab_brown": (162, 20, 47),
}


def _tool_enlarge_patches(args):
    """Figure-making helper (reference: codes/SRN/scripts/
    extract_enlarge_patches.py): crop a patch from every image, enlarge it
    by ``ratio``, and save a copy of the original with the patch location
    drawn as a colored rectangle."""
    import numpy as np

    from dasr_tpu_torch.data.io import list_images, read_img, save_img

    patch_dir = os.path.join(args.out, "patch")
    rect_dir = os.path.join(args.out, "rect")
    os.makedirs(patch_dir, exist_ok=True)
    os.makedirs(rect_dir, exist_ok=True)
    color = np.array(_RECT_COLORS[args.color], np.float32) / 255.0
    h0, hl, w0, wl, lw = args.h_start, args.h_len, args.w_start, args.w_len, args.line_width
    for f in list_images(args.input_dir):
        img = read_img(f)
        base = os.path.splitext(os.path.basename(f))[0]
        patch = img[h0 : h0 + hl, w0 : w0 + wl]
        enlarged = np.repeat(np.repeat(patch, args.ratio, 0), args.ratio, 1)
        save_img(enlarged, os.path.join(patch_dir, f"{base}_patch.png"))
        rect = img.copy()
        rect[h0 - lw : h0 + hl + lw, w0 - lw : w0 + wl + lw] = color
        rect[h0 : h0 + hl, w0 : w0 + wl] = patch
        save_img(rect, os.path.join(rect_dir, f"{base}_rect.png"))
        print(base)


def _tool_lmdb(args):
    try:
        import lmdb  # noqa: F401
    except ImportError as e:
        raise SystemExit(
            "the lmdb module is not available in this environment; install "
            "lmdb or use plain image folders (the data pipeline reads both)"
        ) from e
    from dasr_tpu_torch.data.io import list_images

    env = lmdb.open(args.out, map_size=1099511627776)
    files = list_images(args.input_dir)
    with env.begin(write=True) as txn:
        for f in files:
            with open(f, "rb") as fh:
                txn.put(os.path.basename(f).encode(), fh.read())
    print(f"wrote {len(files)} entries to {args.out}")


def _conv_stack(net: str, n_res_blocks: int, scale: int):
    """[kernel, stride, pad] stack for the RF-analysis nets.

    Mirrors the standalone net definitions in the reference's analysis
    scripts (codes/SRN/scripts/DSN_stride.py, codes/DSN/receptive_cal.py
    CONVNETS) using this repo's nn geometry (nn/generators.py)."""
    from dasr_tpu_torch.ops.rf_splat import CONVNETS

    if net in CONVNETS:
        return CONVNETS[net]
    if net == "DSGAN":
        return [[3, 1, 1]] * (2 + 2 * n_res_blocks)
    if net == "DeResnet":
        n_down = {1: 0, 2: 1, 4: 2}[scale]
        return (
            [[3, 1, 1]]
            + [[3, 1, 1]] * (2 * n_res_blocks)
            + [[3, 2, 1]] * n_down
            + [[3, 1, 1]]
        )
    raise SystemExit(
        f"unknown --net {net}; choose FSD, nld_s1, nld_s2, DSGAN, DeResnet"
    )


def _tool_rf_table(args):
    """Per-layer receptive-field table (n, jump, rf, start) — the ported
    function of the reference's standalone analysis scripts
    (codes/SRN/scripts/DSN_stride.py, codes/DSN/receptive_cal.py:46-53)."""
    from dasr_tpu_torch.ops.rf_splat import receptive_field

    stack = _conv_stack(args.net, args.n_res_blocks, args.scale)
    print(f"--- {args.net} @ input {args.imsize} ---")
    hdr = f"{'layer':>6} {'k':>3} {'s':>3} {'p':>3} {'n':>7} {'jump':>6} {'rf':>6} {'start':>9}"
    print(hdr)
    print(f"{'input':>6} {'':>3} {'':>3} {'':>3} {args.imsize:>7} {1:>6} {1:>6} {0.5:>9}")
    for i in range(1, len(stack) + 1):
        n, j, r, start = receptive_field(args.imsize, stack[:i])
        k, s, pd = stack[i - 1]
        print(f"{i:>6} {k:>3} {s:>3} {pd:>3} {n:>7} {j:>6} {r:>6} {start:>9}")


def _tool_param_count(args):
    """Parameter count of a network-factory G (the 'param analysis' half of
    the reference's scripts/SRN.py standalone net definitions): its
    parameters and floating-point buffers, which are the JAX package's
    variable leaves. A BatchNorm's running mean and variance count, as
    flax's ``batch_stats`` do; its ``num_batches_tracked``, an integer step
    counter flax does not keep, does not."""
    from dasr_tpu_torch.core.config import dict_to_nonedict
    from dasr_tpu_torch.models.registry import define_G

    opt = dict_to_nonedict(
        {
            "scale": args.scale,
            "network_G": {
                "which_model_G": args.which_model_G,
                "nf": args.nf, "nb": args.nb, "gc": args.gc,
                "in_nc": 3, "out_nc": 3, "norm_type": None, "mode": "CNA",
            },
        }
    )
    net = define_G(opt)
    total = sum(t.numel() for t in net.parameters()) + sum(
        t.numel() for t in net.buffers() if t.is_floating_point())
    print(f"{args.which_model_G}: {total:,} parameters")
    return total


def main(argv=None):
    p = argparse.ArgumentParser(description="dasr_tpu_torch offline tools")
    sub = p.add_subparsers(dest="tool", required=True)

    rf = sub.add_parser(
        "rf_table", help="per-layer receptive-field table for a conv stack"
    )
    rf.add_argument("--net", default="FSD")
    rf.add_argument("--imsize", type=int, default=64)
    rf.add_argument("--n_res_blocks", type=int, default=8)
    rf.add_argument("--scale", type=int, default=4)
    rf.set_defaults(fn=_tool_rf_table)

    pc = sub.add_parser(
        "param_count", help="parameter count of a network-factory G"
    )
    pc.add_argument("--which_model_G", default="RRDB_net")
    pc.add_argument("--nf", type=int, default=64)
    pc.add_argument("--nb", type=int, default=23)
    pc.add_argument("--gc", type=int, default=32)
    pc.add_argument("--scale", type=int, default=4)
    pc.add_argument("--imsize", type=int, default=32,
                    help="parsed, not used: a count does not depend on the input (the JAX "
                         "tool's parser takes it too)")
    pc.set_defaults(fn=_tool_param_count)

    bp = sub.add_parser("back_projection")
    bp.add_argument("--sr_dir", required=True)
    bp.add_argument("--lr_dir", required=True)
    bp.add_argument("--out", required=True)
    bp.add_argument("--scale", type=int, default=4)
    bp.add_argument("--iters", type=int, default=10)
    bp.set_defaults(fn=_tool_back_projection)

    g = sub.add_parser("make_video")
    g.add_argument("--input_dir", required=True)
    g.add_argument("--out", required=True)
    g.add_argument("--fps", type=int, default=10)
    g.set_defaults(fn=_tool_gif)

    r = sub.add_parser("rename")
    r.add_argument("--input_dir", required=True)
    r.add_argument("--pattern", default="{i:05d}")
    r.set_defaults(fn=_tool_rename)

    c = sub.add_parser("color2gray")
    c.add_argument("--input_dir", required=True)
    c.add_argument("--out", required=True)
    c.set_defaults(fn=_tool_gray)

    l = sub.add_parser("create_lmdb")
    l.add_argument("--input_dir", required=True)
    l.add_argument("--out", required=True)
    l.set_defaults(fn=_tool_lmdb)

    e = sub.add_parser("extract_enlarge_patches")
    e.add_argument("--input_dir", required=True)
    e.add_argument("--out", required=True)
    e.add_argument("--h_start", type=int, default=170)
    e.add_argument("--h_len", type=int, default=64)
    e.add_argument("--w_start", type=int, default=232)
    e.add_argument("--w_len", type=int, default=100)
    e.add_argument("--ratio", type=int, default=3)
    e.add_argument("--line_width", type=int, default=2)
    e.add_argument("--color", default="yellow", choices=sorted(_RECT_COLORS))
    e.set_defaults(fn=_tool_enlarge_patches)

    m = sub.add_parser("generate_mod_lr_bic")
    m.add_argument("--input_dir", required=True)
    m.add_argument("--out", required=True)
    m.add_argument("--scale", type=int, default=4)
    m.set_defaults(fn=_tool_mod_lr_bic)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
