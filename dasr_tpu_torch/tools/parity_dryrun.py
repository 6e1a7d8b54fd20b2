"""Parity runbook dry-run against a stand-in checkpoint, on the port: the
port of the repository's ``tools/parity_dryrun.py``.

The published DASR checkpoints are not in the repository, so this runs the
parity procedure against a *generated* random-init full-size RRDB ``.pth``
(reference state-dict names, ESRGAN nf64 nb23 gc32):

  1. generate (or reuse) ``<work>/standin_G.pth``;
  2. run the functional torch forward -- full-image AND with the
     reference's recursive forward_chop procedure (shave 20, min_size
     160000, even-size output rounding; codes/SRN/utils/util.py:87-147) --
     on N LR images;
  3. load the same ``.pth`` into the port's 'sr' ``SRModel`` (f32, so on
     the card through the f32 fused-RDB kernel) and run its test path plain
     and with ``chop`` + ``chop_parity``;
  4. report max/mean |delta| per image per path pair, and write
     ``<work>/parity_dryrun.json``.

Both sides run on the card unless ``--device cpu`` is given (the JAX tool's
``--cpu``); without a card the tool raises. The functional reference runs
f32 with TF32 off, which ``resolve_device`` sets.

    python -m dasr_tpu_torch.tools.parity_dryrun --lr_dir abl_corpus/valid_lr \
        --work parity --n 3
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

from dasr_tpu_torch.core.config import dict_to_nonedict
from dasr_tpu_torch.core.device import resolve_device
from dasr_tpu_torch.data.io import list_images, read_img
from dasr_tpu_torch.models.registry import SRModel


def make_standin_pth(path: str, nb: int = 23, nf: int = 64, gc: int = 32,
                     seed: int = 0):
    """Full-size RRDBNet state dict with the reference's key names
    (codes/SRN/models/modules/architecture.py:174-205 module layout)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def add(name, cin, cout, k=3):
        # kaiming-x0.1-like scale (the reference's G init, networks.py:15-30)
        # keeps 69-RDB activations O(1), like a real trained checkpoint
        std = 0.1 * (2.0 / (cin * k * k)) ** 0.5
        sd[name + ".weight"] = torch.randn(cout, cin, k, k, generator=g) * std
        sd[name + ".bias"] = torch.randn(cout, generator=g) * 0.005

    add("model.0", 3, nf)
    for i in range(nb):
        for j in (1, 2, 3):
            for c in range(1, 6):
                cin = nf + (c - 1) * gc
                cout = gc if c < 5 else nf
                add(f"model.1.sub.{i}.RDB{j}.conv{c}.0", cin, cout)
    add(f"model.1.sub.{nb}", nf, nf)
    add("model.3", nf, nf)
    add("model.6", nf, nf)
    add("model.8", nf, nf)
    add("model.10", nf, 3)
    torch.save(sd, path)
    return path


def torch_rrdb_forward(sd, x, nb=23, nf=64, gc=32):
    """Functional ESRGAN forward (architecture.py:174-205 semantics)."""
    def lrelu(v):
        return F.leaky_relu(v, 0.2)

    def c(p, v):
        return F.conv2d(v, sd[p + ".weight"], sd[p + ".bias"], padding=1)

    def rdb(prefix, v):
        x1 = lrelu(c(prefix + ".conv1.0", v))
        x2 = lrelu(c(prefix + ".conv2.0", torch.cat([v, x1], 1)))
        x3 = lrelu(c(prefix + ".conv3.0", torch.cat([v, x1, x2], 1)))
        x4 = lrelu(c(prefix + ".conv4.0", torch.cat([v, x1, x2, x3], 1)))
        x5 = c(prefix + ".conv5.0", torch.cat([v, x1, x2, x3, x4], 1))
        return v + 0.2 * x5

    fea = c("model.0", x)
    h = fea
    for i in range(nb):
        inner = h
        for j in (1, 2, 3):
            inner = rdb(f"model.1.sub.{i}.RDB{j}", inner)
        h = h + 0.2 * inner
    h = fea + c(f"model.1.sub.{nb}", h)
    for p in ("model.3", "model.6"):
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = lrelu(c(p, h))
    return c("model.10", lrelu(c("model.8", h)))


def torch_forward_chop(x, scale, model, shave=20, min_size=160000):
    """The reference's recursive quadrant inference, NCHW
    (codes/SRN/utils/util.py:87-147 semantics incl. even-size rounding)."""
    b, c, h, w = x.shape
    if h <= 2 * shave or w <= 2 * shave:
        return model(x)
    top = slice(0, h // 2 + shave)
    bottom = slice(h - h // 2 - shave, h)
    left = slice(0, w // 2 + shave)
    right = slice(w - w // 2 - shave, w)
    quads = [x[:, :, top, left], x[:, :, top, right],
             x[:, :, bottom, left], x[:, :, bottom, right]]
    if h * w < 4 * min_size:
        out = model(torch.cat(quads, 0))
        yq = [out[i * b : (i + 1) * b] for i in range(4)]
    else:
        yq = [torch_forward_chop(q, scale, model, shave, min_size) for q in quads]
    oh, ow = round(h * scale), round(w * scale)
    if oh % 2:
        oh += 1
    if ow % 2:
        ow += 1
    y = x.new_zeros((b, yq[0].shape[1], oh, ow))
    y[:, :, : oh // 2, : ow // 2] = yq[0][:, :, : oh // 2, : ow // 2]
    y[:, :, : oh // 2, ow - ow // 2 :] = yq[1][:, :, : oh // 2, ow // 2 - ow :]
    y[:, :, oh - oh // 2 :, : ow // 2] = yq[2][:, :, oh // 2 - oh :, : ow // 2]
    y[:, :, oh - oh // 2 :, ow - ow // 2 :] = yq[3][:, :, oh // 2 - oh :, ow // 2 - ow :]
    return y


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--lr_dir", required=True)
    p.add_argument("--work", default=os.path.join(tempfile.gettempdir(), "parity"))
    p.add_argument("--n", type=int, default=3)
    p.add_argument("--nb", type=int, default=23)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run both sides on the GPU (the f32 fused-RDB kernel) or on the CPU")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    os.makedirs(args.work, exist_ok=True)
    pth = os.path.join(args.work, "standin_G.pth")
    if not os.path.exists(pth):
        make_standin_pth(pth, nb=args.nb)
        print(f"generated stand-in checkpoint {pth}")

    sd = {k: v.to(device) for k, v in
          torch.load(pth, map_location="cpu", weights_only=True).items()}
    # one f32 model, served plain and with the reference's chopper
    ours = SRModel(dict_to_nonedict({
        "model": "sr", "scale": 4, "bf16": False, "chop": False, "chop_parity": True,
        "network_G": {"which_model_G": "RRDB_net", "nf": 64, "nb": args.nb,
                      "gc": 32, "norm_type": None},
        "path": {"pretrain_model_G": pth}, "train": {},
    }), device).init().load()

    files = list_images(args.lr_dir)[: args.n]
    report = []
    for f in files:
        lr = read_img(f)
        x_t = torch.from_numpy(
            np.ascontiguousarray(lr.transpose(2, 0, 1))[None]
        ).to(device)
        with torch.no_grad():
            t_full = torch_rrdb_forward(sd, x_t, nb=args.nb)
            t_chop = torch_forward_chop(
                x_t, 4, lambda v: torch_rrdb_forward(sd, v, nb=args.nb)
            )
        t_full = t_full[0].cpu().numpy().transpose(1, 2, 0)
        t_chop = t_chop[0].cpu().numpy().transpose(1, 2, 0)

        ours.opt["chop"] = False
        o_plain = ours.test(lr)
        ours.opt["chop"] = True
        o_chop = ours.test(lr)

        h, w = o_plain.shape[:2]
        pairs = {
            "ours_plain_vs_torch_full": (o_plain, t_full[:h, :w]),
            "ours_chop_vs_torch_chop": (o_chop, t_chop[:h, :w]),
        }
        row = {
            "image": os.path.basename(f),
            "lr_shape": list(lr.shape),
            "out_absmax": float(np.abs(t_full).max()),
        }
        for k, (a, b) in pairs.items():
            d = np.abs(a.astype(np.float64) - b.astype(np.float64))
            scale = max(1.0, float(np.abs(b).max()))
            row[k] = {
                "max_abs": float(d.max()),
                "mean_abs": float(d.mean()),
                "max_rel_to_range": float(d.max()) / scale,
            }
        report.append(row)
        print(json.dumps(row))

    worst = max(
        v["max_abs"] for r in report for v in r.values() if isinstance(v, dict)
    )
    print(json.dumps({"n_images": len(report), "worst_max_abs": worst}))
    with open(os.path.join(args.work, "parity_dryrun.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    return report


if __name__ == "__main__":
    main()
