"""Perceptual-distance CLI of the port (net-lin / net LPIPS, L2, DSSIM):
``python -m dasr_tpu_torch.cli.compute_dists {pair,dirs,self} ... [--device cuda]``.

Port of ``dasr_tpu.cli.compute_dists`` (reference:
codes/PerceptualSimilarity/compute_dists.py, compute_dists_dirs.py,
compute_dists_pair.py):

  pair   — distance between two images
  dirs   — per-file distances between two directories (``-o`` writes the
           lines, ``--html`` a side-by-side report); pair i is read back
           while pair i + 1 decodes and runs
  self   — consecutive-pair distances within one directory

The printed lines and the report are the JAX CLI's.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _dist_fn(model="net-lin", net="alex", version="0.1", backbone=None, device="cpu"):
    import torch

    from dasr_tpu_torch.losses.lpips import create_dist_model

    fn = create_dist_model(model=model, net=net, version=version, backbone_path=backbone,
                           device=device)

    def dispatch(img0_u8, img1_u8):
        """The distance of two uint8 HWC images, not waited for (a device
        tensor; an array for DSSIM, which runs on the host)."""
        a, b = (torch.from_numpy(np.ascontiguousarray(v)).to(device).permute(2, 0, 1)[None]
                .float() / 127.5 - 1.0 for v in (img0_u8, img1_u8))
        return fn(a, b)

    def value(d) -> float:
        d = d.cpu().numpy() if torch.is_tensor(d) else np.asarray(d)
        return float(d.reshape(-1)[0])

    def compute(img0_u8, img1_u8):
        return value(dispatch(img0_u8, img1_u8))

    compute.dispatch, compute.value = dispatch, value
    return compute


def _write_html_report(out_dir, files0, files1, dists, title="distances"):
    """Side-by-side visual report (the reference bundles an HTML visualizer,
    codes/PerceptualSimilarity/util/html.py + util/visualizer.py; this is a
    dependency-free equivalent). Copies both image sets under ``out_dir`` and
    emits ``index.html`` with per-pair distances, sorted worst-first."""
    import html as _html
    import shutil

    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    rows = []
    order = sorted(range(len(dists)), key=lambda i: -dists[i])
    for i in order:
        b0 = f"{i:04d}_a_{os.path.basename(files0[i])}"
        b1 = f"{i:04d}_b_{os.path.basename(files1[i])}"
        shutil.copyfile(files0[i], os.path.join(img_dir, b0))
        shutil.copyfile(files1[i], os.path.join(img_dir, b1))
        name = _html.escape(os.path.basename(files0[i]))
        rows.append(
            f"<tr><td>{name}</td><td>{dists[i]:.4f}</td>"
            f'<td><img src="images/{b0}"></td>'
            f'<td><img src="images/{b1}"></td></tr>'
        )
    doc = (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{_html.escape(title)}</title>"
        "<style>img{max-width:384px} td{padding:4px;vertical-align:top}"
        "table{border-collapse:collapse} tr:nth-child(even){background:#eee}"
        "</style></head><body>"
        f"<h2>{_html.escape(title)} — mean "
        f"{sum(dists) / max(1, len(dists)):.6f}</h2>"
        "<table><tr><th>file</th><th>dist</th><th>dir0</th><th>dir1</th></tr>"
        + "".join(rows)
        + "</table></body></html>"
    )
    with open(os.path.join(out_dir, "index.html"), "w") as f:
        f.write(doc)
    print(f"wrote HTML report to {os.path.join(out_dir, 'index.html')}")


def main(argv=None):
    p = argparse.ArgumentParser(description="LPIPS distances")
    sub = p.add_subparsers(dest="cmd", required=True)
    pp = sub.add_parser("pair")
    pp.add_argument("-p0", "--path0", required=True)
    pp.add_argument("-p1", "--path1", required=True)
    pd = sub.add_parser("dirs")
    pd.add_argument("-d0", "--dir0", required=True)
    pd.add_argument("-d1", "--dir1", required=True)
    pd.add_argument("-o", "--out", default=None)
    pd.add_argument("--html", default=None,
                    help="write a side-by-side HTML report to this directory "
                         "(reference: PerceptualSimilarity/util/html.py)")
    ps = sub.add_parser("self")
    ps.add_argument("-d", "--dir", required=True)
    for s in (pp, pd, ps):
        s.add_argument("--net", default="alex", choices=["alex", "vgg", "squeeze"])
        s.add_argument("--model", default="net-lin",
                       choices=["net-lin", "net", "l2", "L2", "ssim", "DSSIM"])
        s.add_argument("--version", default="0.1", choices=["0.0", "0.1"])
        s.add_argument("--backbone", default=None,
                       help="torchvision backbone .pth for the chosen net")
        s.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="run on the GPU or on the CPU (plain PyTorch)")
    args = p.parse_args(argv)

    from dasr_tpu_torch.core.device import resolve_device
    from dasr_tpu_torch.data.io import list_images, read_img
    from dasr_tpu_torch.eval.evaluate import to_uint8

    device = resolve_device(args.device)
    compute = _dist_fn(args.model, args.net, args.version, args.backbone, device)

    def load(path):
        return to_uint8(read_img(path))

    if args.cmd == "pair":
        d = compute(load(args.path0), load(args.path1))
        print(f"Distance: {d:.4f}")
        return d
    if args.cmd == "dirs":
        files0, files1 = list_images(args.dir0), list_images(args.dir1)
        out_f = open(args.out, "w") if args.out else None
        dists = []

        def drain(f0, d_dev):
            d = compute.value(d_dev)
            dists.append(d)
            line = f"{os.path.basename(f0)}: {d:.4f}"
            print(line)
            if out_f:
                out_f.write(line + "\n")

        try:
            inflight = None
            for f0, f1 in zip(files0, files1):
                prev, inflight = inflight, (f0, compute.dispatch(load(f0), load(f1)))
                if prev is not None:
                    drain(*prev)
            if inflight is not None:
                drain(*inflight)
        finally:
            if out_f:
                out_f.close()
        print(f"mean: {np.mean(dists):.6f}")
        if args.html:
            _write_html_report(args.html, files0, files1, dists,
                               title=f"{args.model}/{args.net} distances")
        return float(np.mean(dists))
    files = list_images(args.dir)
    dists = []
    for f0, f1 in zip(files[:-1], files[1:]):
        d = compute(load(f0), load(f1))
        dists.append(d)
        print(f"({os.path.basename(f0)}, {os.path.basename(f1)}): {d:.4f}")
    print(f"mean: {np.mean(dists):.6f}")
    return float(np.mean(dists))


if __name__ == "__main__":
    main()
