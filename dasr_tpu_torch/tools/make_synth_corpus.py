"""A synthetic AIM2019-shaped corpus for the DDM-mechanism ablation
(``dasr_tpu_torch.tools.ddm_ablation``) and for measured Auto_Reproduce
runs: the port's copy of the repository's ``tools/make_synth_corpus.py``,
with its flags, defaults, layout and bytes (numpy and PIL, no torch).

Layout (written under --out, plus a paths.yml registering it):
  target/    clean structured HR images (DIV2K-sized by default)
  source/    unpaired noisy LR images: an antialiased bicubic /scale of
             *held-out* HR content + the reference's corruption defaults
             (gaussian noise std 8, JPEG quality 30 --
             codes/DSN/add_corruptions.py:10-21)
  valid_hr/  val HR images
  valid_lr/  val LR images with the SAME degradation as source (so val SR
             measures real source-domain performance)

--noise_mode half confines the noise+JPEG degradation to the left half of
every source/valid_lr image; --noise_mode textured confines it to locally
textured regions (``texture_mask``), a domain gap the DDM can locate by
content, for the multiweights on/off ablation.

    python -m dasr_tpu_torch.tools.make_synth_corpus --out abl_corpus \
        --noise_mode textured --n_target 200 --n_source 400 --hr_h 678 \
        --hr_w 1020 --n_valid 10
"""

from __future__ import annotations

import argparse
import io
import multiprocessing
import os

import numpy as np
from PIL import Image


_GRID_CACHE = {}


def _grid(h: int, w: int):
    g = _GRID_CACHE.get((h, w))
    if g is None:
        yy = (np.arange(h, dtype=np.float32) / h)[:, None]
        xx = (np.arange(w, dtype=np.float32) / w)[None, :]
        g = _GRID_CACHE[(h, w)] = (yy, xx)
    return g


def synth_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Structured content: smooth gradients + sinusoid textures + blocks +
    soft disks — learnable edges/textures at several scales, float [0,1]."""
    yy, xx = _grid(h, w)
    img = np.empty((h, w, 3), np.float32)
    # base gradient per channel
    for c in range(3):
        a, b, o = rng.uniform(-0.4, 0.4, 3).astype(np.float32)
        img[..., c] = 0.5 + a * xx + b * yy + 0.2 * o
    # sinusoid textures (a few scales incl. high-frequency); separable
    # phase accumulation keeps this O(HW) with small constants
    tex = np.zeros((h, w), np.float32)
    for _ in range(3):
        fx, fy = rng.uniform(2, 60, 2).astype(np.float32)
        ph = np.float32(rng.uniform(0, 2 * np.pi))
        amp = np.float32(rng.uniform(0.04, 0.12))
        tex += amp * np.sin(
            np.float32(2 * np.pi) * (fx * xx + fy * yy) + ph
        )
    img += tex[..., None] * rng.uniform(0.4, 1.0, 3).astype(np.float32)
    # constant-color rectangles (sharp edges)
    for _ in range(12):
        rh = int(rng.uniform(0.03, 0.25) * h)
        rw = int(rng.uniform(0.03, 0.25) * w)
        r0 = int(rng.uniform(0, h - rh))
        c0 = int(rng.uniform(0, w - rw))
        img[r0 : r0 + rh, c0 : c0 + rw] *= 0.7
        img[r0 : r0 + rh, c0 : c0 + rw] += (
            0.3 * rng.uniform(0, 1, 3).astype(np.float32)
        )
    # soft disks (curved edges) — computed only inside their bounding box
    for _ in range(6):
        cy, cx = rng.uniform(0.1, 0.9, 2)
        rad = float(rng.uniform(0.02, 0.15))
        r0, r1 = max(0, int((cy - rad - 0.01) * h)), min(h, int((cy + rad + 0.01) * h))
        c0, c1 = max(0, int((cx - rad - 0.01) * w)), min(w, int((cx + rad + 0.01) * w))
        if r1 <= r0 or c1 <= c0:
            continue
        d = np.sqrt(
            (yy[r0:r1] - np.float32(cy)) ** 2 + (xx[:, c0:c1] - np.float32(cx)) ** 2
        )
        mask = np.clip((rad - d) / 0.005, 0, 1).astype(np.float32)[..., None]
        col = rng.uniform(0, 1, 3).astype(np.float32)
        sub = img[r0:r1, c0:c1]
        img[r0:r1, c0:c1] = sub * (1 - 0.5 * mask) + 0.5 * mask * col
    return np.clip(img, 0.0, 1.0)


def _box_mean(x: np.ndarray, r: int) -> np.ndarray:
    """(2r+1)^2 box-mean filter via integral image, edge-padded."""
    pad = np.pad(x, ((r + 1, r), (r + 1, r)), mode="edge").astype(np.float64)
    ii = pad.cumsum(0).cumsum(1)
    k = 2 * r + 1
    s = (
        ii[k:, k:] - ii[:-k, k:] - ii[k:, :-k] + ii[:-k, :-k]
    )
    return (s / (k * k)).astype(np.float32)


def texture_mask(lr: np.ndarray, r: int = 3) -> np.ndarray:
    """Soft [0,1] mask of locally-textured regions (box-filtered local
    std of luminance, feathered) — the degradation support for
    ``noise_mode='textured'`` and the eval-side region split."""
    lum = np.clip(lr, 0, 1).astype(np.float32) @ np.float32([0.299, 0.587, 0.114])
    m1 = _box_mean(lum, r)
    var = np.maximum(_box_mean(lum * lum, r) - m1 * m1, 0.0)
    std = np.sqrt(var)
    # thresholds sit at ~the 50th/80th percentile of this corpus's local
    # std, splitting images into comparable textured/flat areas
    mask = np.clip((std - 0.047) / 0.02, 0.0, 1.0)
    return _box_mean(mask, r)


def degrade(
    lr: np.ndarray, rng: np.random.Generator, noise_std: float = 8.0,
    jpeg_quality: int = 30, noise_mode: str = "global",
) -> np.ndarray:
    """Reference corruption defaults (add_corruptions.py:10-21, 33-56):
    gaussian noise std 8 (on 0-255) then JPEG quality 30.

    ``noise_mode``: 'global' = whole image; 'half' = left half only;
    'textured' = only locally-textured regions (a *content-localizable*
    domain gap a patch discriminator can detect — the DDM-ablation corpus,
    VERDICT r2 #3)."""
    u8 = (np.clip(lr, 0, 1) * 255.0).round().astype(np.float64)
    noisy = u8 + rng.normal(0, noise_std, u8.shape)
    noisy = np.clip(noisy, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(noisy).save(buf, "JPEG", quality=jpeg_quality)
    deg = np.asarray(Image.open(buf)).astype(np.float32) / 255.0
    clean = np.clip(lr, 0, 1).astype(np.float32)
    if noise_mode == "half":
        half = lr.shape[1] // 2
        out = clean.copy()
        out[:, :half] = deg[:, :half]
        return out
    if noise_mode == "textured":
        m = texture_mask(clean)[..., None]
        return clean * (1 - m) + deg * m
    return deg


def _bicubic_down(img: np.ndarray, scale: int) -> np.ndarray:
    """Antialiased bicubic downscale (PIL convolution resampler). The
    corpus's source/valid LRs only need *a* clean antialiased downscale —
    the training pipeline computes its own MATLAB-parity bicubic targets
    (ops/resize), so corpus generation can use the fast path."""
    u8 = (np.clip(img, 0, 1) * 255.0).round().astype(np.uint8)
    im = Image.fromarray(u8)
    out = im.resize((im.width // scale, im.height // scale), Image.BICUBIC)
    return np.asarray(out).astype(np.float32) / 255.0


def _save(img: np.ndarray, path: str):
    u8 = (np.clip(img, 0, 1) * 255.0).round().astype(np.uint8)
    # compress_level 1: ~4x faster encode for ~25% bigger files
    Image.fromarray(u8).save(path, compress_level=1)


def _job(task):
    kind, seed, out, h, w, scale, noise_mode = task
    rng = np.random.default_rng(seed)
    img = synth_image(rng, h, w)
    if kind == "target":
        _save(img, out)
    elif kind == "source":
        lr = _bicubic_down(img, scale)
        _save(degrade(lr, rng, noise_mode=noise_mode), out)
    elif kind == "valid":
        hr_path, lr_path = out
        _save(img, hr_path)
        lr = _bicubic_down(img, scale)
        _save(degrade(lr, rng, noise_mode=noise_mode), lr_path)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--n_target", type=int, default=800)
    p.add_argument("--n_source", type=int, default=2650)
    p.add_argument("--n_valid", type=int, default=20)
    p.add_argument("--hr_h", type=int, default=1356)
    p.add_argument("--hr_w", type=int, default=2040)
    p.add_argument("--valid_h", type=int, default=678)
    p.add_argument("--valid_w", type=int, default=1020)
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise_mode", default="global", choices=["global", "half", "textured"])
    p.add_argument("--workers", type=int, default=8)
    args = p.parse_args(argv)

    dirs = {k: os.path.join(args.out, k)
            for k in ("target", "source", "valid_hr", "valid_lr")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    # sources come from held-out seeds (disjoint content from targets —
    # the reference's source/target domains are unpaired)
    tasks = []
    for i in range(args.n_target):
        tasks.append((
            "target", args.seed * 1_000_000 + i,
            os.path.join(dirs["target"], f"t{i:04d}.png"),
            args.hr_h, args.hr_w, args.scale, args.noise_mode,
        ))
    # source content synthesized at half HR size and downscaled /2 to the
    # same LR size (4x cheaper; statistics still antialiased-downscaled)
    for i in range(args.n_source):
        tasks.append((
            "source", args.seed * 1_000_000 + 500_000 + i,
            os.path.join(dirs["source"], f"s{i:04d}.png"),
            args.hr_h // 2, args.hr_w // 2, args.scale // 2 or 1,
            args.noise_mode,
        ))
    for i in range(args.n_valid):
        tasks.append((
            "valid", args.seed * 1_000_000 + 900_000 + i,
            (os.path.join(dirs["valid_hr"], f"v{i:04d}.png"),
             os.path.join(dirs["valid_lr"], f"v{i:04d}.png")),
            args.valid_h, args.valid_w, args.scale, args.noise_mode,
        ))

    # spawned workers: forking a process that runs threads (a caller's
    # loader, torch's pools) is unsafe
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        for n, _ in enumerate(pool.imap_unordered(_job, tasks, chunksize=4)):
            if (n + 1) % 200 == 0 or n + 1 == len(tasks):
                print(f"[{n + 1}/{len(tasks)}]")

    paths_yml = os.path.join(args.out, "paths.yml")
    with open(paths_yml, "w") as f:
        f.write(
            "aim2019:\n  tdsr:\n"
            f"    source: '{dirs['source']}'\n"
            f"    target: '{dirs['target']}'\n"
            f"    valid_hr: '{dirs['valid_hr']}'\n"
            f"    valid_lr: '{dirs['valid_lr']}'\n"
        )
    print(f"wrote {paths_yml}")


if __name__ == "__main__":
    main()
