"""The reference's plain image ops: the MATLAB bicubic (antialiased, with
the symmetric boundary), and the tiling of a large image into 128-px tiles
with a 16-px reflected halo that the served path computes image by image.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch


def _cubic(x):
    ax = np.abs(x)
    return ((1.5 * ax ** 3 - 2.5 * ax ** 2 + 1) * (ax <= 1)
            + (-0.5 * ax ** 3 + 2.5 * ax ** 2 - 4 * ax + 2) * ((ax > 1) & (ax <= 2)))


def bicubic_matrix(n_in: int, n_out: int, scale: float) -> np.ndarray:
    """The (n_out, n_in) MATLAB ``imresize`` bicubic weights along one axis,
    antialiased when shrinking, the out-of-range taps folded back
    symmetrically."""
    width = 4.0 / scale if scale < 1 else 4.0
    x = np.arange(1, n_out + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - width / 2)
    taps = int(math.ceil(width)) + 2
    idx = left[:, None] + np.arange(taps, dtype=np.float64)[None, :]
    dist = u[:, None] - idx
    wts = scale * _cubic(dist * scale) if scale < 1 else _cubic(dist)
    wts = wts / wts.sum(axis=1, keepdims=True)
    zero = (wts == 0).sum(axis=0)
    if not math.isclose(zero[0], 0, rel_tol=1e-6):
        idx, wts = idx[:, 1:], wts[:, 1:]
    if not math.isclose(zero[-1], 0, rel_tol=1e-6):
        idx, wts = idx[:, :-1], wts[:, :-1]
    src = np.mod((idx - 1).astype(np.int64), 2 * n_in)
    src = np.where(src >= n_in, 2 * n_in - 1 - src, src)
    mat = np.zeros((n_out, n_in), np.float64)
    np.add.at(mat, (np.repeat(np.arange(n_out), src.shape[1]), src.ravel()), wts.ravel())
    return mat


def bicubic(x: torch.Tensor, scale: float) -> torch.Tensor:
    """MATLAB-style bicubic resize of NCHW images in [0, 1], clipped."""
    h, w = x.shape[-2:]
    mh = torch.as_tensor(bicubic_matrix(h, math.ceil(h * scale), scale), dtype=torch.float32,
                         device=x.device)
    mw = torch.as_tensor(bicubic_matrix(w, math.ceil(w * scale), scale), dtype=torch.float32,
                         device=x.device)
    return (mh @ x.float() @ mw.T).clamp(0.0, 1.0)


def _reflect(n: int, before: int, after: int) -> torch.Tensor:
    idx = np.arange(-before, n + after)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return torch.from_numpy(np.where(idx >= n, period - idx, idx))


def tile_plan(h: int, w: int, tile: int = 128, halo: int = 16):
    """(tile rows, tile columns, the tile's side with its halo) of an
    h x w image."""
    return -(-h // tile), -(-w // tile), tile + 2 * halo


def tiled(x: torch.Tensor, model: Callable, scale: int = 4, tile: int = 128, halo: int = 16,
          chunk: int = 8) -> torch.Tensor:
    """``model`` over a (1, C, h, w) image by tiles: the image reflected up
    to whole tiles, that reflected again by ``halo`` on every side, every
    tile cut with its halo, run ``chunk`` tiles at a time, the halo dropped
    from each output and the tiles laid back in place, cropped to
    x``scale`` the image."""
    h, w = x.shape[-2:]
    nh, nw, t = tile_plan(h, w, tile, halo)
    rows = _reflect(h, 0, nh * tile - h)[_reflect(nh * tile, halo, halo)].to(x.device)
    cols = _reflect(w, 0, nw * tile - w)[_reflect(nw * tile, halo, halo)].to(x.device)
    padded = x.index_select(-2, rows).index_select(-1, cols)
    tiles = torch.cat([padded[:, :, r:r + t, c:c + t] for r in range(0, nh * tile, tile)
                       for c in range(0, nw * tile, tile)])
    st, sh = tile * scale, halo * scale
    out = x.new_zeros((1, 3, nh * st, nw * st))
    for s in range(0, tiles.shape[0], chunk):
        y = model(tiles[s:s + chunk])[:, :, sh:sh + st, sh:sh + st]
        for j in range(y.shape[0]):
            r, c = divmod(s + j, nw)
            out[:, :, r * st:(r + 1) * st, c * st:(c + 1) * st] = y[j]
    return out[:, :, :h * scale, :w * scale]
