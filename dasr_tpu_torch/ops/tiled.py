"""Large-image tiled inference on NCHW tensors.

Counterpart of ``dasr_tpu.ops.tiled``:

* ``tiled_apply`` — reflect-pads the image to a tile grid, runs the model
  once over the batch of overlapping fixed-size tiles, discards the halos
  and reassembles. Over a world of several ranks (``core/dist.py``) the
  tile batch is wrap-padded to a multiple of the world's size, each rank
  runs its share, and an all-gather reassembles them (JAX shards the tile
  batch over its mesh's 'data' axis).
* ``forward_chop`` — the reference's recursive 4-quadrant chopper
  (codes/SRN/utils/util.py:87-147): same shave/min_size decisions and the
  same even-size output rounding.

Both take NCHW tensors and an NCHW -> NCHW model, the port's layout.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from dasr_tpu_torch.core.dist import World
from dasr_tpu_torch.utils import trace


def reflect_index(n: int, before: int, after: int) -> np.ndarray:
    """Source indices of ``np.pad(..., mode='reflect')`` along one axis,
    for pads of any size (the edge is not repeated; period 2 (n - 1))."""
    idx = np.arange(-before, n + after)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - idx, idx)


def pad_reflect(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """Reflect-pad the last two axes like ``jnp.pad(..., mode='reflect')``."""
    h, w = x.shape[-2], x.shape[-1]
    if top or bottom:
        x = x.index_select(-2, torch.from_numpy(reflect_index(h, top, bottom)).to(x.device))
    if left or right:
        x = x.index_select(-1, torch.from_numpy(reflect_index(w, left, right)).to(x.device))
    return x


def forward_chop(
    img: torch.Tensor,
    scale: int,
    model: Callable[[torch.Tensor], torch.Tensor],
    shave: int = 20,
    min_size: int = 160000,
) -> torch.Tensor:
    """Reference-parity recursive quadrant inference on NCHW images."""
    b, _, h, w = img.shape
    if h <= 2 * shave or w <= 2 * shave:
        # too small to quadrant with this shave: run directly (the reference
        # crashes here; fixed per policy, equal output where it runs)
        return model(img)
    top = slice(0, h // 2 + shave)
    bottom = slice(h - h // 2 - shave, h)
    left = slice(0, w // 2 + shave)
    right = slice(w - w // 2 - shave, w)
    quads = [
        img[:, :, top, left],
        img[:, :, top, right],
        img[:, :, bottom, left],
        img[:, :, bottom, right],
    ]

    if h * w < 4 * min_size:
        out = model(torch.cat(quads, 0))
        y_quads = [out[i * b : (i + 1) * b] for i in range(4)]
    else:
        y_quads = [
            forward_chop(q, scale, model, shave=shave, min_size=min_size) for q in quads
        ]

    oh, ow = round(h * scale), round(w * scale)
    # even-size rounding quirk (reference: utils/util.py:127-128)
    if oh % 2 != 0:
        oh += 1
    if ow % 2 != 0:
        ow += 1
    top_o = slice(0, oh // 2)
    bottom_o = slice(oh - oh // 2, oh)
    bottom_r = slice(oh // 2 - oh, None)
    left_o = slice(0, ow // 2)
    right_o = slice(ow - ow // 2, ow)
    right_r = slice(ow // 2 - ow, None)

    y = y_quads[0].new_zeros((b, y_quads[0].shape[1], oh, ow))
    y[:, :, top_o, left_o] = y_quads[0][:, :, top_o, left_o]
    y[:, :, top_o, right_o] = y_quads[1][:, :, top_o, right_r]
    y[:, :, bottom_o, left_o] = y_quads[2][:, :, bottom_r, left_o]
    y[:, :, bottom_o, right_o] = y_quads[3][:, :, bottom_r, right_r]
    return y


def tiled_apply(
    img: torch.Tensor,
    model: Callable[[torch.Tensor], torch.Tensor],
    scale: float,
    tile: int = 256,
    halo: int = 20,
    world: Optional[World] = None,
) -> torch.Tensor:
    """Run ``model`` (an x`scale` NCHW -> NCHW net) over a large image by tiles.

    Every tile carries a ``halo`` overlap that is discarded from the
    outputs, so a model whose receptive influence is < halo gives seam-free
    results. ``tile*scale`` and ``halo*scale`` must be integers; the output
    is cropped to (ceil(H*scale), ceil(W*scale)). With ``world`` the tiles
    fan out over its ranks, and every rank returns the whole image. With
    tracing on the call is the span ``serve.tiles``."""
    th = int(round(scale * halo))
    st = int(round(scale * tile))
    if abs(th - scale * halo) > 1e-9 or abs(st - scale * tile) > 1e-9:
        raise ValueError("tile*scale and halo*scale must be integers")
    with trace.span("serve.tiles"):
        b, _, h, w = img.shape
        ph = (tile - h % tile) % tile
        pw = (tile - w % tile) % tile
        img_p = pad_reflect(img, 0, ph, 0, pw) if (ph or pw) else img
        nh, nw = (h + ph) // tile, (w + pw) // tile

        padded = pad_reflect(img_p, halo, halo, halo, halo)
        t = tile + 2 * halo
        tiles = torch.cat(
            [padded[:, :, rs : rs + t, cs : cs + t]
             for rs in range(0, nh * tile, tile) for cs in range(0, nw * tile, tile)],
            0,
        )
        if world is not None and world.size > 1:
            n_tiles = tiles.shape[0]
            # wrap-repeat the tile batch to a multiple of the ranks (the pad may
            # exceed n_tiles when there are fewer tiles than ranks), as JAX's
            padded = -(-n_tiles // world.size) * world.size
            tiles = tiles[torch.arange(padded, device=tiles.device) % n_tiles]
            out_tiles = torch.cat(world.all_gather(model(world.shard(tiles))), 0)[:n_tiles]
        else:
            out_tiles = model(tiles)
        inner = out_tiles[:, :, th : th + st, th : th + st]
        co = inner.shape[1]
        # (nh*nw*b, co, st, st) -> (b, co, nh, st, nw, st) -> image
        grid = inner.reshape(nh, nw, b, co, st, st).permute(2, 3, 0, 4, 1, 5)
        out = grid.reshape(b, co, nh * st, nw * st)
        return out[:, :, : math.ceil(scale * h), : math.ceil(scale * w)]
