"""Spatially-sharded inference with halo exchange between ranks.

Counterpart of ``dasr_tpu.ops.spatial_shard``, the multi-card form of the
reference's recursive ``forward_chop`` (codes/SRN/utils/util.py:87-147):
the image's H axis is split over the world's ranks; each rank takes its
neighbours' boundary rows as halos, runs the model on (top halo, its rows,
bottom halo), and crops the scaled halos. The two image-edge strips are
recomputed from the true edges (zero halos differ from a conv's virtual
zero padding once biases exist), so for any zero-padded conv net whose
receptive influence is <= halo the result equals the unsharded forward.

JAX moves the halos with ``ppermute``. Here each rank's edge rows go
through one ``all_gather`` (NCCL, or gloo with CUDA or CPU tensors; gloo has
no point-to-point send of CUDA tensors), and a second one reassembles the
output on every rank. Compare ``ops/tiled.py:tiled_apply``, which fans out
independent overlapping tiles instead.
"""

from __future__ import annotations

from typing import Callable

import torch

from dasr_tpu_torch.core.dist import World
from dasr_tpu_torch.ops.tiled import pad_reflect


def spatially_sharded_apply(
    img: torch.Tensor,
    model: Callable[[torch.Tensor], torch.Tensor],
    scale: int,
    halo: int,
    world: World,
) -> torch.Tensor:
    """Run an x``scale`` NCHW -> NCHW zero-padded conv model over ``img``
    with its H axis split over ``world``'s ranks; every rank returns the
    whole output.

    H that the world's size does not divide is reflect-padded to the next
    multiple (the output cropped back); each rank's rows (after padding)
    must be >= halo. Rows within ``halo`` of the true edges are recomputed
    from the original image, so the padding never leaks into the result."""
    n, r = world.size, world.rank
    h = img.shape[2]
    pad_h = (n - h % n) % n
    x = pad_reflect(img, 0, pad_h, 0, 0) if pad_h else img
    rows = (h + pad_h) // n
    if rows < halo:
        raise ValueError(f"{h} rows over {n} ranks leave {rows} a rank, fewer than the "
                         f"halo of {halo}")
    local = x[:, :, r * rows:(r + 1) * rows]
    # each rank's (top rows, bottom rows); a rank's top halo is the bottom
    # rows of the rank before, its bottom halo the top rows of the one after,
    # zeros at the image's edges (as ppermute leaves them)
    edges = world.all_gather(torch.cat([local[:, :, :halo], local[:, :, rows - halo:]], 2))
    zeros = local.new_zeros(local[:, :, :halo].shape)
    top = edges[r - 1][:, :, halo:] if r > 0 else zeros
    bot = edges[r + 1][:, :, :halo] if r < n - 1 else zeros
    y = model(torch.cat([top, local, bot], 2))
    y = y[:, :, halo * scale: y.shape[2] - halo * scale]
    out = torch.cat(world.all_gather(y), 2)[:, :, : h * scale]

    # the edge strips from the real image's edges (receptive field <= halo)
    if halo:
        out[:, :, : halo * scale] = model(img[:, :, : 2 * halo])[:, :, : halo * scale]
        out[:, :, -halo * scale:] = model(img[:, :, -2 * halo:])[:, :, -halo * scale:]
    return out
