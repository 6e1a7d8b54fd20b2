"""Domain-distance map (DDM) back-projection on tensors.

Counterpart of ``dasr_tpu.ops.rf_splat``. The reference splats every
discriminator patch score over its receptive field with a Python double
loop and normalises by hit counts (codes/DSN/receptive_cal.py:34-60,
driven by codes/DSN/create_dataset_modified.py:14-24). The receptive-field
boxes are axis-aligned, so the splat factors into per-axis interval
indicator matrices U (n_h x H) and V (n_w x W):

    ddm = (U^T . scores . V) / (U^T 1 . 1 V)

two f32 matrix products (TF32 off on the card, as the JAX package's
``Precision.HIGHEST``). The boundary clamping and the reference's ``int()``
truncation of the fractional ``start`` offset are kept.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

# Per-discriminator conv stacks [kernel, stride, padding] used for the
# receptive-field geometry (reference: create_dataset_modified.py:114-121).
CONVNETS = {
    "FSD": [[5, 1, 2]] * 4,
    "nld_s1": [[4, 1, 1]] * 4,
    "nld_s2": [[4, 2, 1], [4, 2, 1], [4, 1, 1], [4, 1, 1]],
}


def receptive_field(imsize: int, convnet: Sequence[Sequence[int]]) -> Tuple[int, int, int, float]:
    """(n_out, jump, rf, start) for a conv stack (reference: receptive_cal.py:8-53)."""
    n, j, r, start = imsize, 1, 1, 0.5
    for k, s, p in convnet:
        n_out = math.floor((n - k + 2 * p) / s) + 1
        actual_p = (n_out - 1) * s - n + k
        p_left = math.floor(actual_p / 2)
        start = start + ((k - 1) / 2 - p_left) * j
        r = r + (k - 1) * j
        j = j * s
        n = n_out
    return n, j, r, start


def _interval_matrix(n_cells: int, length: int, jump: int, rf: int, start: float) -> np.ndarray:
    """M[i, p] = 1 iff pixel p lies in cell i's receptive-field box, with the
    box bounds of the reference's ``weights_matrix`` (receptive_cal.py:34-43):
    lo = int(max(0, start + i*jump - rf//2)), hi = int(start + i*jump + rf -
    rf//2), clamped by slicing."""
    m = np.zeros((n_cells, length), dtype=np.float32)
    half = rf // 2
    for i in range(n_cells):
        lo = int(max(0.0, start + i * jump - half))
        hi = int(start + i * jump + rf - half)
        m[i, lo : max(lo, min(hi, length))] = 1.0
    return m


@functools.lru_cache(maxsize=64)
def _splat_matrices(out_h: int, out_w: int, convnet_key: tuple):
    convnet = [list(c) for c in convnet_key]
    n_h, jump, rf, start = receptive_field(out_h, convnet)
    n_w, _, _, _ = receptive_field(out_w, convnet)
    return (_interval_matrix(n_h, out_h, jump, rf, start),
            _interval_matrix(n_w, out_w, jump, rf, start))


def ddm_splat(scores: torch.Tensor, out_h: int, out_w: int,
              convnet: Sequence[Sequence[int]]) -> torch.Tensor:
    """Back-project D patch scores (...hw) to a dense f32 (..., out_h, out_w)
    DDM. The receptive-field geometry comes from (out_h, out_w); scores are
    truncated to the predicted grid where they are a pixel larger."""
    u, v = _splat_matrices(out_h, out_w, tuple(tuple(c) for c in convnet))
    scores = scores[..., : u.shape[0], : v.shape[0]].float()
    u = torch.from_numpy(u).to(scores.device)
    v = torch.from_numpy(v).to(scores.device)
    cnt = torch.outer(u.sum(0), v.sum(0))
    return (u.T @ scores @ v) / cnt


def ddm_shape_for(filter_type: str, lr_h: int, lr_w: int) -> Tuple[int, int]:
    """DDM spatial size per FS type (reference: create_dataset_modified.py:15-20)."""
    if filter_type.lower() in ("gau", "avg_pool"):
        return lr_h, lr_w
    if filter_type.lower() == "wavelet":
        return lr_h // 2, lr_w // 2
    raise NotImplementedError(f"Frequency Separation [{filter_type}] not recognized")
