"""MATLAB bicubic resize on the host (numpy).

Copied from the numpy part of ``dasr_tpu.ops.resize`` (reference:
codes/DSN/utils.py:37-166, codes/SRN/data/util.py:298-434): one dense
resampling matrix per axis with the symmetric boundary folded in, applied
as two einsums. ``PairedDataset`` uses it for on-the-fly LR images when
``dataroot_LR`` is null. The device version (``imresize``) waits for the
DSN slice.
"""

from __future__ import annotations

import functools
import math

import numpy as np


def _cubic(x: np.ndarray) -> np.ndarray:
    """MATLAB's bicubic kernel (a = -0.5), reference: DSN/utils.py:37-43."""
    absx = np.abs(x)
    absx2 = absx**2
    absx3 = absx**3
    return (1.5 * absx3 - 2.5 * absx2 + 1) * (absx <= 1) + (
        -0.5 * absx3 + 2.5 * absx2 - 4 * absx + 2
    ) * ((absx > 1) & (absx <= 2))


def _symmetric_index(idx: np.ndarray, n: int) -> np.ndarray:
    """Map out-of-range indices to MATLAB 'symmetric' boundary indices:
    position -1 -> 0, -2 -> 1, n -> n-1, ..."""
    idx = np.asarray(idx, dtype=np.int64)
    period = 2 * n
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - 1 - idx, idx)


@functools.lru_cache(maxsize=256)
def _resize_matrix(in_length: int, out_length: int, scale: float, antialiasing: bool):
    """Dense (out_length, in_length) MATLAB-bicubic resampling matrix
    (the weight/index arithmetic of ``calculate_weights_indices``,
    DSN/utils.py:46-98)."""
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale

    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(math.ceil(kernel_width)) + 2

    indices = left[:, None] + np.arange(p, dtype=np.float64)[None, :]
    dist = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / weights.sum(axis=1, keepdims=True)

    # Drop an all-zero first/last column (reference: DSN/utils.py:86-92).
    zero_cols = (weights == 0).sum(axis=0)
    if not math.isclose(zero_cols[0], 0, rel_tol=1e-6):
        indices = indices[:, 1:]
        weights = weights[:, 1:]
    if not math.isclose(zero_cols[-1], 0, rel_tol=1e-6):
        indices = indices[:, :-1]
        weights = weights[:, :-1]

    src = _symmetric_index(indices - 1, in_length)  # 1-based -> 0-based
    mat = np.zeros((out_length, in_length), dtype=np.float32)
    rows = np.repeat(np.arange(out_length), src.shape[1])
    np.add.at(mat, (rows, src.ravel()), weights.astype(np.float32).ravel())
    return mat


def imresize_np(img: np.ndarray, scale: float, antialiasing: bool = True,
                clip: bool = True) -> np.ndarray:
    """MATLAB-parity bicubic resize of ...HWC numpy images in [0, 1]."""
    img = np.asarray(img)
    h, w = img.shape[-3], img.shape[-2]
    out_h, out_w = math.ceil(h * scale), math.ceil(w * scale)
    mh = _resize_matrix(h, out_h, scale, antialiasing)
    mw = _resize_matrix(w, out_w, scale, antialiasing)
    out = np.einsum("oh,...hwc->...owc", mh, img, optimize=True)
    out = np.einsum("pw,...hwc->...hpc", mw, out, optimize=True)
    return np.clip(out, 0.0, 1.0) if clip else out
