"""Fixed (non-learned) frequency-separation filter bank on NCHW tensors.

Counterpart of ``dasr_tpu.ops.filters`` (reference ``GaussianFilter`` /
``FilterLow`` / ``FilterHigh``, codes/DSN/model.py:227-293): depthwise convs
and average pools with the reference's boundary semantics — zero-padded
gaussian low-pass; avg-pool low-pass with ``count_include_pad`` as
``include_pad`` says; VALID low-pass where ``padding=False``. Plain tensor
code, as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from dasr_tpu_torch.core.device import constant
from dasr_tpu_torch.ops.dwt import haar_bands, haar_dwt


@functools.lru_cache(maxsize=16)
def gaussian_kernel(kernel_size: int = 5) -> np.ndarray:
    """2D gaussian window, reference arithmetic (DSN/model.py:230-243)."""
    mean = (kernel_size - 1) / 2.0
    variance = (kernel_size / 6.0) ** 2.0
    coords = np.arange(kernel_size, dtype=np.float64)
    xx, yy = np.meshgrid(coords, coords, indexing="xy")
    k = np.exp(-((xx - mean) ** 2 + (yy - mean) ** 2) / (2 * variance))
    return (k / k.sum()).astype(np.float32)


def _ones_kernel(k: int) -> np.ndarray:
    return np.ones((k, k), dtype=np.float32)


def _depthwise_conv(x: torch.Tensor, make, size: int, stride: int, pad: int):
    """x convolved per channel with the 2D kernel ``make(size)``."""
    c = x.shape[1]
    k = constant(make, size, device=x.device, dtype=x.dtype)
    return F.conv2d(x, k.expand(c, 1, *k.shape), stride=stride, padding=pad, groups=c)


def _avg_pool(x: torch.Tensor, k: int, stride: int, pad: int, include_pad: bool):
    # windowed sums as a depthwise ones-conv, as the JAX package computes them
    sums = _depthwise_conv(x, _ones_kernel, k, stride, pad)
    if include_pad:
        return sums / (k * k)
    counts = _depthwise_conv(x.new_ones((1, 1) + tuple(x.shape[-2:])), _ones_kernel, k, stride,
                             pad)
    return sums / counts


def filter_low(x: torch.Tensor, kernel_size: int = 5, stride: int = 1, recursions: int = 1,
               padding: bool = True, include_pad: bool = True, gaussian: bool = False):
    """Low-pass, reference FilterLow parity (DSN/model.py:258-274)."""
    pad = (kernel_size - 1) // 2 if padding else 0
    for _ in range(recursions):
        if gaussian:
            x = _depthwise_conv(x, gaussian_kernel, kernel_size, stride, pad)
        else:
            x = _avg_pool(x, kernel_size, stride, pad, include_pad)
    return x


def filter_high(x: torch.Tensor, kernel_size: int = 5, stride: int = 1, recursions: int = 1,
                include_pad: bool = True, normalize: bool = True, gaussian: bool = False):
    """High-pass = x - low(x), reference FilterHigh parity
    (DSN/model.py:277-293); with ``normalize`` remapped as 0.5 + 0.5 hf.
    The inner low-pass always pads (SAME)."""

    def low(v):
        return filter_low(v, kernel_size, stride, 1, True, include_pad, gaussian)

    for _ in range(recursions - 1):
        x = low(x)
    x = x - low(x)
    return 0.5 + x * 0.5 if normalize else x


def wavelet_high_cat(x: torch.Tensor, norm: bool = True, cs: str = "cat") -> torch.Tensor:
    """High-band discriminator input via Haar DWT (DSN/model.py:108-118)."""
    return haar_bands(x, norm=norm, cs=cs)[1]


def wavelet_ll(x: torch.Tensor, norm: bool = True) -> torch.Tensor:
    """LL sub-band for the DSN color loss (reference: DSN/loss.py:103-107)."""
    ll = haar_dwt(x)[0]
    return ll * 0.5 if norm else ll
