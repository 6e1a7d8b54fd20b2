"""Quality metrics on the host in float64: PSNR, SSIM (MATLAB-equivalent),
YCbCr conversions, modcrop.

Copied from the numpy part of ``dasr_tpu.ops.metrics``:
  * PSNR on [0,255] arrays (reference: codes/SRN/utils/util.py:240-247)
  * SSIM with an 11x11 gaussian window, sigma 1.5, valid-cropped 5px border
    (reference: codes/SRN/utils/util.py:250-291; the reference's 3-channel
    path averages the full-color ssim three times, which equals the
    per-channel mean computed here directly)
  * MATLAB rgb2ycbcr / bgr2ycbcr (reference: codes/SRN/data/util.py:145-190)

The batched device variants wait for the port of ``srn_test
--device_metrics`` (ROADMAP A.3).
"""

from __future__ import annotations

import functools
import math

import numpy as np
from scipy.ndimage import correlate


@functools.lru_cache(maxsize=8)
def _ssim_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel(size, sigma) outer product."""
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g)


def calculate_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """PSNR on [0,255] images (reference: SRN/utils/util.py:240-247)."""
    img1 = np.asarray(img1, dtype=np.float64)
    img2 = np.asarray(img2, dtype=np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def _valid_filter(img: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Valid-region gaussian filtering of HW or HWC float64 arrays."""
    if img.ndim == 3:
        return np.stack(
            [correlate(img[:, :, c], window)[5:-5, 5:-5] for c in range(img.shape[2])],
            axis=2,
        )
    return correlate(img, window)[5:-5, 5:-5]


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = np.asarray(img1, dtype=np.float64)
    img2 = np.asarray(img2, dtype=np.float64)
    window = _ssim_window()
    mu1 = _valid_filter(img1, window)
    mu2 = _valid_filter(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = _valid_filter(img1**2, window) - mu1_sq
    sigma2_sq = _valid_filter(img2**2, window) - mu2_sq
    sigma12 = _valid_filter(img1 * img2, window) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """MATLAB-equivalent SSIM on [0,255] images (SRN/utils/util.py:273-291)."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 2:
        return _ssim_single(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] == 3:
            return _ssim_single(img1, img2)
        if img1.shape[2] == 1:
            return _ssim_single(img1[:, :, 0], img2[:, :, 0])
    raise ValueError("Wrong input image dimensions.")


_Y_RGB = np.array([65.481, 128.553, 24.966])
_FULL_RGB = np.array(
    [[65.481, -37.797, 112.0], [128.553, -74.203, -93.786], [24.966, 112.0, -18.214]]
)


def _ycbcr(img: np.ndarray, coef_y: np.ndarray, coef_full: np.ndarray, only_y: bool):
    in_type = img.dtype
    img = img.astype(np.float64)
    if in_type != np.uint8:
        img = img * 255.0
    if only_y:
        rlt = img @ coef_y / 255.0 + 16.0
    else:
        rlt = img @ coef_full / 255.0 + np.array([16, 128, 128])
    if in_type == np.uint8:
        rlt = rlt.round()
    else:
        rlt = rlt / 255.0
    return rlt.astype(in_type)


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """MATLAB rgb2ycbcr (reference: SRN/data/util.py:145-166)."""
    return _ycbcr(img, _Y_RGB, _FULL_RGB, only_y)


def bgr2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """BGR variant (reference: SRN/data/util.py:169-190)."""
    return _ycbcr(img, _Y_RGB[::-1], _FULL_RGB[::-1], only_y)


def modcrop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop H, W to multiples of scale (reference: SRN/data/util.py:213-226)."""
    h, w = img.shape[0], img.shape[1]
    return img[: h - h % scale, : w - w % scale, ...]
