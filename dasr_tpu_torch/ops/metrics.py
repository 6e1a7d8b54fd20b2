"""Quality metrics: PSNR, SSIM (MATLAB-equivalent), YCbCr conversions,
modcrop.

Counterpart of ``dasr_tpu.ops.metrics``. On the host in float64, copied:
  * PSNR on [0,255] arrays (reference: codes/SRN/utils/util.py:240-247)
  * SSIM with an 11x11 gaussian window, sigma 1.5, valid-cropped 5px border
    (reference: codes/SRN/utils/util.py:250-291; the reference's 3-channel
    path averages the full-color ssim three times, which equals the
    per-channel mean computed here directly)
  * MATLAB rgb2ycbcr / bgr2ycbcr / ycbcr2rgb (reference:
    codes/SRN/data/util.py:145-210)

On the device, batched torch functions of NHWC tensors in f32
(``psnr_device``, ``ssim_device``: a depthwise ``F.conv2d`` over the
window, which needs TF32 off, as ``core/device.py:f32_numerics`` sets it),
and their masked forms for images zero-padded to a shared bucket shape
with their true (h, w) (``psnr_device_masked``, ``ssim_device_masked``,
``psnr_col_device``). The masked forms are exact: the sums are masked, and
the SSIM map keeps only the positions whose 11x11 window lies inside the
true image, so no kept position reads a padded pixel.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
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


# -- device (batched, f32) ------------------------------------------------------


def psnr_device(img1: torch.Tensor, img2: torch.Tensor, peak: float = 1.0) -> torch.Tensor:
    """Per-image PSNR of ...HWC tensors in [0, peak]."""
    mse = ((img1.float() - img2.float()) ** 2).mean(dim=(-3, -2, -1))
    return 20.0 * math.log10(peak) - 10.0 * torch.log10(mse)


def _ssim_map(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """The SSIM map of NHWC images in [0, 255], computed in f32 with the
    VALID 11x11 gaussian window: (N, C, H - 10, W - 10)."""
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    x = img1.float().permute(0, 3, 1, 2)
    y = img2.float().permute(0, 3, 1, 2)
    ch = x.shape[1]
    win = torch.as_tensor(_ssim_window(), dtype=torch.float32, device=x.device)
    win = win.expand(ch, 1, *win.shape)

    def filt(v):
        return F.conv2d(v, win, groups=ch)

    mu1, mu2 = filt(x), filt(y)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = filt(x * x) - mu1_sq
    s2 = filt(y * y) - mu2_sq
    s12 = filt(x * y) - mu1_mu2
    return ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))


def ssim_device(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image SSIM of NHWC tensors in [0, 255]."""
    return _ssim_map(img1, img2).mean(dim=(1, 2, 3))


def _hw_mask(hh: int, ww: int, h, w, device) -> torch.Tensor:
    """(1, hh, ww, 1) f32 mask of the rows < h and the columns < w."""
    rows = torch.arange(hh, device=device).view(hh, 1) < h
    cols = torch.arange(ww, device=device).view(1, ww) < w
    return (rows & cols).float()[None, :, :, None]


def psnr_device_masked(img1, img2, h, w, peak: float = 1.0) -> torch.Tensor:
    """Per-image PSNR of zero-padded NHWC tensors of true size (h, w)."""
    x, y = img1.float(), img2.float()
    mask = _hw_mask(x.shape[-3], x.shape[-2], h, w, x.device)
    sse = (((x - y) ** 2) * mask).sum(dim=(-3, -2, -1))
    return 20.0 * math.log10(peak) - 10.0 * torch.log10(sse / float(h * w * x.shape[-1]))


def psnr_col_device(img1, img2, h: int, w: int) -> torch.Tensor:
    """Per-image PSNR_col (reference: codes/DSN/evaluate.py:45, the PSNR of
    the per-channel spatial means in [0, 1]) of NHWC tensors of uint8
    values, padded beyond their true size (h, w) or not. The masked channel
    sums of the difference are integers, taken in int64 and so exact, and
    the rest runs in f64: the value is the host f64 one. (The difference of
    two f32 means, as ``dasr_tpu``'s device path takes it, cancels to a few
    significant digits where the means nearly agree: ~5e-4 dB at 60 dB.)"""
    x, y = img1.float(), img2.float()
    mask = _hw_mask(x.shape[-3], x.shape[-2], h, w, x.device)
    diff = ((x - y) * mask).to(torch.int64).sum(dim=(-3, -2))
    mean = diff.double() / (h * w * 255.0)
    return (-10.0 * torch.log10((mean * mean).mean(dim=-1))).float()


def ssim_device_masked(img1, img2, h, w) -> torch.Tensor:
    """Per-image SSIM of zero-padded NHWC tensors in [0, 255], true size
    (h, w): ``ssim_device`` of the unpadded images. Map position (i, j)
    reads pixels [i, i + 11) x [j, j + 11), so the positions i <= h - 11,
    j <= w - 11 read no padding; the mean runs over exactly those."""
    m = _ssim_map(img1, img2).permute(0, 2, 3, 1)
    k = _ssim_window().shape[0]
    oh, ow = h - (k - 1), w - (k - 1)
    mask = _hw_mask(m.shape[1], m.shape[2], oh, ow, m.device)
    return (m * mask).sum(dim=(1, 2, 3)) / float(oh * ow * m.shape[-1])


# -- color conversions (MATLAB parity, host numpy) --------------------------------

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


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """MATLAB ycbcr2rgb (reference: SRN/data/util.py:193-210): uint8 in and
    out (rounded), or floats in [0, 1]."""
    in_type = img.dtype
    x = img.astype(np.float64)
    if in_type != np.uint8:
        x = x * 255.0
    mat = np.array([[0.00456621, 0.00456621, 0.00456621],
                    [0, -0.00153632, 0.00791071],
                    [0.00625893, -0.00318811, 0]])
    rlt = x @ mat * 255.0 + np.array([-222.921, 135.576, -276.836])
    rlt = rlt.round() if in_type == np.uint8 else rlt / 255.0
    return rlt.astype(in_type)


def modcrop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop H, W to multiples of scale (reference: SRN/data/util.py:213-226)."""
    h, w = img.shape[0], img.shape[1]
    return img[: h - h % scale, : w - w % scale, ...]
