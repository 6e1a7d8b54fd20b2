"""Evaluation protocol — parity with the reference's metric pipeline.

Metrics run on uint8-quantised images with a ``scale``-px border crop, and
LPIPS on the uint8 image mapped to [-1, 1] (reference:
codes/SRN/test.py:84-118, tensor2img at codes/SRN/utils/util.py:180-204).
Copied from ``dasr_tpu.eval.evaluate``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from dasr_tpu_torch.ops.metrics import bgr2ycbcr, calculate_psnr, calculate_ssim


def to_uint8(img: np.ndarray) -> np.ndarray:
    """float [0,1] HWC -> uint8, matching tensor2img (clamp, x255, round)."""
    return (np.clip(img, 0, 1) * 255.0).round().astype(np.uint8)


def im2tensor_range(img_uint8: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float HWC in [-1, 1] (PerceptualSimilarity im2tensor)."""
    return img_uint8.astype(np.float32) / 127.5 - 1.0


def sr_metrics(
    sr_uint8: np.ndarray,
    gt_uint8: np.ndarray,
    scale: int,
    lpips_fn=None,
) -> Dict[str, float]:
    """PSNR/SSIM (+Y-channel) with scale-px border crop, optional LPIPS
    (codes/SRN/test.py:84-118). Arrays are RGB; the Y channel goes through
    bgr2ycbcr on the channel-reversed image, as the reference's BGR arrays do."""
    crop = scale
    sr_c = sr_uint8[crop:-crop, crop:-crop, :].astype(np.float64)
    gt_c = gt_uint8[crop:-crop, crop:-crop, :].astype(np.float64)
    out = {
        "psnr": calculate_psnr(sr_c, gt_c),
        "ssim": calculate_ssim(sr_c, gt_c),
    }
    if sr_uint8.shape[2] == 3:
        sr_y = bgr2ycbcr(sr_uint8[:, :, ::-1].astype(np.float64) / 255.0, only_y=True) * 255
        gt_y = bgr2ycbcr(gt_uint8[:, :, ::-1].astype(np.float64) / 255.0, only_y=True) * 255
        out["psnr_y"] = calculate_psnr(sr_y[crop:-crop, crop:-crop], gt_y[crop:-crop, crop:-crop])
        out["ssim_y"] = calculate_ssim(sr_y[crop:-crop, crop:-crop], gt_y[crop:-crop, crop:-crop])
    if lpips_fn is not None:
        out["lpips"] = float(
            lpips_fn(im2tensor_range(sr_uint8)[None], im2tensor_range(gt_uint8)[None])
        )
    return out


def average(results) -> Dict[str, float]:
    keys = results[0].keys()
    return {k: float(np.mean([r[k] for r in results])) for k in keys}
