"""Evaluation protocol — parity with the reference's metric pipeline.

Metrics run on uint8-quantised images with a ``scale``-px border crop, and
LPIPS on the uint8 image mapped to [-1, 1] (reference:
codes/SRN/test.py:84-118, tensor2img at codes/SRN/utils/util.py:180-204).
The host f64 path is copied from ``dasr_tpu.eval.evaluate``; the device
path (``sr_metrics_device``, ``sr_metrics_device_bucketed``) is the
counterpart of the JAX ``srn_train`` CLI's ``_make_dev_val_metrics`` and
``_make_dev_val_metrics_bucketed``: the same protocol in f32 on the card,
within 1e-3 dB and 1e-4 SSIM of the host's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dasr_tpu_torch.ops.metrics import (
    bgr2ycbcr, calculate_psnr, calculate_ssim, psnr_device, psnr_device_masked, ssim_device,
    ssim_device_masked)

METRIC_KEYS = ("psnr", "ssim", "psnr_y", "ssim_y")
_Y_COEF = (65.481, 128.553, 24.966)


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


def to_uint8_device(sr: torch.Tensor) -> torch.Tensor:
    """``to_uint8`` on the device: the same clamp, x255 and half-even round."""
    return torch.round(sr.float().clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def _y(x: torch.Tensor) -> torch.Tensor:
    """MATLAB Y of an (H, W, 3) RGB tensor of 0..255 values: (H, W, 1)."""
    coef = torch.tensor(_Y_COEF, dtype=torch.float32, device=x.device)
    return (x * coef).sum(-1, keepdim=True) / 255.0 + 16.0


def _protocol(sr8, hr8, scale: int, hw=None):
    """[psnr, ssim, psnr_y, ssim_y] of (H, W, 3) f32 tensors of uint8
    values, border-cropped; ``hw``: the true (h, w) of zero-padded ones."""
    c = scale
    pairs = ((sr8[c:-c, c:-c][None], hr8[c:-c, c:-c][None]),
             (_y(sr8)[c:-c, c:-c][None], _y(hr8)[c:-c, c:-c][None]))
    vals = []
    for a, b in pairs:
        if hw is None:
            vals += [psnr_device(a, b, 255.0), ssim_device(a, b)]
        else:
            h, w = hw[0] - 2 * c, hw[1] - 2 * c
            vals += [psnr_device_masked(a, b, h, w, 255.0), ssim_device_masked(a, b, h, w)]
    return vals


def sr_metrics_device(sr: torch.Tensor, gt_uint8: torch.Tensor, scale: int,
                      lpips_raw=None) -> torch.Tensor:
    """``sr_metrics`` on the device, unsynchronised: ``sr`` (H, W, 3) f32 in
    [0, 1], ``gt_uint8`` (H, W, 3) uint8, both on the same device; returns
    [psnr, ssim, psnr_y, ssim_y(, lpips)] as one f32 tensor. ``lpips_raw``:
    (a, b) NCHW in [-1, 1] -> LPIPS tensor."""
    sr8, hr8 = to_uint8_device(sr).float(), gt_uint8.float()
    vals = _protocol(sr8, hr8, scale)
    if lpips_raw is not None:
        vals.append(lpips_raw(*(v.permute(2, 0, 1)[None] / 127.5 - 1.0 for v in (sr8, hr8))))
    return torch.stack([v.reshape(()) for v in vals])


def sr_metrics_device_bucketed(sr_uint8: torch.Tensor, gt_uint8: torch.Tensor, scale: int,
                               bucket: int) -> torch.Tensor:
    """[psnr, ssim, psnr_y, ssim_y] with both images zero-padded to the next
    multiple of ``bucket`` and the masked metrics, so images of many sizes
    share a few shapes: exactly ``sr_metrics_device``'s values."""
    h, w = sr_uint8.shape[0], sr_uint8.shape[1]
    ph, pw = -(-h // bucket) * bucket, -(-w // bucket) * bucket
    padded = []
    for v in (sr_uint8, gt_uint8):
        p = v.new_zeros((ph, pw, v.shape[2]), dtype=torch.float32)
        p[:h, :w] = v.float()
        padded.append(p)
    return torch.stack([v.reshape(()) for v in _protocol(*padded, scale, hw=(h, w))])


def metrics_dict(values, lpips: bool = False) -> Dict[str, float]:
    """A host list of ``sr_metrics_device`` values as ``sr_metrics``'s dict."""
    keys = METRIC_KEYS + (("lpips",) if lpips else ())
    return {k: float(v) for k, v in zip(keys, values)}


def sr_metrics_on(opt, lpips_fn=None, device_metrics: bool = False, bucket: int = 0):
    """The SRN protocol as the CLIs choose it: ``measure(sr, gt)``, with
    ``sr`` the SR image as an f32 HWC device tensor and ``gt`` the HR image
    as the datasets give it (HWC numpy, f32 in [0, 1]), issues the work and returns ``finish(sr_host)`` -> the
    ``sr_metrics`` dict. Host f64 metrics unless ``device_metrics``; on the
    device unless the chop or ``pad_bucket`` forward is on and no
    ``bucket`` is given (as the JAX CLIs gate it). ``lpips_fn``:
    ``srn_test.make_lpips``'s function."""
    scale = opt.get("scale", 4)
    on_device = device_metrics and (bucket or not (opt.get("chop") or opt.get("pad_bucket")))
    raw = lpips_fn.raw if lpips_fn is not None else None

    def measure(sr, gt):
        if not on_device:
            return lambda sr_host: sr_metrics(to_uint8(sr_host), to_uint8(gt), scale, lpips_fn)
        hr8 = torch.from_numpy(to_uint8(gt)).to(sr.device)
        if bucket:
            sr8 = to_uint8_device(sr)
            vals = sr_metrics_device_bucketed(sr8, hr8, scale, bucket)
            if raw is not None:
                vals = torch.cat([vals, raw(*(v.float().permute(2, 0, 1)[None] / 127.5 - 1.0
                                              for v in (sr8, hr8))).reshape(1)])
        else:
            vals = sr_metrics_device(sr, hr8, scale, raw)
        return lambda sr_host: metrics_dict(vals.tolist(), lpips=raw is not None)

    return measure
