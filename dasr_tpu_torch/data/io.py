"""Image/array IO for the host data pipeline.

Copied from ``dasr_tpu.data.io`` (framework-free host code). Images are
RGB float32 HWC in [0, 1] throughout (the reference keeps BGR until tensor
conversion; the conversion happens at this boundary instead).

The decoded-image cache keeps decoded uint8 images in RAM across epochs;
enable it with ``enable_decode_cache(gb)`` or ``DASR_DECODE_CACHE_GB``.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

import cv2
import numpy as np

IMG_EXTENSIONS = (
    ".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG", ".ppm", ".PPM",
    ".bmp", ".BMP", ".npy",
)


def is_image_file(filename: str) -> bool:
    return filename.endswith(IMG_EXTENSIONS)


def list_images(root: str) -> List[str]:
    """Sorted recursive listing (reference: data/util.py:24-37 semantics)."""
    if not os.path.isdir(root):
        raise FileNotFoundError(f"{root} is not a valid directory")
    out: List[str] = []
    for dirpath, _, fnames in sorted(os.walk(root)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                out.append(os.path.join(dirpath, fname))
    if not out:
        raise FileNotFoundError(f"{root} has no valid image file")
    return out


_CACHE_LOCK = threading.Lock()
_CACHE: dict = {}
_CACHE_BYTES = 0
_CACHE_LIMIT = float(os.environ.get("DASR_DECODE_CACHE_GB", "0") or 0) * 2**30


def enable_decode_cache(gb: Optional[float]) -> None:
    """Set the decoded-image cache budget in GiB (0/None disables)."""
    global _CACHE_LIMIT, _CACHE_BYTES
    with _CACHE_LOCK:
        _CACHE_LIMIT = float(gb or 0) * 2**30
        if not _CACHE_LIMIT:
            _CACHE.clear()
            _CACHE_BYTES = 0


def _decode_raw(path: str) -> np.ndarray:
    """Decode to RGB HWC in the file's own dtype (u8/u16/f32), no scaling."""
    if path.endswith(".npy"):
        return np.load(path)
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 3:
        img = np.ascontiguousarray(img[:, :, ::-1])  # BGR -> RGB
    return img


def _decode_cached(path: str) -> np.ndarray:
    global _CACHE_BYTES
    if not _CACHE_LIMIT:
        return _decode_raw(path)
    with _CACHE_LOCK:
        hit = _CACHE.get(path)
    if hit is not None:
        return hit
    img = _decode_raw(path)
    img.setflags(write=False)
    with _CACHE_LOCK:
        if _CACHE_BYTES + img.nbytes <= _CACHE_LIMIT:
            _CACHE[path] = img
            _CACHE_BYTES += img.nbytes
    return img


def read_img(path: str) -> np.ndarray:
    """Read an image (or .npy) to RGB float32 HWC in [0, 1]."""
    img = _decode_cached(path)
    img = img.astype(np.float32)
    if img.max() > 1.5:  # uint8/uint16 ranges
        img = img / 255.0
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] > 3:
        img = img[:, :, :3]
    return np.ascontiguousarray(img)


def read_img_u8(path: str) -> np.ndarray:
    """Read an 8-bit image to RGB uint8 HWC (16-bit files are quantised)."""
    img = _decode_cached(path)
    if img.dtype != np.uint8:
        f = read_img(path)
        return (np.clip(f, 0, 1) * 255.0).round().astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] > 3:
        img = img[:, :, :3]
    return img


def save_img(img: np.ndarray, path: str) -> None:
    """Save RGB float [0,1] (or uint8) HWC image as PNG/JPG."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255.0).round().astype(np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 3:
        arr = arr[:, :, ::-1]  # RGB -> BGR for cv2
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cv2.imwrite(path, arr)
