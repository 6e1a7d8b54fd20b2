"""Dataset modes of the serving path, as plain indexable classes returning
dicts of RGB float32 HWC numpy arrays in [0, 1]:

  * ``PairedDataset`` — 'LRHR': paired LR/HR or on-the-fly MATLAB bicubic
    LR; modcrop at test; random aligned crops + flip/rot at train
    (codes/SRN/data/LRHR_dataset.py:10-128)
  * ``LRDataset``     — 'LR' (codes/SRN/data/LR_dataset.py:7-39)

Copied from ``dasr_tpu.data.datasets``. The unpaired training modes come
with the training slice (ROADMAP A.5).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from dasr_tpu_torch.data.io import list_images, read_img
from dasr_tpu_torch.ops.metrics import modcrop
from dasr_tpu_torch.ops.resize import imresize_np


def _augment(imgs, rng, hflip=True, rot=True):
    """Joint flip/rot augment (reference: codes/SRN/data/util.py:116-128)."""
    do_h = hflip and rng.random() < 0.5
    do_v = rot and rng.random() < 0.5
    do_r = rot and rng.random() < 0.5

    def one(img):
        if do_h:
            img = img[:, ::-1, :]
        if do_v:
            img = img[::-1, :, :]
        if do_r:
            img = img.transpose(1, 0, 2)
        return np.ascontiguousarray(img)

    return [one(i) for i in imgs]


def _rand_crop_aligned(lr_img, lr_size, rng, hr_shape, scale):
    """Random LR crop whose x`scale` HR window fits inside ``hr_shape``."""
    h, w = lr_img.shape[:2]
    max_t = min(h - lr_size, (hr_shape[0] - lr_size * scale) // scale)
    max_l = min(w - lr_size, (hr_shape[1] - lr_size * scale) // scale)
    top = int(rng.integers(0, max(0, max_t) + 1))
    left = int(rng.integers(0, max(0, max_l) + 1))
    return lr_img[top : top + lr_size, left : left + lr_size, :], (top, left)


class PairedDataset:
    """'LRHR' mode."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.phase = opt.get("phase", "train")
        self.scale = opt.get("scale", 4)
        self.hr_size = opt.get("HR_size")
        self.paths_hr = list_images(opt["dataroot_HR"])
        self.paths_lr = (
            list_images(opt["dataroot_LR"]) if opt.get("dataroot_LR") else None
        )

    def __len__(self):
        return len(self.paths_hr)

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(index)
        hr = read_img(self.paths_hr[index])
        if self.phase != "train":
            hr = modcrop(hr, self.scale)
        if self.paths_lr is not None:
            lr = read_img(self.paths_lr[index])
        else:
            lr = imresize_np(hr, 1.0 / self.scale)
        if self.phase == "train":
            lr_size = self.hr_size // self.scale
            lr, (t, l) = _rand_crop_aligned(lr, lr_size, rng, hr.shape, self.scale)
            hr = hr[
                t * self.scale : t * self.scale + self.hr_size,
                l * self.scale : l * self.scale + self.hr_size,
                :,
            ]
            lr, hr = _augment(
                [lr, hr], rng, self.opt.get("use_flip", True), self.opt.get("use_rot", True)
            )
        return {
            "LR": lr,
            "HR": hr,
            "LR_path": self.paths_lr[index] if self.paths_lr else self.paths_hr[index],
            "HR_path": self.paths_hr[index],
        }


class LRDataset:
    """'LR' mode (inference only)."""

    def __init__(self, opt: Dict):
        self.paths_lr = list_images(opt["dataroot_LR"])

    def __len__(self):
        return len(self.paths_lr)

    def __getitem__(self, index: int, rng=None):
        return {"LR": read_img(self.paths_lr[index]), "LR_path": self.paths_lr[index]}


_REGISTRY = {"LRHR": PairedDataset, "LR": LRDataset}


def create_dataset(opt: Dict):
    """Dataset registry (reference: codes/SRN/data/__init__.py:6-27)."""
    mode = opt["mode"]
    if mode not in _REGISTRY:
        raise NotImplementedError(
            f"Dataset [{mode}] is not ported yet: dasr_tpu_torch serves the "
            "'LRHR' and 'LR' modes; the training modes come with ROADMAP A.5"
        )
    return _REGISTRY[mode](opt)
