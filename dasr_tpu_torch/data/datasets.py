"""Dataset modes of the serving path, as plain indexable classes returning
dicts of RGB float32 HWC numpy arrays in [0, 1]:

  * ``PairedDataset`` — 'LRHR': paired LR/HR or on-the-fly MATLAB bicubic
    LR; modcrop at test; random aligned crops + flip/rot at train
    (codes/SRN/data/LRHR_dataset.py:10-128)
  * ``LRDataset``     — 'LR' (codes/SRN/data/LR_dataset.py:7-39)
  * ``DASRUnpairedDataset`` — 'LRHR_wavelet_unpair_fake_weights_EQ', the
    DASR training mode: fake LR + aligned DDM + paired HR + random real LR
    + random unpaired HR, joint augment
    (codes/SRN/data/LRHR_wavelet_unpairEq_fake_w_dataset.py)
  * ``DASRUnpairedEqDataset`` — 'LRHR_wavelet_unpair_fake_real_w_EQ': also
    the per-real-LR DDMs (LRHR_wavelet_unpairEq_dataset.py)
  * ``DSNTrainDataset`` — the DSN feed: a clean HR crop, its MATLAB-bicubic
    LR, and a crop of a noisy LR image (codes/DSN/data_loader.py:12-59)
  * ``DSNValDataset``   — the DSN validation feed (data_loader.py:157-190)

Copied from ``dasr_tpu.data.datasets``: the same draws from the same
per-item ``np.random.Generator``, so the port's batches are the JAX
package's. The other unpaired modes wait for their trainers (ROADMAP A.9).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from dasr_tpu_torch.data.io import list_images, load_ddm, read_img, read_img_u8, resize_linear
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


def _rand_crop(img, size, rng):
    h, w = img.shape[:2]
    top = rng.integers(0, max(0, h - size) + 1)
    left = rng.integers(0, max(0, w - size) + 1)
    return img[top : top + size, left : left + size, :], (int(top), int(left))


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


class DASRUnpairedDataset:
    """'LRHR_wavelet_unpair_fake_weights_EQ' — the DASR training mode."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.phase = opt.get("phase", "train")
        self.scale = opt.get("scale", 4)
        self.hr_size = opt.get("HR_size", 128)
        # transfer_uint8: the four image tensors as uint8, cast to f32 / 255
        # on the device by the facade; exact for 8-bit sources (crops and
        # flips only move pixels), 16-bit ones are quantised to 8 bits
        self._read = read_img_u8 if opt.get("transfer_uint8") else read_img
        self.paths_hr = list_images(opt["dataroot_HR"])
        self.paths_fake_lr = list_images(opt["dataroot_fake_LR"])
        self.paths_real_lr = list_images(opt["dataroot_real_LR"])
        self.paths_fake_w = (
            list_images(opt["dataroot_fake_weights"])
            if opt.get("dataroot_fake_weights")
            else None
        )

    def __len__(self):
        return len(self.paths_fake_lr)

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(index)
        lr_fake = self._read(self.paths_fake_lr[index])
        self._last_real_index = int(rng.integers(len(self.paths_real_lr)))
        lr_real = self._read(self.paths_real_lr[self._last_real_index])
        fake_w = None
        if self.paths_fake_w is not None:
            fake_w = load_ddm(self.paths_fake_w[index])
            # DDM -> fake-LR size (reference: fake_w_dataset.py:66, bilinear)
            fake_w = resize_linear(fake_w, lr_fake.shape[1], lr_fake.shape[0])
        hr = self._read(self.paths_hr[index])
        hr_unpair = self._read(self.paths_hr[int(rng.integers(len(self.paths_hr)))])

        if self.phase == "train":
            lr_size = self.hr_size // self.scale
            lr_fake_c, (t, l) = _rand_crop_aligned(lr_fake, lr_size, rng, hr.shape, self.scale)
            if fake_w is not None:
                fake_w = fake_w[t : t + lr_size, l : l + lr_size, :]
            lr_real, _ = _rand_crop(lr_real, lr_size, rng)
            hr = hr[
                t * self.scale : t * self.scale + self.hr_size,
                l * self.scale : l * self.scale + self.hr_size,
                :,
            ]
            hr_unpair, _ = _rand_crop(hr_unpair, self.hr_size, rng)
            imgs = [lr_fake_c, lr_real, hr, hr_unpair] + ([fake_w] if fake_w is not None else [])
            imgs = _augment(
                imgs, rng, self.opt.get("use_flip", True), self.opt.get("use_rot", True)
            )
            lr_fake, lr_real, hr, hr_unpair = imgs[:4]
            if fake_w is not None:
                fake_w = imgs[4]
        item = {
            "LR_fake": lr_fake,
            "LR_real": lr_real,
            "HR": hr,
            "HR_unpair": hr_unpair,
            "LR_fake_path": self.paths_fake_lr[index],
            "HR_path": self.paths_hr[index],
        }
        if fake_w is not None:
            item["fake_w"] = fake_w
        return item


class DASRUnpairedEqDataset(DASRUnpairedDataset):
    """'LRHR_wavelet_unpair_fake_real_w_EQ': like the DASR mode but also
    loads per-real-LR DDMs (reference: codes/SRN/data/
    LRHR_wavelet_unpairEq_dataset.py — DSN --including_source_ddm output)."""

    def __init__(self, opt: Dict):
        super().__init__(opt)
        self.paths_real_w = (
            list_images(opt["dataroot_real_weights"])
            if opt.get("dataroot_real_weights")
            else None
        )

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(index)
        item = super().__getitem__(index, rng)
        if self.paths_real_w is not None:
            i_real = self._last_real_index % len(self.paths_real_w)
            real_w = load_ddm(self.paths_real_w[i_real])
            lr = item["LR_real"]
            real_w = resize_linear(real_w, lr.shape[1], lr.shape[0])
            item["real_w"] = real_w[: lr.shape[0], : lr.shape[1], :]
        return item


class DSNTrainDataset:
    """DSN unpaired trainer feed (codes/DSN/data_loader.py:12-59).

    Returns (clean HR crop, MATLAB-bicubic LR of that crop, random noisy LR
    crop); each noisy image is paired with a random clean image.
    ``transfer_uint8`` keeps the crops uint8 (cast on the device);
    ``device_bicubic`` leaves out the bicubic, which the step computes."""

    def __init__(self, source_dir: str, target_dir: str, crop_size: int = 256,
                 upscale_factor: int = 4, flips: bool = False, rotations: bool = False,
                 transfer_uint8: bool = False, device_bicubic: bool = False):
        self.noisy = list_images(source_dir)
        self.clean = list_images(target_dir)
        self.crop = crop_size - crop_size % upscale_factor
        self.scale = upscale_factor
        self.flips = flips
        self.rotations = rotations
        self.device_bicubic = device_bicubic
        self._read = read_img_u8 if transfer_uint8 else read_img

    def __len__(self):
        return len(self.noisy)

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(index)
        clean = self._read(self.clean[int(rng.integers(len(self.clean)))])
        noisy = self._read(self.noisy[index])
        clean, _ = _rand_crop(clean, self.crop, rng)
        noisy, _ = _rand_crop(noisy, self.crop // self.scale, rng)
        if self.flips or self.rotations:
            clean = _augment([clean], rng, self.flips, self.rotations)[0]
            noisy = _augment([noisy], rng, self.flips, self.rotations)[0]
        item = {"input": clean, "disc": noisy}
        if not self.device_bicubic:
            clean_f = clean.astype(np.float32) / 255.0 if clean.dtype == np.uint8 else clean
            item["bicubic"] = imresize_np(clean_f, 1.0 / self.scale)
        return item


class DSNValDataset:
    """DSN validation feed (codes/DSN/data_loader.py:157-190): a deterministic
    center crop by default, so val PSNR is comparable across epochs;
    ``random_crop`` re-crops at random as the reference does."""

    def __init__(self, hr_dir: str, lr_dir: Optional[str] = None, crop_size: int = 256,
                 upscale_factor: int = 4, random_crop: bool = False):
        self.hr = list_images(hr_dir)
        self.lr = list_images(lr_dir) if lr_dir else None
        self.crop = crop_size - crop_size % upscale_factor
        self.scale = upscale_factor
        self.random_crop = random_crop

    def __len__(self):
        return len(self.hr)

    def __getitem__(self, index: int, rng=None):
        hr = read_img(self.hr[index])
        h, w = hr.shape[:2]
        if self.random_crop:
            rng = rng or np.random.default_rng(index)
            hr, _ = _rand_crop(hr, self.crop, rng)
        else:
            t = max(0, (h - self.crop) // 2)
            l = max(0, (w - self.crop) // 2)
            hr = hr[t : t + self.crop, l : l + self.crop, :]
        out = {"input": hr, "bicubic": imresize_np(hr, 1.0 / self.scale)}
        if self.lr:
            out["lr"] = read_img(self.lr[index % len(self.lr)])
        return out


_REGISTRY = {
    "LRHR": PairedDataset,
    "LR": LRDataset,
    "LRHR_wavelet_unpair_fake_weights_EQ": DASRUnpairedDataset,
    "LRHR_wavelet_unpair_fake_real_w_EQ": DASRUnpairedEqDataset,
}


def create_dataset(opt: Dict):
    """Dataset registry (reference: codes/SRN/data/__init__.py:6-27)."""
    mode = opt["mode"]
    if mode not in _REGISTRY:
        raise NotImplementedError(
            f"Dataset [{mode}] is not ported yet: dasr_tpu_torch has the modes "
            f"{sorted(_REGISTRY)}; the others come with their trainers (ROADMAP A.9)"
        )
    return _REGISTRY[mode](opt)
