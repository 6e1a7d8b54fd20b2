"""Device-resident image banks: the whole decoded training corpus on the
card, crops taken there.

Counterpart of ``dasr_tpu.data.device_bank``. Every decoded image is
uploaded once (padded to the bank's largest size, uint8; the DDMs as f32),
and each train step samples its batch from the banks on the card: the only
per-step host traffic is a (K, B) index window. The sampling law is the
host loader's (codes/DSN/data_loader.py:12-59,
codes/SRN/data/LRHR_wavelet_unpairEq_fake_w_dataset.py:95-140, the 'LRHR'
mode's aligned crop, ``data/datasets.py:PairedDataset``): uniform
crop offsets over the valid range, uniform picks, a 50% dihedral augment
per draw. The stream is torch's, not the host loader's or JAX's.

Sampling is split in two so each half can be held on its own:

* ``draw_dsn`` / ``draw_dasr`` / ``draw_paired`` draw, from an explicit
  ``torch.Generator`` on the bank's device, the uniforms of the crop
  offsets, the picks and the three augment bits of every item, as plain
  tensors;
* ``gather_dsn`` / ``gather_dasr`` / ``gather_paired`` turn (indices,
  draws) into the batch.
  Each tensor of the batch is one advanced-indexing read of its bank
  through a (B, crop, crop) row and column index grid, into which the
  joint dihedral augment is folded (a flip reverses a grid axis, a
  transpose swaps the row and column grids): five reads a DASR step, two
  a paired one, whatever B is, at fixed shapes. ``gather_*_plain`` is the literal per-item slicing
  of the JAX sampler's loop, used to check them.

Batches are NHWC, so ``permute(0, 3, 1, 2)`` gives channels_last NCHW
without a copy. The JAX package's layout-pin upload (``_pinned_put``) is
TPU machinery and is not ported: ``upload`` is a plain copy.

Repaired against the JAX package: the host cache of ``build_bank`` keys on
each file's path, mtime and size, not on the paths alone, so a corpus
rewritten in place is never served stale.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from dasr_tpu_torch.data.io import list_images, load_ddm, read_img_u8, resize_linear


class ImageBank(NamedTuple):
    """(N, Hmax, Wmax, C) images, zero-padded, and their (N, 2) int32 true
    (h, w): numpy arrays on the host, tensors on the device."""

    data: "np.ndarray | torch.Tensor"
    sizes: "np.ndarray | torch.Tensor"


class SrnBanks(NamedTuple):
    """The four stage-3 banks; ``ddm`` is None where weights are computed
    online."""

    fake: ImageBank
    hr: ImageBank
    real: ImageBank
    ddm: Optional[ImageBank]


class PairedBanks(NamedTuple):
    """The paired models' two banks ('LRHR'): the LR images and their HRs,
    row for row."""

    lr: ImageBank
    hr: ImageBank


class DsnDraws(NamedTuple):
    """One DSN batch's draws: the clean image picked for each noisy index,
    the crop-offset uniforms of both crops (B, 2), the augment bits (B, 3)
    of each crop (hflip, vflip, transpose)."""

    clean_pick: torch.Tensor
    clean_u: torch.Tensor
    noisy_u: torch.Tensor
    clean_aug: torch.Tensor
    noisy_aug: torch.Tensor


class DasrDraws(NamedTuple):
    """One DASR batch's draws: the aligned fake-LR/HR offset uniforms, the
    real-LR pick and its offset uniforms, the unpaired-HR pick and its
    offset uniforms, and one joint augment (B, 3) for all five tensors."""

    fake_u: torch.Tensor
    real_pick: torch.Tensor
    real_u: torch.Tensor
    hr_pick: torch.Tensor
    unpair_u: torch.Tensor
    aug: torch.Tensor


class PairedDraws(NamedTuple):
    """One paired batch's draws: the aligned LR/HR offset uniforms (B, 2)
    and the augment bits (B, 3) of both crops."""

    u: torch.Tensor
    aug: torch.Tensor


def _files(dir_or_files):
    if isinstance(dir_or_files, (str, os.PathLike)):
        return list_images(dir_or_files)
    return list(dir_or_files)


def _header_sizes(dir_or_files):
    from PIL import Image

    out = []
    for f in _files(dir_or_files):
        with Image.open(f) as im:
            w, h = im.size
        out.append((h, w))
    return np.array(out, np.int64)


def bank_nbytes(dir_or_files) -> int:
    """Padded uint8 footprint of a bank without decoding (image headers)."""
    hw = _header_sizes(dir_or_files)
    return int(len(hw) * hw[:, 0].max() * hw[:, 1].max() * 3)


def bank_min_hw(dir_or_files) -> tuple:
    """Smallest (h, w) over the bank's images, without decoding: callers
    fall back to the host loader where an image cannot hold a crop (the
    host loader's crop truncates there; the bank's fixed-size gather
    cannot)."""
    hw = _header_sizes(dir_or_files)
    return int(hw[:, 0].min()), int(hw[:, 1].min())


def _cache_key(files) -> str:
    """sha1 over each file's path, mtime and size."""
    lines = []
    for f in files:
        st = os.stat(f)
        lines.append(f"{f}\t{st.st_mtime_ns}\t{st.st_size}")
    return hashlib.sha1("\n".join(lines).encode()).hexdigest()[:16]


def _check_min(sizes, min_size, files):
    if min_size is not None and (sizes < min_size).any():
        bad = files[int(np.argmin(sizes.min(axis=1)))]
        raise ValueError(f"device bank: {bad} is smaller than the {min_size}px crop")


def build_bank(dir_or_files, min_size: Optional[int] = None) -> ImageBank:
    """Decode every image (through the decode cache if enabled) into one
    padded uint8 array. ``min_size`` checks that every image holds a full
    crop. ``DASR_BANK_HOST_CACHE=<dir>`` keeps the padded array on disk and
    memory-maps it on the next build of the same files (same paths, mtimes
    and sizes)."""
    files = _files(dir_or_files)
    if not files:
        raise ValueError(f"device bank: no images under {dir_or_files!r}")
    cache_dir = os.environ.get("DASR_BANK_HOST_CACHE")
    cdir = os.path.join(cache_dir, _cache_key(files)) if cache_dir else None
    if cdir and os.path.exists(os.path.join(cdir, "sizes.npy")):
        sizes = np.load(os.path.join(cdir, "sizes.npy"))
        _check_min(sizes, min_size, files)
        return ImageBank(np.load(os.path.join(cdir, "data.npy"), mmap_mode="r"), sizes)

    imgs = [read_img_u8(f) for f in files]
    sizes = np.array([im.shape[:2] for im in imgs], np.int32)
    _check_min(sizes, min_size, files)
    data = np.zeros((len(imgs), sizes[:, 0].max(), sizes[:, 1].max(), 3), np.uint8)
    for i, im in enumerate(imgs):
        data[i, : im.shape[0], : im.shape[1]] = im
    if cdir:
        os.makedirs(cdir, exist_ok=True)
        np.save(os.path.join(cdir, "data.npy"), data)
        np.save(os.path.join(cdir, "sizes.npy"), sizes)
    return ImageBank(data, sizes)


def build_ddm_bank(ddm_files: Sequence[str], lr_sizes) -> ImageBank:
    """Every DDM bilinear-resized to its fake LR's full size (the host path
    resizes the whole map, then crops: fake_w_dataset.py:66), padded into
    one (N, Hmax, Wmax, 1) f32 array. ``lr_sizes``: the fake-LR bank's
    (N, 2) true sizes."""
    lr_sizes = np.asarray(lr_sizes)
    if len(ddm_files) != lr_sizes.shape[0]:
        raise ValueError(f"device bank: {len(ddm_files)} DDMs vs {lr_sizes.shape[0]} fake LRs")
    maps = [resize_linear(load_ddm(f), int(w), int(h)) for f, (h, w) in zip(ddm_files, lr_sizes)]
    data = np.zeros((len(maps), max(m.shape[0] for m in maps),
                     max(m.shape[1] for m in maps), 1), np.float32)
    for i, m in enumerate(maps):
        data[i, : m.shape[0], : m.shape[1]] = m
    return ImageBank(data, lr_sizes.astype(np.int32))


_SLAB_BYTES = 256 << 20


def upload(bank: Optional[ImageBank], device):
    """The bank as tensors on ``device``, copied in slabs of ~256 MiB (a
    memory-mapped bank is never read whole into host memory)."""
    if bank is None:
        return None
    data = bank.data
    out = torch.empty(data.shape, dtype=torch.from_numpy(np.zeros(0, data.dtype)).dtype,
                      device=device)
    step = max(1, _SLAB_BYTES // max(1, data[0].nbytes))
    for i in range(0, data.shape[0], step):
        out[i:i + step].copy_(torch.from_numpy(np.array(data[i:i + step])))
    return ImageBank(out, torch.from_numpy(np.asarray(bank.sizes, np.int32)).to(device))


def nbytes(banks) -> int:
    """Device bytes of a sequence of banks (None entries skipped)."""
    return sum(b.data.numel() * b.data.element_size() for b in banks if b is not None)


def epoch_rows(seed: int, epoch: int, n: int, batch_size: int, shuffle: bool = True):
    """The index rows of one epoch over ``n`` banked images, ``drop_last``:
    the order ``np.random.default_rng((seed, epoch)).permutation(n)`` of the
    JAX CLIs, which is also the host ``Loader``'s order for the epoch."""
    perm = np.random.default_rng((seed, epoch)).permutation(n) if shuffle else np.arange(n)
    return [perm[s * batch_size:(s + 1) * batch_size] for s in range(n // batch_size)]


def window_generator(seed: int, start: int, device) -> torch.Generator:
    """The generator of the window that starts at iteration ``start`` of a
    run seeded ``seed``: a resumed run draws the same stream, window for
    window (the role of ``jax.random.fold_in(key(seed), start)``)."""
    s = int(np.random.SeedSequence([int(seed), int(start)]).generate_state(1)[0])
    return torch.Generator(device=torch.device(device)).manual_seed(s)


# -- draws --------------------------------------------------------------------


def draw_dsn(gen: torch.Generator, b: int, n_clean: int) -> DsnDraws:
    """``b`` items' draws for ``gather_dsn``, on ``gen``'s device."""
    u = torch.rand((b, 11), generator=gen, device=gen.device)
    pick = (u[:, 0] * n_clean).long().clamp_(max=n_clean - 1)
    return DsnDraws(pick, u[:, 1:3], u[:, 3:5], u[:, 5:8] < 0.5, u[:, 8:11] < 0.5)


def draw_dasr(gen: torch.Generator, b: int, n_real: int, n_hr: int) -> DasrDraws:
    """``b`` items' draws for ``gather_dasr``, on ``gen``'s device."""
    u = torch.rand((b, 11), generator=gen, device=gen.device)

    def pick(col, n):
        return (u[:, col] * n).long().clamp_(max=n - 1)

    return DasrDraws(u[:, 0:2], pick(2, n_real), u[:, 3:5], pick(5, n_hr), u[:, 6:8],
                     u[:, 8:11] < 0.5)


def draw_paired(gen: torch.Generator, b: int) -> PairedDraws:
    """``b`` items' draws for ``gather_paired``, on ``gen``'s device."""
    u = torch.rand((b, 5), generator=gen, device=gen.device)
    return PairedDraws(u[:, 0:2], u[:, 2:5] < 0.5)


def shard_draws(draws, rows: slice):
    """The draws of items ``rows`` of a batch's (a rank's share of the global
    row's draws); ``draws`` itself where ``rows`` is the whole batch (one
    rank), so a replayed step's inputs cost no views."""
    if rows == slice(0, draws[0].shape[0]):
        return draws
    return type(draws)(*(t[rows] for t in draws))


# -- offsets (shared by the gathers and their plain versions) ------------------


def _offsets(u, sizes, crop: int):
    """Uniform (top, left) over [0, size - crop] from uniforms ``u`` (B, 2),
    in f32 as JAX's ``crop_offsets``."""
    return torch.minimum((u * (sizes - crop + 1).float()).int(), sizes - crop)


def _aligned_offsets(u, lr_sizes, hr_sizes, lr: int, scale: int):
    """(top, left) of the fake-LR crop whose x``scale`` HR window fits in
    the paired HR (datasets._rand_crop_aligned), in f32 as JAX's."""
    span = torch.clamp(torch.minimum(lr_sizes - lr, (hr_sizes - lr * scale) // scale), min=0)
    return torch.minimum((u * (span + 1).float()).int(), span)


# -- the gather ------------------------------------------------------------------


def _grid(tl, crop: int, aug, use_flip: bool, use_rot: bool):
    """(B, crop, crop) row and column indices into the bank for crops at
    ``tl`` (B, 2), with the augment folded in, in the host augment's order
    (hflip, then vflip, then transpose): output (i, j) reads crop pixel
    (r, c) with (r, c) = (j, i) under the transpose, r mirrored under the
    vflip, c under the hflip."""
    b = tl.shape[0]
    ar = torch.arange(crop, device=tl.device)
    r = ar.view(1, crop, 1).expand(b, crop, crop)
    c = ar.view(1, 1, crop).expand(b, crop, crop)

    def bit(k):
        return aug[:, k].view(b, 1, 1)

    if use_rot:
        r, c = torch.where(bit(2), c, r), torch.where(bit(2), r, c)
        r = torch.where(bit(1), crop - 1 - r, r)
    if use_flip:
        c = torch.where(bit(0), crop - 1 - c, c)
    return tl[:, 0].view(b, 1, 1) + r, tl[:, 1].view(b, 1, 1) + c


def _read(bank_data, idx, tl, crop, aug, use_flip, use_rot):
    rows, cols = _grid(tl.long(), crop, aug, use_flip, use_rot)
    return bank_data[idx.long().view(-1, 1, 1), rows, cols]


def _as_f32(x):
    return x.float() / 255.0


def gather_dsn(clean: ImageBank, noisy: ImageBank, noisy_idx, d: DsnDraws, crop: int,
               scale: int, flips: bool = False, rotations: bool = False) -> Dict[str, torch.Tensor]:
    """The DSN batch (DSNTrainDataset, reference codes/DSN/data_loader.py:
    12-59) of ``noisy_idx`` (B,): ``input``, a crop of the picked clean
    image, and ``disc``, a crop of the noisy image at 1/``scale`` size, each
    with its own augment; uint8 NHWC. The trainer's cast and in-step bicubic
    complete it."""
    crop -= crop % scale
    small = crop // scale
    tl_c = _offsets(d.clean_u, clean.sizes[d.clean_pick], crop)
    tl_n = _offsets(d.noisy_u, noisy.sizes[noisy_idx.long()], small)
    return {"input": _read(clean.data, d.clean_pick, tl_c, crop, d.clean_aug, flips, rotations),
            "disc": _read(noisy.data, noisy_idx, tl_n, small, d.noisy_aug, flips, rotations)}


def gather_dasr(banks: SrnBanks, fake_idx, d: DasrDraws, hr_size: int, scale: int,
                use_flip: bool = True, use_rot: bool = True) -> Dict[str, torch.Tensor]:
    """The DASR batch (DASRUnpairedDataset's train branch) of ``fake_idx``
    (B,): LR_fake/HR aligned crops of pair i, the DDM crop on the LR_fake
    window (ones without a DDM bank: the Adaptive model's 'LRHR_unpair'
    window, as ``sample_dasr_batch`` with ``ddm_bank=None``), LR_real and
    HR_unpair crops of the picked images, one augment per item on all five.
    LR_fake, LR_real, HR, HR_unpair f32 in [0, 1] and fake_w f32, NHWC."""
    lr = hr_size // scale
    idx = fake_idx.long()
    tl = _aligned_offsets(d.fake_u, banks.fake.sizes[idx], banks.hr.sizes[idx], lr, scale)
    tl_r = _offsets(d.real_u, banks.real.sizes[d.real_pick], lr)
    tl_u = _offsets(d.unpair_u, banks.hr.sizes[d.hr_pick], hr_size)
    aug = (d.aug, use_flip, use_rot)
    out = {
        "LR_fake": _as_f32(_read(banks.fake.data, idx, tl, lr, *aug)),
        "LR_real": _as_f32(_read(banks.real.data, d.real_pick, tl_r, lr, *aug)),
        "HR": _as_f32(_read(banks.hr.data, idx, tl * scale, hr_size, *aug)),
        "HR_unpair": _as_f32(_read(banks.hr.data, d.hr_pick, tl_u, hr_size, *aug)),
    }
    if banks.ddm is not None:
        out["fake_w"] = _read(banks.ddm.data, idx, tl, lr, *aug)
    else:
        out["fake_w"] = torch.ones((idx.shape[0], lr, lr, 1), device=idx.device)
    return out


def gather_paired(banks: PairedBanks, idx, d: PairedDraws, hr_size: int, scale: int,
                  use_flip: bool = True, use_rot: bool = True) -> Dict[str, torch.Tensor]:
    """The 'LRHR' batch (``PairedDataset``'s train branch) of ``idx`` (B,):
    the LR crop whose x``scale`` window fits in its HR, and that window of
    the HR, one augment per item on both; ``LR`` and ``HR`` f32 in [0, 1],
    NHWC."""
    lr = hr_size // scale
    idx = idx.long()
    tl = _aligned_offsets(d.u, banks.lr.sizes[idx], banks.hr.sizes[idx], lr, scale)
    aug = (d.aug, use_flip, use_rot)
    return {"LR": _as_f32(_read(banks.lr.data, idx, tl, lr, *aug)),
            "HR": _as_f32(_read(banks.hr.data, idx, tl * scale, hr_size, *aug))}


# -- the plain versions (the JAX sampler's per-item loop) -------------------------


def _crop_plain(data, i: int, t: int, l: int, crop: int, aug, use_flip: bool, use_rot: bool):
    x = data[i, t:t + crop, l:l + crop]
    if use_flip and aug[0]:
        x = x.flip(1)
    if use_rot and aug[1]:
        x = x.flip(0)
    if use_rot and aug[2]:
        x = x.transpose(0, 1)
    return x


def gather_dsn_plain(clean: ImageBank, noisy: ImageBank, noisy_idx, d: DsnDraws, crop: int,
                     scale: int, flips: bool = False, rotations: bool = False):
    """``gather_dsn`` item by item with slices and flips."""
    crop -= crop % scale
    small = crop // scale
    tl_c = _offsets(d.clean_u, clean.sizes[d.clean_pick], crop).tolist()
    tl_n = _offsets(d.noisy_u, noisy.sizes[noisy_idx.long()], small).tolist()
    picks, idx = d.clean_pick.tolist(), noisy_idx.tolist()
    ca, na = d.clean_aug.tolist(), d.noisy_aug.tolist()
    return {
        "input": torch.stack([_crop_plain(clean.data, picks[b], *tl_c[b], crop, ca[b], flips,
                                          rotations) for b in range(len(idx))]),
        "disc": torch.stack([_crop_plain(noisy.data, idx[b], *tl_n[b], small, na[b], flips,
                                         rotations) for b in range(len(idx))]),
    }


def gather_dasr_plain(banks: SrnBanks, fake_idx, d: DasrDraws, hr_size: int, scale: int,
                      use_flip: bool = True, use_rot: bool = True):
    """``gather_dasr`` item by item with slices and flips."""
    lr = hr_size // scale
    idx = fake_idx.long()
    tl = _aligned_offsets(d.fake_u, banks.fake.sizes[idx], banks.hr.sizes[idx], lr,
                          scale).tolist()
    tl_r = _offsets(d.real_u, banks.real.sizes[d.real_pick], lr).tolist()
    tl_u = _offsets(d.unpair_u, banks.hr.sizes[d.hr_pick], hr_size).tolist()
    idx, rp, hp, aug = idx.tolist(), d.real_pick.tolist(), d.hr_pick.tolist(), d.aug.tolist()
    parts = {k: [] for k in ("LR_fake", "LR_real", "HR", "HR_unpair", "fake_w")}
    for b, i in enumerate(idx):
        a = (aug[b], use_flip, use_rot)
        (t, l) = tl[b]
        parts["LR_fake"].append(_crop_plain(banks.fake.data, i, t, l, lr, *a))
        parts["LR_real"].append(_crop_plain(banks.real.data, rp[b], *tl_r[b], lr, *a))
        parts["HR"].append(_crop_plain(banks.hr.data, i, t * scale, l * scale, hr_size, *a))
        parts["HR_unpair"].append(_crop_plain(banks.hr.data, hp[b], *tl_u[b], hr_size, *a))
        parts["fake_w"].append(
            _crop_plain(banks.ddm.data, i, t, l, lr, *a) if banks.ddm is not None
            else torch.ones((lr, lr, 1), device=fake_idx.device))
    out = {k: torch.stack(v) for k, v in parts.items()}
    for k in ("LR_fake", "LR_real", "HR", "HR_unpair"):
        out[k] = _as_f32(out[k])
    return out
