"""The reference's copy of how a banked step gets its batch: the window's
generator, the draws, and the crops by plain slicing, item by item.

The draws come from a ``torch.Generator`` on the banks' device seeded from
(the run's seed, the window's first iteration), which the window's steps
draw from in turn; on the same device the same calls give the same
numbers, so the reference draws the batch the program drew without
reading it from the program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def epoch_rows(seed: int, epoch: int, n: int, batch: int) -> List[np.ndarray]:
    """The index rows of one shuffled epoch over ``n`` images, the last
    partial row dropped (the train CLIs' order)."""
    perm = np.random.default_rng((seed, epoch)).permutation(n)
    return [perm[s * batch:(s + 1) * batch] for s in range(n // batch)]


def window_generator(seed: int, start: int, device) -> torch.Generator:
    s = int(np.random.SeedSequence([int(seed), int(start)]).generate_state(1)[0])
    return torch.Generator(device=torch.device(device)).manual_seed(s)


def call_generators(seed: int, calls, device):
    """The generator of each step in turn: one a call, seeded from (the
    run's seed, the call's first iteration), that the call's steps draw
    from one after another. ``calls``: (first iteration, steps) a call."""
    for start, k in calls:
        gen = window_generator(seed, start, device)
        for _ in range(k):
            yield gen


def _pick(u, n):
    return (u * n).long().clamp_(max=n - 1)


def _offsets(u, sizes, crop: int):
    return torch.minimum((u * (sizes - crop + 1).float()).int(), sizes - crop)


def _crop(data, i: int, t: int, l: int, crop: int, aug, flip: bool, rot: bool):
    x = data[i, t:t + crop, l:l + crop]
    if flip and aug[0]:
        x = x.flip(1)
    if rot and aug[1]:
        x = x.flip(0)
    if rot and aug[2]:
        x = x.transpose(0, 1)
    return x


def dasr_batch(banks: Dict[str, tuple], row: torch.Tensor, gen: torch.Generator, hr: int,
               scale: int, flip: bool, rot: bool) -> Dict[str, torch.Tensor]:
    """The DASR batch of the fake-LR indices ``row``: LR_fake / HR aligned
    crops, the DDM on the LR_fake window, LR_real and HR_unpair crops of
    drawn images, one dihedral augment per item on all five. ``banks``:
    name -> (data NHWC, sizes (N, 2) int32). NCHW f32."""
    b = row.shape[0]
    u = torch.rand((b, 11), generator=gen, device=gen.device)
    fake, hrb, real, ddm = banks["fake"], banks["hr"], banks["real"], banks["ddm"]
    lr = hr // scale
    idx = row.long()
    real_pick, hr_pick, aug = _pick(u[:, 2], real[0].shape[0]), _pick(u[:, 5], hrb[0].shape[0]), \
        (u[:, 8:11] < 0.5)
    fs, hs = fake[1][idx], hrb[1][idx]
    span = torch.clamp(torch.minimum(fs - lr, (hs - lr * scale) // scale), min=0)
    tl = torch.minimum((u[:, 0:2] * (span + 1).float()).int(), span).tolist()
    tl_r = _offsets(u[:, 3:5], real[1][real_pick], lr).tolist()
    tl_u = _offsets(u[:, 6:8], hrb[1][hr_pick], hr).tolist()
    idx, rp, hp, aug = idx.tolist(), real_pick.tolist(), hr_pick.tolist(), aug.tolist()
    parts = {k: [] for k in ("LR_fake", "LR_real", "HR", "HR_unpair", "fake_w")}
    for j, i in enumerate(idx):
        a = (aug[j], flip, rot)
        t, l = tl[j]
        parts["LR_fake"].append(_crop(fake[0], i, t, l, lr, *a))
        parts["LR_real"].append(_crop(real[0], rp[j], *tl_r[j], lr, *a))
        parts["HR"].append(_crop(hrb[0], i, t * scale, l * scale, hr, *a))
        parts["HR_unpair"].append(_crop(hrb[0], hp[j], *tl_u[j], hr, *a))
        parts["fake_w"].append(_crop(ddm[0], i, t, l, lr, *a))
    out = {}
    for k, v in parts.items():
        x = torch.stack(v).permute(0, 3, 1, 2)
        out[k] = x.float() if k == "fake_w" else x.float() / 255.0
    return out


def dsn_batch(clean: tuple, noisy: tuple, row: torch.Tensor, gen: torch.Generator, crop: int,
              scale: int, flips: bool, rotations: bool) -> Dict[str, torch.Tensor]:
    """The DSN batch of the noisy indices ``row``: ``input``, a crop of a
    drawn clean image, ``disc``, a crop of the noisy image at 1 / ``scale``,
    each with its own augment. NCHW f32 in [0, 1]."""
    b = row.shape[0]
    u = torch.rand((b, 11), generator=gen, device=gen.device)
    crop -= crop % scale
    small = crop // scale
    pick = _pick(u[:, 0], clean[0].shape[0])
    tl_c = _offsets(u[:, 1:3], clean[1][pick], crop).tolist()
    tl_n = _offsets(u[:, 3:5], noisy[1][row.long()], small).tolist()
    ca, na = (u[:, 5:8] < 0.5).tolist(), (u[:, 8:11] < 0.5).tolist()
    pick, idx = pick.tolist(), row.tolist()
    inp = [_crop(clean[0], pick[j], *tl_c[j], crop, ca[j], flips, rotations) for j in range(b)]
    disc = [_crop(noisy[0], idx[j], *tl_n[j], small, na[j], flips, rotations) for j in range(b)]
    return {"input": torch.stack(inp).permute(0, 3, 1, 2).float() / 255.0,
            "disc": torch.stack(disc).permute(0, 3, 1, 2).float() / 255.0}
