"""Single-level Haar DWT on NCHW tensors.

Counterpart of ``dasr_tpu.ops.dwt`` (the reference calls
``pytorch_wavelets.DWTForward(J=1, wave='haar', mode='reflect')``,
codes/SRN/models/DASR_model.py:56). Each 2x2 block ``[[a, b], [c, d]]``
(rows = H) maps to

    LL = (a + b + c + d) / 2      (pywt cA)
    LH = (a + b - c - d) / 2      (pywt cH: highpass along H)
    HL = (a - b + c - d) / 2      (pywt cV: highpass along W)
    HH = (a - b - c + d) / 2      (pywt cD)

Odd sizes are reflect-padded by one at the bottom/right first.
``dwt_init`` is the reference's other Haar (codes/SRN/utils/util.py:211-224),
whose LH/HL carry opposite signs. Plain tensor code, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _pad_to_even(x: torch.Tensor) -> torch.Tensor:
    ph, pw = x.shape[-2] % 2, x.shape[-1] % 2
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="reflect")
    return x


def _blocks(x: torch.Tensor):
    """The four stride-2 phases a, b, c, d of the 2x2 blocks of NCHW x."""
    x = _pad_to_even(x)
    return x[..., 0::2, 0::2], x[..., 0::2, 1::2], x[..., 1::2, 0::2], x[..., 1::2, 1::2]


def haar_dwt(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(LL, LH, HL, HH) of NCHW images, pywt/pytorch_wavelets convention."""
    a, b, c, d = _blocks(x)
    return (a + b + c + d) * 0.5, (a + b - c - d) * 0.5, (a - b + c - d) * 0.5, (a - b - c + d) * 0.5


def haar_bands(x: torch.Tensor, norm: bool = True, cs: str = "cat"):
    """(LL, high bands) in the reference's discriminator input format
    (DSN/model.py:108-118, SRN DASR_model.py:442-452): with ``norm`` the
    high bands map to ``*0.5 + 0.5`` and LL to ``*0.5``; ``cs='cat'``
    concatenates (LH, HL, HH) along channels, ``cs='sum'`` averages them."""
    ll, lh, hl, hh = haar_dwt(x)
    if norm:
        ll = ll * 0.5
        lh, hl, hh = lh * 0.5 + 0.5, hl * 0.5 + 0.5, hh * 0.5 + 0.5
    if cs == "cat":
        high = torch.cat([lh, hl, hh], dim=1)
    elif cs == "sum":
        high = (lh + hl + hh) / 3.0
    else:
        raise NotImplementedError(f"Wavelet format [{cs}] not recognized")
    return ll, high


def dwt_init(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """SRN utils Haar variant: (LL, cat(HL, LH, HH)) with its signs
    (codes/SRN/utils/util.py:211-224)."""
    a, b, c, d = _blocks(x)
    ll = (a + b + c + d) * 0.5
    hl = (-a - c + b + d) * 0.5
    lh = (-a + c - b + d) * 0.5
    hh = (a - c - b + d) * 0.5
    return ll, torch.cat([hl, lh, hh], dim=1)
