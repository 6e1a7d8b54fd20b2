"""Mask-based batch split/merge (reference: codes/SRN/utils/util.py:150-176).

Counterpart of ``dasr_tpu.utils.batch_ops``. The trainers do not use
these (their masks are static halves); they exist for API parity and for
variable masks. ``b_split`` returns (fake, real), mask == 0 selecting fake,
as the reference does; ``b_split`` and ``b_merge`` are host numpy (copied),
``b_select`` is the elementwise merge on tensors of any device.
"""

from __future__ import annotations

import numpy as np
import torch


def b_split(batch: np.ndarray, mask) -> tuple:
    mask = np.asarray(mask).astype(int)
    fake = batch[mask == 0]
    real = batch[mask == 1]
    return fake, real


def b_merge(real: np.ndarray, fake: np.ndarray, mask) -> np.ndarray:
    mask = np.asarray(mask).astype(int)
    out = np.empty((len(mask),) + tuple(fake.shape[1:]), dtype=fake.dtype)
    out[mask == 0] = fake
    out[mask == 1] = real
    return out


def b_select(real: torch.Tensor, fake: torch.Tensor, mask) -> torch.Tensor:
    """Elementwise merge at a static shape: mask == 1 takes real, 0 fake."""
    m = torch.as_tensor(mask, device=real.device).reshape((-1,) + (1,) * (real.dim() - 1))
    m = m.to(real.dtype)
    return m * real + (1 - m) * fake
