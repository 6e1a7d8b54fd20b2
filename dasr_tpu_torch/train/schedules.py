"""Learning-rate schedules of the SRN trainers.

Counterpart of ``dasr_tpu.train.schedules.multistep`` (the reference's
MultiStepLR, codes/SRN/models/DASR_model.py:146-149): the LR is multiplied
by ``gamma`` at each milestone. As optax's ``piecewise_constant_schedule``
does, the update whose count (updates made before it) is at or past a
milestone is scaled. ``scheduler.step()`` follows each ``optimizer.step()``,
so the lambda's argument is that count. The DSN decay waits for the DSN
stage (ROADMAP A.7).
"""

from __future__ import annotations

from typing import Sequence

import torch


def multistep(optimizer: torch.optim.Optimizer, milestones: Sequence[int],
              gamma: float = 0.5) -> torch.optim.lr_scheduler.LambdaLR:
    ms = sorted(int(m) for m in milestones)
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda count: gamma ** sum(count >= m for m in ms))
