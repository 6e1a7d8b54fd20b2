"""Learning-rate schedules of the port's trainers, as ``LambdaLR``s.

Counterpart of ``dasr_tpu.train.schedules``. optax evaluates a schedule at
its per-optimizer update count (the updates made before this one); here
``scheduler.step()`` follows each ``optimizer.step()``, so the lambda's
argument is that count, and a network that skips an update (``disc_freq`` /
``gen_freq``) does not advance its schedule.

* ``multistep`` — the SRN trainers' MultiStepLR (codes/SRN/models/
  DASR_model.py:146-149): the LR is multiplied by ``gamma`` at each
  milestone; the update whose count is at or past a milestone is scaled, as
  optax's ``piecewise_constant_schedule`` does.
* ``dsn_linear_decay`` — the DSN's constant LR, then a linear decay to 0
  over the last ``num_decay_epochs`` (codes/DSN/train.py:152-157, LambdaLR
  with factor 1 - max(0, e - (E - D)) / D), a staircase over the update
  count with ``steps_per_epoch`` updates an epoch.
"""

from __future__ import annotations

from typing import Sequence

import torch


def multistep(optimizer: torch.optim.Optimizer, milestones: Sequence[int],
              gamma: float = 0.5) -> torch.optim.lr_scheduler.LambdaLR:
    ms = sorted(int(m) for m in milestones)
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda count: gamma ** sum(count >= m for m in ms))


def dsn_linear_decay(optimizer: torch.optim.Optimizer, num_epochs: int, num_decay_epochs: int,
                     steps_per_epoch: int) -> torch.optim.lr_scheduler.LambdaLR:
    decay_start = (num_epochs - num_decay_epochs) * steps_per_epoch
    total_decay = num_decay_epochs * steps_per_epoch

    def factor(count):
        epoch_like = (count // steps_per_epoch) * steps_per_epoch
        return max(0.0, 1.0 - max(0, epoch_like - decay_start) / total_decay)

    return torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
