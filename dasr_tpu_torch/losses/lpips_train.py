"""LPIPS 2AFC training (reference: codes/PerceptualSimilarity/models/
networks_basic.py:114-141 + dist_model.py:88-130).

Counterpart of ``dasr_tpu.losses.lpips_train``. ``Dist2LogitLayer`` maps
two distances to a preference probability; ``bce_ranking_loss`` trains the
metric on two-alternative-forced-choice human judgements. In
``TwoAFCTrainer`` only the heads ``lin{k}`` and the ranking net train, under
one Adam; the backbone stays frozen, so its taps are taken without an
autograd graph, and after each update the heads are clamped nonnegative
(DistModel's ``clamp_weights``, dist_model.py:125-130).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from dasr_tpu_torch.losses.lpips import LPIPS
from dasr_tpu_torch.nn.layers import Conv2d, init_lecun_


class Dist2LogitLayer(nn.Module):
    """Three 1x1 convs over [d0, d1, d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps)]
    with LeakyReLU 0.2 between them, then a sigmoid."""

    def __init__(self, chn_mid: int = 32, use_sigmoid: bool = True):
        super().__init__()
        self.use_sigmoid = use_sigmoid
        self.conv0 = Conv2d(5, chn_mid, 1)
        self.conv1 = Conv2d(chn_mid, chn_mid, 1)
        self.conv2 = Conv2d(chn_mid, 1, 1)

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """flax's init law: lecun-normal kernels, zero biases."""
        return init_lecun_(self, generator)

    def forward(self, d0, d1, eps: float = 0.1):
        x = torch.cat([d0, d1, d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps)], 1)
        x = F.leaky_relu(self.conv0(x), 0.2)
        x = F.leaky_relu(self.conv1(x), 0.2)
        x = self.conv2(x)
        return torch.sigmoid(x) if self.use_sigmoid else x


def bce_ranking_loss(logit, judge):
    """BCE on the preference probability; judge in [-1, 1] -> p in [0, 1]."""
    per = (judge + 1.0) / 2.0
    logit = logit.clamp(1e-7, 1 - 1e-7)
    return torch.mean(-(per * torch.log(logit) + (1 - per) * torch.log(1 - logit)))


class TwoAFCTrainer:
    """Trains ``lpips``'s heads and ``rank`` on 2AFC triplets, Adam with
    betas (``beta1``, 0.999). ``lr`` is a float, or a callable of the 0-based
    update count, as optax's schedule (a ``LambdaLR`` stepped after each
    update gives the same sequence)."""

    def __init__(self, lpips: LPIPS, rank: Dist2LogitLayer,
                 lr: Union[float, Callable[[int], float]] = 1e-4, beta1: float = 0.5):
        if not lpips.use_lins:
            raise ValueError("2AFC training trains the heads of a 'net-lin' LPIPS")
        self.lpips, self.rank = lpips, rank
        lpips.backbone.requires_grad_(False)
        self.lins = [p.requires_grad_(True) for p in lpips.parameters(recurse=False)]
        self.opt = torch.optim.Adam(self.lins + list(rank.parameters()),
                                    lr=1.0 if callable(lr) else lr, betas=(beta1, 0.999),
                                    eps=1e-8)
        self.sched = (torch.optim.lr_scheduler.LambdaLR(self.opt, lr) if callable(lr)
                      else None)

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update. ``batch``: ref, p0, p1 NCHW in [-1, 1] and judge
        (B, 1, 1, 1) in [0, 1], on the trainer's device. Returns loss and
        acc = mean((d1 < d0) == (judge > 0.5)) of the distances before the
        update, as device tensors."""
        ref, p0, p1, judge = batch["ref"], batch["p0"], batch["p1"], batch["judge"]
        b = ref.shape[0]
        with torch.no_grad():
            taps = self.lpips.taps(torch.cat([ref, p0, p1]))
        t_ref, t0, t1 = ([t[i * b:(i + 1) * b] for t in taps] for i in range(3))
        hw = ref.shape[-2:]
        d0 = self.lpips.distance(t_ref, t0, hw)
        d1 = self.lpips.distance(t_ref, t1, hw)
        loss = bce_ranking_loss(self.rank(d0, d1), judge * 2.0 - 1.0)
        acc = ((d1 < d0) == (judge > 0.5)).float().mean()
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        if self.sched is not None:
            self.sched.step()
        with torch.no_grad():
            for w in self.lins:
                w.clamp_(min=0.0)
        return {"loss": loss.detach(), "acc": acc}
