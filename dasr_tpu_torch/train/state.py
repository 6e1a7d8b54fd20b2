"""Train state of the port's GAN trainers.

Counterpart of ``dasr_tpu.train.state``: where JAX keeps one immutable
pytree that a jitted step maps to the next, the port keeps the modules, a
``torch.optim.Adam`` and a scheduler per network, updated in place, as the
reference does (codes/SRN/models/DASR_model.py:120-151). In a world of
several ranks (``core/dist.py``) ``NetState.step`` first averages the
gradients over the ranks, as XLA's all-reduce does under JAX's mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn as nn

from dasr_tpu_torch.core import dist
from dasr_tpu_torch.train.schedules import multistep


@dataclasses.dataclass
class NetState:
    """One network with its optimizer and LR scheduler."""

    net: nn.Module
    opt: torch.optim.Optimizer
    sched: torch.optim.lr_scheduler.LRScheduler

    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """Apply ``grads`` (one per trainable parameter, in order), averaged
        over the current world's ranks."""
        for p, g in zip(self.params(), dist.average_grads(grads)):
            p.grad = g
        self.opt.step()
        self.sched.step()
        self.opt.zero_grad(set_to_none=True)

    def params(self):
        return [p for p in self.net.parameters() if p.requires_grad]


def make_net_state(net: nn.Module, lr: float, beta1: float, milestones: Sequence[int],
                   gamma: float) -> NetState:
    """Adam (b2 0.999, eps 1e-8, optax's defaults) with a multistep LR."""
    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(beta1, 0.999), eps=1e-8)
    return NetState(net, opt, multistep(opt, milestones, gamma))


@dataclasses.dataclass
class GANTrainState:
    """Generator, up to two discriminators, and the step counter."""

    step: int
    g: NetState
    d_target: Optional[NetState] = None
    d_source: Optional[NetState] = None
