"""G-only pixel-loss trainer: 'De_Resnet' (HR -> LR) and 'sr' (LR -> HR).

Counterpart of ``dasr_tpu.train.degradation_trainer`` (reference:
codes/SRN/models/Degradation_Resnet.py:15-151) and of the step of
``dasr_tpu``'s ``SRModel`` (reference: codes/SRN/models/SR_model.py): the
generator maps ``batch[source]`` towards ``batch[target]`` under
``pixel_weight`` x the l1 or l2 loss, with one Adam and a MultiStepLR.
Both references weight the loss; ``dasr_tpu``'s ``SRModel`` leaves
``pixel_weight`` out, the port applies it to 'sr' too (ROADMAP C.2).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from dasr_tpu_torch.train.srgan_trainer import pixel_loss
from dasr_tpu_torch.train.state import GANTrainState, make_net_state


@dataclasses.dataclass(frozen=True)
class PixelConfig:
    lr_g: float = 1e-4
    beta1_g: float = 0.9
    lr_steps: Sequence[int] = (100000, 200000)
    lr_gamma: float = 0.5
    pixel_criterion: str = "l1"
    pixel_weight: float = 1.0
    seed: int = 0


class PixelTrainer:
    """Holds G and its optimizer (``self.state``, a ``GANTrainState`` with G
    alone) and runs the step from ``source`` to ``target``."""

    def __init__(self, cfg: PixelConfig, g_model: torch.nn.Module,
                 device: torch.device = torch.device("cpu"), source: str = "HR",
                 target: str = "LR"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.g_model, self.source, self.target = g_model, source, target
        self.state: Optional[GANTrainState] = None

    def init_state(self, seed: Optional[int] = None) -> GANTrainState:
        c = self.cfg
        self.g_model.init_weights(torch.Generator().manual_seed(c.seed if seed is None else seed))
        self.g_model.to(self.device, memory_format=torch.channels_last).train()
        self.state = GANTrainState(
            step=0, g=make_net_state(self.g_model, c.lr_g, c.beta1_g, c.lr_steps, c.lr_gamma))
        return self.state

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One step on NCHW device tensors; ``{"loss/l_pix": loss}`` as a 0-d
        f32 tensor."""
        c, st = self.cfg, self.state
        loss = c.pixel_weight * pixel_loss(st.g.net(batch[self.source]), batch[self.target],
                                           c.pixel_criterion)
        st.g.step(torch.autograd.grad(loss, st.g.params()))
        st.step += 1
        return {"loss/l_pix": loss.detach().float()}
