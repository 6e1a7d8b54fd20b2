"""DASR Adaptive trainer: the domain-distance map computed online.

Counterpart of ``dasr_tpu.train.dasr_adaptive_trainer`` (reference:
codes/SRN/models/DASR_Adaptive_model.py:23-515). What differs from the
DASR step (``train/srn_trainer.py``, whose ``_gan_step`` it shares):

* the DDM is computed every step by an FSD patch discriminator over the
  concatenated LR batch (``adaptive_weights = net_patchD(var_L)``, :208)
  instead of precomputed ``.npy`` maps; its source half, bilinearly resized
  to HR, is the pixel-loss weight map (:212-216), with the reference's
  double ``pixel_weight`` (``use_domain_distance_map``; off: the plain
  pixel loss);
* the whole map conditions the generator's adaptive blocks
  (``netG(var_L, adaptive_weights)``, :227; ``RRDBNetResidualConv``);
* with ``use_patchD_opt`` the patch D takes an Adam step on
  ``dsn_discriminator_loss`` of its own scores (real half, fake half)
  before the G step (:217-222); everything downstream uses the scores of
  the parameters from before that step;
* the patch D runs in eval mode (BatchNorm on its running statistics) and
  its Adam keeps a constant LR, as JAX's ``optax.adam(lr_patchd)``.

``train_banked_step`` is the DASR trainer's: the device-bank window draws
and gathers its batches by the same law, with no DDM bank (the gather's
all-ones ``fake_w`` is unused here), and ``train/step_graph.py`` replays it
from a CUDA graph of ``device_step`` (the patch D's forward, with
``use_patchD_opt`` its gradient and Adam step, the resize, then the DASR
step's device part) or loops it, as it does the DASR step. The captured
tensors include the patch D's and its Adam's (``graph_tensors``);
``host_step`` adds the patch D's LR schedule where it steps. With tracing
on, the online DDM is the device phase ``ddm``, from the patch D's forward
through the resize, between the banked step's ``batch`` and ``g_forward``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import torch

from dasr_tpu_torch.losses.gan import dsn_discriminator_loss
from dasr_tpu_torch.losses.lpips import LPIPS
from dasr_tpu_torch.nn.discriminators import FSDiscriminator
from dasr_tpu_torch.nn.generators import RRDBNetResidualConv
from dasr_tpu_torch.nn.layers import init_lecun_
from dasr_tpu_torch.ops.resize import bilinear_resize
from dasr_tpu_torch.train.srn_trainer import SRNConfig, SRNTrainer
from dasr_tpu_torch.train.state import GANTrainState, NetState, make_net_state
from dasr_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig(SRNConfig):
    use_domain_distance_map: bool = True
    use_patchD_opt: bool = False
    lr_patchd: float = 1e-4


@dataclasses.dataclass
class AdaptiveState:
    """The DASR train state (``base``) and the patch D's ``NetState``; the
    base's fields read through, so code written for a ``GANTrainState``
    (the registry, ``checkpoints``) takes this one too."""

    base: GANTrainState
    patchd: NetState

    @property
    def step(self) -> int:
        return self.base.step

    @step.setter
    def step(self, value: int) -> None:
        self.base.step = value

    @property
    def g(self) -> NetState:
        return self.base.g

    @property
    def d_target(self) -> Optional[NetState]:
        return self.base.d_target

    @property
    def d_source(self) -> Optional[NetState]:
        return self.base.d_source


class DASRAdaptiveTrainer(SRNTrainer):
    """``SRNTrainer`` with the online DDM, training the modules it is given
    (the registry builds them: ``define_G``, ``define_patchD``)."""

    graph_name = "adaptive"

    def __init__(self, cfg: AdaptiveConfig, g_model: RRDBNetResidualConv,
                 patchd: FSDiscriminator, device: torch.device = torch.device("cpu"),
                 lpips: Optional[LPIPS] = None):
        super().__init__(cfg, device, g_model=g_model, lpips=lpips)
        self.patchd = patchd
        self.state: Optional[AdaptiveState] = None

    def init_state(self, seed: Optional[int] = None) -> AdaptiveState:
        """The DASR networks' seeded init, then the patch D's (flax's
        lecun-normal law, from the same stream); a pretrained patch D is
        loaded after this call."""
        c = self.cfg
        base = super().init_state(seed)
        gen = torch.Generator().manual_seed((c.seed if seed is None else seed) + 1)
        init_lecun_(self.patchd, gen)
        self.patchd.to(self.device, memory_format=torch.channels_last).eval()
        patchd = make_net_state(self.patchd, c.lr_patchd, c.beta1_d, (), 1.0)
        self.state = AdaptiveState(base=base, patchd=patchd)
        return self.state

    def device_step(self, batch: Dict[str, torch.Tensor], do_g: bool,
                    do_d: bool) -> Dict[str, torch.Tensor]:
        """``train_step`` without its host part, what a CUDA graph captures:
        the online DDM on a batch of NCHW device tensors (keys LR_fake,
        LR_real, HR, HR_unpair; a ``fake_w`` is ignored), then the DASR
        step's device part. The patch D steps whenever ``use_patchD_opt`` is
        on, as in JAX, whatever ``do_g``/``do_d`` say."""
        c, st = self.cfg, self.state
        trace.phase("ddm")
        var_l = torch.cat([batch["LR_fake"], batch["LR_real"]])
        var_h = torch.cat([batch["HR"], batch["HR_unpair"]])
        b = batch["LR_fake"].shape[0]
        metrics = {}
        if c.use_patchD_opt:
            scores = st.patchd.net(var_l)
            loss = dsn_discriminator_loss(scores[b:], scores[:b])
            st.patchd.update(torch.autograd.grad(loss, st.patchd.params()))
            metrics["loss/patch_D_gan_loss"] = loss
            ada_w = scores.detach()
        else:
            with torch.no_grad():
                ada_w = st.patchd.net(var_l)
        ddm = bilinear_resize(ada_w[:b], var_h.shape[-2], var_h.shape[-1])
        return self._gan_step(st.base, var_l, var_h, b, (ada_w,),
                              ddm if c.use_domain_distance_map else None, metrics, do_g, do_d)

    def host_step(self, do_g: bool, do_d: bool) -> None:
        """The DASR step's host part, and the patch D's LR schedule where it
        steps."""
        if self.cfg.use_patchD_opt:
            self.state.patchd.advance()
        super().host_step(do_g, do_d)

    def graph_tensors(self) -> Iterator[torch.Tensor]:
        """The DASR trainer's tensors and the patch D's: its parameters,
        buffers, Adam state and LR tensor."""
        yield from super().graph_tensors()
        yield from self.state.patchd.tensors()

    @torch.no_grad()
    def sr(self, lr_img: torch.Tensor) -> torch.Tensor:
        return self.g_model(lr_img, self.patchd(lr_img))
