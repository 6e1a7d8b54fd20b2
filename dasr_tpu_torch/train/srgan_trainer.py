"""SRGAN / SRRaGAN trainer (the ESRGAN recipe).

Counterpart of ``dasr_tpu.train.srgan_trainer`` (reference:
codes/SRN/models/SRGAN_model.py:16-242, SRRaGAN_model.py:113-187):

* G's loss: the pixel loss (l1/l2) + the VGG19-54 feature loss (l1/l2) +
  the adversarial term, vanilla / lsgan / wgan-gp against "real", or the
  relativistic-average pair for SRRaGAN; each weighted;
* D's loss: real then fake (the fake detached), BCE(real, 1) + BCE(fake, 0)
  (SRGAN, not halved) or the relativistic pair halved (SRRaGAN), plus
  ``GP_WEIGHT`` x the WGAN-GP penalty for 'wgan-gp' (``dasr_tpu``'s
  default; neither it nor the port reads the reference's ``gp_weigth``);
* G's and D's gradients are both taken at the parameters from before the
  step (``torch.autograd.grad`` per network), then the optimizers step;
* D's BatchNorm / spectral-norm running state moves in D's own forwards
  only, real then fake, as the JAX step chains it; D's forwards inside G's
  loss and in the penalty leave it (JAX discards those updates), where a
  torch D in training mode would move it a third time;
* an Adam and a MultiStepLR per network.

G and D are given (``define_G`` / ``define_D``); the VGG feature net is a
seeded random init unless one is given (no VGG19 weights ship with the
repository). The WGAN-GP interpolation ``alpha`` can be injected, as
``losses/gan.py:gradient_penalty`` takes it; by default it is drawn from a
generator seeded by (``cfg.seed``, step).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from dasr_tpu_torch.core import dist
from dasr_tpu_torch.losses.gan import gan_loss, gradient_penalty, ragan_pair_loss
from dasr_tpu_torch.nn.layers import init_lecun_, stats_updates
from dasr_tpu_torch.nn.vgg import VGG19Feature54
from dasr_tpu_torch.train.state import GANTrainState, make_net_state


GP_WEIGHT = 10.0


@dataclasses.dataclass(frozen=True)
class SRGANConfig:
    lr_g: float = 1e-4
    lr_d: float = 1e-4
    beta1_g: float = 0.9
    beta1_d: float = 0.9
    lr_steps: Sequence[int] = (50000, 100000, 200000, 300000)
    lr_gamma: float = 0.5
    pixel_criterion: str = "l1"
    pixel_weight: float = 1e-2
    feature_criterion: str = "l1"
    feature_weight: float = 1.0
    gan_type: str = "vanilla"
    gan_weight: float = 5e-3
    ragan: bool = False  # SRRaGAN (SRRaGAN_model.py:113-187)
    d_update_ratio: int = 1
    d_init_iters: int = 0
    seed: int = 0
    dtype: torch.dtype = torch.float32


def pixel_loss(a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    """Mean absolute ('l1') or squared ('l2') difference, in f32."""
    d = a.float() - b.float()
    return d.abs().mean() if kind == "l1" else (d * d).mean()


class SRGANTrainer:
    """Holds G, D, the VGG feature net and their optimizers (``self.state``)
    and runs the step."""

    def __init__(self, cfg: SRGANConfig, g_model: torch.nn.Module, d_model: torch.nn.Module,
                 device: torch.device = torch.device("cpu"),
                 vgg: Optional[VGG19Feature54] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.g_model, self.d_model, self.vgg = g_model, d_model, vgg
        self.state: Optional[GANTrainState] = None

    def init_state(self, seed: Optional[int] = None) -> GANTrainState:
        """Seeded weights in the JAX init's law (``cfg.seed`` unless ``seed``
        is given) on the device, an Adam and a scheduler per network."""
        c = self.cfg
        gen = torch.Generator().manual_seed(c.seed if seed is None else seed)
        self.g_model.init_weights(gen)
        init_lecun_(self.d_model, gen)
        if c.feature_weight > 0 and self.vgg is None:
            self.vgg = init_lecun_(VGG19Feature54(), gen).requires_grad_(False)
        if self.vgg is not None:
            self.vgg.to(self.device, memory_format=torch.channels_last).eval()
        self.g_model.to(self.device, memory_format=torch.channels_last).train()
        self.d_model.to(self.device, memory_format=torch.channels_last).train()
        self.state = GANTrainState(
            step=0,
            g=make_net_state(self.g_model, c.lr_g, c.beta1_g, c.lr_steps, c.lr_gamma),
            d_target=make_net_state(self.d_model, c.lr_d, c.beta1_d, c.lr_steps, c.lr_gamma),
        )
        return self.state

    def _d(self, x: torch.Tensor, update: bool) -> torch.Tensor:
        with stats_updates(self.d_model, update):
            return self.d_model(x.to(self.cfg.dtype).contiguous(memory_format=torch.channels_last))

    def g_update_due(self, iteration: int) -> bool:
        """The reference's G gate (SRGAN_model.py ``optimize_parameters``):
        ``iteration`` 1-based, as the reference's ``current_step``."""
        c = self.cfg
        return iteration % c.d_update_ratio == 0 and iteration > c.d_init_iters

    def train_step(self, batch: Dict[str, torch.Tensor], do_g: bool = True, do_d: bool = True,
                   alpha: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One step on NCHW device tensors (``LR``, ``HR``, optional ``ref``:
        D's real images, ``HR`` by default). ``alpha``: the WGAN-GP
        interpolation, (B, 1, 1, 1). Returns the metrics as 0-d f32
        tensors; with ``do_g`` / ``do_d`` false that side is not updated (nor,
        for D, its running state)."""
        c, st = self.cfg, self.state
        var_l, var_h = batch["LR"], batch["HR"]
        var_ref = batch.get("ref", var_h)
        metrics: Dict[str, torch.Tensor] = {}

        fake_h = st.g.net(var_l)
        total = torch.zeros((), device=self.device)
        if c.pixel_weight > 0:
            l_pix = c.pixel_weight * pixel_loss(fake_h, var_h, c.pixel_criterion)
            total = total + l_pix
            metrics["loss/l_g_pix"] = l_pix
        if c.feature_weight > 0:
            with torch.no_grad():
                f_real = self.vgg(var_h.to(c.dtype))
            l_fea = c.feature_weight * pixel_loss(self.vgg(fake_h.to(c.dtype)), f_real,
                                                  c.feature_criterion)
            total = total + l_fea
            metrics["loss/l_g_fea"] = l_fea
        pred_fake = self._d(fake_h, update=False)
        if c.ragan:
            with torch.no_grad():
                pred_real = self._d(var_ref, update=False)
            l_gan = c.gan_weight * ragan_pair_loss(pred_fake, pred_real, c.gan_type)
        else:
            l_gan = c.gan_weight * gan_loss(pred_fake, True, c.gan_type)
        total = total + l_gan
        metrics["loss/l_g_gan"] = l_gan
        g_grads = torch.autograd.grad(total, st.g.params())

        fake_det = fake_h.detach()
        pr = self._d(var_ref, update=do_d)
        pf = self._d(fake_det, update=do_d)
        if c.ragan:
            d_loss = ragan_pair_loss(pr, pf, c.gan_type)
        else:
            d_loss = gan_loss(pr, True, c.gan_type) + gan_loss(pf, False, c.gan_type)
        if c.gan_type == "wgan-gp":
            if alpha is None:
                # the global batch's draws, then this rank's rows of them
                world = dist.current()
                gen = torch.Generator(self.device).manual_seed(c.seed * 2**20 + st.step)
                alpha = world.shard(torch.rand((var_ref.shape[0] * world.size, 1, 1, 1),
                                               generator=gen, device=self.device))
            d_loss = d_loss + GP_WEIGHT * gradient_penalty(
                lambda x: self._d(x, update=False), var_ref, fake_det, alpha)
        d_grads = torch.autograd.grad(d_loss, st.d_target.params())
        metrics.update({"loss/l_d_total": d_loss, "disc_Score/D_real": pr.float().mean(),
                        "disc_Score/D_fake": pf.float().mean()})

        if do_d:
            st.d_target.step(d_grads)
        if do_g:
            st.g.step(g_grads)
        metrics["loss/l_g_total"] = total
        st.step += 1
        return dist.current().mean_metrics({k: v.detach().float() for k, v in metrics.items()})
