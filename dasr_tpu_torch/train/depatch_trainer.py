"""DePatch wavelet GAN trainer ('De_patch_wavelet_GAN').

Counterpart of ``dasr_tpu.train.depatch_trainer`` (reference:
codes/SRN/models/DePatchGAN_wavelet_model.py:19-357): the DSN recipe inside
the SRN framework, an HR -> LR generator trained with

* the pixel loss (l1 or l2) on the Haar LL band of G(HR) against the LL
  band of ``LR`` (both halved where ``norm``);
* LPIPS alex of G(HR) against ``LR`` ([0, 1] inputs), whenever
  ``feature_weight`` > 0, as ``dasr_tpu`` does;
* ``gan_weight`` x the DSN generator loss (-log D) on D's scores of the 9
  Haar high bands of G(HR);

and D (an ``FSDiscriminator`` with no front end: the step hands it the
bands) trained with the DSN discriminator loss, the high bands of ``ref``
(real LR images) against those of G(HR), detached. Both gradients are
taken at the parameters from before the step, as JAX's pair of
``value_and_grad`` does, then each network takes one Adam step with its
MultiStepLR. Losses are taken in f32.

``realness_map`` is the test-time receptive-field map of an LR image (the
DDM's precursor, DePatchGAN_wavelet_model.py:270-296), splatted with
``ops/rf_splat.py:ddm_splat`` as stage 2 does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from dasr_tpu_torch.losses.gan import dsn_discriminator_loss, dsn_generator_adv_loss
from dasr_tpu_torch.losses.lpips import LPIPS, default_lpips
from dasr_tpu_torch.nn.discriminators import FSDiscriminator
from dasr_tpu_torch.nn.layers import init_lecun_
from dasr_tpu_torch.ops.dwt import haar_bands
from dasr_tpu_torch.ops.rf_splat import CONVNETS, ddm_splat
from dasr_tpu_torch.train.srgan_trainer import pixel_loss
from dasr_tpu_torch.train.state import GANTrainState, make_net_state


@dataclasses.dataclass(frozen=True)
class DePatchConfig:
    lr_g: float = 1e-4
    lr_d: float = 1e-4
    beta1_g: float = 0.9
    beta1_d: float = 0.9
    lr_steps: Sequence[int] = (100000, 200000)
    lr_gamma: float = 0.5
    norm: bool = True
    pixel_criterion: str = "l1"
    pixel_weight: float = 1.0
    feature_weight: float = 1.0
    gan_weight: float = 0.005
    seed: int = 0
    dtype: torch.dtype = torch.float32


def make_d(cfg: DePatchConfig) -> FSDiscriminator:
    """D on the 9 Haar high bands: the FSD body with InstanceNorm, no front
    end (``dasr_tpu``'s, whatever ``network_D`` names)."""
    return FSDiscriminator(d_arch="FSD", filter_type=None, norm_layer="Instance",
                           dtype=cfg.dtype, in_ch=9)


@torch.no_grad()
def realness_map(d: FSDiscriminator, lr: torch.Tensor, norm: bool = True) -> torch.Tensor:
    """``make_d``'s D's scores on the high bands of NCHW ``lr``, splatted to
    the bands' (h, w): (B, h, w) f32."""
    _, hf = haar_bands(lr, norm=norm, cs="cat")
    return ddm_splat(d(hf)[:, 0], hf.shape[-2], hf.shape[-1], CONVNETS["FSD"])


class DePatchTrainer:
    """Holds G (given: ``define_G``'s), D, LPIPS and their optimizers
    (``self.state``) and runs the step. ``lpips``: a frozen LPIPS to use
    instead of the seeded default (the tests pass the JAX package's)."""

    def __init__(self, cfg: DePatchConfig, g_model: torch.nn.Module,
                 d_model: Optional[FSDiscriminator] = None,
                 device: torch.device = torch.device("cpu"), lpips: Optional[LPIPS] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.g_model = g_model
        self.d_model = d_model if d_model is not None else make_d(cfg)
        self.lpips = lpips
        self.state: Optional[GANTrainState] = None

    def init_state(self, seed: Optional[int] = None) -> GANTrainState:
        """Seeded weights in the JAX init's law (``cfg.seed`` unless ``seed``
        is given) on the device, an Adam and a scheduler per network."""
        c = self.cfg
        seed = c.seed if seed is None else seed
        gen = torch.Generator().manual_seed(seed)
        self.g_model.init_weights(gen)
        init_lecun_(self.d_model, gen)
        if c.feature_weight > 0 and self.lpips is None:
            self.lpips = default_lpips("alex", seed=seed, dtype=c.dtype)
        if self.lpips is not None:
            self.lpips.to(self.device)
        self.g_model.to(self.device, memory_format=torch.channels_last).train()
        self.d_model.to(self.device, memory_format=torch.channels_last).train()
        self.state = GANTrainState(
            step=0,
            g=make_net_state(self.g_model, c.lr_g, c.beta1_g, c.lr_steps, c.lr_gamma),
            d_target=make_net_state(self.d_model, c.lr_d, c.beta1_d, c.lr_steps, c.lr_gamma),
        )
        return self.state

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One step on NCHW device tensors: ``HR``, its ``LR`` and ``ref``
        (real LR images; ``LR`` where absent, as in JAX). Returns the metrics
        as 0-d f32 tensors."""
        c, st = self.cfg, self.state
        var_h, var_l = batch["HR"], batch["LR"]
        var_ref = batch.get("ref", var_l)
        _, hf_real = haar_bands(var_ref, norm=c.norm, cs="cat")
        lf_bic, _ = haar_bands(var_l, norm=c.norm, cs="cat")
        g, d = st.g.net, st.d_target.net
        metrics: Dict[str, torch.Tensor] = {}

        fake_l = g(var_h)
        lf_fake, hf_fake = haar_bands(fake_l, norm=c.norm, cs="cat")
        total = torch.zeros((), device=self.device)
        if c.pixel_weight > 0:
            l_pix = c.pixel_weight * pixel_loss(lf_fake, lf_bic, c.pixel_criterion)
            total = total + l_pix
            metrics["loss/l_g_pix"] = l_pix
        if c.feature_weight > 0:
            l_fea = c.feature_weight * self.lpips(fake_l, var_l, normalize=True).float().mean()
            total = total + l_fea
            metrics["loss/l_g_fea"] = l_fea
        l_gan = c.gan_weight * dsn_generator_adv_loss(d(hf_fake))
        total = total + l_gan
        metrics["loss/l_g_gan"] = l_gan
        metrics["loss/l_g_total"] = total
        g_grads = torch.autograd.grad(total, st.g.params())

        real_tex, fake_tex = d(hf_real), d(hf_fake.detach())
        d_loss = dsn_discriminator_loss(real_tex, fake_tex)
        d_grads = torch.autograd.grad(d_loss, st.d_target.params())
        metrics.update({"loss/l_d_total": d_loss, "disc_Score/real": real_tex.float().mean(),
                        "disc_Score/fake": fake_tex.float().mean()})

        st.g.step(g_grads)
        st.d_target.step(d_grads)
        st.step += 1
        return {k: v.detach().float() for k, v in metrics.items()}
