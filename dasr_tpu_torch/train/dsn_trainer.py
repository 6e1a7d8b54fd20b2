"""DSN (down-sampling network) GAN trainer: stage 1 of the pipeline.

Counterpart of ``dasr_tpu.train.dsn_trainer`` (reference:
codes/DSN/train.py:199-291):

* one G forward and one pair of D scorings per iteration;
* G loss = w_col * L1(low(fake), low(bicubic)) + w_tex * (-log D(fake))
  + w_per * LPIPS(fake, bicubic) (codes/DSN/loss.py:82-92); the colour
  loss's low-pass is VALID (``padding=False``), or the Haar LL band for
  ``filter='wavelet'``; LPIPS alex takes [0, 1] inputs (``normalize``);
* G's gradients go through D at its current parameters and are taken with
  respect to G's parameters only (``torch.autograd.grad``); D's gradients
  use the detached fake, at the same parameters; both Adams (beta1 0.5)
  step after both gradients exist, as the reference's ``retain_graph``
  pattern gives;
* D loss = -log D(real) - log(1 - D(fake)), or WGAN's signed means plus
  10 x the gradient penalty (DSN/train.py:229-236), whose per-sample
  ``alpha`` is drawn from a ``torch.Generator`` seeded from (seed, step),
  or passed in;
* DSGAN takes the bicubic as its input and as the rgb/mean reference;
* ``disc_freq`` / ``gen_freq``: the caller says which networks update.

uint8 batches (``--transfer_uint8``) are cast to f32 / 255 on the device;
without ``bicubic`` in the batch (``--device_bicubic``) the MATLAB bicubic
target is computed in the step (``ops.resize.imresize``).

``train_multi_step`` runs K steps on K device batches, and
``train_banked_step`` K steps on batches drawn and gathered on the device
from the clean and noisy banks (``data/device_bank.py``), uint8 crops cast
and the bicubic computed in the step; both are Python loops of
``train_step`` with no sync (the JAX package scans them; a CUDA graph of
the window is ROADMAP B.1).

In a world of several ranks (``core/dist.py``) each rank steps on its rows
of the global batch: the RaGAN batch mean (``FSDiscriminator``), the
WGAN-GP draws and the metrics are the global batch's, a banked window draws
for the global row, and ``NetState.step`` averages the gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dasr_tpu_torch.core import dist
from dasr_tpu_torch.data.device_bank import (
    ImageBank,
    draw_dsn,
    gather_dsn,
    shard_draws,
    window_generator,
)
from dasr_tpu_torch.losses.gan import (
    dsn_discriminator_loss,
    dsn_generator_adv_loss,
    gradient_penalty,
)
from dasr_tpu_torch.losses.lpips import LPIPS, default_lpips
from dasr_tpu_torch.nn.discriminators import FSDiscriminator
from dasr_tpu_torch.nn.generators import DeResnet, DSGANGenerator
from dasr_tpu_torch.nn.layers import init_lecun_
from dasr_tpu_torch.ops.filters import filter_low, wavelet_ll
from dasr_tpu_torch.ops.resize import imresize
from dasr_tpu_torch.train.schedules import dsn_linear_decay
from dasr_tpu_torch.train.state import GANTrainState, NetState


@dataclasses.dataclass(frozen=True)
class DSNConfig:
    """Mirrors the reference's argparse surface (DSN/train.py:24-73)."""

    generator: str = "DeResnet"  # 'DeResnet' | 'DSGAN'
    discriminator: str = "FSD"  # 'FSD' | 'nld_s1' | 'nld_s2'
    filter: str = "gau"  # 'gau' | 'avg_pool' | 'wavelet'
    cat_or_sum: str = "cat"
    norm_layer: str = "Instance"
    kernel_size: int = 5
    num_res_blocks: int = 8
    upscale_factor: int = 4
    highpass: bool = True
    wgan: bool = False
    ragan: bool = False
    w_col: float = 1.0
    w_tex: float = 0.005
    w_per: float = 0.01
    use_per_loss: bool = True
    per_type: str = "LPIPS"
    learning_rate: float = 1e-4
    adam_beta_1: float = 0.5
    disc_freq: int = 1
    gen_freq: int = 1
    seed: int = 0  # the init, and the WGAN-GP draws with the step
    packed_trunk: bool = False  # a TPU rewrite of DeResnet's trunk: ignored
    dtype: torch.dtype = torch.float32  # activations; parameters stay f32


class DSNTrainer:
    """Holds G, D, LPIPS and their optimizers (``self.state``) and runs the
    step. ``lpips``: a frozen LPIPS to use instead of the seeded default
    (the tests pass the JAX package's, carried across). ``decay``:
    (num_epochs, num_decay_epochs, steps_per_epoch) of ``dsn_linear_decay``;
    None keeps the LR constant."""

    def __init__(self, cfg: DSNConfig, device: torch.device = torch.device("cpu"),
                 lpips: Optional[LPIPS] = None,
                 decay: Optional[Tuple[int, int, int]] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        if cfg.generator == "DSGAN":
            self.g_model = DSGANGenerator(cfg.num_res_blocks, dtype=cfg.dtype)
        elif cfg.generator == "DeResnet":
            self.g_model = DeResnet(cfg.num_res_blocks, cfg.upscale_factor,
                                    packed_trunk=cfg.packed_trunk, dtype=cfg.dtype)
        else:
            raise NotImplementedError(f"Generator model [{cfg.generator}] not recognized")
        self.d_model = FSDiscriminator(
            d_arch=cfg.discriminator, filter_type=cfg.filter if cfg.highpass else None,
            kernel_size=cfg.kernel_size, cs=cfg.cat_or_sum, norm_layer=cfg.norm_layer,
            wgan=cfg.wgan, dtype=cfg.dtype)
        self.lpips = lpips
        self.decay = decay
        self.state: Optional[GANTrainState] = None

    # -- init -----------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> GANTrainState:
        """Seeded weights in the JAX init's law (``cfg.seed`` unless ``seed``
        is given) on the device, an Adam and a scheduler per network."""
        c = self.cfg
        gen = torch.Generator().manual_seed(c.seed if seed is None else seed)
        self.g_model.init_weights(gen)
        init_lecun_(self.d_model, gen)
        if c.use_per_loss and self.lpips is None:
            self.lpips = default_lpips("alex", seed=c.seed, dtype=c.dtype)
        if self.lpips is not None:
            self.lpips.to(self.device)
        self.g_model.to(self.device, memory_format=torch.channels_last)
        self.d_model.to(self.device, memory_format=torch.channels_last)
        self.state = GANTrainState(step=0, g=self._net_state(self.g_model),
                                   d_target=self._net_state(self.d_model))
        return self.state

    def _net_state(self, net) -> NetState:
        c = self.cfg
        opt = torch.optim.Adam(net.parameters(), lr=c.learning_rate,
                               betas=(c.adam_beta_1, 0.999), eps=1e-8)
        sched = (dsn_linear_decay(opt, *self.decay) if self.decay is not None
                 else torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0))
        return NetState(net, opt, sched)

    # -- loss pieces ----------------------------------------------------------

    def _color_loss(self, fake, target):
        c = self.cfg
        if c.filter == "wavelet":
            lf, lt = wavelet_ll(fake, norm=True), wavelet_ll(target, norm=True)
        else:
            kw = dict(kernel_size=c.kernel_size, padding=False, gaussian=c.filter == "gau")
            lf, lt = filter_low(fake, **kw), filter_low(target, **kw)
        return (lf.float() - lt.float()).abs().mean()

    def gp_alpha(self, batch_size: int) -> torch.Tensor:
        """This step's WGAN-GP mixing draws, (B, 1, 1, 1) uniform, from a
        generator seeded from (cfg.seed, step): this rank's ``batch_size``
        rows of the global batch's draws."""
        seed = int(np.random.SeedSequence([self.cfg.seed, self.state.step]).generate_state(1)[0])
        gen = torch.Generator(device=self.device).manual_seed(seed)
        world = dist.current()
        return world.shard(torch.rand((batch_size * world.size, 1, 1, 1), generator=gen,
                                      device=self.device))

    # -- the step -------------------------------------------------------------

    def train_step(self, batch: Dict[str, torch.Tensor], do_g: bool = True, do_d: bool = True,
                   gp_alpha: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One step on a batch of NCHW device tensors: ``input`` (HR crops),
        ``disc`` (real LR crops) and, unless the bicubic is computed here,
        ``bicubic``; f32 in [0, 1] or uint8. Returns the nine metrics as 0-d
        f32 tensors. With ``do_g`` / ``do_d`` false the losses are still
        reported but that network is not updated."""
        c, st = self.cfg, self.state
        batch = {k: v.float() / 255.0 if v.dtype == torch.uint8 else v for k, v in batch.items()}
        if "bicubic" in batch:
            target = batch["bicubic"]
        else:
            target = imresize(batch["input"], 1.0 / c.upscale_factor)
        # DSGAN is a 1:1 net on the bicubic (DSN/train.py:216)
        g_input = target if c.generator == "DSGAN" else batch["input"]
        disc = batch["disc"]
        g, d = st.g.net, st.d_target.net

        # G's gradient, through D at its current parameters
        fake = g(g_input)
        l_tex = dsn_generator_adv_loss(d(fake, disc) if c.ragan else d(fake), wasserstein=c.wgan)
        l_col = self._color_loss(fake, target)
        loss = c.w_col * l_col + c.w_tex * l_tex
        l_per = torch.zeros((), device=self.device)
        if c.use_per_loss:
            l_per = self.lpips(fake, target, normalize=True).mean()
            loss = loss + c.w_per * l_per
        g_grads = torch.autograd.grad(loss, st.g.params())

        # D's gradient at the same parameters, on the detached fake
        fake_det = fake.detach()
        if c.ragan:
            real_tex, fake_tex = d(disc, fake_det), d(fake_det, disc)
        else:
            real_tex, fake_tex = d(disc), d(fake_det)
        gp = 0.0
        if c.wgan:
            alpha = self.gp_alpha(disc.shape[0]) if gp_alpha is None else gp_alpha
            gp = 10.0 * gradient_penalty(d, disc, fake_det, alpha)
        d_loss = dsn_discriminator_loss(real_tex, fake_tex, wasserstein=c.wgan, grad_penalty=gp)
        d_grads = torch.autograd.grad(d_loss, st.d_target.params())

        if do_g:
            st.g.step(g_grads)
        if do_d:
            st.d_target.step(d_grads)
        st.step += 1

        # L1 between per-image spatial means, so the fake-LR / input sizes do
        # not matter (DSN/loss.py:97-101, logged against the G input)
        fake32, ref32 = fake_det.float(), g_input.float()
        rgb_loss = (fake32.mean((2, 3)) - ref32.mean((2, 3))).abs().mean()
        mean_loss = (fake32.mean((1, 2, 3)) - ref32.mean((1, 2, 3))).abs().mean()
        metrics = {
            "loss/g_overall_loss": loss,
            "loss/color_loss": l_col,
            "loss/g_tex_loss": l_tex,
            "loss/perceptual_loss": l_per,
            "loss/d_tex_loss": d_loss,
            "loss/rgb_loss": rgb_loss,
            "loss/mean_loss": mean_loss,
            "disc_score/real": real_tex.float().mean(),
            "disc_score/fake": fake_tex.float().mean(),
        }
        return dist.current().mean_metrics({k: v.detach().float() for k, v in metrics.items()})

    def train_multi_step(self, batches, do_g: bool = True,
                         do_d: bool = True) -> Dict[str, torch.Tensor]:
        """``train_step`` over a list of K device batches; the last step's
        metrics, unsynchronised (the CLI runs it with ``disc_freq`` and
        ``gen_freq`` 1)."""
        metrics = {}
        for batch in batches:
            metrics = self.train_step(batch, do_g=do_g, do_d=do_d)
        return metrics

    def train_banked_step(self, clean: ImageBank, noisy: ImageBank, noisy_idx: torch.Tensor,
                          seed: int, crop: int, flips: bool = False, rotations: bool = False,
                          do_g: bool = True, do_d: bool = True) -> Dict[str, torch.Tensor]:
        """K steps over a (K, B) window of noisy-image indices on the banks'
        device, each on a batch drawn and gathered there (``draw_dsn``,
        ``gather_dsn``); ``seed``: the window's first iteration. The last
        step's metrics, unsynchronised (counterpart of
        ``DSNTrainer.train_banked_step``)."""
        gen = window_generator(self.cfg.seed, seed, self.device)
        world = dist.current()
        metrics = {}
        for row in noisy_idx:
            # the global row's draws, then this rank's items of it
            sl = world.batch_slice(row.shape[0])
            draws = shard_draws(draw_dsn(gen, row.shape[0], clean.data.shape[0]), sl)
            batch = gather_dsn(clean, noisy, row[sl], draws, crop, self.cfg.upscale_factor,
                               flips, rotations)
            metrics = self.train_step({k: v.permute(0, 3, 1, 2) for k, v in batch.items()},
                                      do_g=do_g, do_d=do_d)
        return metrics

    @torch.no_grad()
    def generate(self, x: torch.Tensor) -> torch.Tensor:
        return self.g_model(x)
