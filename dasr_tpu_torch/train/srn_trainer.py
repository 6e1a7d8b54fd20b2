"""SRN/DASR trainer: the domain-distance-aware SR training step.

Counterpart of ``dasr_tpu.train.srn_trainer`` (reference:
codes/SRN/models/DASR_model.py:192-330):

* batches are structured: the fake (source) half, then the real (target)
  half; G runs once on the concatenated LR batch;
* frequency separation: Haar wavelet / gaussian / avg-pool split of SR and
  HR (DASR_model.py:442-458);
* G losses (source half): DDM-weighted L1 (multiweights), LL-band L1
  (sup_LL), LPIPS or VGG feature loss; (target half): GAN on the high
  bands against D_target; the optional source-domain GAN
  (DASR_model.py:210-263). Losses are taken in f32 from the working-type
  activations;
* G's gradients are taken with respect to G's parameters only
  (``torch.autograd.grad``), so nothing leaks into D; each D loss is built
  from the detached SR halves at D's parameters from before any update
  (DASR_model.py:267-302), and the optimizers step after all gradients
  are taken;
* an Adam and a MultiStepLR per network (DASR_model.py:120-151).

Reference quirks reproduced, as the JAX package does: ``l_pix_w`` is
applied twice in the multiweights path (DASR_model.py:213-218); with RaGAN
on, ``gan_H_target`` is applied twice on the G side (:240-247).

``train_banked_step`` runs a window of K steps on batches sampled on the
device from the stage-3 banks (``data/device_bank.py``), no sync, the
generator seeded from (``cfg.seed``, the window's first iteration), as the
JAX package folds the window into its key. It hands the step's parts to
``train/step_graph.py:StepGraphs.window``, which replays each step from a
CUDA graph of ``device_step`` on CUDA in a world of one rank without a
process group (the counterpart of JAX's ``jit`` over ``lax.scan``) and
elsewhere, and as the plain version the card is held against, loops
``device_step`` and ``host_step``. A window of host batches is the facade's
loop of ``train_step`` (``models/registry.py:DASRModel.train_multi_step``).

In a world of several ranks (``core/dist.py``) each rank steps on its rows
of the global batch: the RaGAN batch means and the metrics are the global
batch's, and ``NetState.step`` averages the gradients.

With tracing on (``utils/trace.py``) a step marks its device phases: a
banked step's ``batch`` (the gather and the layout), then ``_gan_step``'s
``g_forward`` (G and its losses), ``g_backward``, ``d`` (the
discriminators' losses and gradients) and ``adam``, closed at its end.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from dasr_tpu_torch.core import dist
from dasr_tpu_torch.data.device_bank import (
    SrnBanks,
    draw_dasr,
    gather_dasr,
    shard_draws,
    window_generator,
)
from dasr_tpu_torch.losses.gan import gan_loss, ragan_pair_loss
from dasr_tpu_torch.losses.lpips import LPIPS, default_lpips
from dasr_tpu_torch.nn.discriminators import NLayerDiscriminator
from dasr_tpu_torch.nn.generators import RRDBNet
from dasr_tpu_torch.nn.layers import init_lecun_
from dasr_tpu_torch.nn.vgg import VGG19Feature54
from dasr_tpu_torch.ops.dwt import haar_bands
from dasr_tpu_torch.ops.filters import filter_high, filter_low
from dasr_tpu_torch.ops.resize import bilinear_resize
from dasr_tpu_torch.train import step_graph
from dasr_tpu_torch.train.state import GANTrainState, make_net_state
from dasr_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class SRNConfig:
    """Mirrors the shipped DASR train JSON (train_DASR_auto_reproduce_*.json)."""

    scale: int = 4
    # network_G
    nf: int = 64
    nb: int = 23
    gc: int = 32
    # network_D (discriminator_patch on 9ch wavelet bands)
    d_in_nc: int = 9
    d_nf: int = 64
    d_n_layers: int = 2
    # train block
    lr_g: float = 1e-4
    lr_d: float = 1e-4
    beta1_g: float = 0.9
    beta1_d: float = 0.9
    lr_steps: Sequence[int] = (35000, 80000, 100000, 150000)
    lr_gamma: float = 0.5
    fs: str = "wavelet"  # 'wavelet' | 'gau' | 'avgpool'
    fs_kernel_size: int = 5
    norm: bool = True
    sup_LL: bool = True
    pixel_weight: float = 1.0
    pixel_LL_weight: float = 1.0
    pixel_criterion: str = "l1"
    feature_criterion: str = "LPIPS"  # 'LPIPS' | 'l1' | 'l2'
    feature_weight: float = 1.0
    gan_type: str = "vanilla"
    ragan: bool = False
    gan_H_target: float = 0.005
    gan_H_source: float = 0.0
    multiweights: bool = True
    g_update_inter: int = 1
    d_update_inter: int = 1
    seed: int = 0
    dtype: torch.dtype = torch.float32


class SRNTrainer:
    """Holds the networks and their optimizers (``self.state``) and runs the
    step. ``lpips`` / ``vgg``: frozen feature nets to use instead of the
    seeded defaults (the tests pass the JAX package's, carried across)."""

    # the name of the captured step in its key (``train_banked_step``)
    graph_name = "dasr"

    def __init__(self, cfg: SRNConfig, device: torch.device = torch.device("cpu"),
                 g_model: Optional[RRDBNet] = None, lpips: Optional[LPIPS] = None,
                 vgg: Optional[VGG19Feature54] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.g_model = g_model if g_model is not None else RRDBNet(
            nf=cfg.nf, nb=cfg.nb, gc=cfg.gc, upscale=cfg.scale, dtype=cfg.dtype)
        self.lpips, self.vgg = lpips, vgg
        self.state: Optional[GANTrainState] = None
        self.graphs = step_graph.StepGraphs(self.device)

    def make_d(self) -> NLayerDiscriminator:
        """SRN 'discriminator_patch': NLayer, stride 2, instance norm,
        bias-free middle convs (networks.py:184-185)."""
        c = self.cfg
        return NLayerDiscriminator(in_ch=c.d_in_nc, ndf=c.d_nf, n_layers=c.d_n_layers,
                                   norm_layer="Instance", stride=2, use_bias_middle=False)

    # -- init -----------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> GANTrainState:
        """Seeded weights in the JAX init's law (``cfg.seed`` unless ``seed``
        is given), moved to the device, with an Adam and a scheduler per
        network. Pretrained weights are loaded after this call."""
        c = self.cfg
        gen = torch.Generator().manual_seed(c.seed if seed is None else seed)
        self.g_model.init_weights(gen)
        d_target = init_lecun_(self.make_d(), gen)
        d_source = init_lecun_(self.make_d(), gen) if c.gan_H_source > 0 else None
        if c.feature_weight > 0 and c.feature_criterion == "LPIPS" and self.lpips is None:
            self.lpips = default_lpips("alex", seed=c.seed, dtype=c.dtype)
        if c.feature_weight > 0 and c.feature_criterion in ("l1", "l2") and self.vgg is None:
            self.vgg = init_lecun_(VGG19Feature54(), gen).requires_grad_(False)
        for m in (self.lpips, self.vgg):
            if m is not None:
                m.to(self.device)
        self.g_model.to(self.device, memory_format=torch.channels_last)

        def net_state(net, lr, beta1):
            return make_net_state(net.to(self.device), lr, beta1, c.lr_steps, c.lr_gamma)

        self.state = GANTrainState(
            step=0,
            g=net_state(self.g_model, c.lr_g, c.beta1_g),
            d_target=net_state(d_target, c.lr_d, c.beta1_d),
            d_source=net_state(d_source, c.lr_d, c.beta1_d) if d_source is not None else None,
        )
        return self.state

    # -- frequency separation (DASR_model.py:442-458) --------------------------

    def _fs(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        if c.fs == "wavelet":
            return haar_bands(x, norm=c.norm, cs="cat")
        gau = c.fs == "gau"
        low = filter_low(x, kernel_size=c.fs_kernel_size, gaussian=gau)
        high = filter_high(x, kernel_size=c.fs_kernel_size, gaussian=gau, normalize=False)
        if c.norm:
            high = high * 0.5 + 0.5
        return low, high

    def _pix(self, a, b):
        d = a.float() - b.float()
        return d.abs().mean() if self.cfg.pixel_criterion == "l1" else (d * d).mean()

    def _d(self, net, x):
        return net(x.to(self.cfg.dtype))

    def _d_loss(self, net, real, fake):
        pr, pf = self._d(net, real), self._d(net, fake)
        c = self.cfg
        if c.ragan:
            loss = ragan_pair_loss(pr, pf, c.gan_type)
        else:
            loss = (gan_loss(pr, True, c.gan_type) + gan_loss(pf, False, c.gan_type)) / 2
        return loss, pr.float().mean(), pf.float().mean()

    # -- the step -----------------------------------------------------------------

    def train_step(self, batch: Dict[str, torch.Tensor], do_g: bool = True,
                   do_d: bool = True) -> Dict[str, torch.Tensor]:
        """One step on a batch of NCHW device tensors (keys LR_fake, LR_real,
        HR, HR_unpair, fake_w). Returns the metrics as 0-d f32 tensors. With
        ``do_g``/``do_d`` false the losses are still reported but that side
        is not updated."""
        metrics = self.device_step(batch, do_g, do_d)
        self.host_step(do_g, do_d)
        return metrics

    def host_step(self, do_g: bool, do_d: bool) -> None:
        """The host part of a step: the LR schedule of each network that
        updated, and ``state.step`` + 1."""
        c, st = self.cfg, self.state
        if do_d:
            for ns, on in ((st.d_target, c.gan_H_target > 0), (st.d_source, c.gan_H_source > 0)):
                if on:
                    ns.advance()
        if do_g:
            st.g.advance()
        st.step += 1

    def device_step(self, batch: Dict[str, torch.Tensor], do_g: bool,
                    do_d: bool) -> Dict[str, torch.Tensor]:
        """``train_step`` without its host part: what a CUDA graph captures."""
        var_l = torch.cat([batch["LR_fake"], batch["LR_real"]])
        var_h = torch.cat([batch["HR"], batch["HR_unpair"]])
        weights = bilinear_resize(batch["fake_w"], var_h.shape[-2], var_h.shape[-1])
        return self._gan_step(self.state, var_l, var_h, batch["LR_fake"].shape[0], (),
                              weights if self.cfg.multiweights else None, {}, do_g, do_d)

    def _gan_step(self, st: GANTrainState, var_l, var_h, b: int, g_extra, weights,
                  metrics: Dict[str, torch.Tensor], do_g: bool,
                  do_d: bool) -> Dict[str, torch.Tensor]:
        """The step's device part after its batch is assembled: G on
        ``var_l`` (and ``g_extra``), G's losses, the discriminators' losses,
        the updates (``host_step`` follows). ``weights``: the per-pixel
        pixel-loss weights at HR size, or None for the plain pixel loss;
        ``metrics``: those the caller already took."""
        c = self.cfg
        trace.phase("g_forward")
        real_ll, real_hc = self._fs(var_h)
        hr_src, hr_ll_src = var_h[:b], real_ll[:b]
        hf_src_real, hf_tgt_real = real_hc[:b], real_hc[b:]

        fake_h = st.g.net(var_l, *g_extra)
        fake_ll, fake_hc = self._fs(fake_h)
        sr_src, sr_ll_src = fake_h[:b], fake_ll[:b]
        hf_src_fake, hf_tgt_fake = fake_hc[:b], fake_hc[b:]

        total = torch.zeros((), device=self.device)
        if c.pixel_weight > 0:
            if weights is not None:
                # reference quirk: l_pix_w applied twice (DASR_model.py:214-218)
                l_pix = c.pixel_weight * torch.mean(
                    weights.float() * (sr_src.float() - hr_src.float()).abs())
            else:
                l_pix = self._pix(sr_src, hr_src)
            total = total + c.pixel_weight * l_pix
            metrics["loss/l_g_pix"] = l_pix
            if c.sup_LL:
                l_ll = self._pix(sr_ll_src, hr_ll_src)
                total = total + c.pixel_LL_weight * l_ll
                metrics["loss/l_g_LL_pix"] = l_ll

        if c.feature_weight > 0:
            if c.feature_criterion == "LPIPS":
                l_fea = self.lpips(sr_src, hr_src, normalize=True).mean()
            else:
                with torch.no_grad():
                    f_real = self.vgg(hr_src.to(c.dtype))
                l_fea = self._pix(self.vgg(sr_src.to(c.dtype)), f_real)
            total = total + c.feature_weight * l_fea
            metrics["loss/l_g_fea"] = l_fea

        if c.gan_H_target > 0:
            pred_fake = self._d(st.d_target.net, hf_tgt_fake)
            if c.ragan:
                with torch.no_grad():
                    pred_real = self._d(st.d_target.net, hf_tgt_real)
                # reference quirk: the weight applied twice with RaGAN (:242-247)
                l_gan_t = c.gan_H_target * ragan_pair_loss(pred_fake, pred_real, c.gan_type)
            else:
                l_gan_t = gan_loss(pred_fake, True, c.gan_type)
            total = total + c.gan_H_target * l_gan_t
            metrics["loss/l_g_gan_target_Hf"] = l_gan_t

        if c.gan_H_source > 0:
            pred_fake_s = self._d(st.d_source.net, hf_src_fake)
            if c.ragan:
                with torch.no_grad():
                    pred_real_s = self._d(st.d_source.net, hf_src_real)
                l_gan_s = c.gan_H_source * ragan_pair_loss(pred_fake_s, pred_real_s, c.gan_type)
            else:
                l_gan_s = c.gan_H_source * gan_loss(pred_fake_s, True, c.gan_type)
            total = total + l_gan_s
            metrics["loss/l_g_gan_source_H"] = l_gan_s

        # G's gradients w.r.t. G's parameters only: nothing reaches D here
        trace.phase("g_backward")
        g_grads = torch.autograd.grad(total, st.g.params())

        # each D on the detached SR halves, at its parameters from before
        # any update
        trace.phase("d")
        updates = []
        if c.gan_H_target > 0:
            loss, r, f = self._d_loss(st.d_target.net, hf_tgt_real, hf_tgt_fake.detach())
            updates.append((st.d_target, torch.autograd.grad(loss, st.d_target.params())))
            metrics.update({"loss/l_d_target_total": loss, "disc_Score/D_real_target_H": r,
                            "disc_Score/D_fake_target_H": f})
        if c.gan_H_source > 0:
            loss, r, f = self._d_loss(st.d_source.net, hf_src_real, hf_src_fake.detach())
            updates.append((st.d_source, torch.autograd.grad(loss, st.d_source.params())))
            metrics.update({"loss/l_d_total": loss, "disc_Score/D_real_source_H": r,
                            "disc_Score/D_fake_source_H": f})
        trace.phase("adam")
        if do_d:
            for net_state, grads in updates:
                net_state.update(grads)
        if do_g:
            st.g.update(g_grads)
        metrics["loss/l_g_total"] = total
        out = dist.current().mean_metrics({k: v.detach().float() for k, v in metrics.items()})
        trace.end_phases()
        return out

    def graph_tensors(self) -> Iterator[torch.Tensor]:
        """Every tensor of the trainer whose address a captured step bakes in:
        each network's parameters, buffers, Adam state and LR tensor, and the
        frozen feature nets' parameters and buffers."""
        st = self.state
        for ns in (st.g, st.d_target, st.d_source):
            if ns is not None:
                yield from ns.tensors()
        for m in (self.lpips, self.vgg):
            if m is not None:
                yield from m.parameters()
                yield from m.buffers()

    def train_banked_step(self, banks: SrnBanks, fake_idx: torch.Tensor, seed: int,
                          hr_size: int, use_flip: bool = True, use_rot: bool = True,
                          do_g: bool = True, do_d: bool = True) -> Dict[str, torch.Tensor]:
        """K steps over a (K, B) window of fake-LR indices on the banks'
        device, each on a batch drawn and gathered there (``draw_dasr``,
        ``gather_dasr``); ``seed``: the window's first iteration. Returns the
        last step's metrics as device tensors, unsynchronised (counterpart of
        ``SRNTrainer.train_banked_step``). ``self.graphs`` runs the window,
        replayed or looped, keyed by ``graph_name``; ``graph_tensors`` and
        the banks are the tensors a capture bakes in. Every rank draws for
        the global row, from the same generator, and gathers its own rows of
        it (``World.batch_slice``)."""
        c = self.cfg
        gen = window_generator(c.seed, seed, self.device)
        n_real, n_hr = banks.real.data.shape[0], banks.hr.data.shape[0]
        batch_size = fake_idx.shape[1]
        rows = dist.current().batch_slice(batch_size)

        def step(row, draws):
            trace.phase("batch")
            batch = gather_dasr(banks, row, draws, hr_size, c.scale, use_flip, use_rot)
            return self.device_step({k: v.permute(0, 3, 1, 2) for k, v in batch.items()},
                                    do_g, do_d)

        def tensors():
            yield from self.graph_tensors()
            for b in banks:
                if b is not None:
                    yield from b

        key = (self.graph_name, batch_size, hr_size, use_flip, use_rot, c.dtype, do_g, do_d)
        return self.graphs.window(
            key, tensors, step,
            ((row, shard_draws(draw_dasr(gen, batch_size, n_real, n_hr), rows))
             for row in fake_idx[:, rows]),
            lambda: self.host_step(do_g, do_d), self.state.step)

    # -- inference ----------------------------------------------------------------

    @torch.no_grad()
    def sr(self, lr_img: torch.Tensor) -> torch.Tensor:
        return self.g_model(lr_img)
