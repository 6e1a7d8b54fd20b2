"""Model registry — the facades of the serving and training paths.

Counterpart of ``dasr_tpu.models.registry``: ``create_model(opt)`` keyed
like the reference (codes/SRN/models/__init__.py:5-26), ``define_G``
(codes/SRN/models/networks.py:83-147), ``define_D`` / ``define_pairD``
(:151-227) and ``define_patchD``. Ported: 'DASR' (``DASRModel``),
serving and training on host batches one step or a window at a time,
uint8 batches cast on the device, and windows sampled from device-resident banks
(``setup_device_bank``, ``train_banked_window_async``), resumed from the
port's own ``{iter}.pt`` (``resume``) or a reference ``{iter}.state``
(``resume_reference_state``); 'DASR_Adaptive_Model'
(``DASRAdaptiveModel``), serving and training its DDM-conditioned
generator; and the paired-data trainers 'sr' (``SRModel``, with
``test_x8``), 'srgan' / 'srragan' (``SRGANModel``) and 'De_Resnet'
(``DegradationModel``), serving and training on host batches one step a
call, and 'srgan' / 'srragan' with G and D updated every step also in
K-step windows, on host batches or drawn from paired banks on the device;
and 'De_patch_wavelet_GAN' (``DePatchModel``), the wavelet GAN of
the De_Resnet family, with its realness map; and 'sftgan' (``SFTGANModel``),
serving 'sft_arch' (SFTNet) on an LR image and its segmentation maps
(``sftgan_test`` runs through it). ``define_G`` also builds 'DSGAN',
``define_D`` 'dis_acd'; no model trains or serves them (``dsn_test`` runs
the DSGAN generator), and only 'sftgan' takes 'sft_arch'. Any other model,
or a generator the model does not feed, raises ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import logging
import math
from typing import Dict, Optional

import numpy as np
import torch

from dasr_tpu_torch.core import dist
from dasr_tpu_torch.data import device_bank
from dasr_tpu_torch.losses.lpips import default_lpips
from dasr_tpu_torch.nn.layers import init_lecun_
from dasr_tpu_torch.nn.discriminators import (
    DiscriminatorBasic,
    DiscriminatorVGG,
    DiscriminatorVGG128SN,
    FSDiscriminator,
    NLayerDiscriminator,
    make_vgg_discriminator,
)
from dasr_tpu_torch.nn.generators import (
    DeResnetSRN,
    DSGANGenerator,
    RRDBNet,
    RRDBNetResidualConv,
    RRDBNetSEAN,
    SRResNet,
)
from dasr_tpu_torch.nn.sft import ACDVGGBN96, SFTNet
from dasr_tpu_torch.ops.spatial_shard import spatially_sharded_apply
from dasr_tpu_torch.ops.tiled import forward_chop, pad_reflect, tiled_apply
from dasr_tpu_torch.train import checkpoints
from dasr_tpu_torch.train.dasr_adaptive_trainer import AdaptiveConfig, DASRAdaptiveTrainer
from dasr_tpu_torch.train.degradation_trainer import PixelConfig, PixelTrainer
from dasr_tpu_torch.train.depatch_trainer import (
    DePatchConfig,
    DePatchTrainer,
    make_d,
    realness_map,
)
from dasr_tpu_torch.train.srgan_trainer import SRGANConfig, SRGANTrainer, single_step_reason
from dasr_tpu_torch.train.srn_trainer import SRNConfig, SRNTrainer
from dasr_tpu_torch.utils import trace

logger = logging.getLogger("base")

# De_Resnet family: the variant, and whether the config's act_type holds
# (networks.py:106-127 give De_RRDB and the bilinear / x2 variants 'relu')
_DE_RESNETS = {"De_Resnet": ("strided", True), "De_RRDB": ("strided", False),
               "De_Resnet_bilinear": ("bilinear", False), "De_Resnet2xd": ("x2", False)}


SHARD_HALO = 20  # spatially sharded inference's halo: forward_chop's shave (utils/util.py:96)

# the generators no model feeds, and what runs them
_RUNNERS = {
    DSGANGenerator: "a 1:1 generator no SRN trainer feeds; dsn_test runs it "
                    "(--generator DSGAN)",
    SFTNet: "it takes segmentation maps, which no SRN dataset gives; model [sftgan] "
            "serves it, and sftgan_test runs that model",
}


def compute_dtype(opt: Dict) -> torch.dtype:
    """bf16 activations with f32 params unless the options say ``"bf16": false``."""
    return torch.bfloat16 if opt.get("bf16", True) else torch.float32


def define_G(opt: Dict) -> torch.nn.Module:
    """Build the generator module from a network_G config block."""
    net = opt["network_G"]
    which = net["which_model_G"]
    widths = dict(in_nc=net.get("in_nc", 3), out_nc=net.get("out_nc", 3), nf=net.get("nf", 64),
                  nb=net.get("nb", 23), gc=net.get("gc", 32), upscale=opt.get("scale", 4),
                  dtype=compute_dtype(opt))
    if which in ("RRDB_net", "RRDB_mask"):
        return RRDBNet(
            **widths, norm_type=net.get("norm_type"),
            fused_tail=bool(net.get("fused_tail")), scan_blocks=bool(net.get("scan_blocks")),
        )
    if which == "RRDB_SEAN":
        return RRDBNetSEAN(**widths, nb_ada=net.get("ada_nb", 1) or 1,
                           norm_type=net.get("norm_type"))
    if which in ("RRDB_Residual_conv", "RRDB_Residual_conv_concat"):
        return RRDBNetResidualConv(**widths, nb_ada=net.get("ada_nb", 1) or 1,
                                   concat=which != "RRDB_Residual_conv")
    if which == "sr_resnet":
        return SRResNet(in_nc=widths["in_nc"], out_nc=widths["out_nc"], nf=widths["nf"],
                        nb=net.get("nb", 16), upscale=widths["upscale"],
                        norm_type=net.get("norm_type"), mode=net.get("mode", "NAC"),
                        dtype=widths["dtype"])
    if which in _DE_RESNETS:
        variant, own_act = _DE_RESNETS[which]
        return DeResnetSRN(in_nc=widths["in_nc"], out_nc=widths["out_nc"], nf=widths["nf"],
                           nb=net.get("nb", 8) or 8, downscale=widths["upscale"],
                           norm_type=net.get("norm_type"),
                           act_type=net.get("act_type") if own_act else "relu",
                           mode=net.get("mode", "NAC") or "NAC", variant=variant,
                           dtype=widths["dtype"])
    if which == "DSGAN":
        return DSGANGenerator(dtype=widths["dtype"])
    if which == "sft_arch":
        return SFTNet(n_blocks=net.get("nb") or 16, dtype=widths["dtype"])
    raise NotImplementedError(f"Generator model [{which}] not recognized")


def define_D(opt: Dict) -> torch.nn.Module:
    """The discriminator of ``network_D.which_model_D`` (networks.py:151-194;
    default ``discriminator_vgg_128``)."""
    net = opt.get("network_D") or {}
    return _build_d(net.get("which_model_D", "discriminator_vgg_128"), net)


def define_pairD(opt: Dict) -> torch.nn.Module:
    """The paired-domain discriminator (networks.py:196-227):
    ``which_model_pairD``, else ``which_model_D``."""
    net = opt.get("network_D") or {}
    return _build_d(net.get("which_model_pairD", net.get("which_model_D")), net)


def _build_d(which: str, net: Dict) -> torch.nn.Module:
    in_nc, nf = net.get("in_nc", 3), net.get("nf", 64)
    if which == "discriminator_vgg_128":
        return DiscriminatorVGG(input_size=128, in_ch=in_nc, nf=nf)
    if which == "discriminator_vgg_128_SN":
        return DiscriminatorVGG128SN()
    if which == "discriminator_patch":
        return NLayerDiscriminator(in_ch=in_nc, ndf=nf, n_layers=net.get("n_layers", 3) or 3,
                                   norm_layer="Instance", stride=2, use_bias_middle=False)
    if which == "DSGAN":
        return DiscriminatorBasic(in_ch=in_nc)
    if which == "dis_acd":
        return ACDVGGBN96()
    return make_vgg_discriminator(which, in_nc=in_nc, nf=nf,
                                  norm_type=net.get("norm_type", "batch"),
                                  act_type=net.get("act_type", "leakyrelu"),
                                  mode=net.get("mode", "CNA"))


def define_patchD(opt: Dict) -> FSDiscriminator:
    """The FS patch discriminator (networks.py:229-245): ``network_patchD``'s
    ``FS_type`` (default gau), ``kernel_size`` and ``norm_layer``, its body
    in the compute dtype. The Adaptive model's too, as in the reference;
    ``dasr_tpu``'s Adaptive model defaults ``FS_type`` to avg_pool
    (``registry.py:838``), so a config without the key gets another patch D
    there (ROADMAP C.2)."""
    net = opt.get("network_patchD") or {}
    if net.get("which_patchD", "FSD") != "FSD":
        raise NotImplementedError(
            f"Patch Discriminator model [{net.get('which_patchD')}] not recognized")
    return FSDiscriminator(d_arch="FSD", filter_type=net.get("FS_type", "gau") or "gau",
                           kernel_size=net.get("kernel_size", 5) or 5,
                           norm_layer=net.get("norm_layer", "Instance") or "Instance",
                           dtype=compute_dtype(opt))


class _InferenceModel:
    """G-only inference facade (the ``_InferenceMixin`` logic of dasr_tpu),
    honouring the reference's chop flag, and the train-facade methods the
    trainers share (``self.trainer``, set by a model built with
    ``is_train``).

    ``chop`` semantics per trainer: SRModel chops whenever the flag is set
    (codes/SRN/models/SR_model.py:88-100); the DASR trainer only above
    320k input pixels (DASR_model.py:337), exposed as ``chop_threshold``.
    ``chop_parity`` selects the reference's recursive chopper, otherwise
    ``tiled_apply`` runs 128-px tiles with a 16-px halo. ``pad_bucket: N``
    reflect-pads inputs up to multiples of N and crops after.

    ``g_types``: the generators the model feeds; ``define_G`` builds the
    DDM-conditioned ones too, which only ``DASRAdaptiveModel`` feeds a map.
    ``_batch_keys``: the images of a host batch; ``val_keys``: G's input and
    the image its output is held against in validation and ``srn_test``. A
    model without K-step windows has ``supports_multi_step`` false:
    ``srn_train`` then runs one step a call (and logs the model's
    ``single_step_reason`` where it has one)."""

    chop_threshold: int = 0
    g_types: tuple = (RRDBNet,)
    _batch_keys: tuple = ("LR", "HR")
    val_keys: tuple = ("LR", "HR")
    supports_multi_step = False

    def __init__(self, opt: Dict, device: torch.device):
        self.opt = opt
        self.device = torch.device(device)
        self.g = define_G(opt)
        self.trainer = None
        if not isinstance(self.g, self.g_types):
            which = opt["network_G"]["which_model_G"]
            runner = _RUNNERS.get(type(self.g))
            raise NotImplementedError(
                f"Model [{opt.get('model')}] does not take generator [{which}]"
                + (f": {runner}" if runner else ""))

    _world: Optional[dist.World] = None
    _spatial_shard: bool = False

    def prepare_mesh(self, world: dist.World, spatial_shard: bool = False):
        """Route inference over ``world``'s ranks (JAX's ``prepare_mesh``):
        with ``chop`` the tile batch fans out over them
        (``tiled_apply``); with ``spatial_shard`` the image's H axis is
        split over them with halo exchange (``spatially_sharded_apply``,
        halo 20, the chop's shave), where each rank's share of the rows holds
        the halo, else the image falls through to the other forwards. Every
        rank must load the same weights; this checks that it did."""
        world.check_replicated(self.g.state_dict().items(), "prepare_mesh")
        self._world, self._spatial_shard = world, bool(spatial_shard)
        return self

    def init(self, seed: Optional[int] = None):
        """Seeded weights (``train.manual_seed`` by default with a trainer,
        else 0) on the device; with a trainer, also its other networks and
        optimizers."""
        if self.trainer is not None:
            self.trainer.init_state(seed)
            return self
        self.g.init_weights(torch.Generator().manual_seed(seed or 0))
        self.g.to(self.device, memory_format=torch.channels_last).eval()
        return self

    def load(self):
        """G from ``pretrain_model_G``: a reference-named ``.pth`` of the
        port's generator, or the port's ``.pt`` (a ``{iter}.pt`` train
        state, or G's state dict alone)."""
        path = (self.opt.get("path") or {}).get("pretrain_model_G")
        if path:
            if path.endswith(".pt"):
                saved = torch.load(path, map_location="cpu", weights_only=True)
                self.g.load_state_dict(saved["G"]["net"] if "G" in saved else saved)
            elif path.endswith(".pth"):
                checkpoints.load_pth(self.g, path)
            else:
                raise NotImplementedError(
                    f"pretrain_model_G {path!r}: dasr_tpu_torch loads reference "
                    "*_G.pth files and its own {iter}.pt; orbax checkpoints are JAX-only"
                )
        return self

    def _apply_g(self, x, *cond):
        return self.g(x, *cond)

    def _cond_inputs(self, cond, h0: int, w0: int, n: int) -> tuple:
        """The condition of an h0 x w0 LR image as G's further inputs on
        the device, uploaded as the image's ``n``-th; a model whose G takes
        none refuses one."""
        if cond is not None:
            raise ValueError(f"model [{self.opt.get('model')}] takes no condition beside "
                             "the LR image")
        return ()

    @contextlib.contextmanager
    def _g_in_eval_mode(self):
        """G in eval mode for the block, then back in its own mode: a
        BatchNorm G serves and validates on its running statistics and
        leaves them, as the reference's ``test`` runs ``netG.eval()``. Each
        switch walks every module of G: with tracing on, a span
        ``serve.eval_mode``."""
        was_training = self.g.training
        with trace.span("serve.eval_mode"):
            self.g.eval()
        try:
            yield
        finally:
            with trace.span("serve.eval_mode"):
                self.g.train(was_training)

    def test(self, lr_img: np.ndarray, cond: Optional[np.ndarray] = None) -> np.ndarray:
        """One LR image (HWC, float [0, 1] or uint8), and its condition
        where G takes one -> SR image (HWC float32)."""
        return self.test_async(lr_img, cond).cpu().numpy()

    @torch.no_grad()
    def test_async(self, lr_img: np.ndarray, cond: Optional[np.ndarray] = None) -> torch.Tensor:
        """``test``'s SR image as an f32 HWC tensor on the device, without
        waiting for it (the CLIs read it back one image later); ``cond``:
        the image's condition, for a model whose G takes one
        (``_cond_inputs``). Counts ``serve.images``, the LR pixels served
        (``serve.image_lr_px``) and those forwarded, tile halos and pads
        included (``serve.tile_lr_px``); with tracing on
        (``utils/trace.py``) its parts are spans of the image's count:
        ``serve.upload`` (the copy to the card, the cast and the bucket pad,
        and the condition's upload nested in it), ``serve.forward`` (each
        forward's issue) and ``serve.crop``."""
        h0, w0 = lr_img.shape[0], lr_img.shape[1]
        n = trace.count("serve.images")
        trace.count("serve.image_lr_px", h0 * w0)
        scale = self.opt.get("scale", 4)
        with trace.span("serve.upload", n):
            x = torch.from_numpy(np.ascontiguousarray(lr_img))[None].permute(0, 3, 1, 2)
            x = x.to(self.device)
            if x.dtype == torch.uint8:
                x = x.float() / 255.0
            bucket = int(self.opt.get("pad_bucket") or 0)
            if bucket:
                bh = math.ceil(h0 / bucket) * bucket
                bw = math.ceil(w0 / bucket) * bucket
                x = pad_reflect(x, 0, bh - h0, 0, bw - w0)
            extra = self._cond_inputs(cond, h0, w0, n)

        def forward(t):
            trace.count("serve.tile_lr_px", t.shape[0] * t.shape[2] * t.shape[3])
            with trace.span("serve.forward", n):
                return self._apply_g(t, *extra)

        world = self._world
        with self._g_in_eval_mode():
            if self._spatial_shard and -(-x.shape[2] // world.size) >= SHARD_HALO:
                out = spatially_sharded_apply(x, forward, scale, SHARD_HALO, world)
            elif self.opt.get("chop") and h0 * w0 >= self.chop_threshold:
                if self.opt.get("chop_parity"):
                    out = forward_chop(x, scale, forward, min_size=320000)
                else:
                    out = tiled_apply(x, forward, scale=scale, tile=128, halo=16, world=world)
            else:
                out = forward(x)
        with trace.span("serve.crop", n):
            out = out[0, :, : scale * h0, : scale * w0]
            return out.permute(1, 2, 0).float()

    @torch.no_grad()
    def test_batch_async(self, lr_imgs) -> torch.Tensor:
        """One plain forward over a stack of same-shape LR images (HWC, float
        [0, 1] or uint8): their SR images as an f32 (B, H, W, C) tensor on
        the device, without waiting (srn_train's ``val_batch``). The chop
        and ``pad_bucket`` forwards stay per image."""
        x = torch.from_numpy(np.ascontiguousarray(np.stack(lr_imgs))).permute(0, 3, 1, 2)
        x = x.to(self.device)
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        with self._g_in_eval_mode():
            return self._apply_g(x).permute(0, 2, 3, 1).float()

    def _trainer(self):
        if self.trainer is None or self.trainer.state is None:
            raise RuntimeError(f"train_step needs a [{self.opt.get('model')}] model created "
                               "with is_train and init()")
        return self.trainer

    def _to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """A host batch (NHWC arrays or tensors, as the Loader gives them) as
        NCHW device tensors; uint8 images (``transfer_uint8``) are cast to
        f32 / 255 on the device."""
        dev = {}
        for k in self._batch_keys:
            v = torch.as_tensor(batch[k]).to(self.device, non_blocking=True)
            if v.dtype == torch.uint8 and k != "fake_w":
                v = v.float() / 255.0
            elif v.dtype != torch.float32:
                raise ValueError(f"train_step: {k} must be float32 in [0, 1] or uint8 images, "
                                 f"got {v.dtype}")
            dev[k] = v.permute(0, 3, 1, 2)
        return dev

    def train_step(self, batch: Dict) -> Dict[str, float]:
        """One step on a host batch; the metrics as floats."""
        return self.metrics_to_host(self._trainer().train_step(self._to_device(batch)))

    def train_multi_step(self, batches) -> Dict[str, float]:
        """K steps on a list of K host batches; the metrics' mean over K."""
        return self.metrics_to_host(self.train_multi_step_async(batches))

    def train_multi_step_async(self, batches) -> Dict[str, torch.Tensor]:
        """K steps on K host batches (a model whose ``supports_multi_step``
        holds: every step updates every network); the (K,) device metrics,
        unsynchronised (read them with ``metrics_to_host``)."""
        tr = self._trainer()
        steps = [tr.train_step(self._to_device(b)) for b in batches]
        return {k: torch.stack([m[k] for m in steps]) for k in steps[0]}

    def train_banked_window_async(self, idx: np.ndarray, seed: int) -> Dict[str, torch.Tensor]:
        """One (K, B) window of image indices (the DASR models' fake LRs, the
        paired models' pairs) on the banks ``setup_device_bank`` uploaded;
        ``seed``: the window's first iteration (a resumed run replays the
        stream). Returns the last step's device metrics, unsynchronised.
        With tracing on, the index row's pin and copy is the span
        ``window.upload``."""
        tr = self._trainer()
        with trace.span("window.upload", tr.state.step):
            idx = torch.from_numpy(np.ascontiguousarray(idx, np.int64))
            if self.device.type == "cuda":
                idx = idx.pin_memory()
            idx = idx.to(self.device, non_blocking=True)
        return tr.train_banked_step(self._banks, idx, seed, *self._bank_args)

    @staticmethod
    def metrics_to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Device metrics (0-d, or (K,) of a window: their mean) as floats,
        in one sync."""
        values = torch.stack([v.float().mean() for v in metrics.values()]).tolist()
        return dict(zip(metrics, values))

    @property
    def step(self) -> int:
        return self._trainer().state.step

    def save(self, ckpt_dir: str, iter_step: int) -> str:
        return checkpoints.save_train_state(ckpt_dir, self._trainer().state, iter_step)

    def resume(self, path: str) -> int:
        """Load a ``save`` file (``{iter}.pt``, or the latest in a directory)
        into the train state; returns its iteration."""
        return checkpoints.load_train_state(path, self._trainer().state)


def pixel_config(opt: Dict) -> PixelConfig:
    """PixelConfig from the options ('sr', 'De_Resnet'), with the JAX
    package's defaults."""
    train = opt.get("train") or {}
    return PixelConfig(lr_g=train.get("lr_G", 1e-4), beta1_g=train.get("beta1_G", 0.9),
                       lr_steps=tuple(int(m) for m in (train.get("lr_steps") or ())),
                       lr_gamma=train.get("lr_gamma", 0.5),
                       pixel_criterion=train.get("pixel_criterion", "l1"),
                       pixel_weight=train.get("pixel_weight", 1.0),
                       seed=int(train.get("manual_seed", 0) or 0))


class SRModel(_InferenceModel):
    """'sr' (reference: codes/SRN/models/SR_model.py): ``RRDB_net`` or
    ``sr_resnet`` served, with chop and the geometric self-ensemble
    ``test_x8``; with ``is_train``, trained on the pixel loss
    (``PixelTrainer``, LR -> HR) one step a call. ``pretrain_model_G``
    loads by the generator's reference names, so a reference ``sr_resnet``
    ``.pth`` loads too; ``dasr_tpu`` imports every ``.pth`` as an RRDB
    (``registry.py:311-313``, ROADMAP C.2)."""

    g_types = (RRDBNet, SRResNet)

    def __init__(self, opt: Dict, device: torch.device):
        super().__init__(opt, device)
        if opt.get("is_train"):
            self.trainer = self.make_trainer()

    def make_trainer(self):
        return PixelTrainer(pixel_config(self.opt), self.g, self.device, source="LR",
                            target="HR")

    @torch.no_grad()
    def test_x8(self, lr_img: np.ndarray) -> np.ndarray:
        """The mean of the eight dihedral forwards (SR_model.py:102-140): the
        LR image flipped and transposed on the host, each SR image turned
        back and summed on the device."""
        total = None
        for rot in range(2):
            for fh in range(2):
                for fv in range(2):
                    t = lr_img
                    if fv:
                        t = t[::-1, :, :]
                    if fh:
                        t = t[:, ::-1, :]
                    if rot:
                        t = t.transpose(1, 0, 2)
                    sr = self.test_async(np.ascontiguousarray(t))
                    if rot:
                        sr = sr.transpose(0, 1)
                    if fh:
                        sr = sr.flip(1)
                    if fv:
                        sr = sr.flip(0)
                    total = sr if total is None else total + sr
        return (total / 8).cpu().numpy()


def srgan_config(opt: Dict, ragan: bool = False) -> SRGANConfig:
    """SRGANConfig from the options ('srgan', 'srragan'), with the JAX
    package's defaults; ``ragan`` (the model 'srragan') or ``train.ragan``
    turns RaGAN on."""
    train = opt.get("train") or {}
    return SRGANConfig(
        lr_g=train.get("lr_G", 1e-4), lr_d=train.get("lr_D", 1e-4),
        beta1_g=train.get("beta1_G", 0.9), beta1_d=train.get("beta1_D", 0.9),
        lr_steps=tuple(int(m) for m in (train.get("lr_steps") or ())),
        lr_gamma=train.get("lr_gamma", 0.5),
        pixel_criterion=train.get("pixel_criterion", "l1"),
        pixel_weight=train.get("pixel_weight", 1e-2) or 0.0,
        feature_criterion=train.get("feature_criterion", "l1"),
        feature_weight=train.get("feature_weight", 1.0) or 0.0,
        gan_type=train.get("gan_type", "vanilla"),
        gan_weight=train.get("gan_weight", 5e-3),
        ragan=ragan or bool(train.get("ragan", False)),
        d_update_ratio=train.get("D_update_ratio", 1) or 1,
        d_init_iters=train.get("D_init_iters", 0) or 0,
        scale=opt.get("scale", 4),
        seed=int(train.get("manual_seed", 0) or 0),
        dtype=compute_dtype(opt),
    )


class SRGANModel(SRModel):
    """'srgan' / 'srragan' (reference: codes/SRN/models/SRGAN_model.py,
    SRRaGAN_model.py): G from ``define_G`` (``RRDB_net`` or ``sr_resnet``),
    D from ``define_D`` (``network_D.which_model_D``), the VGG19-54 feature
    net seeded; on host batches one step a call, D every step and G where
    ``SRGANTrainer.g_update_due`` holds for the 1-based iteration. Where the
    gate always holds and no step draws on the host
    (``srgan_trainer.single_step_reason`` is None: ``D_update_ratio`` 1,
    ``D_init_iters`` 0, not 'wgan-gp', as train_SRGAN.json ships),
    ``supports_multi_step`` holds: windows of K host batches, and windows
    drawn from the paired banks on the device (``setup_device_bank``,
    ``train_banked_window_async``; ``SRGANTrainer.train_banked_step``,
    replayed from a CUDA graph on the card). Two deviations from
    ``dasr_tpu`` (ROADMAP C.2): its ``SRGANModel`` trains a
    ``DiscriminatorVGG(input_size=HR_size)`` whatever ``which_model_D``
    names (``srgan_trainer.py:64-66``), and its gate counts iterations from
    0, so G skips the first step the reference updates it in."""

    def __init__(self, opt: Dict, device: torch.device, ragan: bool = False):
        self.ragan = ragan
        super().__init__(opt, device)

    @property
    def single_step_reason(self) -> Optional[str]:
        """Why this model trains one step a call, or None."""
        if self.trainer is None:
            return "the model was not built for training"
        return single_step_reason(self.trainer.cfg)

    @property
    def supports_multi_step(self) -> bool:
        return self.single_step_reason is None

    def setup_device_bank(self, lr_h, hr_h, hr_size: int, use_flip: bool = True,
                          use_rot: bool = True):
        """Upload the paired banks (``device_bank.ImageBank``s on the host,
        row i of one the pair of row i of the other) once, for
        ``train_banked_window_async``."""
        if not self.supports_multi_step:
            raise ValueError(f"--device_bank: {self.single_step_reason}")
        self._banks = device_bank.PairedBanks(device_bank.upload(lr_h, self.device),
                                              device_bank.upload(hr_h, self.device))
        self._bank_args = (hr_size, use_flip, use_rot)
        return self

    def make_trainer(self) -> SRGANTrainer:
        cfg = srgan_config(self.opt, self.ragan)
        d = define_D(self.opt)
        if isinstance(d, ACDVGGBN96):
            raise NotImplementedError(
                f"Model [{self.opt.get('model')}] with discriminator [dis_acd]: ACDVGGBN96 "
                "gives two heads (GAN and class), and the SRGAN step trains a one-headed D")
        return SRGANTrainer(cfg, self.g, d, self.device)

    def train_step(self, batch: Dict) -> Dict[str, float]:
        tr = self._trainer()
        return self.metrics_to_host(tr.train_step(
            self._to_device(batch), do_g=tr.g_update_due(tr.state.step + 1)))


class DegradationModel(_InferenceModel):
    """'De_Resnet' (reference: codes/SRN/models/Degradation_Resnet.py): a
    ``DeResnetSRN`` from ``define_G``, trained HR -> LR on the pixel loss
    (``PixelTrainer``) one step a call. ``test`` degrades the whole image it
    is given: ``chop`` and ``pad_bucket``, forwards of the x4 SR models,
    are refused. Validation feeds G the HR image and holds the
    result against the LR one (``val_keys``), where ``dasr_tpu``'s CLI feeds
    G the LR image and fails on the shapes. ``pretrain_model_G`` is loaded,
    as the reference loads it; ``dasr_tpu``'s ``DegradationModel.load``
    ignores it (``registry.py:777-778``, ROADMAP C.2)."""

    g_types = (DeResnetSRN,)
    val_keys = ("HR", "LR")

    def __init__(self, opt: Dict, device: torch.device):
        for key in ("chop", "pad_bucket"):
            if opt.get(key):
                raise ValueError(f"'{key}' is for the x4 SR models; model "
                                 f"[{opt.get('model')}] degrades the whole image")
        super().__init__(opt, device)
        if opt.get("is_train"):
            self.trainer = self.make_trainer()

    def make_trainer(self):
        return PixelTrainer(pixel_config(self.opt), self.g, self.device, source="HR",
                            target="LR")


def depatch_config(opt: Dict) -> DePatchConfig:
    """DePatchConfig from the options, with ``dasr_tpu``'s keys and defaults
    (its ``DePatchModel``, ``registry.py:919-944``): a ``gan_weight`` of 0
    trains at 0.005, and D is always ``FSDiscriminator('FSD')`` with
    InstanceNorm (see ``DePatchModel``)."""
    train = opt.get("train") or {}
    return DePatchConfig(
        lr_g=train.get("lr_G", 1e-4), lr_d=train.get("lr_D", 1e-4),
        beta1_g=train.get("beta1_G", 0.9), beta1_d=train.get("beta1_D", 0.9),
        lr_steps=tuple(int(m) for m in (train.get("lr_steps") or (100000,))),
        lr_gamma=train.get("lr_gamma", 0.5),
        norm=bool(train.get("norm", True)),
        pixel_criterion=train.get("pixel_criterion", "l1"),
        pixel_weight=train.get("pixel_weight", 1.0) or 0.0,
        feature_weight=train.get("feature_weight", 1.0) or 0.0,
        gan_weight=train.get("gan_weight", 0.005) or 0.005,
        seed=int(train.get("manual_seed", 0) or 0),
        dtype=compute_dtype(opt),
    )


class DePatchModel(DegradationModel):
    """'De_patch_wavelet_GAN' (reference: codes/SRN/models/
    DePatchGAN_wavelet_model.py): a De_Resnet-family G from ``define_G``,
    trained HR -> LR by ``DePatchTrainer`` against a patch D on the Haar
    high bands of real LR images (``ref``), one step a call; served and
    validated as 'De_Resnet' (G(HR) against the LR image). ``realness_map``
    gives D's receptive-field map of an LR image (``srn_test``'s
    ``save_RealorFake``).

    ``pretrain_model_G`` loads G (a ``.pth`` of the port's generator, or the
    port's ``{iter}.pt``, which also gives D); ``pretrain_model_D`` a
    ``.pth`` of the port's D. The train state saves to and resumes from the
    port's ``{iter}.pt``. ``dasr_tpu``'s model has no ``resume`` and loads
    neither file (ROADMAP C.2). As in ``dasr_tpu``, the config's
    ``network_D``, ``ragan``, ``gan_type`` and ``feature_criterion`` are not
    read (LPIPS is the feature loss whenever ``feature_weight`` > 0), and one
    line at construction names those the config sets."""

    _batch_keys = ("HR", "LR", "ref")

    def __init__(self, opt: Dict, device: torch.device):
        self.cfg = depatch_config(opt)
        self.d = make_d(self.cfg)
        train = opt.get("train") or {}
        unread = [f"{key} ({why})" for key, value, why in (
            ("network_D", opt.get("network_D"),
             "D is FSDiscriminator('FSD', InstanceNorm) on the 9 Haar high bands"),
            ("train.ragan", train.get("ragan"), "the DSN losses"),
            ("train.gan_type", train.get("gan_type"), "the DSN losses"),
            ("train.feature_criterion", train.get("feature_criterion"),
             "LPIPS whenever feature_weight > 0")) if value is not None]
        if train.get("gan_weight") == 0:
            unread.append("train.gan_weight 0 (trains at 0.005)")
        if unread:
            print(f"De_patch_wavelet_GAN: not read, as in dasr_tpu: {'; '.join(unread)}",
                  flush=True)
        super().__init__(opt, device)

    def make_trainer(self) -> DePatchTrainer:
        lpips = None
        if self.cfg.feature_weight > 0:
            lpips = default_lpips("alex", seed=self.cfg.seed, dtype=self.cfg.dtype,
                                  backbone_path=(self.opt.get("path") or {}).get("lpips_backbone"))
        return DePatchTrainer(self.cfg, self.g, self.d, self.device, lpips=lpips)

    def init(self, seed: Optional[int] = None):
        """Seeded weights on the device, D's too; with a trainer, also the
        optimizers."""
        if self.trainer is not None:
            self.trainer.init_state(seed)
            return self
        seed = seed or 0
        super().init(seed)
        init_lecun_(self.d, torch.Generator().manual_seed(seed + 1))
        self.d.to(self.device, memory_format=torch.channels_last).eval()
        return self

    def load(self):
        super().load()
        paths = self.opt.get("path") or {}
        g_path = paths.get("pretrain_model_G") or ""
        if g_path.endswith(".pt"):
            saved = torch.load(g_path, map_location="cpu", weights_only=True)
            self.d.load_state_dict(saved["D_target"]["net"])
        if paths.get("pretrain_model_D"):
            checkpoints.load_pth(self.d, paths["pretrain_model_D"])
        return self

    def realness_map(self, lr_img: np.ndarray) -> np.ndarray:
        """D's receptive-field map of one LR image (HWC, float [0, 1] or
        uint8): (h / 2, w / 2) f32 (JAX's ``DePatchModel.realness_map``)."""
        x = torch.from_numpy(np.ascontiguousarray(lr_img))[None].permute(0, 3, 1, 2)
        x = x.to(self.device)
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        return realness_map(self.d, x, self.cfg.norm)[0].cpu().numpy()


def srn_config(opt: Dict) -> SRNConfig:
    """SRNConfig from the options, with the JAX package's defaults."""
    train = opt.get("train") or {}
    net_g = opt.get("network_G") or {}
    net_d = opt.get("network_D") or {}
    return SRNConfig(
        scale=opt.get("scale", 4),
        nf=net_g.get("nf", 64), nb=net_g.get("nb", 23), gc=net_g.get("gc", 32),
        d_in_nc=net_d.get("in_nc", 9), d_nf=net_d.get("nf", 64),
        d_n_layers=net_d.get("n_layers", 2),
        lr_g=train.get("lr_G", 1e-4), lr_d=train.get("lr_D", 1e-4),
        beta1_g=train.get("beta1_G", 0.9), beta1_d=train.get("beta1_D", 0.9),
        lr_steps=tuple(int(m) for m in (train.get("lr_steps") or (35000, 80000, 100000, 150000))),
        lr_gamma=train.get("lr_gamma", 0.5),
        fs=train.get("fs", "wavelet"),
        fs_kernel_size=train.get("fs_kernel_size", 5) or 5,
        norm=bool(train.get("norm", True)),
        sup_LL=bool(train.get("sup_LL", True)),
        pixel_weight=train.get("pixel_weight", 1.0),
        pixel_LL_weight=train.get("pixel_LL_weight", 1.0),
        pixel_criterion=train.get("pixel_criterion", "l1"),
        feature_criterion=train.get("feature_criterion", "LPIPS"),
        feature_weight=train.get("feature_weight", 1.0),
        gan_type=train.get("gan_type", "vanilla"),
        ragan=bool(train.get("ragan", False)),
        gan_H_target=train.get("gan_H_target", 0.005),
        gan_H_source=train.get("gan_H_source", 0.0) or 0.0,
        multiweights=bool(opt.get("multiweights", True)),
        g_update_inter=train.get("G_update_inter", 1) or 1,
        d_update_inter=train.get("D_update_inter", 1) or 1,
        seed=int(train.get("manual_seed", 0) or 0),
        dtype=compute_dtype(opt),
    )


class DASRModel(_InferenceModel):
    """'DASR' (reference: codes/SRN/models/DASR_model.py). Without
    ``is_train`` it holds the generator for inference; with it, an
    ``SRNTrainer`` around the same generator, its discriminators, LPIPS
    and optimizers (the reference's ``optimize_parameters``)."""

    chop_threshold = 320000  # DASR_model.py:337
    _batch_keys = ("LR_fake", "LR_real", "HR", "HR_unpair", "fake_w")

    def __init__(self, opt: Dict, device: torch.device):
        super().__init__(opt, device)
        if opt.get("is_train"):
            self.trainer = self.make_trainer()

    def _lpips(self, cfg: SRNConfig):
        if cfg.feature_weight > 0 and cfg.feature_criterion == "LPIPS":
            return default_lpips("alex", seed=cfg.seed, dtype=cfg.dtype,
                                 backbone_path=(self.opt.get("path") or {}).get("lpips_backbone"))
        return None

    def make_trainer(self) -> SRNTrainer:
        cfg = srn_config(self.opt)
        return SRNTrainer(cfg, self.device, g_model=self.g, lpips=self._lpips(cfg))

    def load(self):
        """The ``pretrain_model_*`` ``.pth`` files (``check_resume`` points
        them at a reference ``{iter}.state``'s networks), then, for a
        ``resume_state`` ending in ``.state``, its Adam states and iteration
        (``resume_reference_state``)."""
        paths = self.opt.get("path") or {}
        if self.trainer is None:
            for key in ("pretrain_model_D_target", "pretrain_model_D_source"):
                if paths.get(key):
                    logger.info(f"{key} not loaded: the inference facade holds G only")
            return super().load()
        super().load()
        st = self.trainer.state
        for key, net in (("pretrain_model_D_target", st.d_target),
                         ("pretrain_model_D_source", st.d_source)):
            if paths.get(key) and net is not None:
                checkpoints.load_pth(net.net, paths[key])
        rstate = paths.get("resume_state") or ""
        if rstate.endswith(".state"):
            self.resume_reference_state(rstate)
        return self

    def resume_reference_state(self, path: str) -> int:
        """Resume from a reference ``{iter}.state`` (base_model.py:76-86; the
        port of ``dasr_tpu``'s ``DASRModel.resume_reference_state``): its
        ``optimizers`` list, zipped over (G, D_target, D_source), gives each
        network this config has its Adam moments and its own update count
        (``checkpoints.import_adam_state``); ``iter`` gives the step.
        Returns the step."""
        saved = checkpoints.load_reference_training_state(path)
        st = self._trainer().state
        for ns, adam_sd in zip((st.g, st.d_target, st.d_source), saved.get("optimizers", [])):
            if ns is not None:
                checkpoints.import_adam_state(ns, adam_sd)
        st.step = int(saved.get("iter", 0))
        return st.step

    def train_step(self, batch: Dict) -> Dict[str, float]:
        """One step on a host batch, with the reference's G/D update cadence
        (DASR_model.py; ``G_update_inter``/``D_update_inter``). Returns the
        metrics as floats."""
        tr = self._trainer()
        c = tr.cfg
        step = tr.state.step
        metrics = tr.train_step(self._to_device(batch), do_g=step % c.g_update_inter == 0,
                                do_d=step % c.d_update_inter == 0)
        return self.metrics_to_host(metrics)

    @property
    def supports_multi_step(self) -> bool:
        """Windows of K steps need G and D to update every step (the DASR
        default, ``G_update_inter`` = ``D_update_inter`` = 1)."""
        c = self._trainer().cfg
        return c.g_update_inter == 1 and c.d_update_inter == 1

    def setup_device_bank(self, fake_h, hr_h, real_h, ddm_h, hr_size: int,
                          use_flip: bool = True, use_rot: bool = True):
        """Upload the stage-3 banks (``device_bank.ImageBank``s on the host;
        ``ddm_h`` None where weights are computed online) once, for
        ``train_banked_window_async``."""
        if not self.supports_multi_step:
            raise ValueError("--device_bank needs G_update_inter == D_update_inter == 1")
        self._banks = device_bank.SrnBanks(*(device_bank.upload(b, self.device)
                                             for b in (fake_h, hr_h, real_h, ddm_h)))
        self._bank_args = (hr_size, use_flip, use_rot)
        return self

    def save_reference_formats(self, out_dir: str, iter_step: int) -> str:
        return checkpoints.save_reference_formats(out_dir, self._trainer().state, iter_step)


def adaptive_config(opt: Dict) -> AdaptiveConfig:
    """AdaptiveConfig from the options, with the JAX package's keys and
    defaults but one: the DDM switch is read from the shipped configs' key
    ``use_domain_distance_map``, then from ``adaptive_weights``, the only key
    ``dasr_tpu`` reads (``registry.py:836``), where a shipped config's
    ``false`` is ignored (ROADMAP C.2)."""
    train = opt.get("train") or {}
    net_g = opt.get("network_G") or {}
    net_d = opt.get("network_D") or {}
    switch = next((opt[k] for k in ("use_domain_distance_map", "adaptive_weights")
                   if opt.get(k) is not None), True)
    return AdaptiveConfig(
        scale=opt.get("scale", 4),
        nf=net_g.get("nf", 64), nb=net_g.get("nb", 23), gc=net_g.get("gc", 32),
        d_in_nc=net_d.get("in_nc", 9), d_nf=net_d.get("nf", 64),
        d_n_layers=net_d.get("n_layers", 2),
        lr_g=train.get("lr_G", 1e-4), lr_d=train.get("lr_D", 1e-4),
        beta1_g=train.get("beta1_G", 0.9), beta1_d=train.get("beta1_D", 0.9),
        lr_steps=tuple(int(m) for m in (train.get("lr_steps") or (35000,))),
        lr_gamma=train.get("lr_gamma", 0.5),
        fs=train.get("fs", "wavelet"),
        norm=bool(train.get("norm", True)),
        sup_LL=bool(train.get("sup_LL", True)),
        pixel_weight=train.get("pixel_weight", 1.0),
        pixel_LL_weight=train.get("pixel_LL_weight", 1.0),
        feature_criterion=train.get("feature_criterion", "LPIPS"),
        feature_weight=train.get("feature_weight", 1.0),
        gan_type=train.get("gan_type", "vanilla"),
        ragan=bool(train.get("ragan", False)),
        gan_H_target=train.get("gan_H_target", 0.005),
        use_domain_distance_map=bool(switch),
        use_patchD_opt=bool(train.get("use_patchD_opt", False)),
        seed=int(train.get("manual_seed", 0) or 0),
        dtype=compute_dtype(opt),
    )


def patchd_tar_path(opt: Dict) -> Optional[str]:
    """The patch D's DSN ``.tar``: the shipped configs' key
    ``path.Patch_Discriminator``, then ``path.pretrain_model_patchD``, the
    only key ``dasr_tpu`` reads (``registry.py:845``), so that with a
    shipped config it serves and trains from a random patch D (ROADMAP
    C.2)."""
    paths = opt.get("path") or {}
    return paths.get("Patch_Discriminator") or paths.get("pretrain_model_patchD")


class DASRAdaptiveModel(DASRModel):
    """'DASR_Adaptive_Model' (reference: codes/SRN/models/
    DASR_Adaptive_model.py): the DDM computed online by the patch D
    (``self.patchd``, ``define_patchD``) conditions the generator
    (``define_G``; ``RRDB_Residual_conv[_concat]``, the ones ``dasr_tpu``
    trains). Without ``is_train`` it serves; with it, a ``DASRAdaptiveTrainer``
    around the same two modules. The step has no G/D update cadence, so
    windows of K steps and the device bank (``LRHR_unpair``, no DDM bank)
    always serve. Its train state (the patch D's included) saves to and
    resumes from the port's ``{iter}.pt``; ``dasr_tpu`` has no reference
    formats for this model, and ``srn_train`` refuses them."""

    _batch_keys = ("LR_fake", "LR_real", "HR", "HR_unpair")
    g_types = (RRDBNetResidualConv,)

    def __init__(self, opt: Dict, device: torch.device):
        self.cfg = adaptive_config(opt)
        self.patchd = define_patchD(opt)
        super().__init__(opt, device)

    def make_trainer(self) -> DASRAdaptiveTrainer:
        return DASRAdaptiveTrainer(self.cfg, self.g, self.patchd, self.device,
                                   lpips=self._lpips(self.cfg))

    def init(self, seed: Optional[int] = None):
        """Seeded weights on the device (the patch D's too); with a trainer,
        also the discriminators and optimizers."""
        if self.trainer is not None:
            self.trainer.init_state(seed)
            return self
        seed = seed or 0
        super().init(seed)
        init_lecun_(self.patchd, torch.Generator().manual_seed(seed + 1))
        self.patchd.to(self.device, memory_format=torch.channels_last).eval()
        return self

    def load(self):
        """G from ``pretrain_model_G`` (a ``.pth`` of the port's generator, or
        the port's ``{iter}.pt`` train state), the patch D from its DSN
        ``.tar`` (``patchd_tar_path``); with no ``.tar`` the patch D keeps
        its fresh init, as in ``dasr_tpu``, and one line says so."""
        _InferenceModel.load(self)
        tar = patchd_tar_path(self.opt)
        if tar:
            if not tar.endswith(".tar"):
                raise ValueError(f"the patch D's checkpoint {tar!r} is not a DSN .tar")
            checkpoints.load_patchd_tar(self.patchd, tar)
            print(f"patch D: loaded from {tar}", flush=True)
        else:
            print("patch D: no DSN .tar under path.Patch_Discriminator or "
                  "path.pretrain_model_patchD; the DDM comes from a fresh patch D init",
                  flush=True)
        return self

    def _apply_g(self, x):
        return self.g(x, self.patchd(x))


class SFTGANModel(_InferenceModel):
    """'sftgan' (reference: codes/SRN/test_sftgan.py; Wang et al., CVPR
    2018): serves 'sft_arch' (``SFTNet``) on an LR image and its
    segmentation probability maps, through the facade's one ``test_async``
    (``test_async(lr_img, seg)``). The maps are uploaded in f32, as the
    reference's test script hands them to the net, and cast on the device
    to the working dtype (span ``serve.cond_upload``, nested in
    ``serve.upload``; counter ``serve.cond_bytes``, the bytes copied).

    Refused by name: ``is_train`` (DASR ships no SFTGAN trainer, and no
    model trains 'dis_acd''s two heads), ``chop`` and ``pad_bucket`` (the
    condition is not tiled or padded), and a ``scale`` other than SFTNet's
    4. ``pretrain_model_G`` is a reference ``SFTGAN_*.pth`` (the
    reference's names) or the port's ``.pt``."""

    g_types = (SFTNet,)

    def __init__(self, opt: Dict, device: torch.device):
        for key, why in (("is_train", "DASR ships no SFTGAN trainer, and no model trains "
                                      "dis_acd's two heads"),
                         ("chop", "the segmentation maps are not tiled"),
                         ("pad_bucket", "the segmentation maps are not padded")):
            if opt.get(key):
                raise ValueError(f"'{key}' is refused by model [sftgan]: {why}")
        if opt.get("scale", 4) != 4:
            raise ValueError(f"'scale' {opt['scale']}: SFTNet is x4")
        super().__init__(opt, device)

    def _cond_inputs(self, seg, h0: int, w0: int, n: int) -> tuple:
        """The maps of an h0 x w0 LR image (CHW or HWC, at 4 h0 x 4 w0, as
        ``sftgan_test.load_seg`` gives them) as SFTNet's NCHW ``seg`` on the
        device in its working dtype."""
        if seg is None:
            raise ValueError("model [sftgan] serves an LR image with its segmentation maps: "
                             "test_async(lr_img, seg)")
        c, hw = self.g.CondNet[0].in_channels, (4 * h0, 4 * w0)
        shape = tuple(seg.shape)
        if shape not in ((c,) + hw, hw + (c,)):
            raise ValueError(f"segmentation maps of shape {shape}: an LR image of {h0}x{w0} "
                             f"takes ({c}, {hw[0]}, {hw[1]}) or ({hw[0]}, {hw[1]}, {c})")
        with trace.span("serve.cond_upload", n):
            t = torch.from_numpy(np.ascontiguousarray(seg))
            trace.count("serve.cond_bytes", t.numel() * t.element_size())
            t = t if shape[0] == c else t.permute(2, 0, 1)
            return (t[None].to(self.device).to(self.g.dtype),)


# the models whose training JAX shards over its mesh's 'data' axis
# (dasr_tpu/models/registry.py:create_model); the others train on one rank
SHARDED_MODELS = ("DASR", "DASR_Adaptive_Model", "srgan", "srragan")


def create_model(opt: Dict, device: torch.device = torch.device("cpu")):
    """Trainer registry (reference: codes/SRN/models/__init__.py:5-26). A
    model JAX does not shard is refused for training in a world of several
    ranks."""
    model = opt.get("model")
    size = dist.current().size
    if opt.get("is_train") and size > 1 and model not in SHARDED_MODELS:
        raise NotImplementedError(
            f"Model [{model}] trains on one rank (dasr_tpu shards only "
            f"{', '.join(SHARDED_MODELS)} over its mesh); this process is one of {size}")
    if model == "DASR":
        return DASRModel(opt, device)
    if model == "DASR_Adaptive_Model":
        return DASRAdaptiveModel(opt, device)
    if model == "sr":
        return SRModel(opt, device)
    if model in ("srgan", "srragan"):
        return SRGANModel(opt, device, ragan=model == "srragan")
    if model == "De_Resnet":
        return DegradationModel(opt, device)
    if model == "De_patch_wavelet_GAN":
        return DePatchModel(opt, device)
    if model == "sftgan":
        return SFTGANModel(opt, device)
    raise NotImplementedError(f"Model [{model}] not recognized.")
