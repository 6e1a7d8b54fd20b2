"""Model registry — the facades of the serving and training paths.

Counterpart of ``dasr_tpu.models.registry``: ``create_model(opt)`` keyed
like the reference (codes/SRN/models/__init__.py:5-26) and ``define_G``
(codes/SRN/models/networks.py:83-147). Ported so far: inference of 'sr'
(``SRModel``) and 'DASR' (``DASRModel``) with ``RRDB_net``, and the DASR
trainer (``DASRModel`` with ``is_train``): host batches one step or a
window at a time, uint8 batches cast on the device, and windows sampled
from device-resident banks (``setup_device_bank``,
``train_banked_window_async``), resumed from the port's own ``{iter}.pt``
(``resume``) or a reference ``{iter}.state`` (``resume_reference_state``);
and 'DASR_Adaptive_Model' (``DASRAdaptiveModel``), serving and training
its DDM-conditioned generator. Any other model, trainer, or model and
generator pair raises
``NotImplementedError`` naming its ROADMAP queue item.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Optional

import numpy as np
import torch

from dasr_tpu_torch.data import device_bank
from dasr_tpu_torch.losses.lpips import default_lpips
from dasr_tpu_torch.nn.layers import init_lecun_
from dasr_tpu_torch.nn.discriminators import FSDiscriminator
from dasr_tpu_torch.nn.generators import RRDBNet, RRDBNetResidualConv, RRDBNetSEAN
from dasr_tpu_torch.ops.tiled import forward_chop, pad_reflect, tiled_apply
from dasr_tpu_torch.train import checkpoints
from dasr_tpu_torch.train.dasr_adaptive_trainer import AdaptiveConfig, DASRAdaptiveTrainer
from dasr_tpu_torch.train.srn_trainer import SRNConfig, SRNTrainer

logger = logging.getLogger("base")

_TRAINERS = ("srgan", "srragan", "De_Resnet", "De_patch_wavelet_GAN")
_GENERATORS = (
    "sr_resnet", "De_Resnet", "De_RRDB", "De_Resnet_bilinear", "De_Resnet2xd", "DSGAN",
    "sft_arch",
)


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
    if which in _GENERATORS:
        raise NotImplementedError(
            f"Generator model [{which}] is not ported yet (ROADMAP A.9)"
        )
    raise NotImplementedError(f"Generator model [{which}] not recognized")


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
    honouring the reference's chop flag.

    ``chop`` semantics per trainer: SRModel chops whenever the flag is set
    (codes/SRN/models/SR_model.py:88-100); the DASR trainer only above
    320k input pixels (DASR_model.py:337), exposed as ``chop_threshold``.
    ``chop_parity`` selects the reference's recursive chopper, otherwise
    ``tiled_apply`` runs 128-px tiles with a 16-px halo. ``pad_bucket: N``
    reflect-pads inputs up to multiples of N and crops after.

    ``g_types``: the generators the model feeds; ``define_G`` builds the
    DDM-conditioned ones too, which only ``DASRAdaptiveModel`` feeds a map."""

    chop_threshold: int = 0
    g_types: tuple = (RRDBNet,)

    def __init__(self, opt: Dict, device: torch.device):
        self.opt = opt
        self.device = torch.device(device)
        self.g = define_G(opt)
        if not isinstance(self.g, self.g_types):
            raise NotImplementedError(
                f"Model [{opt.get('model')}] with generator "
                f"[{opt['network_G']['which_model_G']}] is not ported yet (ROADMAP A.9)")

    def init(self, seed: int = 0):
        """Seeded random weights in the JAX init's law, then move to the device."""
        self.g.init_weights(torch.Generator().manual_seed(seed))
        self.g.to(self.device, memory_format=torch.channels_last).eval()
        return self

    def load(self):
        path = (self.opt.get("path") or {}).get("pretrain_model_G")
        if path:
            if not path.endswith(".pth"):
                raise NotImplementedError(
                    f"pretrain_model_G {path!r}: dasr_tpu_torch loads reference "
                    "*_G.pth files; orbax checkpoints are JAX-only"
                )
            checkpoints.load_pth(self.g, path)
        return self

    def _apply_g(self, x):
        return self.g(x)

    def test(self, lr_img: np.ndarray) -> np.ndarray:
        """One LR image (HWC, float [0, 1] or uint8) -> SR image (HWC float32)."""
        return self.test_async(lr_img).cpu().numpy()

    @torch.no_grad()
    def test_async(self, lr_img: np.ndarray) -> torch.Tensor:
        """``test``'s SR image as an f32 HWC tensor on the device, without
        waiting for it (the CLIs read it back one image later)."""
        h0, w0 = lr_img.shape[0], lr_img.shape[1]
        x = torch.from_numpy(np.ascontiguousarray(lr_img))[None].permute(0, 3, 1, 2)
        x = x.to(self.device)
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        scale = self.opt.get("scale", 4)
        bucket = int(self.opt.get("pad_bucket") or 0)
        if bucket:
            bh = math.ceil(h0 / bucket) * bucket
            bw = math.ceil(w0 / bucket) * bucket
            x = pad_reflect(x, 0, bh - h0, 0, bw - w0)
        if self.opt.get("chop") and h0 * w0 >= self.chop_threshold:
            if self.opt.get("chop_parity"):
                out = forward_chop(x, scale, self._apply_g, min_size=320000)
            else:
                out = tiled_apply(x, self._apply_g, scale=scale, tile=128, halo=16)
        else:
            out = self._apply_g(x)
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
        return self._apply_g(x).permute(0, 2, 3, 1).float()

    def train_step(self, batch):
        raise NotImplementedError(self._train_todo)


class SRModel(_InferenceModel):
    """'sr' (reference: codes/SRN/models/SR_model.py): G-only inference."""

    _train_todo = "the 'sr' trainer is not ported yet (ROADMAP A.9)"


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
        self.trainer: Optional[SRNTrainer] = None
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

    def init(self, seed: Optional[int] = None):
        """Seeded weights (``train.manual_seed`` by default) on the device;
        with a trainer, also the discriminators and optimizers."""
        if self.trainer is None:
            return super().init(seed or 0)
        self.trainer.init_state(seed)
        return self

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

    def _trainer(self) -> SRNTrainer:
        if self.trainer is None or self.trainer.state is None:
            raise RuntimeError("train_step needs a DASR model created with is_train and init()")
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

    def train_multi_step(self, batches) -> Dict[str, float]:
        """K steps on a list of K host batches; the metrics' mean over K."""
        return self.metrics_to_host(self.train_multi_step_async(batches))

    def train_multi_step_async(self, batches) -> Dict[str, torch.Tensor]:
        """K steps on K host batches; the (K,) device metrics, unsynchronised
        (read them with ``metrics_to_host``)."""
        tr = self._trainer()
        steps = [tr.train_step(self._to_device(b)) for b in batches]
        return {k: torch.stack([m[k] for m in steps]) for k in steps[0]}

    @staticmethod
    def metrics_to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Device metrics (0-d, or (K,) of a window: their mean) as floats,
        in one sync."""
        values = torch.stack([v.float().mean() for v in metrics.values()]).tolist()
        return dict(zip(metrics, values))

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

    def train_banked_window_async(self, fake_idx: np.ndarray, seed: int) -> Dict[str, torch.Tensor]:
        """One (K, B) window of fake-LR indices on the device banks; ``seed``:
        the window's first iteration (a resumed run replays the stream).
        Returns the last step's device metrics, unsynchronised."""
        idx = torch.from_numpy(np.ascontiguousarray(fake_idx, np.int64))
        if self.device.type == "cuda":
            idx = idx.pin_memory()
        idx = idx.to(self.device, non_blocking=True)
        return self._trainer().train_banked_step(self._banks, idx, seed, *self._bank_args)

    @property
    def step(self) -> int:
        return self._trainer().state.step

    def save(self, ckpt_dir: str, iter_step: int) -> str:
        return checkpoints.save_train_state(ckpt_dir, self._trainer().state, iter_step)

    def resume(self, path: str) -> int:
        """Load a ``save`` file (``{iter}.pt``, or the latest in a directory)
        into the train state; returns its iteration."""
        return checkpoints.load_train_state(path, self._trainer().state)

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
        paths = self.opt.get("path") or {}
        g_path = paths.get("pretrain_model_G")
        if g_path:
            if g_path.endswith(".pt"):
                saved = torch.load(g_path, map_location="cpu", weights_only=True)
                self.g.load_state_dict(saved["G"]["net"])
            else:
                checkpoints.load_pth(self.g, g_path)
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


def create_model(opt: Dict, device: torch.device = torch.device("cpu")):
    """Trainer registry (reference: codes/SRN/models/__init__.py:5-26)."""
    model = opt.get("model")
    if model == "DASR":
        return DASRModel(opt, device)
    if model == "DASR_Adaptive_Model":
        return DASRAdaptiveModel(opt, device)
    if model == "sr":
        if opt.get("is_train"):
            raise NotImplementedError(SRModel._train_todo)
        return SRModel(opt, device)
    if model in _TRAINERS:
        raise NotImplementedError(f"Model [{model}] is not ported yet (ROADMAP A.9)")
    raise NotImplementedError(f"Model [{model}] not recognized.")
