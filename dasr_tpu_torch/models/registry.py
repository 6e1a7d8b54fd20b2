"""Model registry — the inference facades of the serving path.

Counterpart of ``dasr_tpu.models.registry``: ``create_model(opt)`` keyed
like the reference (codes/SRN/models/__init__.py:5-26) and ``define_G``
(codes/SRN/models/networks.py:83-147). Ported so far: the generator side of
'sr' (``SRModel``) and 'DASR' (``DASRModel``) with ``RRDB_net``; any other
model, and any training call, raises ``NotImplementedError`` naming its
ROADMAP queue item.
"""

from __future__ import annotations

import logging
import math
from typing import Dict

import numpy as np
import torch

from dasr_tpu_torch.nn.generators import RRDBNet
from dasr_tpu_torch.ops.tiled import forward_chop, pad_reflect, tiled_apply
from dasr_tpu_torch.train import checkpoints

logger = logging.getLogger("base")

_TRAINERS = ("srgan", "srragan", "De_Resnet", "De_patch_wavelet_GAN", "DASR_Adaptive_Model")
_GENERATORS = (
    "sr_resnet", "De_Resnet", "De_RRDB", "De_Resnet_bilinear", "De_Resnet2xd", "DSGAN",
    "RRDB_SEAN", "RRDB_Residual_conv", "RRDB_Residual_conv_concat", "sft_arch",
)


def compute_dtype(opt: Dict) -> torch.dtype:
    """bf16 activations with f32 params unless the options say ``"bf16": false``."""
    return torch.bfloat16 if opt.get("bf16", True) else torch.float32


def define_G(opt: Dict) -> RRDBNet:
    """Build the generator module from a network_G config block."""
    net = opt["network_G"]
    which = net["which_model_G"]
    if which in ("RRDB_net", "RRDB_mask"):
        return RRDBNet(
            in_nc=net.get("in_nc", 3), out_nc=net.get("out_nc", 3),
            nf=net.get("nf", 64), nb=net.get("nb", 23), gc=net.get("gc", 32),
            upscale=opt.get("scale", 4), norm_type=net.get("norm_type"),
            fused_tail=bool(net.get("fused_tail")), scan_blocks=bool(net.get("scan_blocks")),
            dtype=compute_dtype(opt),
        )
    if which in _GENERATORS:
        raise NotImplementedError(
            f"Generator model [{which}] is not ported yet (ROADMAP A.7 / A.9)"
        )
    raise NotImplementedError(f"Generator model [{which}] not recognized")


class _InferenceModel:
    """G-only inference facade (the ``_InferenceMixin`` logic of dasr_tpu),
    honouring the reference's chop flag.

    ``chop`` semantics per trainer: SRModel chops whenever the flag is set
    (codes/SRN/models/SR_model.py:88-100); the DASR trainer only above
    320k input pixels (DASR_model.py:337), exposed as ``chop_threshold``.
    ``chop_parity`` selects the reference's recursive chopper, otherwise
    ``tiled_apply`` runs 128-px tiles with a 16-px halo. ``pad_bucket: N``
    reflect-pads inputs up to multiples of N and crops after."""

    chop_threshold: int = 0

    def __init__(self, opt: Dict, device: torch.device):
        self.opt = opt
        self.device = torch.device(device)
        self.g = define_G(opt)

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
            checkpoints.load_rrdbnet_pth(self.g, path)
        return self

    def _apply_g(self, x):
        return self.g(x)

    @torch.no_grad()
    def test(self, lr_img: np.ndarray) -> np.ndarray:
        """One LR image (HWC, float [0, 1] or uint8) -> SR image (HWC float32)."""
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
        return out.permute(1, 2, 0).float().cpu().numpy()

    def train_step(self, batch):
        raise NotImplementedError(self._train_todo)


class SRModel(_InferenceModel):
    """'sr' (reference: codes/SRN/models/SR_model.py): G-only inference."""

    _train_todo = "the 'sr' trainer is not ported yet (ROADMAP A.9)"


class DASRModel(_InferenceModel):
    """'DASR' (reference: codes/SRN/models/DASR_model.py): its generator for
    inference. The discriminators belong to training."""

    chop_threshold = 320000  # DASR_model.py:337
    _train_todo = "the DASR train step is not ported yet (ROADMAP A.4)"

    def load(self):
        paths = self.opt.get("path") or {}
        if paths.get("resume_state"):
            raise NotImplementedError(
                "resume_state is a training state; resuming is not ported yet (ROADMAP A.5)"
            )
        for key in ("pretrain_model_D_target", "pretrain_model_D_source"):
            if paths.get(key):
                logger.info(f"{key} not loaded: the inference facade holds G only")
        return super().load()


def create_model(opt: Dict, device: torch.device = torch.device("cpu")):
    """Trainer registry (reference: codes/SRN/models/__init__.py:5-26)."""
    model = opt.get("model")
    if opt.get("is_train"):
        raise NotImplementedError(
            f"training [{model}] is not ported yet (ROADMAP A.4); "
            "dasr_tpu_torch serves inference only"
        )
    if model == "sr":
        return SRModel(opt, device)
    if model == "DASR":
        return DASRModel(opt, device)
    if model in _TRAINERS:
        raise NotImplementedError(f"Model [{model}] is not ported yet (ROADMAP A.9)")
    raise NotImplementedError(f"Model [{model}] not recognized.")
