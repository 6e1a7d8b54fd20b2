"""LPIPS (Learned Perceptual Image Patch Similarity), 'net-lin' alex.

Counterpart of ``dasr_tpu.losses.lpips`` (reference:
codes/PerceptualSimilarity/models/networks_basic.py:27-111): scaling layer
-> one backbone pass over both images -> unit-normalise each tap (the norm
taken in f32) -> squared difference -> learned 1x1 head per tap, in f32 ->
spatial mean -> sum over taps. NCHW inputs in [-1, 1], or [0, 1] with
``normalize=True``.

Weights: the per-tap heads ship with the reference as small ``.pth`` files
(``codes/PerceptualSimilarity/models/weights/v0.1/alex.pth``); the
backbone is a torchvision AlexNet state dict. Neither is in this
repository. ``default_lpips`` reads the heads from the directory named by
``DASR_TPU_LPIPS_LIN`` (the reference's ``models/weights``) and the
backbone from ``path.lpips_backbone`` or ``DASR_TPU_LPIPS_BACKBONE`` when
they exist, and otherwise keeps the seeded init (heads at 1/C, a random
backbone), as the JAX package does; it logs which. The 'vgg' and
'squeeze' nets wait for ROADMAP A.10.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.nn as nn

from dasr_tpu_torch.nn.layers import lecun_normal_
from dasr_tpu_torch.nn.vgg import AlexNetFeatures, load_torchvision_features
from dasr_tpu_torch.ops.resize import bilinear_resize

logger = logging.getLogger("base")

# ScalingLayer constants (networks_basic.py:94-101)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_CHNS = {"alex": (64, 192, 384, 256, 256)}


def _normalize(feat, eps=1e-10):
    norm = torch.sqrt(torch.sum(feat.float() ** 2, dim=1, keepdim=True))
    return feat / (norm + eps).to(feat.dtype)


class LPIPS(nn.Module):
    """net-lin LPIPS. ``dtype`` is the backbone's compute type (the heads
    and the normalisation run in f32). Heads are the parameters
    ``lin{k}`` of shape (C,)."""

    def __init__(self, net: str = "alex", use_lins: bool = True, spatial: bool = False,
                 version: str = "0.1", dtype: torch.dtype = torch.float32):
        super().__init__()
        if net not in _CHNS:
            raise NotImplementedError(f"LPIPS net [{net}] is not ported yet (ROADMAP A.10)")
        self.net, self.use_lins, self.spatial, self.version = net, use_lins, spatial, version
        self.dtype = dtype
        self.backbone = AlexNetFeatures()
        for k, c in enumerate(_CHNS[net]):
            self.register_parameter(f"lin{k}", nn.Parameter(torch.full((c,), 1.0 / c)))

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """The JAX init's law: lecun-normal backbone convs, zero biases,
        heads at 1/C."""
        with torch.no_grad():
            for conv in self.backbone.stack.convs():
                lecun_normal_(conv.weight, generator)
                conv.bias.zero_()
            for k, c in enumerate(_CHNS[self.net]):
                getattr(self, f"lin{k}").fill_(1.0 / c)
        return self

    def forward(self, in0, in1, normalize: bool = False):
        """(B, 1, 1, 1) distances, or (B, 1, H, W) when ``spatial``."""
        if normalize:
            in0, in1 = 2 * in0 - 1, 2 * in1 - 1
        if self.version == "0.1":
            shift = torch.tensor(_SHIFT, device=in0.device).view(1, 3, 1, 1)
            scale = torch.tensor(_SCALE, device=in0.device).view(1, 3, 1, 1)
            in0, in1 = (in0 - shift) / scale, (in1 - shift) / scale
        b = in0.shape[0]
        # an input under 32 px per side makes torch's max pool raise "Output
        # size is too small", as the reference's backbone does
        taps = self.backbone(torch.cat([in0.to(self.dtype), in1.to(self.dtype)]))
        total = None
        for k, feat in enumerate(taps):
            diff = ((_normalize(feat[:b]) - _normalize(feat[b:])) ** 2).float()
            if self.use_lins:
                d = (diff * getattr(self, f"lin{k}").view(1, -1, 1, 1)).sum(1, keepdim=True)
            else:
                d = diff.sum(1, keepdim=True)
            if self.spatial:
                d = bilinear_resize(d, in0.shape[-2], in0.shape[-1])
            else:
                d = d.mean(dim=(2, 3), keepdim=True)
            total = d if total is None else total + d
        return total


def load_lpips_params(model: LPIPS, lin_path: Optional[str] = None,
                      backbone_path: Optional[str] = None) -> LPIPS:
    """Load the reference's heads (``lin{k}.model.1.weight``, (1, C, 1, 1))
    and a torchvision AlexNet ``features.{i}`` state dict, where given."""
    if lin_path:
        sd = torch.load(lin_path, map_location="cpu", weights_only=True)
        with torch.no_grad():
            for k in range(len(_CHNS[model.net])):
                key = f"lin{k}.model.1.weight"
                if key not in sd:  # some dumps drop the dropout index
                    key = f"lin{k}.model.0.weight"
                getattr(model, f"lin{k}").copy_(sd[key][0, :, 0, 0])
    if backbone_path:
        sd = torch.load(backbone_path, map_location="cpu", weights_only=True)
        load_torchvision_features(model.backbone.stack, sd)
    return model


def reference_lin_weights_path(net: str = "alex", version: str = "0.1") -> Optional[str]:
    """The reference's bundled heads under ``DASR_TPU_LPIPS_LIN``, if there."""
    root = os.environ.get("DASR_TPU_LPIPS_LIN")
    p = os.path.join(root, f"v{version}", f"{net}.pth") if root else None
    return p if p and os.path.exists(p) else None


def default_lpips(net: str = "alex", backbone_path: Optional[str] = None, seed: int = 0,
                  dtype: torch.dtype = torch.float32) -> LPIPS:
    """The JAX package's ``default_lpips_variables``, as a module.

    LPIPS for the training and eval loops: a seeded init, the
    reference's heads when mounted, and a user-supplied torchvision
    backbone (``backbone_path`` or ``DASR_TPU_LPIPS_BACKBONE``) when it
    exists. Frozen (no parameter asks for a gradient)."""
    model = LPIPS(net=net, dtype=dtype).init_weights(torch.Generator().manual_seed(seed))
    backbone = backbone_path or os.environ.get("DASR_TPU_LPIPS_BACKBONE")
    if backbone and not os.path.exists(backbone):
        logger.warning(f"!!! LPIPS backbone path does not exist, IGNORING it: {backbone} "
                       "(the perceptual loss runs random-init)")
        backbone = None
    lin = reference_lin_weights_path(net)
    if not (lin or backbone):
        logger.info("LPIPS: no heads or backbone weights found; seeded random init "
                    f"(seed {seed}), not the published metric")
    load_lpips_params(model, lin_path=lin, backbone_path=backbone)
    return model.requires_grad_(False)

