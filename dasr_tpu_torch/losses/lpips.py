"""LPIPS (Learned Perceptual Image Patch Similarity) and the DistModel
distances.

Counterpart of ``dasr_tpu.losses.lpips`` (reference:
codes/PerceptualSimilarity/models/networks_basic.py:27-185,
dist_model.py:40-73): scaling layer (skipped by ``version`` '0.0', the
original release's bug) -> one backbone pass over both images ('alex',
'vgg' or 'squeeze') -> unit-normalise each tap (the norm taken in f32) ->
squared difference -> learned 1x1 head per tap in f32 ('net-lin'), or the
sum over channels ('net') -> spatial mean, or a bilinear upsample with
``spatial`` -> sum over taps. NCHW inputs in [-1, 1], or [0, 1] with
``normalize=True``. ``l2_distance``, ``dssim_distance`` and
``create_dist_model`` are the reference DistModel's other modes.

Weights: the per-tap heads ship with the reference as small ``.pth`` files
(``codes/PerceptualSimilarity/models/weights/v{0.0,0.1}/{net}.pth``); the
backbone is a torchvision alexnet, vgg16 or squeezenet1_1 state dict.
Neither is in this repository. ``default_lpips`` reads the heads from the
directory named by ``DASR_TPU_LPIPS_LIN`` (the reference's
``models/weights``) and the backbone from ``path.lpips_backbone`` or
``DASR_TPU_LPIPS_BACKBONE`` when they exist, and otherwise keeps the
seeded init (heads at 1/C, a random backbone), as the JAX package does;
it logs which.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import torch
import torch.nn as nn

import numpy as np

from dasr_tpu_torch.core.device import constant
from dasr_tpu_torch.nn.layers import init_lecun_
from dasr_tpu_torch.nn.vgg import (
    AlexNetFeatures, SqueezeNetFeatures, VGG16Features, load_torchvision_features)
from dasr_tpu_torch.ops.resize import bilinear_resize

logger = logging.getLogger("base")

# ScalingLayer constants (networks_basic.py:94-101)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_CHNS = {
    "alex": (64, 192, 384, 256, 256),
    "vgg": (64, 128, 256, 512, 512),
    "squeeze": (64, 128, 256, 384, 384, 512, 512),
}
_BACKBONES = {"alex": AlexNetFeatures, "vgg": VGG16Features, "squeeze": SqueezeNetFeatures}


def _normalize(feat, eps=1e-10):
    norm = torch.sqrt(torch.sum(feat.float() ** 2, dim=1, keepdim=True))
    return feat / (norm + eps).to(feat.dtype)


class LPIPS(nn.Module):
    """LPIPS on a backbone ``net``: 'net-lin' (``use_lins``, the heads are
    the parameters ``lin{k}`` of shape (C,)) or 'net' (no heads).
    ``dtype`` is the backbone's compute type (the heads and the
    normalisation run in f32)."""

    def __init__(self, net: str = "alex", use_lins: bool = True, spatial: bool = False,
                 version: str = "0.1", dtype: torch.dtype = torch.float32):
        super().__init__()
        if net not in _CHNS:
            raise NotImplementedError(f"LPIPS net [{net}] not recognized: alex, vgg or squeeze")
        if version not in ("0.0", "0.1"):
            raise NotImplementedError(f"LPIPS version [{version}] not recognized: 0.0 or 0.1")
        self.net, self.use_lins, self.spatial, self.version = net, use_lins, spatial, version
        self.dtype = dtype
        self.backbone = _BACKBONES[net]()
        if use_lins:
            for k, c in enumerate(_CHNS[net]):
                self.register_parameter(f"lin{k}", nn.Parameter(torch.full((c,), 1.0 / c)))

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """The JAX init's law: lecun-normal backbone convs, zero biases,
        heads at 1/C."""
        init_lecun_(self.backbone, generator)
        with torch.no_grad():
            for k, c in enumerate(_CHNS[self.net] if self.use_lins else ()):
                getattr(self, f"lin{k}").fill_(1.0 / c)
        return self

    def taps(self, x) -> List[torch.Tensor]:
        """The unit-normalised backbone taps of NCHW [-1, 1] images, in the
        backbone's dtype (the scaling layer first, for version '0.1')."""
        if self.version == "0.1":
            shift = constant(np.asarray, _SHIFT, device=x.device).view(1, 3, 1, 1)
            scale = constant(np.asarray, _SCALE, device=x.device).view(1, 3, 1, 1)
            x = (x - shift) / scale
        # an input too small for a backbone stage (alex: under 32 px per
        # side) makes torch's conv or max pool raise, as the reference's does
        return [_normalize(f) for f in self.backbone(x.to(self.dtype))]

    def distance(self, taps0, taps1, hw) -> torch.Tensor:
        """The distance of two images' ``taps`` (images of size ``hw``):
        (B, 1, 1, 1), or (B, 1, H, W) when ``spatial``; f32."""
        total = None
        for k, (f0, f1) in enumerate(zip(taps0, taps1)):
            diff = ((f0 - f1) ** 2).float()
            if self.use_lins:
                d = (diff * getattr(self, f"lin{k}").view(1, -1, 1, 1)).sum(1, keepdim=True)
            else:
                d = diff.sum(1, keepdim=True)
            if self.spatial:
                d = bilinear_resize(d, hw[0], hw[1])
            else:
                d = d.mean(dim=(2, 3), keepdim=True)
            total = d if total is None else total + d
        return total

    def forward(self, in0, in1, normalize: bool = False):
        """(B, 1, 1, 1) distances, or (B, 1, H, W) when ``spatial``; one
        backbone pass over both images."""
        if normalize:
            in0, in1 = 2 * in0 - 1, 2 * in1 - 1
        b = in0.shape[0]
        taps = self.taps(torch.cat([in0, in1]))
        return self.distance([t[:b] for t in taps], [t[b:] for t in taps], in0.shape[-2:])


def load_lpips_params(model: LPIPS, lin_path: Optional[str] = None,
                      backbone_path: Optional[str] = None) -> LPIPS:
    """Load the reference's heads (``lin{k}.model.1.weight``, (1, C, 1, 1);
    a 'net' model has none to load) and a torchvision state dict of the
    model's backbone (``load_torchvision_features``), where given."""
    if lin_path and model.use_lins:
        sd = torch.load(lin_path, map_location="cpu", weights_only=True)
        with torch.no_grad():
            for k in range(len(_CHNS[model.net])):
                key = f"lin{k}.model.1.weight"
                if key not in sd:  # some dumps drop the dropout index
                    key = f"lin{k}.model.0.weight"
                getattr(model, f"lin{k}").copy_(sd[key][0, :, 0, 0])
    if backbone_path:
        sd = torch.load(backbone_path, map_location="cpu", weights_only=True)
        load_torchvision_features(model.backbone, sd)
    return model


def reference_lin_weights_path(net: str = "alex", version: str = "0.1") -> Optional[str]:
    """The reference's bundled heads under ``DASR_TPU_LPIPS_LIN``, if there."""
    root = os.environ.get("DASR_TPU_LPIPS_LIN")
    p = os.path.join(root, f"v{version}", f"{net}.pth") if root else None
    return p if p and os.path.exists(p) else None


def l2_distance(in0: torch.Tensor, in1: torch.Tensor) -> torch.Tensor:
    """DistModel 'L2' (RGB, networks_basic.py:150-158): the per-image mean of
    the squared difference of NCHW [-1, 1] tensors, (B,) in f32."""
    return ((in0.float() - in1.float()) ** 2).mean(dim=(1, 2, 3))


def dssim_distance(in0: torch.Tensor, in1: torch.Tensor) -> np.ndarray:
    """DistModel 'DSSIM' (RGB, models/util.py:52-53) as the JAX package
    computes it: (1 - SSIM) / 2 of the images in [0, 255] on the host, SSIM
    the MATLAB-style one of ``ops/metrics.py`` averaged over the channels;
    (B,) for NCHW [-1, 1] tensors."""
    from dasr_tpu_torch.ops.metrics import calculate_ssim

    def to_im(t):
        return np.clip((t.detach().float().cpu().numpy() + 1.0) / 2.0, 0, 1) * 255.0

    a, b = to_im(in0), to_im(in1)
    return np.asarray([(1.0 - np.mean([calculate_ssim(a[i, c], b[i, c])
                                       for c in range(a.shape[1])])) / 2.0
                       for i in range(a.shape[0])])


def create_dist_model(model: str = "net-lin", net: str = "alex", version: str = "0.1",
                      lin_path: Optional[str] = None, backbone_path: Optional[str] = None,
                      spatial: bool = False, device: torch.device = torch.device("cpu")):
    """DistModel factory (dist_model.py:40-73): ``fn(in0, in1)`` on NCHW
    [-1, 1] tensors for 'net-lin', 'net', 'L2' / 'l2' and 'DSSIM' / 'ssim'.
    An LPIPS model is seeded (0), takes the heads of ``lin_path`` or the
    reference's bundled ones of ``version``, and ``backbone_path``, and
    runs on ``device``; its distances stay there."""
    low = model.lower()
    if low == "l2":
        return l2_distance
    if low in ("dssim", "ssim"):
        return dssim_distance
    if low not in ("net-lin", "net"):
        raise NotImplementedError(f"DistModel [{model}] not recognized")
    lpips = LPIPS(net=net, use_lins=low == "net-lin", spatial=spatial, version=version)
    lpips.init_weights(torch.Generator().manual_seed(0))
    load_lpips_params(lpips, lin_path=lin_path or reference_lin_weights_path(net, version),
                      backbone_path=backbone_path)
    lpips = lpips.to(device).eval().requires_grad_(False)

    @torch.no_grad()
    def fn(in0, in1):
        return lpips(in0.to(device), in1.to(device))

    return fn


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

