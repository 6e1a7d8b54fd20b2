"""SFT-GAN networks ('sft_arch' generator, 'dis_acd' discriminator).

Counterpart of ``dasr_tpu.nn.sft`` (reference: codes/SRN/models/modules/
sft_arch.py:8-226). A condition branch (``CondNet``) turns the
segmentation probability maps into per-pixel (scale, shift) pairs that
modulate the SR trunk's features (``SFTLayer``).

The modules carry the reference's names (``conv0``,
``sft_branch.{i}.{sft0,sft1}.SFT_{scale,shift}_conv{0,1}``,
``sft_branch.{i}.conv{0,1}``, ``HR_branch.{0,3,6,8}``,
``CondNet.{0,2,4,6,8}``), so a reference ``SFTGAN_*.pth`` loads as it is.
The HR branch upsamples with ``nn.PixelShuffle``, the reference's channel
order; ``dasr_tpu``'s depth-to-space orders them (dy, dx, c), and its
importer permutes for it.

As in ``dasr_tpu``, ``SFTNet`` runs the full documented architecture: the
reference's shipped forward bypasses the SFT branch (sft_arch.py:76-83 is
commented out). With tracing on (``utils/trace.py``) its forward marks the
device phases ``cond``, ``sft_branch`` and ``hr_branch``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dasr_tpu_torch.nn.layers import BatchNorm2d, Conv2d, Linear, init_lecun_
from dasr_tpu_torch.utils import trace


def _lrelu01(x):
    return F.leaky_relu(x, 0.1)


class SFTLayer(nn.Module):
    """fea * (scale + 1) + shift, each of (scale, shift) two 1x1 convs with a
    LeakyReLU 0.1 between them over the condition (sft_arch.py:8-20)."""

    def __init__(self):
        super().__init__()
        self.SFT_scale_conv0 = Conv2d(32, 32, 1)
        self.SFT_scale_conv1 = Conv2d(32, 64, 1)
        self.SFT_shift_conv0 = Conv2d(32, 32, 1)
        self.SFT_shift_conv1 = Conv2d(32, 64, 1)

    def forward(self, fea, cond):
        scale = self.SFT_scale_conv1(_lrelu01(self.SFT_scale_conv0(cond)))
        shift = self.SFT_shift_conv1(_lrelu01(self.SFT_shift_conv0(cond)))
        return fea * (scale + 1) + shift


class ResBlockSFT(nn.Module):
    """fea + conv1(sft1(relu(conv0(sft0(fea))))) (sft_arch.py:23-37)."""

    def __init__(self):
        super().__init__()
        self.sft0 = SFTLayer()
        self.conv0 = Conv2d(64, 64, 3, 1, 1)
        self.sft1 = SFTLayer()
        self.conv1 = Conv2d(64, 64, 3, 1, 1)

    def forward(self, fea, cond):
        h = F.relu(self.conv0(self.sft0(fea, cond)))
        return fea + self.conv1(self.sft1(h, cond))


class SFTNet(nn.Module):
    """x4 SR conditioned on segmentation maps (sft_arch.py:40-85):
    ``img`` (B, 3, H, W) and ``seg`` (B, 8, 4H, 4W), which ``CondNet``
    brings to (B, 32, H, W) with a stride-4 conv; ``n_blocks`` SFT residual
    blocks, an SFT layer and a conv (``sft_branch``) with a long skip, then
    two pixel-shuffle x2 stages and two convs (``HR_branch``). Activations
    run in ``dtype``; parameters stay f32. The device phases (while tracing
    is on): ``cond`` (the maps' cast and ``CondNet``), ``sft_branch`` (the
    image's cast, ``conv0`` and the SFT branch) and ``hr_branch`` (the long
    skip and the HR branch)."""

    def __init__(self, n_blocks: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = Conv2d(3, 64, 3, 1, 1)
        self.sft_branch = nn.ModuleList(
            [ResBlockSFT() for _ in range(n_blocks)] + [SFTLayer(), Conv2d(64, 64, 3, 1, 1)])
        self.HR_branch = nn.Sequential(
            Conv2d(64, 256, 3, 1, 1), nn.PixelShuffle(2), nn.ReLU(),
            Conv2d(64, 256, 3, 1, 1), nn.PixelShuffle(2), nn.ReLU(),
            Conv2d(64, 64, 3, 1, 1), nn.ReLU(),
            Conv2d(64, 3, 3, 1, 1))
        self.CondNet = nn.Sequential(
            Conv2d(8, 128, 4, 4), nn.LeakyReLU(0.1),
            Conv2d(128, 128, 1), nn.LeakyReLU(0.1),
            Conv2d(128, 128, 1), nn.LeakyReLU(0.1),
            Conv2d(128, 128, 1), nn.LeakyReLU(0.1),
            Conv2d(128, 32, 1))

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """flax's default init, as ``dasr_tpu``'s SFTNet: lecun-normal
        kernels, zero biases."""
        return init_lecun_(self, generator)

    def forward(self, img, seg):
        cl = torch.channels_last
        trace.phase("cond")
        cond = self.CondNet(seg.to(self.dtype).contiguous(memory_format=cl))
        trace.phase("sft_branch")
        fea = self.conv0(img.to(self.dtype).contiguous(memory_format=cl))
        h = fea
        for block in self.sft_branch[:-2]:
            h = block(h, cond)
        h = self.sft_branch[-1](self.sft_branch[-2](h, cond))
        trace.phase("hr_branch")
        out = self.HR_branch(fea + h)
        trace.end_phases()
        return out


class ACDVGGBN96(nn.Module):
    """The auxiliary-classifier discriminator (ACD_VGG_BN_96,
    sft_arch.py:87-130): eight convs (3x3 stride 1 and 4x4 stride 2 in
    turn, 64 to 512 channels), BatchNorm after all but the first, LeakyReLU
    0.1; on the NCHW flatten a GAN head (``gan``: 100, then 1) and a class
    head (``cls``: 100, then ``n_classes``). ``forward`` returns (gan,
    cls). ``input_size`` 96 is the reference's (a 6x6 map before the
    heads). The BatchNorms keep flax's running statistics
    (``nn/layers.py:BatchNorm2d``)."""

    _CHANS = ((64, 3, 1, False), (64, 4, 2, True), (128, 3, 1, True), (128, 4, 2, True),
              (256, 3, 1, True), (256, 4, 2, True), (512, 3, 1, True), (512, 4, 2, True))

    def __init__(self, n_classes: int = 8, input_size: int = 96, in_ch: int = 3):
        super().__init__()
        layers, prev = [], in_ch
        for ch, k, s, bn in self._CHANS:
            layers.append(Conv2d(prev, ch, k, s, 1))
            if bn:
                layers.append(BatchNorm2d(ch, eps=1e-5, momentum=0.1))
            layers.append(nn.LeakyReLU(0.1))
            prev = ch
        self.feature = nn.Sequential(*layers)
        flat = prev * (input_size // 16) ** 2
        self.gan = nn.Sequential(Linear(flat, 100), nn.LeakyReLU(0.1), Linear(100, 1))
        self.cls = nn.Sequential(Linear(flat, 100), nn.LeakyReLU(0.1), Linear(100, n_classes))

    def forward(self, x):
        fea = self.feature(x).flatten(1)
        return self.gan(fea), self.cls(fea)
