"""Discriminators. Counterpart of ``dasr_tpu.nn.discriminators``: the
pix2pix PatchGAN ``NLayerDiscriminator`` that the DASR step trains on the
Haar high bands, and the DSN stage's ``DiscriminatorBasic`` (FSD) and
``FSDiscriminator`` (high-pass front end + body + sigmoid).
``DiscriminatorVGG`` waits for the other trainers (ROADMAP A.9).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dasr_tpu_torch.nn.layers import Conv2d
from dasr_tpu_torch.ops.dwt import haar_bands
from dasr_tpu_torch.ops.filters import filter_high


class InstanceNorm(nn.Module):
    """InstanceNorm2d with torch defaults (no affine, no running stats),
    its statistics taken in f32 and the result cast back to the input's
    dtype."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        return F.instance_norm(x.float(), eps=self.eps).to(x.dtype)


def _norm(norm_layer: str, channels: int) -> nn.Module:
    if norm_layer.lower() == "instance":
        return InstanceNorm()
    if norm_layer.lower() == "batch":
        return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)
    raise NotImplementedError(f"{norm_layer} norm layer is not recognized")


class NLayerDiscriminator(nn.Module):
    """PatchGAN: 4x4 convs with padding 1, LeakyReLU 0.2, a norm after every
    middle conv, a 1-channel logit head.

    ``model`` is an ``nn.Sequential`` with the reference's indices
    (codes/SRN/models/modules/architecture.py:983-1024; convs at 0,
    2 + 3 (n - 1), then the stride-1 block and the head), so a reference
    ``*_D_target.pth`` loads with plain ``load_state_dict``.
    ``use_bias_middle=None`` is the DSN rule (bias iff InstanceNorm); the
    SRN variant passes False. Activations run in the input's dtype."""

    def __init__(self, in_ch: int = 3, ndf: int = 64, n_layers: int = 3,
                 norm_layer: str = "Instance", stride: int = 2,
                 use_bias_middle: Optional[bool] = None):
        super().__init__()
        bias = norm_layer.lower() == "instance" if use_bias_middle is None else use_bias_middle

        def conv(cin, cout, s, b):
            return Conv2d(cin, cout, 4, stride=s, padding=1, bias=b)

        layers = [conv(in_ch, ndf, stride, True), nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers):
            prev, mult = mult, min(2**n, 8)
            layers += [conv(ndf * prev, ndf * mult, stride, bias), _norm(norm_layer, ndf * mult),
                       nn.LeakyReLU(0.2)]
        prev, mult = mult, min(2**n_layers, 8)
        layers += [conv(ndf * prev, ndf * mult, 1, bias), _norm(norm_layer, ndf * mult),
                   nn.LeakyReLU(0.2), conv(ndf * mult, 1, 1, True)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


class DiscriminatorBasic(nn.Module):
    """FSSR's "FSD" (reference: codes/DSN/model.py:173-210): 5x5 convs to 64,
    128 and 256 channels with zero padding 2, Batch or Instance norm after
    the second and third, LeakyReLU 0.2, a 1x1 conv to one logit per pixel.
    ``net`` holds the convs at the reference's indices 0, 2, 5 and 8."""

    def __init__(self, in_ch: int = 3, norm_layer: str = "Batch"):
        super().__init__()
        self.net = nn.Sequential(
            Conv2d(in_ch, 64, 5, padding=2), nn.LeakyReLU(0.2),
            Conv2d(64, 128, 5, padding=2), _norm(norm_layer, 128), nn.LeakyReLU(0.2),
            Conv2d(128, 256, 5, padding=2), _norm(norm_layer, 256), nn.LeakyReLU(0.2),
            Conv2d(256, 1, 1),
        )

    def forward(self, x):
        return self.net(x)


class FSDiscriminator(nn.Module):
    """Frequency-separation discriminator (codes/DSN/model.py:60-118): a
    fixed front end, one of three bodies, and a sigmoid unless ``wgan``.

    Front ends: ``gau`` / ``avg_pool`` high-pass (``filter_high`` with
    ``include_pad=False``), ``wavelet`` (the Haar high bands, 9 channels
    for ``cs='cat'``), or none. Bodies (``net``): ``FSD``
    (``DiscriminatorBasic``), ``nld_s1`` / ``nld_s2`` (``NLayerDiscriminator``
    with two layers, stride 1 or 2). With ``y`` the output is relativistic:
    ``net(x) - mean(net(y), 0)``. The body runs in ``dtype``; the front end
    in its input's."""

    def __init__(self, d_arch: str = "FSD", filter_type: Optional[str] = "gau",
                 kernel_size: int = 5, recursions: int = 1, stride: int = 1, cs: str = "cat",
                 norm_layer: str = "Instance", wgan: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.filter_type = (filter_type or "").lower()
        if self.filter_type not in ("", "gau", "avg_pool", "wavelet"):
            raise NotImplementedError(f"Frequency Separation type [{filter_type}] not recognized")
        self.kernel_size, self.recursions, self.stride, self.cs = kernel_size, recursions, stride, cs
        self.wgan, self.dtype = wgan, dtype
        n_in = 9 if self.filter_type == "wavelet" and cs == "cat" else 3
        arch = d_arch.lower()
        if arch == "fsd":
            self.net = DiscriminatorBasic(in_ch=n_in, norm_layer=norm_layer)
        elif arch in ("nld_s1", "nld_s2"):
            self.net = NLayerDiscriminator(in_ch=n_in, ndf=64, n_layers=2, norm_layer=norm_layer,
                                           stride=1 if arch == "nld_s1" else 2)
        else:
            raise NotImplementedError(f"Discriminator architecture [{d_arch}] not recognized")

    def _filter(self, x):
        if self.filter_type == "wavelet":
            return haar_bands(x, norm=True, cs=self.cs)[1]
        if self.filter_type:
            return filter_high(x, kernel_size=self.kernel_size, stride=self.stride,
                               recursions=self.recursions, include_pad=False,
                               gaussian=self.filter_type == "gau")
        return x

    def _body(self, x):
        return self.net(self._filter(x).to(self.dtype).contiguous(
            memory_format=torch.channels_last))

    def forward(self, x, y=None):
        out = self._body(x)
        if y is not None:
            out = out - self._body(y).mean(0, keepdim=True)
        return out if self.wgan else torch.sigmoid(out)
