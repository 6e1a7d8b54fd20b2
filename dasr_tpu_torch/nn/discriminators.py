"""Discriminators. Counterpart of ``dasr_tpu.nn.discriminators``; so far the
pix2pix PatchGAN ``NLayerDiscriminator`` that the DASR step trains on the
Haar high bands. ``DiscriminatorBasic``, ``FSDiscriminator`` and
``DiscriminatorVGG`` wait for the DSN stage and the other trainers
(ROADMAP A.7 / A.9).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dasr_tpu_torch.nn.layers import Conv2d


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
