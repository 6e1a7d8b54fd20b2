"""The rest of the reference's architecture zoo: EDSR commons, module
utils, feature extractors, the CycleGAN generator.

Counterpart of ``dasr_tpu.nn.misc_nets``:

  * ``MeanShift`` / ``EDSRResBlock`` / ``Upsampler`` — EDSR commons
    (reference: codes/SRN/models/common.py:7-90)
  * ``ResidualBlockNoBN`` / ``make_layer`` / ``flow_warp`` — module utils
    (module_util.py:7-79)
  * ``MINCNet`` — the MINC material-feature net (architecture.py:1116-1175)
  * ``ResNet101Features`` — ResNet101's stem and first stage
    (architecture.py:1092-1113), torchvision's names
  * ``ResnetGenerator`` — the CycleGAN generator (architecture.py:301-388)

Where ``dasr_tpu`` departs from the reference, the port follows the
reference, so that a reference ``.pth`` computes what it computed there,
and the class says where: ``MINCNet`` leaves ``conv53`` without a ReLU and
pools with ``ceil_mode`` (JAX keeps the ReLU and pools with floor);
``ResnetGenerator`` upsamples with the reference's ``padding=1,
output_padding=1`` transposed convs (JAX's 'SAME' taps are one pixel off
them). ``MeanShift`` divides the shift by std twice, as ``dasr_tpu`` does;
for the unit std every caller uses it is the reference's map.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dasr_tpu_torch.nn.layers import BatchNorm2d, Conv2d


class MeanShift(nn.Module):
    """(x + sign * rgb_range * mean / std) / std per channel (common.py:7-18;
    the reference's fixed 1x1 conv adds sign * rgb_range * mean / std to
    x / std, which is the same for its unit std)."""

    def __init__(self, rgb_range: float = 1.0,
                 rgb_mean: Sequence[float] = (0.4488, 0.4371, 0.4040),
                 rgb_std: Sequence[float] = (1.0, 1.0, 1.0), sign: int = -1):
        super().__init__()
        self.register_buffer("mean", torch.tensor(rgb_mean).view(1, -1, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(rgb_std).view(1, -1, 1, 1), persistent=False)
        self.rgb_range, self.sign = rgb_range, sign

    def forward(self, x):
        mean, std = self.mean.to(x.dtype), self.std.to(x.dtype)
        return (x + self.sign * self.rgb_range * mean / std) / std


class EDSRResBlock(nn.Module):
    """x + res_scale * conv(relu(conv(x))) (common.py:38-59, ``body.{0,2}``)."""

    def __init__(self, nf: int = 64, res_scale: float = 1.0):
        super().__init__()
        self.body = nn.Sequential(Conv2d(nf, nf, 3, 1, 1), nn.ReLU(), Conv2d(nf, nf, 3, 1, 1))
        self.res_scale = res_scale

    def forward(self, x):
        return x + self.body(x) * self.res_scale


class Upsampler(nn.Sequential):
    """x``scale`` pixel-shuffle chain (common.py:61-90): per x2 stage (one
    x3 stage for scale 3) a 3x3 conv to r^2 nf channels and
    ``nn.PixelShuffle(r)``."""

    def __init__(self, scale: int = 4, nf: int = 64):
        r = 3 if scale == 3 else 2
        n = 1 if scale == 3 else int(math.log2(scale))
        layers = []
        for _ in range(n):
            layers += [Conv2d(nf, nf * r * r, 3, 1, 1), nn.PixelShuffle(r)]
        super().__init__(*layers)


class ResidualBlockNoBN(nn.Module):
    """x + conv2(relu(conv1(x))), norm-free (module_util.py:36-56)."""

    def __init__(self, nf: int = 64):
        super().__init__()
        self.conv1 = Conv2d(nf, nf, 3, 1, 1)
        self.conv2 = Conv2d(nf, nf, 3, 1, 1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x)))


def make_layer(block_fn: Callable[[], nn.Module], n: int) -> nn.Sequential:
    """``n`` blocks of ``block_fn()`` in sequence (module_util.py:28-33)."""
    return nn.Sequential(*(block_fn() for _ in range(n)))


def flow_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear warp of NCHW ``x`` by a (B, H, W, 2) flow in pixels, (dx,
    dy) last (module_util.py:59-79), sampling positions clamped to the
    border, as ``dasr_tpu``'s gather."""
    b, c, h, w = x.shape
    gy, gx = torch.meshgrid(torch.arange(h, dtype=flow.dtype, device=flow.device),
                            torch.arange(w, dtype=flow.dtype, device=flow.device),
                            indexing="ij")
    sy = (gy[None] + flow[..., 1]).clamp(0, h - 1)
    sx = (gx[None] + flow[..., 0]).clamp(0, w - 1)
    y0, x0 = sy.floor().long(), sx.floor().long()
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    wy, wx = (sy - y0)[:, None], (sx - x0)[:, None]
    flat = x.reshape(b, c, h * w)

    def gather(yy, xx):
        idx = (yy * w + xx).reshape(b, 1, h * w).expand(b, c, h * w)
        return flat.gather(2, idx).reshape(b, c, h, w)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return top * (1 - wy) + bot * wy


class MINCNet(nn.Module):
    """MINC's VGG-like feature net (architecture.py:1116-1175): convs
    ``conv11`` to ``conv53`` (64, 128, 256, 512, 512 channels), a ReLU after
    each but ``conv53``, and a 2x2 max pool with ``ceil_mode`` after each
    stage but the last, as the reference. ``dasr_tpu`` keeps the last ReLU
    and pools with floor (ROADMAP C.5)."""

    _STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

    def __init__(self, in_ch: int = 3):
        super().__init__()
        self.stages, prev = [], in_ch
        for si, (ch, n) in enumerate(self._STAGES):
            self.stages.append([f"conv{si + 1}{j + 1}" for j in range(n)])
            for name in self.stages[-1]:
                setattr(self, name, Conv2d(prev, ch, 3, 1, 1))
                prev = ch

    def forward(self, x):
        for si, names in enumerate(self.stages):
            if si:
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
            for name in names:
                x = getattr(self, name)(x)
                if name != "conv53":
                    x = F.relu(x)
        return x


class FrozenBatchNorm2d(BatchNorm2d):
    """A BatchNorm that always normalises by its running statistics (flax's
    ``use_running_average=True``)."""

    def forward(self, x):
        return F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, self.eps).to(x.dtype)


class Bottleneck(nn.Module):
    """ResNet's 1x1-3x3-1x1 bottleneck, torchvision's names, frozen norms."""

    def __init__(self, cin: int, width: int, downsample: bool):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = Conv2d(width, 4 * width, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(4 * width)
        self.downsample = (nn.Sequential(Conv2d(cin, 4 * width, 1, bias=False),
                                         FrozenBatchNorm2d(4 * width)) if downsample else None)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class ResNet101Features(nn.Module):
    """ResNet101's stem and first stage (conv1 + layer1), ImageNet-normalised
    input, BatchNorm on running statistics (architecture.py:1092-1113, as
    ``dasr_tpu`` cuts it): ``features`` carries torchvision's
    ``resnet101`` names (``features.0`` conv1, ``features.1`` bn1,
    ``features.4`` layer1), so its state dict loads under those prefixes."""

    def __init__(self, use_input_norm: bool = True):
        super().__init__()
        self.use_input_norm = use_input_norm
        self.register_buffer("mean", torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1),
                             persistent=False)
        self.features = nn.Sequential(
            Conv2d(3, 64, 7, 2, 3, bias=False), FrozenBatchNorm2d(64), nn.ReLU(),
            nn.MaxPool2d(3, 2, 1),
            nn.Sequential(Bottleneck(64, 64, True), Bottleneck(256, 64, False),
                          Bottleneck(256, 64, False)))

    def forward(self, x):
        if self.use_input_norm:
            x = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        return self.features(x)


class ConvTranspose2d(nn.ConvTranspose2d):
    """The reference's stride-2 3x3 transposed conv to twice the size
    (``padding=1, output_padding=1``), f32 parameters cast to the input's
    dtype. JAX's ``ConvTranspose(padding='SAME')`` is torch's full
    transposed conv (padding 0) cropped to 2n: its taps are one pixel off
    these (ROADMAP C.5)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, stride=2, padding=1, output_padding=1)

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), stride=2,
                                  padding=1, output_padding=1)


def _inorm(ch: int) -> nn.Module:
    return nn.InstanceNorm2d(ch, eps=1e-5)


class ResnetBlock(nn.Module):
    """x + [reflect pad, conv, IN, ReLU, reflect pad, conv, IN](x)
    (``conv_block.{1,5}`` the convs)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), Conv2d(ch, ch, 3), _inorm(ch), nn.ReLU(),
            nn.ReflectionPad2d(1), Conv2d(ch, ch, 3), _inorm(ch))

    def forward(self, x):
        return x + self.conv_block(x)


class ResnetGenerator(nn.Module):
    """CycleGAN generator (architecture.py:301-388): c7s1-ngf, two stride-2
    downs, ``n_blocks`` residual blocks, two transposed-conv ups, c7s1-out
    and tanh, InstanceNorm without affine; ``model`` in the reference's
    order, its ups the reference's ``ConvTranspose2d``."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, ngf: int = 64, n_blocks: int = 6):
        super().__init__()
        layers = [nn.ReflectionPad2d(3), Conv2d(in_nc, ngf, 7), _inorm(ngf), nn.ReLU()]
        for mult in (1, 2):
            layers += [Conv2d(ngf * mult, ngf * mult * 2, 3, 2, 1), _inorm(ngf * mult * 2),
                       nn.ReLU()]
        layers += [ResnetBlock(ngf * 4) for _ in range(n_blocks)]
        for mult in (4, 2):
            layers += [ConvTranspose2d(ngf * mult, ngf * mult // 2), _inorm(ngf * mult // 2),
                       nn.ReLU()]
        layers += [nn.ReflectionPad2d(3), Conv2d(ngf, out_nc, 7), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)
