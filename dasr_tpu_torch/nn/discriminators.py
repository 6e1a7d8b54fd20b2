"""Discriminators. Counterpart of ``dasr_tpu.nn.discriminators``: the
pix2pix PatchGAN ``NLayerDiscriminator`` that the DASR step trains on the
Haar high bands, and the DSN stage's ``DiscriminatorBasic`` (FSD) and
``FSDiscriminator`` (high-pass front end + body + sigmoid); and the VGG
discriminators of the paired GAN trainers: ``DiscriminatorVGG`` (the
reference's Discriminator_VGG_128 at any input size),
``make_vgg_discriminator``'s stacks (Discriminator_VGG_96/192/48 and the
patch variants) and ``DiscriminatorVGG128SN``. Their BatchNorm and
spectral-norm layers keep flax's running state (``nn/layers.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dasr_tpu_torch.core.dist import batch_mean
from dasr_tpu_torch.nn.blocks import sequential
from dasr_tpu_torch.nn.layers import (
    BatchNorm2d,
    Conv2d,
    Linear,
    SNConv2d,
    SNLinear,
    conv_block,
    stats_updates,
)
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
        # flax's statistics, the global batch's over several ranks
        return BatchNorm2d(channels, eps=1e-5, momentum=0.1)
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
    ``net(x) - mean(net(y), 0)``, the mean over the global batch
    (``dist.batch_mean``). The body runs in ``dtype``; the front end
    in its input's. ``in_ch``: the body's input channels where the caller
    filters (flax infers them; 9 for the Haar high bands, 3 by default)."""

    def __init__(self, d_arch: str = "FSD", filter_type: Optional[str] = "gau",
                 kernel_size: int = 5, recursions: int = 1, stride: int = 1, cs: str = "cat",
                 norm_layer: str = "Instance", wgan: bool = False,
                 dtype: torch.dtype = torch.float32, in_ch: Optional[int] = None):
        super().__init__()
        self.filter_type = (filter_type or "").lower()
        if self.filter_type not in ("", "gau", "avg_pool", "wavelet"):
            raise NotImplementedError(f"Frequency Separation type [{filter_type}] not recognized")
        self.kernel_size, self.recursions, self.stride, self.cs = kernel_size, recursions, stride, cs
        self.wgan, self.dtype = wgan, dtype
        n_in = in_ch or (9 if self.filter_type == "wavelet" and cs == "cat" else 3)
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
            out = out - batch_mean(self._body(y))
        return out if self.wgan else torch.sigmoid(out)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class DiscriminatorVGG(nn.Module):
    """VGG-style global D (Discriminator_VGG_128, architecture.py:442-495):
    ``conv0_0`` (3x3, bias) and ``conv0_1`` (4x4 stride 2, ``bn0_1``), then
    pairs ``conv{i}_0`` (3x3) / ``conv{i}_1`` (4x4 stride 2), each with its
    BatchNorm, until the map is 4x4, channels doubling to 8 nf; ``linear1``
    (to 100) on the NCHW flatten, ``linear2`` (to 1). ``input_size`` 128 is
    the reference's layer for layer, and its ``.pth`` loads as it is; other
    sizes repeat the pair, as ``dasr_tpu``'s module does."""

    def __init__(self, input_size: int = 128, in_ch: int = 3, nf: int = 64):
        super().__init__()
        size, ch, chans = input_size // 2, nf, [nf]
        while size > 4:
            ch = min(ch * 2, nf * 8)
            chans.append(ch)
            size //= 2
        self.n_stages = len(chans)
        prev = in_ch
        for i, ch in enumerate(chans):
            setattr(self, f"conv{i}_0", Conv2d(prev, ch, 3, 1, 1, bias=i == 0))
            if i:
                setattr(self, f"bn{i}_0", BatchNorm2d(ch))
            setattr(self, f"conv{i}_1", Conv2d(ch, ch, 4, 2, 1, bias=False))
            setattr(self, f"bn{i}_1", BatchNorm2d(ch))
            prev = ch
        self.linear1 = Linear(prev * size * size, 100)
        self.linear2 = Linear(100, 1)

    def forward(self, x):
        x = _lrelu(self.conv0_0(x))
        x = _lrelu(self.bn0_1(self.conv0_1(x)))
        for i in range(1, self.n_stages):
            x = _lrelu(getattr(self, f"bn{i}_0")(getattr(self, f"conv{i}_0")(x)))
            x = _lrelu(getattr(self, f"bn{i}_1")(getattr(self, f"conv{i}_1")(x)))
        return self.linear2(_lrelu(self.linear1(x.flatten(1))))


# stage specs per reference variant: (ch_mult, kernel, stride, use_norm)
_VGG_STAGES_96 = (
    (1, 3, 1, False), (1, 4, 2, True), (2, 3, 1, True), (2, 4, 2, True),
    (4, 3, 1, True), (4, 4, 2, True), (8, 3, 1, True), (8, 4, 2, True),
    (8, 3, 1, True), (8, 4, 2, True),
)
_VGG_STAGES_192 = _VGG_STAGES_96 + ((8, 3, 1, True), (8, 4, 2, True))
_VGG_STAGES_48 = (
    (1, 3, 1, False), (1, 4, 1, True), (2, 3, 1, True), (2, 4, 1, True),
    (4, 3, 1, True), (4, 4, 1, True), (8, 3, 1, True), (8, 4, 2, True),
    (8, 3, 1, True), (8, 4, 2, True), (8, 3, 1, True), (8, 4, 2, True),
)
_VGG_STAGES_96_PATCH = _VGG_STAGES_96 + ((8, 3, 1, True),)
# name: (stages, the input size the head is sized for, or None: no head)
_VGG_VARIANTS = {
    "discriminator_vgg_96": (_VGG_STAGES_96, 96),
    "discriminator_vgg_192": (_VGG_STAGES_192, 192),
    "discriminator_vgg_192_wavelet": (_VGG_STAGES_192, 192),
    "discriminator_vgg_48": (_VGG_STAGES_48, 48),
    "discriminator_vgg_96_patch": (_VGG_STAGES_96_PATCH, None),
    "discriminator_vgg_patch": (_VGG_STAGES_96_PATCH, None),
}


class DiscriminatorVGGStack(nn.Module):
    """The conv-block VGG discriminators (architecture.py:544-830):
    ``features``, the reference's flattened sequential of ``conv_block``s
    (convs with biases, the norm on all but the first, CNA or NAC), then,
    with a head, ``classifier`` = Linear(8 nf x k x k, 100), LeakyReLU 0.2,
    Linear(100, 1) on the NCHW flatten (k: ``input_size`` over the stride
    product). Without a head the features are the output."""

    def __init__(self, stages, in_nc: int = 3, nf: int = 64, norm_type: Optional[str] = "batch",
                 act_type: str = "leakyrelu", mode: str = "CNA",
                 input_size: Optional[int] = None):
        super().__init__()
        blocks, prev, size = [], in_nc, input_size
        for mult, k, s, use_norm in stages:
            blocks.append(conv_block(prev, nf * mult, k, stride=s,
                                     norm_type=norm_type if use_norm else None,
                                     act_type=act_type, mode=mode))
            prev = nf * mult
            if size is not None:
                size = (size + 2 * ((k - 1) // 2) - k) // s + 1
        self.features = sequential(*blocks)
        self.classifier = None
        if input_size is not None:
            self.classifier = nn.Sequential(Linear(prev * size * size, 100), nn.LeakyReLU(0.2),
                                            Linear(100, 1))

    def forward(self, x):
        x = self.features(x)
        return x if self.classifier is None else self.classifier(x.flatten(1))


def make_vgg_discriminator(which: str, in_nc: int = 3, nf: int = 64,
                           norm_type: Optional[str] = "batch", act_type: str = "leakyrelu",
                           mode: str = "CNA") -> DiscriminatorVGGStack:
    """The reference's conv-block VGG D zoo by name (networks.py:151-194)."""
    if which not in _VGG_VARIANTS:
        raise NotImplementedError(f"Discriminator model [{which}] not recognized")
    stages, size = _VGG_VARIANTS[which]
    return DiscriminatorVGGStack(stages, in_nc=in_nc, nf=nf, norm_type=norm_type,
                                 act_type=act_type, mode=mode, input_size=size)


class DiscriminatorVGG128SN(nn.Module):
    """Discriminator_VGG_128_SN (architecture.py:499-541): ten spectral-norm
    convs ``conv0..conv9`` (3x3 stride 1 and 4x4 stride 2 in turns, padding
    1, 64 to 512 channels), LeakyReLU 0.2, no norm, then ``linear0`` (512 x
    4 x 4 to 100) and ``linear1`` (to 1), spectral-normed, on the NCHW
    flatten. ``update_stats`` as flax's: True stores each layer's ``u`` and
    ``sigma``; None leaves the layers' own setting (``stats_updates``)."""

    _CHANS = (64, 64, 128, 128, 256, 256, 512, 512, 512, 512)

    def __init__(self):
        super().__init__()
        prev = 3
        for i, ch in enumerate(self._CHANS):
            k, s = (3, 1) if i % 2 == 0 else (4, 2)
            setattr(self, f"conv{i}", SNConv2d(prev, ch, k, s, 1))
            prev = ch
        self.linear0 = SNLinear(512 * 4 * 4, 100)
        self.linear1 = SNLinear(100, 1)

    def forward(self, x, update_stats: Optional[bool] = None):
        if update_stats is not None:
            with stats_updates(self, update_stats):
                return self.forward(x)
        for i in range(len(self._CHANS)):
            x = _lrelu(getattr(self, f"conv{i}")(x))
        return self.linear1(_lrelu(self.linear0(x.flatten(1))))
