"""Feature-extraction backbones (AlexNet, VGG16, SqueezeNet 1.1, VGG19
conv5_4) on NCHW tensors.

Counterpart of ``dasr_tpu.nn.vgg``: the LPIPS backbones 'alex', 'vgg' and
'squeeze' (reference: codes/PerceptualSimilarity/models/
pretrained_networks.py slices torchvision's nets into taps) and the SRN
VGG feature loss (architecture.py:1060-1088, VGG19 feature_layer 34). Conv
modules are named ``stack.conv{i}`` in torch module order, as the JAX
package names them, and SqueezeNet's ``conv0`` and ``fire{i}.{squeeze,
expand1x1,expand3x3}`` after torchvision's ``features.{i}``;
``load_torchvision_features`` reads a torchvision state dict. No weights
ship with the repository.

SqueezeNet pools with ``ceil_mode=True``, as torchvision's
``squeezenet1_1`` does, and the published squeeze heads were trained on
it. ``dasr_tpu``'s ``SqueezeNetFeatures`` pools with floor
(``dasr_tpu/nn/vgg.py:136,140,144``): the two agree at 64x64 and differ
where a pooled side is even, e.g. at 100x100 (ROADMAP C.2).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dasr_tpu_torch.nn.layers import Conv2d

# (out_ch, kernel, stride, pad) per conv; 'M3' = 3x3/2 maxpool (alexnet),
# 'M2' = 2x2/2 maxpool (vgg); taps after the ReLU of the listed convs
_ALEX_CFG: Sequence = [(64, 11, 4, 2), "M3", (192, 5, 1, 2), "M3", (384, 3, 1, 1),
                       (256, 3, 1, 1), (256, 3, 1, 1)]
_ALEX_TAPS = (0, 1, 2, 3, 4)
_VGG16_CFG: Sequence = [
    (64, 3, 1, 1), (64, 3, 1, 1), "M2",
    (128, 3, 1, 1), (128, 3, 1, 1), "M2",
    (256, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1), "M2",
    (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1), "M2",
    (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1),
]
_VGG16_TAPS = (1, 3, 6, 9, 12)  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
_VGG19_CFG: Sequence = [
    (64, 3, 1, 1), (64, 3, 1, 1), "M2",
    (128, 3, 1, 1), (128, 3, 1, 1), "M2",
    (256, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1), "M2",
    (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1), "M2",
    (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1),
]
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class _ConvStack(nn.Module):
    """Convs (each followed by ReLU, except the last one when
    ``final_conv_no_relu``) and max pools; returns the listed taps."""

    def __init__(self, cfg: Tuple, taps: Tuple[int, ...], in_ch: int = 3,
                 final_conv_no_relu: bool = False):
        super().__init__()
        self.cfg, self.taps, self.final_conv_no_relu = tuple(cfg), tuple(taps), final_conv_no_relu
        n = 0
        for item in self.cfg:
            if item in ("M2", "M3"):
                continue
            ch, k, s, p = item
            setattr(self, f"conv{n}", Conv2d(in_ch, ch, k, stride=s, padding=p))
            in_ch, n = ch, n + 1
        self.n_convs = n

    def forward(self, x) -> List[torch.Tensor]:
        outs, n = [], 0
        for item in self.cfg:
            if item == "M2":
                x = F.max_pool2d(x, 2, 2)
                continue
            if item == "M3":
                x = F.max_pool2d(x, 3, 2)
                continue
            x = getattr(self, f"conv{n}")(x)
            if not (n == self.n_convs - 1 and self.final_conv_no_relu):
                x = F.relu(x)
            if n in self.taps:
                outs.append(x)
            n += 1
        return outs

    def convs(self):
        return [getattr(self, f"conv{i}") for i in range(self.n_convs)]


class AlexNetFeatures(nn.Module):
    """5-tap AlexNet feature pyramid (LPIPS 'alex')."""

    def __init__(self):
        super().__init__()
        self.stack = _ConvStack(_ALEX_CFG, _ALEX_TAPS)

    def forward(self, x):
        return self.stack(x)


class VGG16Features(nn.Module):
    """5-tap VGG16 feature pyramid (LPIPS 'vgg')."""

    def __init__(self):
        super().__init__()
        self.stack = _ConvStack(_VGG16_CFG, _VGG16_TAPS)

    def forward(self, x):
        return self.stack(x)


class Fire(nn.Module):
    """SqueezeNet Fire module: 1x1 squeeze -> relu -> [1x1 | 3x3] expand,
    each with its relu, concatenated (torchvision squeezenet1_1 layout)."""

    def __init__(self, in_ch: int, squeeze_ch: int, expand_ch: int):
        super().__init__()
        self.squeeze = Conv2d(in_ch, squeeze_ch, 1)
        self.expand1x1 = Conv2d(squeeze_ch, expand_ch, 1)
        self.expand3x3 = Conv2d(squeeze_ch, expand_ch, 3, padding=1)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))], 1)


# torchvision squeezenet1_1.features index -> (squeeze_ch, expand_ch) of its
# Fire; the reference's seven slices end after features 1, 4, 7, 9, 10, 11, 12
_SQUEEZE_FIRES = {3: (16, 64), 4: (16, 64), 6: (32, 128), 7: (32, 128),
                  9: (48, 192), 10: (48, 192), 11: (64, 256), 12: (64, 256)}


class SqueezeNetFeatures(nn.Module):
    """7-tap squeezenet1_1 feature pyramid (LPIPS 'squeeze'); its pools take
    torchvision's ``ceil_mode=True``."""

    _TAP_AFTER = (4, 7, 9, 10, 11, 12)  # the Fires closing slices 2..7
    _POOL_BEFORE = (3, 6, 9)

    def __init__(self):
        super().__init__()
        self.conv0 = Conv2d(3, 64, 3, stride=2)
        in_ch = 64
        for i, (s, e) in _SQUEEZE_FIRES.items():
            setattr(self, f"fire{i}", Fire(in_ch, s, e))
            in_ch = 2 * e

    def forward(self, x) -> List[torch.Tensor]:
        x = F.relu(self.conv0(x))
        outs = [x]
        for i in _SQUEEZE_FIRES:
            if i in self._POOL_BEFORE:
                x = F.max_pool2d(x, 3, 2, ceil_mode=True)
            x = getattr(self, f"fire{i}")(x)
            if i in self._TAP_AFTER:
                outs.append(x)
        return outs


class VGG19Feature54(nn.Module):
    """VGG19 conv5_4 (pre-ReLU, feature_layer 34) with ImageNet input
    normalisation (architecture.py:1060-1088, networks.py:247-261). The
    mean and std are non-persistent f32 buffers, made once and cast to the
    input's dtype in the forward: the forward copies nothing from the host,
    so a CUDA graph can capture it, and the state dict holds the convs
    only."""

    def __init__(self, use_input_norm: bool = True):
        super().__init__()
        self.use_input_norm = use_input_norm
        self.stack = _ConvStack(_VGG19_CFG, (15,), final_conv_no_relu=True)
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x):
        if self.use_input_norm:
            x = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        return self.stack(x)[0]


def load_torchvision_features(net: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Copy a torchvision state dict into a backbone (``load_lpips_params``
    of the JAX package): ``features.{i}.weight/bias`` into a conv stack's
    convs in order, or a squeezenet1_1's ``features.0`` and
    ``features.{i}.{squeeze,expand1x1,expand3x3}`` into a
    ``SqueezeNetFeatures``."""
    if isinstance(net, SqueezeNetFeatures):
        pairs = [(net.conv0, "features.0")]
        for i in _SQUEEZE_FIRES:
            fire = getattr(net, f"fire{i}")
            pairs += [(getattr(fire, part), f"features.{i}.{part}")
                      for part in ("squeeze", "expand1x1", "expand3x3")]
        with torch.no_grad():
            for conv, key in pairs:
                conv.weight.copy_(sd[f"{key}.weight"])
                conv.bias.copy_(sd[f"{key}.bias"])
        return
    stack = net.stack if hasattr(net, "stack") else net
    ids = sorted({int(k.split(".")[1]) for k in sd
                  if k.startswith("features.") and k.endswith(".weight") and sd[k].dim() == 4})
    if len(ids) != stack.n_convs:
        raise ValueError(f"backbone state dict has {len(ids)} convs, the stack {stack.n_convs}")
    with torch.no_grad():
        for conv, i in zip(stack.convs(), ids):
            conv.weight.copy_(sd[f"features.{i}.weight"])
            conv.bias.copy_(sd[f"features.{i}.bias"])
