"""Feature-extraction backbones (AlexNet, VGG19 conv5_4) on NCHW tensors.

Counterpart of ``dasr_tpu.nn.vgg``: the LPIPS 'alex' backbone (reference:
codes/PerceptualSimilarity/models/pretrained_networks.py slices
torchvision's AlexNet into five taps) and the SRN VGG feature loss
(architecture.py:1060-1088, VGG19 feature_layer 34). Conv modules are
named ``stack.conv{i}`` in torch module order, as the JAX package names
them; ``load_torchvision_features`` reads a torchvision ``features.{i}``
state dict. No weights ship with the repository. VGG16 and SqueezeNet
(LPIPS 'vgg' / 'squeeze') wait for ROADMAP A.10.
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


class VGG19Feature54(nn.Module):
    """VGG19 conv5_4 (pre-ReLU, feature_layer 34) with ImageNet input
    normalisation (architecture.py:1060-1088, networks.py:247-261)."""

    def __init__(self, use_input_norm: bool = True):
        super().__init__()
        self.use_input_norm = use_input_norm
        self.stack = _ConvStack(_VGG19_CFG, (15,), final_conv_no_relu=True)

    def forward(self, x):
        if self.use_input_norm:
            mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
            std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
            x = (x - mean) / std
        return self.stack(x)[0]


def load_torchvision_features(stack: _ConvStack, sd: Dict[str, torch.Tensor]) -> None:
    """Copy a torchvision ``features.{i}.weight/bias`` state dict into a conv
    stack, matching convs in order (``load_lpips_params`` of the JAX
    package)."""
    ids = sorted({int(k.split(".")[1]) for k in sd
                  if k.startswith("features.") and k.endswith(".weight") and sd[k].dim() == 4})
    if len(ids) != stack.n_convs:
        raise ValueError(f"backbone state dict has {len(ids)} convs, the stack {stack.n_convs}")
    with torch.no_grad():
        for conv, i in zip(stack.convs(), ids):
            conv.weight.copy_(sd[f"features.{i}.weight"])
            conv.bias.copy_(sd[f"features.{i}.bias"])
