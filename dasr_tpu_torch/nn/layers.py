"""Shared layer primitives (PyTorch, NCHW in ``channels_last`` memory).

Counterpart of ``dasr_tpu.nn.layers``. Parameters live in f32; a conv runs
in its input's dtype (bf16 on the card by default), like flax's ``dtype``.
``conv_block`` returns an ``nn.Sequential`` laid out like the reference's
``conv_block`` (codes/SRN/models/modules/block.py:130-157), so reference
``.pth`` names load as they are.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with f32 parameters cast to the input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class PReLU(nn.PReLU):
    """Parametric ReLU with a single shared slope, cast to the input's dtype."""

    def forward(self, x):
        return F.prelu(x, self.weight.to(x.dtype))


def act_fn(name: Optional[str], neg_slope: float = 0.2) -> Optional[nn.Module]:
    if name is None:
        return None
    low = name.lower()
    if low == "relu":
        return nn.ReLU()
    if low in ("leakyrelu", "lrelu"):
        return nn.LeakyReLU(neg_slope)
    if low == "sigmoid":
        return nn.Sigmoid()
    raise NotImplementedError(f"activation [{name}] not found")


def get_norm(norm_type: Optional[str], channels: int) -> Optional[nn.Module]:
    """Norm factory: 'batch' / 'instance' / None (torch defaults: eps 1e-5,
    BatchNorm momentum 0.1, InstanceNorm without affine or running stats)."""
    if norm_type is None:
        return None
    low = norm_type.lower()
    if low == "batch":
        return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)
    if low == "instance":
        return nn.InstanceNorm2d(channels, eps=1e-5)
    raise NotImplementedError(f"normalization layer [{norm_type}] not found")


def conv_block(
    in_ch: int,
    out_ch: int,
    kernel_size: int = 3,
    stride: int = 1,
    dilation: int = 1,
    groups: int = 1,
    bias: bool = True,
    norm_type: Optional[str] = None,
    act_type: Optional[str] = "leakyrelu",
    mode: str = "CNA",
) -> nn.Sequential:
    """Conv + norm + activation in CNA or NAC order, zero padding."""
    pad = (kernel_size - 1) // 2 * dilation
    conv = Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=pad,
                  dilation=dilation, groups=groups, bias=bias)
    if act_type and act_type.lower() == "prelu":
        act = PReLU(num_parameters=1, init=0.2)  # reference block.py:20-21
    else:
        act = act_fn(act_type)
    if mode == "CNA":
        layers = [conv, get_norm(norm_type, out_ch), act]
    elif mode == "NAC":
        layers = [get_norm(norm_type, in_ch), act, conv]
    else:
        raise NotImplementedError(f"conv mode [{mode}] not found")
    return nn.Sequential(*(m for m in layers if m is not None))


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None):
    """flax's default conv init: truncated normal (+-2 sd) of variance
    1 / fan_in, rescaled for the truncation."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def init_lecun_(net: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """flax's default conv init over ``net``: lecun-normal kernels, zero
    biases (PReLU slopes keep their 0.25, flax's init too)."""
    for m in net.modules():
        if isinstance(m, Conv2d):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return net


def kaiming_normal_(weight: torch.Tensor, scale: float = 1.0,
                    generator: Optional[torch.Generator] = None):
    """torch kaiming_normal_(fan_in, a=0) x scale — the ESRGAN G init
    (reference: codes/SRN/models/networks.py:15-40, scale 0.1 for RDB convs)."""
    std = math.sqrt(2.0 / weight[0].numel()) * scale
    with torch.no_grad():
        return weight.normal_(0.0, std, generator=generator)
