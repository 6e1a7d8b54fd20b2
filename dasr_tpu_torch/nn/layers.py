"""Shared layer primitives (PyTorch, NCHW in ``channels_last`` memory).

Counterpart of ``dasr_tpu.nn.layers``. Parameters live in f32; a conv runs
in its input's dtype (bf16 on the card by default), like flax's ``dtype``.
``conv_block`` returns an ``nn.Sequential`` laid out like the reference's
``conv_block`` (codes/SRN/models/modules/block.py:130-157), so reference
``.pth`` names load as they are.

``BatchNorm2d`` and the spectral-norm layers keep flax's running state
(BatchNorm's biased variance, SpectralNorm's ``u`` and ``sigma``); whether
a forward moves it is each layer's ``update_stats``, which
``stats_updates`` sets over a network for the length of a block.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dasr_tpu_torch.core.dist import world_mean
from dasr_tpu_torch.utils import trace


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with f32 parameters cast to the input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """``nn.Linear`` with f32 parameters cast to the input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's statistics: in training mode it normalises by
    the batch's mean and biased variance, both taken as flax takes them
    (var = E[x^2] - E[x]^2), and where ``update_stats`` holds it moves the
    running mean and variance towards them by ``momentum`` (torch's 0.1 is
    flax's 0.9). ``nn.BatchNorm2d`` moves the running variance towards the
    unbiased variance instead. Statistics and the affine map are taken in
    f32; the result has the input's dtype. In a world of several ranks the
    statistics are the global batch's (``dist.world_mean``, under autograd),
    as under JAX's mesh. Each forward that moves the statistics counts
    ``bn.layer_updates`` (``utils/trace.py``)."""

    update_stats = True

    def forward(self, x):
        xf = x.float()
        if not self.training:
            return F.batch_norm(xf, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps).to(x.dtype)
        # the global batch's statistics in a world of several ranks
        mean, sq = world_mean(torch.stack([xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))]))
        var = (sq - mean * mean).clamp_min(0.0)
        if self.update_stats:
            trace.count("bn.layer_updates")
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked += 1
        mul = self.weight * torch.rsqrt(var + self.eps)
        return ((xf - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None]).to(x.dtype)


def _l2_normalize(v, eps):
    return v * torch.rsqrt((v * v).sum() + eps)


class _SpectralNorm:
    """flax's ``nn.SpectralNorm`` over a layer's weight, one power iteration
    a forward: with W the weight as (out, fan in) and u the (1, out)
    buffer, v = l2(u W), u' = l2(v W^T), sigma = v W^T u'^T, and the layer
    runs with W / sigma. u' and v are constants to autograd, sigma is not.
    Where ``update_stats`` holds, u' and sigma are stored. ``u`` starts as
    a standard normal draw, as flax's."""

    update_stats = False
    eps = 1e-12

    def _sn_init(self, out_features: int):
        self.register_buffer("u", torch.randn(1, out_features))
        self.register_buffer("sigma", torch.ones(()))

    def sn_weight(self):
        w = self.weight
        wm = w.reshape(w.shape[0], -1)
        with torch.no_grad():
            v = _l2_normalize(self.u @ wm, self.eps)
            u = _l2_normalize(v @ wm.T, self.eps)
        sigma = (v @ wm.T @ u.T)[0, 0]
        if self.update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


class SNConv2d(_SpectralNorm, Conv2d):
    """``Conv2d`` with flax's spectral normalisation of its kernel."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._sn_init(self.out_channels)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.sn_weight().to(x.dtype), bias)


class SNLinear(_SpectralNorm, Linear):
    """``Linear`` with flax's spectral normalisation of its kernel."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._sn_init(self.out_features)

    def forward(self, x):
        return F.linear(x, self.sn_weight().to(x.dtype), self.bias.to(x.dtype))


@contextlib.contextmanager
def stats_updates(net: nn.Module, on: bool):
    """Within the block, every ``BatchNorm2d`` and spectral-norm layer of
    ``net`` moves its running state (``on``) or keeps it."""
    layers = [m for m in net.modules() if isinstance(m, (BatchNorm2d, _SpectralNorm))]
    before = [m.__dict__.get("update_stats") for m in layers]
    for m in layers:
        m.update_stats = on
    try:
        yield
    finally:
        for m, b in zip(layers, before):
            if b is None:
                del m.update_stats
            else:
                m.update_stats = b


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
    """Norm factory: 'batch' (``BatchNorm2d``: eps 1e-5, momentum 0.1, flax's
    running variance) / 'instance' (no affine, no running stats) / None."""
    if norm_type is None:
        return None
    low = norm_type.lower()
    if low == "batch":
        return BatchNorm2d(channels, eps=1e-5, momentum=0.1)
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
    """flax's default conv and dense init over ``net``: lecun-normal kernels,
    zero biases (PReLU slopes keep their 0.25, BatchNorm its unit scale,
    flax's init too); a spectral-norm layer's ``u`` a standard normal draw."""
    for m in net.modules():
        if isinstance(m, (Conv2d, Linear)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        if isinstance(m, _SpectralNorm):
            with torch.no_grad():
                m.u.normal_(generator=generator)
    return net


def kaiming_normal_(weight: torch.Tensor, scale: float = 1.0,
                    generator: Optional[torch.Generator] = None):
    """torch kaiming_normal_(fan_in, a=0) x scale — the ESRGAN G init
    (reference: codes/SRN/models/networks.py:15-40, scale 0.1 for RDB convs)."""
    std = math.sqrt(2.0 / weight[0].numel()) * scale
    with torch.no_grad():
        return weight.normal_(0.0, std, generator=generator)
