"""Core residual blocks of the x4 ESRGAN generator.

Counterpart of ``dasr_tpu.nn.blocks``:
  * ``RDB5C`` / ``RRDB``   — ESRGAN residual-dense core
                             (reference: codes/SRN/models/modules/block.py:254-309)
  * ``upconv``             — nearest-x`factor` + conv + act (block.py:854-861)
  * ``pixelshuffle_block`` — conv + depth-to-space + act (block.py:838-851)
  * ``ShortcutBlock`` / ``sequential`` — the reference's containers, so a
    module tree carries the reference's parameter names.
  * ``ResidualBlock``      — the DSN generators' conv-PReLU-conv + skip
                             (codes/DSN/model.py:213-224)

``RDB5C`` runs ``ops.rdb.fused_rdb`` (the hand-written kernel on the card,
its plain version on the CPU; under grad mode through its autograd
Function); with a norm layer, another activation or another conv order it
runs the literal dense chain of ``nn`` layers. The
grouped-scatter regrouping of the JAX module is a TPU rewrite and is not
ported.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch
import torch.nn as nn

from dasr_tpu_torch.nn.layers import Conv2d, PReLU, act_fn, conv_block
from dasr_tpu_torch.ops.rdb import fused_rdb, prepare_weights


def sequential(*args) -> nn.Module:
    """The reference's ``B.sequential``: one level of nested
    ``nn.Sequential``s is flattened into the result."""
    if len(args) == 1:
        if isinstance(args[0], OrderedDict):
            raise NotImplementedError("sequential does not support OrderedDict input")
        return args[0]
    modules = []
    for module in args:
        if isinstance(module, nn.Sequential):
            modules.extend(module.children())
        elif isinstance(module, nn.Module):
            modules.append(module)
    return nn.Sequential(*modules)


class ShortcutBlock(nn.Module):
    """x + sub(x) (reference: block.py:97-111)."""

    def __init__(self, submodule: nn.Module):
        super().__init__()
        self.sub = submodule

    def forward(self, x):
        return x + self.sub(x)


class RDB5C(nn.Module):
    """Residual Dense Block, 5 convs (block.py:254-286); out = x + 0.2 * conv5.

    ``conv{k}`` are reference-named conv blocks (OIHW f32 weights). The
    kernel path takes the same weights as HWIO in the working dtype. Under
    grad mode they are differentiable casts of the parameters, made on
    every call, so autograd routes the gradients back to them; otherwise
    they are prepared once per parameter version (an optimizer step bumps
    ``_version``) and cached here."""

    def __init__(self, nc: int = 64, gc: int = 32, norm_type: Optional[str] = None,
                 act_type: str = "leakyrelu", mode: str = "CNA"):
        super().__init__()
        for k in range(5):
            setattr(self, f"conv{k + 1}", conv_block(
                nc + k * gc, gc if k < 4 else nc, 3, norm_type=norm_type,
                act_type=act_type if k < 4 else None, mode="CNA",
            ))
        self.fused = (
            norm_type is None and mode == "CNA"
            and act_type.lower() in ("leakyrelu", "lrelu")
        )
        self._cache = None

    def convs(self):
        return [getattr(self, f"conv{k + 1}")[0] for k in range(5)]

    def kernel_weights(self, dtype):
        """(HWIO kernels in ``dtype``, f32 biases) for ``fused_rdb``."""
        convs = self.convs()
        if torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters()):
            return (
                tuple(c.weight.permute(2, 3, 1, 0).to(dtype).contiguous() for c in convs),
                tuple(c.bias.float() for c in convs),
            )
        key = (dtype,) + tuple(
            (p.device, p.data_ptr(), p._version) for c in convs for p in (c.weight, c.bias)
        )
        if self._cache is None or self._cache[0] != key:
            weights = prepare_weights(
                [c.weight.permute(2, 3, 1, 0) for c in convs], [c.bias for c in convs], dtype
            )
            self._cache = (key, weights)
        return self._cache[1]

    def forward(self, x):
        if not self.fused:
            # literal chain (block.py:280-286), with the optional norm
            feats = [x]
            for k in range(4):
                feats.append(getattr(self, f"conv{k + 1}")(torch.cat(feats, 1)))
            return x + self.conv5(torch.cat(feats, 1)) * 0.2
        ks, bs = self.kernel_weights(x.dtype)
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        return fused_rdb(nhwc, ks, bs).permute(0, 3, 1, 2)


class ResidualBlock(nn.Module):
    """x + conv2(prelu(conv1(x))), 3x3 convs with zero padding 1 and one
    PReLU slope; named ``conv1``/``prelu``/``conv2`` as the reference."""

    def __init__(self, channels: int = 64):
        super().__init__()
        self.conv1 = Conv2d(channels, channels, 3, padding=1)
        self.prelu = PReLU()
        self.conv2 = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(self.prelu(self.conv1(x)))


class RRDB(nn.Module):
    """Residual-in-Residual Dense Block (block.py:289-309)."""

    def __init__(self, nc: int = 64, gc: int = 32, norm_type: Optional[str] = None,
                 act_type: str = "leakyrelu"):
        super().__init__()
        self.RDB1 = RDB5C(nc, gc, norm_type, act_type)
        self.RDB2 = RDB5C(nc, gc, norm_type, act_type)
        self.RDB3 = RDB5C(nc, gc, norm_type, act_type)

    def forward(self, x):
        return x + self.RDB3(self.RDB2(self.RDB1(x))) * 0.2


def upconv(in_ch: int, out_ch: int, factor: int = 2,
           act_type: Optional[str] = "relu") -> nn.Sequential:
    """Nearest-neighbour x`factor` upsample + conv + act (block.py:854-861)."""
    return sequential(
        nn.Upsample(scale_factor=factor, mode="nearest"),
        conv_block(in_ch, out_ch, 3, act_type=act_type),
    )


class DepthToSpace(nn.Module):
    """(B, r*r*C, H, W) -> (B, C, r*H, r*W) in ``dasr_tpu``'s channel order:
    input channel (i*r + j)*C + c lands at offset (i, j) of channel c.
    ``nn.PixelShuffle`` orders the channels as c*r*r + i*r + j instead."""

    def __init__(self, r: int):
        super().__init__()
        self.r = r

    def forward(self, x):
        b, c, h, w = x.shape
        r = self.r
        x = x.reshape(b, r, r, c // (r * r), h, w).permute(0, 3, 4, 1, 5, 2)
        return x.reshape(b, c // (r * r), h * r, w * r)


def pixelshuffle_block(in_ch: int, out_ch: int, factor: int = 2,
                       act_type: Optional[str] = "relu") -> nn.Sequential:
    """conv to r^2*C, depth-to-space, act (block.py:838-851)."""
    act = act_fn(act_type)
    mods = [conv_block(in_ch, out_ch * factor * factor, 3, act_type=None), DepthToSpace(factor)]
    return sequential(*mods, *([act] if act is not None else []))
