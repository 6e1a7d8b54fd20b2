"""Generators. Counterpart of ``dasr_tpu.nn.generators``; so far the x4
ESRGAN generator ``RRDBNet`` that DASR serves and trains."""

from __future__ import annotations

import logging
import math
from typing import Optional

import torch
import torch.nn as nn

from dasr_tpu_torch.nn.blocks import (
    RDB5C,
    RRDB,
    ShortcutBlock,
    pixelshuffle_block,
    sequential,
    upconv,
)
from dasr_tpu_torch.nn.layers import Conv2d, conv_block, kaiming_normal_, lecun_normal_

logger = logging.getLogger("base")


class RRDBNet(nn.Module):
    """ESRGAN generator (architecture.py:174-205). nf=64 nb=23 gc=32 by default.

    The module tree is the reference's: ``model.0`` stem conv,
    ``model.1.sub.{i}.RDB{j}.conv{k}.0`` the trunk, ``model.1.sub.{nb}`` the
    trunk conv, then the upsampler and the two HR convs, so a reference
    ``*_G.pth`` loads with plain ``load_state_dict``.

    Activations run in ``dtype`` (bf16 on the card by default); parameters
    stay f32. ``fused_tail`` and ``scan_blocks`` are the JAX package's TPU
    rewrites of the same math (phase-conv tail, ``lax.scan`` trunk); they are
    accepted and ignored."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64, nb: int = 23,
                 gc: int = 32, upscale: int = 4, norm_type: Optional[str] = None,
                 act_type: str = "leakyrelu", mode: str = "CNA",
                 upsample_mode: str = "upconv", fused_tail: bool = False,
                 scan_blocks: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        for flag, on in (("fused_tail", fused_tail), ("scan_blocks", scan_blocks)):
            if on:
                logger.info(f"RRDBNet: {flag} ignored: a TPU rewrite of the same math, not ported")
        n_up = 1 if upscale == 3 else int(math.log2(upscale))
        factor = 3 if upscale == 3 else 2
        fea_conv = conv_block(in_nc, nf, 3, act_type=None)
        trunk = [RRDB(nf, gc, norm_type, act_type) for _ in range(nb)]
        lr_conv = conv_block(nf, nf, 3, norm_type=norm_type, act_type=None, mode=mode)
        if upsample_mode == "upconv":
            up = [upconv(nf, nf, factor, act_type) for _ in range(n_up)]
        elif upsample_mode == "pixelshuffle":
            up = [pixelshuffle_block(nf, nf, factor, act_type) for _ in range(n_up)]
        else:
            raise NotImplementedError(f"upsample mode [{upsample_mode}] is not found")
        hr_conv0 = conv_block(nf, nf, 3, act_type=act_type)
        hr_conv1 = conv_block(nf, out_nc, 3, act_type=None)
        self.model = sequential(
            fea_conv, ShortcutBlock(sequential(*trunk, lr_conv)), *up, hr_conv0, hr_conv1
        )
        self.dtype = dtype

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """The JAX init's law, drawn from ``generator``: kaiming fan-in x 0.1
        for RDB convs, lecun-normal for every other conv, zero biases."""
        rdb_convs = {id(c) for m in self.modules() if isinstance(m, RDB5C) for c in m.convs()}
        for m in self.modules():
            if isinstance(m, Conv2d):
                if id(m) in rdb_convs:
                    kaiming_normal_(m.weight, 0.1, generator)
                else:
                    lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        return self

    def forward(self, x):
        """x (B, in_nc, H, W) -> (B, out_nc, upscale*H, upscale*W) in ``dtype``."""
        return self.model(x.to(self.dtype).contiguous(memory_format=torch.channels_last))
