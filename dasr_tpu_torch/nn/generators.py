"""Generators. Counterpart of ``dasr_tpu.nn.generators``; so far the x4
ESRGAN generator ``RRDBNet`` that DASR serves and trains, and the DSN
stage's degradation generators ``DeResnet`` and ``DSGANGenerator``."""

from __future__ import annotations

import logging
import math
from typing import Optional

import torch
import torch.nn as nn

from dasr_tpu_torch.nn.blocks import (
    RDB5C,
    RRDB,
    ResidualBlock,
    ShortcutBlock,
    pixelshuffle_block,
    sequential,
    upconv,
)
from dasr_tpu_torch.nn.layers import (
    Conv2d,
    PReLU,
    conv_block,
    init_lecun_,
    kaiming_normal_,
    lecun_normal_,
)

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


class DeResnet(nn.Module):
    """DSN degradation generator, HR -> LR / ``scale`` (reference:
    codes/DSN/model.py:25-55): ``block_input`` (3x3 conv, PReLU),
    ``res_blocks``, ``down_sample`` (log2(scale) stride-2 3x3 convs with
    padding 1, each with a PReLU), ``block_output`` (3x3 conv to RGB), then
    a sigmoid. The names are the reference's, so a DSN checkpoint's
    ``model_g_state_dict`` loads with plain ``load_state_dict``.

    Activations run in ``dtype``; parameters stay f32. ``packed_trunk`` is
    the JAX package's TPU rewrite of the same function (a 2x2
    space-to-depth trunk); it is accepted and ignored."""

    def __init__(self, n_res_blocks: int = 8, scale: int = 4, features: int = 64,
                 packed_trunk: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if packed_trunk:
            logger.info("DeResnet: packed_trunk ignored: a TPU rewrite of the same math, "
                        "not ported")
        n_down = {1: 0, 2: 1, 4: 2}[scale]
        self.block_input = nn.Sequential(Conv2d(3, features, 3, padding=1), PReLU())
        self.res_blocks = nn.Sequential(*(ResidualBlock(features) for _ in range(n_res_blocks)))
        self.down_sample = nn.Sequential(*(
            m for _ in range(n_down)
            for m in (Conv2d(features, features, 3, stride=2, padding=1), PReLU())))
        self.block_output = Conv2d(features, 3, 3, padding=1)
        self.dtype = dtype

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """The JAX init's law: lecun-normal convs, zero biases, slopes 0.25."""
        return init_lecun_(self, generator)

    def forward(self, x):
        """x (B, 3, H, W) -> (B, 3, ceil(H / scale), ceil(W / scale)) in ``dtype``."""
        h = self.block_input(x.to(self.dtype).contiguous(memory_format=torch.channels_last))
        h = self.down_sample(self.res_blocks(h))
        return torch.sigmoid(self.block_output(h))


class DSGANGenerator(DeResnet):
    """DSGAN's 1:1 corruption generator (reference: codes/DSN/model.py:7-22):
    the DeResnet layout without down-sampling."""

    def __init__(self, n_res_blocks: int = 8, features: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__(n_res_blocks, scale=1, features=features, dtype=dtype)
