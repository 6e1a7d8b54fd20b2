"""Generators. Counterpart of ``dasr_tpu.nn.generators``: the x4 ESRGAN
generator ``RRDBNet`` that DASR, 'sr' and 'srgan' serve and train, its
DDM-conditioned variants ``RRDBNetResidualConv`` (the Adaptive model's) and
``RRDBNetSEAN``, ``SRResNet`` ('sr' and 'srgan'), the SRN's degradation
nets ``DeResnetSRN`` ('De_Resnet'), and the DSN stage's ``DeResnet`` and
``DSGANGenerator``."""

from __future__ import annotations

import logging
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dasr_tpu_torch.nn.adaptive_blocks import RRDBSEAN
from dasr_tpu_torch.nn.blocks import (
    RDB5C,
    RRDB,
    ResidualBlock,
    ResNetBlock,
    RRDBResidualConv,
    RRDBResidualConvConcat,
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
        fea_conv = conv_block(in_nc, nf, 3, act_type=None)
        trunk = [RRDB(nf, gc, norm_type, act_type) for _ in range(nb)]
        lr_conv = conv_block(nf, nf, 3, norm_type=norm_type, act_type=None, mode=mode)
        self.model = sequential(fea_conv, ShortcutBlock(sequential(*trunk, lr_conv)),
                                _tail(nf, out_nc, upscale, act_type, upsample_mode))
        self.dtype = dtype

    def init_weights(self, generator: Optional[torch.Generator] = None):
        return init_rrdb_law_(self, generator)

    def forward(self, x):
        """x (B, in_nc, H, W) -> (B, out_nc, upscale*H, upscale*W) in ``dtype``."""
        return self.model(x.to(self.dtype).contiguous(memory_format=torch.channels_last))


def init_rrdb_law_(net: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """The JAX init's law of the ESRGAN generators, drawn from ``generator``:
    kaiming fan-in x 0.1 for RDB convs, lecun-normal for every other conv,
    zero biases; other parameters keep their constructor's constants."""
    rdb_convs = {id(c) for m in net.modules() if isinstance(m, RDB5C) for c in m.convs()}
    for m in net.modules():
        if isinstance(m, Conv2d):
            if id(m) in rdb_convs:
                kaiming_normal_(m.weight, 0.1, generator)
            else:
                lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return net


def _tail(nf: int, out_nc: int, upscale: int, act_type: str, upsample_mode: str = "upconv"):
    """The x``upscale`` upsampler and the two HR convs."""
    n_up = 1 if upscale == 3 else int(math.log2(upscale))
    factor = 3 if upscale == 3 else 2
    if upsample_mode == "upconv":
        up = [upconv(nf, nf, factor, act_type) for _ in range(n_up)]
    elif upsample_mode == "pixelshuffle":
        up = [pixelshuffle_block(nf, nf, factor, act_type) for _ in range(n_up)]
    else:
        raise NotImplementedError(f"upsample mode [{upsample_mode}] is not found")
    return sequential(*up, conv_block(nf, nf, 3, act_type=act_type),
                      conv_block(nf, out_nc, 3, act_type=None))


class SRResNet(nn.Module):
    """SRResNet (architecture.py:18-49, as networks.py builds it: act 'relu',
    the pixelshuffle upsampler): ``model.0`` stem conv,
    ``model.1.sub.{i}.res`` the ``ResNetBlock`` trunk, ``model.1.sub.{nb}``
    the trunk conv (norm, no act), the long skip, the upsampler and the two
    HR convs, the reference's module tree, so a reference ``.pth`` loads as
    it is. Activations run in ``dtype``; parameters stay f32."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64, nb: int = 16,
                 upscale: int = 4, norm_type: Optional[str] = "batch", mode: str = "NAC",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        fea_conv = conv_block(in_nc, nf, 3, act_type=None)
        trunk = [ResNetBlock(nf, norm_type, "relu", mode) for _ in range(nb)]
        lr_conv = conv_block(nf, nf, 3, norm_type=norm_type, act_type=None, mode=mode)
        self.model = sequential(fea_conv, ShortcutBlock(sequential(*trunk, lr_conv)),
                                _tail(nf, out_nc, upscale, "relu", "pixelshuffle"))
        self.dtype = dtype

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """The JAX init's law: lecun-normal convs, zero biases."""
        return init_lecun_(self, generator)

    def forward(self, x):
        return self.model(x.to(self.dtype).contiguous(memory_format=torch.channels_last))


class DeResnetSRN(nn.Module):
    """The SRN's ``arch.De_Resnet`` family, HR -> LR, no output sigmoid
    (architecture.py:51-171): ``model.0`` stem conv, ``model.1.sub`` the
    ``ResNetBlock`` trunk and its conv with the long skip, then by
    ``variant``: 'strided' log2(``downscale``) stride-2 conv blocks with the
    activation (De_Resnet), 'x2' one of them (De_Resnetdx2), 'bilinear' a
    bilinear x1/4 resize without antialiasing (De_Resnet_bilinear), and two
    conv blocks (the norm, no act), under ``model`` or, for 'bilinear', under
    ``Afterconv``: the layout ``dasr_tpu``'s ``import_deresnet_srn_params``
    reads a reference ``.pth`` from."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64, nb: int = 8,
                 downscale: int = 4, norm_type: Optional[str] = "batch",
                 act_type: Optional[str] = "prelu", mode: str = "NAC",
                 variant: str = "strided", dtype: torch.dtype = torch.float32):
        super().__init__()
        n_down = {"strided": int(math.log2(downscale)), "x2": 1, "bilinear": 0}.get(variant)
        if n_down is None:
            raise NotImplementedError(f"De_Resnet variant [{variant}] not recognized")
        trunk = [ResNetBlock(nf, norm_type, act_type, mode) for _ in range(nb)]
        head = [conv_block(in_nc, nf, 3, act_type=None),
                ShortcutBlock(sequential(*trunk, conv_block(nf, nf, 3, norm_type=norm_type,
                                                            act_type=None, mode=mode)))]
        down = [conv_block(nf, nf, 3, stride=2, act_type=act_type) for _ in range(n_down)]
        after = [conv_block(nf, nf, 3, norm_type=norm_type, act_type=None, mode=mode),
                 conv_block(nf, out_nc, 3, norm_type=norm_type, act_type=None, mode=mode)]
        self.bilinear = variant == "bilinear"
        if self.bilinear:
            self.model, self.Afterconv = sequential(*head), sequential(*after)
        else:
            self.model = sequential(*head, *down, *after)
        self.dtype = dtype

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """The JAX init's law: lecun-normal convs, zero biases, PReLU 0.2."""
        return init_lecun_(self, generator)

    def forward(self, x):
        """x (B, in_nc, H, W) -> (B, out_nc, H / 4, W / 4) ('x2': H / 2) in
        ``dtype``."""
        h = self.model(x.to(self.dtype).contiguous(memory_format=torch.channels_last))
        if not self.bilinear:
            return h
        h = F.interpolate(h.float(), size=(h.shape[-2] // 4, h.shape[-1] // 4), mode="bilinear",
                          align_corners=False, antialias=False).to(h.dtype)
        return self.Afterconv(h)


class _ConditionedRRDBNet(nn.Module):
    """Shared frame of the DDM-conditioned generators: ``fea_conv``, the
    conditioned and plain trunk (``_trunk``), ``lr_conv``, the long skip and
    ``tail``; ``forward(x, w)`` with a (B, 1, h, w) map at the LR size.
    These generators have no published ``.pth`` layout; their parameter
    names are the port's own (``checkpoints`` carries JAX trees to them)."""

    def init_weights(self, generator: Optional[torch.Generator] = None):
        return init_rrdb_law_(self, generator)

    def forward(self, x, w):
        """x (B, in_nc, H, W), w (B, 1, H, W) -> (B, out_nc, upscale*H,
        upscale*W) in ``dtype``."""
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        fea = self.fea_conv(x)
        return self.tail(fea + self.lr_conv(self._trunk(fea, w.to(self.dtype))))


class RRDBNetResidualConv(_ConditionedRRDBNet):
    """The DASR Adaptive generator (architecture.py:208-297):
    ``nb_ada`` DDM-conditioned blocks (``RRDBResidualConv``, or
    ``RRDBResidualConvConcat`` with ``concat``) on the head features, then
    ``nb`` plain RRDBs, the trunk conv, the long skip and the
    nearest-upconv tail."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64, nb: int = 23,
                 gc: int = 32, nb_ada: int = 1, concat: bool = False, upscale: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        block = RRDBResidualConvConcat if concat else RRDBResidualConv
        self.fea_conv = conv_block(in_nc, nf, 3, act_type=None)
        self.ada_blocks = nn.ModuleList(block(nf, gc) for _ in range(nb_ada))
        self.trunk = nn.Sequential(*(RRDB(nf, gc) for _ in range(nb)))
        self.lr_conv = conv_block(nf, nf, 3, act_type=None)
        self.tail = _tail(nf, out_nc, upscale, "leakyrelu")
        self.dtype = dtype

    def _trunk(self, h, w):
        for block in self.ada_blocks:
            h = block(h, w)
        return self.trunk(h)


class RRDBNetSEAN(_ConditionedRRDBNet):
    """ESRGAN generator with trailing SEAN-conditioned RRDBs
    (architecture.py:873-918): ``nb`` plain RRDBs, then ``nb_ada``
    ``RRDBSEAN``, the trunk conv, the long skip, the upsampler
    (``upsample_mode``) and the HR convs."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64, nb: int = 23,
                 gc: int = 32, nb_ada: int = 1, upscale: int = 4,
                 norm_type: Optional[str] = None, upsample_mode: str = "upconv",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fea_conv = conv_block(in_nc, nf, 3, act_type=None)
        self.trunk = nn.Sequential(*(RRDB(nf, gc, norm_type) for _ in range(nb)))
        self.ada_blocks = nn.ModuleList(RRDBSEAN(nf, gc) for _ in range(nb_ada))
        self.lr_conv = conv_block(nf, nf, 3, norm_type=norm_type, act_type=None)
        self.tail = _tail(nf, out_nc, upscale, "leakyrelu", upsample_mode)
        self.dtype = dtype

    def _trunk(self, h, w):
        h = self.trunk(h)
        for block in self.ada_blocks:
            h = block(h, w)
        return h


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
