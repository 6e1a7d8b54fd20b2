"""DDM-conditioning and channel-attention block variants.

Counterpart of ``dasr_tpu.nn.adaptive_blocks``, the reference's conditioned
RRDB zoo (codes/SRN/models/modules/block.py:335-828):

  * ``AffineModule`` / ``RRDBAffine`` — DDM -> conv features, affine
    gamma * f1 * x + beta * f2 after each RDB (block.py:532-558 / 335-365)
  * ``SEANModule`` / ``RRDBSEAN``     — SEAN-style modulation: gamma / beta
    from the channel-repeated DDM and from conv'd DDM paths, with learned
    blend alphas (block.py:561-595 / 367-435)
  * ``RRDBAda``                       — RDB chain scaled by ddm * lambda
    (block.py:438-460)
  * ``AdaptiveModule``                — real/fake dual RRDB paths selected
    per sample by a domain mask (block.py:598-615); as in ``dasr_tpu``,
    both paths run and a select keeps them
  * ``RRDBCatInput`` / ``RRDBWithFeatureOut`` — an RRDB whose RDB inputs
    are concatenated with a conditioning tensor; an RRDB with a 1x1 feature
    tap (block.py:311-333, 648-...)
  * ``CALayer`` / ``RCAB`` / ``CARRDB`` — channel attention (block.py:644-828)

Reference quirks kept, as ``dasr_tpu`` keeps them for checkpoint parity:
``AffineModule`` computes both feature maps with the first conv stack
(``df2 = df1``); ``SEANModule`` takes ``f_rep_beta`` from the gamma stack
and still holds the unused beta stack's parameters (``rep_beta_dormant``).
Every RDB is the port's ``RDB5C``, so it runs ``fused_rdb``. The maps are
(B, 1, h, w) and broadcast over the channels.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dasr_tpu_torch.nn.blocks import RDB5C, RRDB, sequential
from dasr_tpu_torch.nn.layers import Conv2d, conv_block


def _rdb3(nc: int, gc: int) -> nn.Sequential:
    return nn.Sequential(*(RDB5C(nc, gc) for _ in range(3)))


def _stack(cin: int, nf: int, n: int) -> nn.Sequential:
    """``n`` 3x3 conv blocks with LeakyReLU 0.2, ``cin`` -> nf -> ... -> nf."""
    return sequential(*(conv_block(cin if i == 0 else nf, nf, 3) for i in range(n)))


class AffineModule(nn.Module):
    def __init__(self, nf: int = 64):
        super().__init__()
        self.ddm_conv1 = _stack(1, nf, 2)
        self.gamma1 = nn.Parameter(torch.full((1,), 0.1))
        self.bias1 = nn.Parameter(torch.zeros(1))

    def forward(self, x, ddm):
        df1 = self.ddm_conv1(ddm.to(x.dtype))
        df2 = df1  # reference quirk: both feature maps come from ddm_conv1
        return self.gamma1.to(x.dtype) * df1 * x + self.bias1.to(x.dtype) * df2


class RRDBAffine(nn.Module):
    def __init__(self, nc: int = 64, gc: int = 32):
        super().__init__()
        self.RDBs = _rdb3(nc, gc)
        self.affines = nn.ModuleList(AffineModule(nc) for _ in range(3))

    def forward(self, x, ddm):
        out = x
        for rdb, affine in zip(self.RDBs, self.affines):
            out = affine(rdb(out), ddm)
        return out * 0.2 + x


class SEANModule(nn.Module):
    def __init__(self, nf: int = 64):
        super().__init__()
        self.nf = nf
        self.rep_gamma = _stack(nf, nf, 2)
        # the reference's beta stack of the repeated map, which its quirk
        # leaves unused (block.py:574-575, 588): parameters, no compute
        self.rep_beta_dormant = _stack(nf, nf, 2)
        self.ddm_conv = _stack(1, nf, 1)
        self.ddm_gamma = _stack(nf, nf, 2)
        self.ddm_beta = _stack(nf, nf, 2)
        self.alpha_gamma = nn.Parameter(torch.full((1,), 0.5))
        self.alpha_beta = nn.Parameter(torch.full((1,), 0.5))

    def forward(self, x, ddm):
        ddm = ddm.to(x.dtype)
        f_rep_gamma = self.rep_gamma(ddm.expand(-1, self.nf, -1, -1))
        f_rep_beta = f_rep_gamma  # reference quirk (block.py:588)
        d = self.ddm_conv(ddm)
        a_g, a_b = self.alpha_gamma.to(x.dtype), self.alpha_beta.to(x.dtype)
        gamma = f_rep_gamma + (1 - a_g) * self.ddm_gamma(d)
        beta = f_rep_beta + (1 - a_b) * self.ddm_beta(d)
        return x * gamma + beta


class RRDBSEAN(nn.Module):
    """Three RDBs, then three (SEAN -> LeakyReLU 0.01 -> conv block)."""

    def __init__(self, nc: int = 64, gc: int = 32):
        super().__init__()
        self.RDBs = _rdb3(nc, gc)
        self.seans = nn.ModuleList(SEANModule(nc) for _ in range(3))
        self.convs = nn.ModuleList(conv_block(nc, nc, 3) for _ in range(3))

    def forward(self, x, ddm):
        out = self.RDBs(x)
        for sean, conv in zip(self.seans, self.convs):
            out = conv(F.leaky_relu(sean(out, ddm), 0.01))
        return out * 0.2 + x


class RRDBAda(nn.Module):
    def __init__(self, nc: int = 64, gc: int = 32):
        super().__init__()
        self.lda = nn.Parameter(torch.full((1,), 0.4))
        self.RDBs = _rdb3(nc, gc)

    def forward(self, x, ddm):
        out = self.RDBs(x)
        return out * (ddm.to(out.dtype) * self.lda.to(out.dtype)) + x


class AdaptiveModule(nn.Module):
    """Two chains of ``ada_nb`` RRDBs (gc 32), ``real`` and ``fake``; the
    per-sample mask (B,) picks real where 1 and fake where 0."""

    def __init__(self, nf: int = 64, ada_nb: int = 4):
        super().__init__()
        self.real = nn.Sequential(*(RRDB(nf) for _ in range(ada_nb)))
        self.fake = nn.Sequential(*(RRDB(nf) for _ in range(ada_nb)))

    def forward(self, x, mask):
        m = mask.reshape(-1, 1, 1, 1).to(x.dtype)
        return m * self.real(x) + (1 - m) * self.fake(x)


class RRDBCatInput(nn.Module):
    """An RRDB whose every RDB input is a conv block of ``[v, cond]``."""

    def __init__(self, nc: int = 64, gc: int = 32, cond_ch: int = 1):
        super().__init__()
        self.merges = nn.ModuleList(conv_block(nc + cond_ch, nc, 3) for _ in range(3))
        self.RDBs = _rdb3(nc, gc)

    def forward(self, x, cond):
        out = x
        for merge, rdb in zip(self.merges, self.RDBs):
            out = rdb(merge(torch.cat([out, cond.to(out.dtype)], 1)))
        return out * 0.2 + x


class RRDBWithFeatureOut(nn.Module):
    """An RRDB that also appends a 1x1 conv tap of its chain to a feature
    stream: returns (out, [stream, tap])."""

    def __init__(self, nc: int = 64, gc: int = 32, tap_ch: int = 16):
        super().__init__()
        self.RDBs = _rdb3(nc, gc)
        self.tap = conv_block(nc, tap_ch, 1)

    def forward(self, x, feature_stream):
        out = self.RDBs(x)
        return out * 0.2 + x, torch.cat([feature_stream.to(out.dtype), self.tap(out)], 1)


class CALayer(nn.Module):
    """Channel attention (RCAN; block.py:644-668)."""

    def __init__(self, channel: int = 64, reduction: int = 16):
        super().__init__()
        self.conv_du = nn.Sequential(Conv2d(channel, channel // reduction, 1), nn.ReLU(),
                                     Conv2d(channel // reduction, channel, 1), nn.Sigmoid())

    def forward(self, x):
        return x * self.conv_du(x.mean((2, 3), keepdim=True))


class RCAB(nn.Module):
    """Residual channel-attention block (block.py:671-...)."""

    def __init__(self, nf: int = 64, reduction: int = 16, res_scale: float = 1.0):
        super().__init__()
        self.body = nn.Sequential(Conv2d(nf, nf, 3, padding=1), nn.ReLU(),
                                  Conv2d(nf, nf, 3, padding=1), CALayer(nf, reduction))
        self.res_scale = res_scale

    def forward(self, x):
        return x + self.body(x) * self.res_scale


class CARRDB(nn.Module):
    """RDB chain + two RCABs (block.py:768-828)."""

    def __init__(self, nc: int = 64, gc: int = 32, reduction: int = 16):
        super().__init__()
        self.RDBs = _rdb3(nc, gc)
        self.RCABs = nn.Sequential(RCAB(nc, reduction), RCAB(nc, reduction))

    def forward(self, x):
        return self.RCABs(self.RDBs(x)) * 0.2 + x
