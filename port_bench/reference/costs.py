"""The benchmark's frozen cost arithmetic: the peaks of one H100, the RDB
kernel's per-level operations and bytes, and the model FLOPs of the
networks the cells run, counted from their conv shapes.

A frozen copy: the program keeps its own (``ops/rdb.py:level_costs``),
which a later change may edit; the yardstick stays here. Only convs are
counted (2 FLOP a multiply-add); element-wise ops, norms, the Haar split,
the bicubic and Adam are left out, and so is any recomputation.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

# NVIDIA's data sheet, H100 SXM, dense: bf16 tensor-core FLOP/s and HBM3 bytes/s
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12


def rdb_level_costs(b: int, h: int, w: int, nc: int = 64, gc: int = 32,
                    itemsize: int = 2) -> List[tuple]:
    """[(FLOP, bytes)] of the five levels of one RDB run as five launches:
    each reads its input channels and weights once and writes its output
    once."""
    pix = b * h * w
    out = []
    for k in range(5):
        cin, cout = nc + k * gc, gc if k < 4 else nc
        out.append((2 * 9 * pix * cin * cout,
                    pix * (cin + cout) * itemsize + 9 * cin * cout * itemsize + 4 * cout))
    return out


def rdb_bound_s(b: int, h: int, w: int, nc: int = 64, gc: int = 32) -> float:
    """The least seconds the five bf16 level launches of one RDB at (b, h, w)
    could take: each launch max(FLOP / peak, bytes / peak), summed."""
    return sum(max(f / PEAK_FLOPS_BF16, n / PEAK_BYTES_PER_S)
               for f, n in rdb_level_costs(b, h, w, nc, gc))


class Conv(NamedTuple):
    """One conv of a network at one input size: channels, kernel, output
    pixels per image."""

    cin: int
    cout: int
    k: int
    out_px: int

    @property
    def flop(self) -> int:
        return 2 * self.k * self.k * self.cin * self.cout * self.out_px


def _out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def rrdbnet_convs(h: int, w: int, nf: int = 64, nb: int = 23, gc: int = 32, in_nc: int = 3,
                  out_nc: int = 3, scale: int = 4) -> List[Conv]:
    """The convs of the x``scale`` ESRGAN generator on one h x w image, in
    forward order (the first is the stem, whose input needs no gradient)."""
    px = h * w
    convs = [Conv(in_nc, nf, 3, px)]
    for _ in range(3 * nb):
        convs += [Conv(nf + k * gc, gc if k < 4 else nf, 3, px) for k in range(5)]
    convs.append(Conv(nf, nf, 3, px))
    for up in range(int(math.log2(scale))):
        convs.append(Conv(nf, nf, 3, px * 4 ** (up + 1)))
    convs += [Conv(nf, nf, 3, px * scale * scale), Conv(nf, out_nc, 3, px * scale * scale)]
    return convs


def rrdbnet_flop_per_px(**widths) -> float:
    """Forward FLOP per LR pixel of the generator (35.85 M at nf 64, nb 23,
    gc 32, x4)."""
    return sum(c.flop for c in rrdbnet_convs(1, 1, **widths))


def nlayer_convs(h: int, w: int, in_ch: int = 9, ndf: int = 64, n_layers: int = 2) -> List[Conv]:
    """The SRN PatchGAN on an h x w input: 4x4 convs, padding 1, stride 2
    then stride 1, a 1-channel head."""
    convs, mult = [], 1
    h1, w1 = _out(h, 4, 2, 1), _out(w, 4, 2, 1)
    convs.append(Conv(in_ch, ndf, 4, h1 * w1))
    for n in range(1, n_layers):
        prev, mult = mult, min(2 ** n, 8)
        h1, w1 = _out(h1, 4, 2, 1), _out(w1, 4, 2, 1)
        convs.append(Conv(ndf * prev, ndf * mult, 4, h1 * w1))
    prev, mult = mult, min(2 ** n_layers, 8)
    h1, w1 = _out(h1, 4, 1, 1), _out(w1, 4, 1, 1)
    convs.append(Conv(ndf * prev, ndf * mult, 4, h1 * w1))
    h1, w1 = _out(h1, 4, 1, 1), _out(w1, 4, 1, 1)
    convs.append(Conv(ndf * mult, 1, 4, h1 * w1))
    return convs


def alexnet_convs(h: int, w: int) -> List[Conv]:
    """LPIPS alex's five convs on an h x w image (3x3/2 max pools after the
    first two)."""
    convs = []
    h1, w1 = _out(h, 11, 4, 2), _out(w, 11, 4, 2)
    convs.append(Conv(3, 64, 11, h1 * w1))
    h1, w1 = _out(h1, 3, 2, 0), _out(w1, 3, 2, 0)
    convs.append(Conv(64, 192, 5, h1 * w1))
    h1, w1 = _out(h1, 3, 2, 0), _out(w1, 3, 2, 0)
    convs += [Conv(192, 384, 3, h1 * w1), Conv(384, 256, 3, h1 * w1),
              Conv(256, 256, 3, h1 * w1)]
    return convs


def deresnet_convs(h: int, w: int, nb: int = 8, nf: int = 64, scale: int = 4) -> List[Conv]:
    """The DSN generator on an h x w HR crop: stem, 2 nb trunk convs,
    log2(scale) stride-2 convs, the RGB head."""
    convs = [Conv(3, nf, 3, h * w)] + [Conv(nf, nf, 3, h * w)] * (2 * nb)
    for _ in range(int(math.log2(scale))):
        h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
        convs.append(Conv(nf, nf, 3, h * w))
    convs.append(Conv(nf, 3, 3, h * w))
    return convs


def fsd_convs(h: int, w: int) -> List[Conv]:
    """The FSD body (5x5 convs to 64, 128, 256, a 1x1 head) on an h x w
    input; the fixed high-pass in front of it is not counted."""
    px = h * w
    return [Conv(3, 64, 5, px), Conv(64, 128, 5, px), Conv(128, 256, 5, px), Conv(256, 1, 1, px)]


def _fwd(convs, n) -> int:
    return n * sum(c.flop for c in convs)


def _dgrad(convs, n, first: bool) -> int:
    """Input-gradient products; ``first``: whether the first conv's input
    needs one."""
    return n * sum(c.flop for c in (convs if first else convs[1:]))


def dasr_step_flop(batch: int, hr: int, scale: int = 4, nf: int = 64, nb: int = 23,
                   gc: int = 32, d_nf: int = 64, d_layers: int = 2) -> int:
    """Model FLOPs of one DASR step with ``batch`` fake + ``batch`` real
    items: G forward, weight and input gradients (not the stem's input) on
    2 ``batch`` LRs; LPIPS forward on SR and HR of the fake half and its
    input gradient on SR; D on the target half's SR bands for G's loss
    (forward and input gradients), then on real and detached SR bands for
    its own loss (forward, weight gradients, input gradients past its first
    conv)."""
    lr = hr // scale
    g = rrdbnet_convs(lr, lr, nf, nb, gc, scale=scale)
    lp = alexnet_convs(hr, hr)
    d = nlayer_convs(hr // 2, hr // 2, 9, d_nf, d_layers)
    two = 2 * batch
    total = _fwd(g, two) * 2 + _dgrad(g, two, first=False)
    total += _fwd(lp, two) + _dgrad(lp, batch, first=True)
    total += _fwd(d, batch) + _dgrad(d, batch, first=True)
    total += _fwd(d, two) * 2 + _dgrad(d, two, first=False)
    return total


def dsn_step_flop(batch: int, crop: int, nb: int = 8, scale: int = 4) -> int:
    """Model FLOPs of one DSN step: DeResnet forward, weight and input
    gradients (not the stem's input) on ``batch`` HR crops; LPIPS forward on
    the fake and the bicubic LRs and its input gradient on the fake; the FSD
    body on the fake for G's loss (forward and input gradients), then on
    real and detached fake for its own loss (forward, weight gradients,
    input gradients past its first conv)."""
    g = deresnet_convs(crop, crop, nb, scale=scale)
    lr = crop // scale
    lp = alexnet_convs(lr, lr)
    d = fsd_convs(lr, lr)
    two = 2 * batch
    total = _fwd(g, batch) * 2 + _dgrad(g, batch, first=False)
    total += _fwd(lp, two) + _dgrad(lp, batch, first=True)
    total += _fwd(d, batch) + _dgrad(d, batch, first=True)
    total += _fwd(d, two) * 2 + _dgrad(d, two, first=False)
    return total
