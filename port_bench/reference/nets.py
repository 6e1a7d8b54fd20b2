"""The plain reference networks: functional PyTorch over dicts of
parameters, in float32, with no kernel of the program.

Each network is a ``*_spec`` (its parameters by the program's
``state_dict`` names, with their shapes and init law) and a forward that
takes the parameters, the input and ``conv``, the one conv every layer
goes through: ``conv_f32`` for the reference, ``Fp8Conv`` for the control
that computes the same network in a lower precision, ``Bf16Conv`` for the
plain bf16 network that serving's errors are scaled by.

Followed from the published networks (ESRGAN's RRDBNet, pix2pix's
PatchGAN, FSSR's DeResnet and FSD, LPIPS alex v0.1); the names are the
program's so that the benchmark can load the weights it draws into both
sides.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
# name -> (shape, law); law: ('normal', std) | ('const', value)
Spec = Dict[str, Tuple[tuple, tuple]]


@contextlib.contextmanager
def f32_exact():
    """float32 means float32 on the card: no TF32 in cuDNN or cuBLAS."""
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def conv_f32(x, w, b=None, stride: int = 1, padding: int = 0):
    return F.conv2d(x, w, b, stride, padding)


class Fp8Conv:
    """The control's conv: input and kernel each rounded to float8 e4m3
    under a per-tensor scale (448 / absmax, the usual fp8 recipe), then
    convolved in f32; gradients pass straight through the rounding."""

    @staticmethod
    def _q(v):
        amax = v.detach().abs().amax().clamp_min(1e-12)
        s = 448.0 / amax
        q = (v.detach() * s).to(torch.float8_e4m3fn).float() / s
        return v + (q - v.detach())

    def __call__(self, x, w, b=None, stride: int = 1, padding: int = 0):
        return F.conv2d(self._q(x), self._q(w), b, stride, padding)


class Bf16Conv:
    """The conv of the plain bf16 network that a served image's errors are
    measured against: input and kernel in bf16 (f32 accumulation), the
    output rounded to bf16, everything between convs in f32."""

    def __call__(self, x, w, b=None, stride: int = 1, padding: int = 0):
        bias = None if b is None else b.bfloat16()
        return F.conv2d(x.bfloat16(), w.bfloat16(), bias, stride, padding).float()


# the reference in another precision, by name
PRECISIONS = {"fp8": Fp8Conv, "bf16": Bf16Conv}


def _lecun(shape) -> tuple:
    return ("normal", 1.0 / math.sqrt(math.prod(shape[1:])))


def _conv_spec(spec: Spec, name: str, cin: int, cout: int, k: int, bias: bool = True,
               law=None):
    shape = (cout, cin, k, k)
    spec[f"{name}.weight"] = (shape, law or _lecun(shape))
    if bias:
        spec[f"{name}.bias"] = ((cout,), ("const", 0.0))


def lrelu(v):
    return F.leaky_relu(v, 0.2)


# -- RRDBNet (ESRGAN x4 generator) ----------------------------------------------------


def rrdbnet_spec(nf: int = 64, nb: int = 23, gc: int = 32, in_nc: int = 3,
                 out_nc: int = 3) -> Spec:
    """The generator's parameters: RDB convs kaiming fan-in x 0.1, the
    others lecun-normal, zero biases."""
    spec: Spec = {}
    _conv_spec(spec, "model.0", in_nc, nf, 3)
    for i in range(nb):
        for j in (1, 2, 3):
            for k in range(5):
                cin, cout = nf + k * gc, gc if k < 4 else nf
                law = ("normal", math.sqrt(2.0 / (cin * 9)) * 0.1)
                _conv_spec(spec, f"model.1.sub.{i}.RDB{j}.conv{k + 1}.0", cin, cout, 3, law=law)
    _conv_spec(spec, f"model.1.sub.{nb}", nf, nf, 3)
    for name in ("model.3", "model.6", "model.8"):
        _conv_spec(spec, name, nf, nf, 3)
    _conv_spec(spec, "model.10", nf, out_nc, 3)
    return spec


def _rdb(p: Params, pre: str, x, conv):
    feats = [x]
    for k in range(4):
        feats.append(lrelu(conv(torch.cat(feats, 1), p[f"{pre}.conv{k + 1}.0.weight"],
                                p[f"{pre}.conv{k + 1}.0.bias"], 1, 1)))
    return x + 0.2 * conv(torch.cat(feats, 1), p[f"{pre}.conv5.0.weight"],
                          p[f"{pre}.conv5.0.bias"], 1, 1)


def rrdbnet(p: Params, x, conv: Callable = conv_f32, nb: int = 23):
    """NCHW LR -> NCHW x4 SR: stem, nb RRDBs and the trunk conv under one
    skip, two nearest x2 upconvs, two HR convs."""
    fea = conv(x, p["model.0.weight"], p["model.0.bias"], 1, 1)
    h = fea
    for i in range(nb):
        r = h
        for j in (1, 2, 3):
            r = _rdb(p, f"model.1.sub.{i}.RDB{j}", r, conv)
        h = h + 0.2 * r
    h = fea + conv(h, p[f"model.1.sub.{nb}.weight"], p[f"model.1.sub.{nb}.bias"], 1, 1)
    for name in ("model.3", "model.6"):
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = lrelu(conv(h, p[f"{name}.weight"], p[f"{name}.bias"], 1, 1))
    h = lrelu(conv(h, p["model.8.weight"], p["model.8.bias"], 1, 1))
    return conv(h, p["model.10.weight"], p["model.10.bias"], 1, 1)


# -- the SRN PatchGAN on the Haar high bands -------------------------------------------


def nlayer_spec(in_ch: int = 9, ndf: int = 64, n_layers: int = 2) -> Spec:
    """4x4 convs, biases on the first and the head only (SRN's
    ``discriminator_patch``), lecun-normal."""
    spec: Spec = {}
    _conv_spec(spec, "model.0", in_ch, ndf, 4)
    idx, mult = 2, 1
    for n in range(1, n_layers):
        prev, mult = mult, min(2 ** n, 8)
        _conv_spec(spec, f"model.{idx}", ndf * prev, ndf * mult, 4, bias=False)
        idx += 3
    prev, mult = mult, min(2 ** n_layers, 8)
    _conv_spec(spec, f"model.{idx}", ndf * prev, ndf * mult, 4, bias=False)
    _conv_spec(spec, f"model.{idx + 3}", ndf * mult, 1, 4)
    return spec


def nlayer(p: Params, x, conv: Callable = conv_f32, n_layers: int = 2):
    h = lrelu(conv(x, p["model.0.weight"], p["model.0.bias"], 2, 1))
    idx = 2
    for _ in range(1, n_layers):
        h = lrelu(F.instance_norm(conv(h, p[f"model.{idx}.weight"], None, 2, 1), eps=1e-5))
        idx += 3
    h = lrelu(F.instance_norm(conv(h, p[f"model.{idx}.weight"], None, 1, 1), eps=1e-5))
    return conv(h, p[f"model.{idx + 3}.weight"], p[f"model.{idx + 3}.bias"], 1, 1)


def haar_bands(x):
    """(LL * 0.5, the LH, HL, HH bands * 0.5 + 0.5 concatenated) of one
    Haar level; even sizes."""
    a, b = x[..., 0::2, 0::2], x[..., 0::2, 1::2]
    c, d = x[..., 1::2, 0::2], x[..., 1::2, 1::2]
    ll = (a + b + c + d) * 0.5
    lh, hl, hh = (a + b - c - d) * 0.5, (a - b + c - d) * 0.5, (a - b - c + d) * 0.5
    return ll * 0.5, torch.cat([lh * 0.5 + 0.5, hl * 0.5 + 0.5, hh * 0.5 + 0.5], 1)


# -- LPIPS alex v0.1 ------------------------------------------------------------------

_ALEX = ((3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1), (384, 256, 3, 1, 1),
         (256, 256, 3, 1, 1))
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def lpips_spec() -> Spec:
    """The alex backbone (lecun-normal, zero biases) and the five heads at
    1 / C."""
    spec: Spec = {}
    for i, (cin, cout, k, _, _) in enumerate(_ALEX):
        _conv_spec(spec, f"backbone.stack.conv{i}", cin, cout, k)
    for i, (_, cout, _, _, _) in enumerate(_ALEX):
        spec[f"lin{i}"] = ((cout,), ("const", 1.0 / cout))
    return spec


def lpips(p: Params, in0, in1, conv: Callable = conv_f32):
    """The (B,) LPIPS distances of two batches of NCHW images in [0, 1]."""
    b = in0.shape[0]
    x = torch.cat([in0, in1]) * 2 - 1
    shift = torch.tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
    x = (x - shift) / scale
    total = 0
    for i, (_, _, _, stride, pad) in enumerate(_ALEX):
        if i in (1, 2):
            x = F.max_pool2d(x, 3, 2)
        x = F.relu(conv(x, p[f"backbone.stack.conv{i}.weight"],
                        p[f"backbone.stack.conv{i}.bias"], stride, pad))
        f = x / (x.pow(2).sum(1, keepdim=True).sqrt() + 1e-10)
        d = ((f[:b] - f[b:]) ** 2 * p[f"lin{i}"].view(1, -1, 1, 1)).sum(1)
        total = total + d.mean((1, 2))
    return total


# -- the DSN networks ---------------------------------------------------------------------


def deresnet_spec(nb: int = 8, nf: int = 64, scale: int = 4) -> Spec:
    """DeResnet: lecun-normal convs, zero biases, PReLU slopes 0.25."""
    spec: Spec = {}
    _conv_spec(spec, "block_input.0", 3, nf, 3)
    spec["block_input.1.weight"] = ((1,), ("const", 0.25))
    for i in range(nb):
        _conv_spec(spec, f"res_blocks.{i}.conv1", nf, nf, 3)
        spec[f"res_blocks.{i}.prelu.weight"] = ((1,), ("const", 0.25))
        _conv_spec(spec, f"res_blocks.{i}.conv2", nf, nf, 3)
    for j in range(int(math.log2(scale))):
        _conv_spec(spec, f"down_sample.{2 * j}", nf, nf, 3)
        spec[f"down_sample.{2 * j + 1}.weight"] = ((1,), ("const", 0.25))
    _conv_spec(spec, "block_output", nf, 3, 3)
    return spec


def deresnet(p: Params, x, conv: Callable = conv_f32, nb: int = 8, scale: int = 4):
    """HR -> sigmoid(LR / ``scale``)."""
    h = F.prelu(conv(x, p["block_input.0.weight"], p["block_input.0.bias"], 1, 1),
                p["block_input.1.weight"])
    for i in range(nb):
        r = F.prelu(conv(h, p[f"res_blocks.{i}.conv1.weight"], p[f"res_blocks.{i}.conv1.bias"],
                         1, 1), p[f"res_blocks.{i}.prelu.weight"])
        h = h + conv(r, p[f"res_blocks.{i}.conv2.weight"], p[f"res_blocks.{i}.conv2.bias"], 1, 1)
    for j in range(int(math.log2(scale))):
        h = F.prelu(conv(h, p[f"down_sample.{2 * j}.weight"], p[f"down_sample.{2 * j}.bias"],
                         2, 1), p[f"down_sample.{2 * j + 1}.weight"])
    return torch.sigmoid(conv(h, p["block_output.weight"], p["block_output.bias"], 1, 1))


def fsd_spec() -> Spec:
    """The FSD body (``net.net``: 5x5 convs to 64, 128, 256 and a 1x1 head),
    lecun-normal."""
    spec: Spec = {}
    for idx, (cin, cout, k) in zip((0, 2, 5, 8), ((3, 64, 5), (64, 128, 5), (128, 256, 5),
                                                  (256, 1, 1))):
        _conv_spec(spec, f"net.net.{idx}", cin, cout, k)
    return spec


def fsd(p: Params, x, conv: Callable = conv_f32, kernel_size: int = 5):
    """sigmoid(FSD body(the avg-pool high-pass of x, 0.5 + 0.5 hf)), the
    low-pass a same-size mean over the window's in-image pixels; instance
    norm after the second and third convs."""
    pad = (kernel_size - 1) // 2
    low = F.avg_pool2d(x, kernel_size, 1, pad, count_include_pad=False)
    h = 0.5 + 0.5 * (x - low)
    h = lrelu(conv(h, p["net.net.0.weight"], p["net.net.0.bias"], 1, 2))
    h = lrelu(F.instance_norm(conv(h, p["net.net.2.weight"], p["net.net.2.bias"], 1, 2), eps=1e-5))
    h = lrelu(F.instance_norm(conv(h, p["net.net.5.weight"], p["net.net.5.bias"], 1, 2), eps=1e-5))
    return torch.sigmoid(conv(h, p["net.net.8.weight"], p["net.net.8.bias"], 1, 0))
