"""The plain reference of SFTGAN's generator (model 'sftgan', 'sft_arch'):
SFTNet's forward over an LR image and its segmentation probability maps,
its parameters and its model FLOPs, in float32 PyTorch over dicts of
parameters named as the program's ``state_dict``.

Followed from the published network (Wang, Yu, Dong and Loy, "Recovering
Realistic Texture in Image Super-resolution by Deep Spatial Feature
Transform", CVPR 2018; xinntao/SFTGAN pytorch_test/architectures.py
``SFT_Net_torch``, and DASR's copy, codes/SRN/models/modules/sft_arch.py:8-85):
``CondNet`` brings the 8-class maps at the HR size to a 32-channel
condition at the LR size (a 4x4 stride-4 conv to 128, three 1x1 convs at
128 and a 1x1 conv to 32, LeakyReLU 0.1 between them); each SFT layer is
``fea * (scale + 1) + shift``, scale and shift each two 1x1 convs over the
condition (32 -> 32, LeakyReLU 0.1, 32 -> 64); 16 residual blocks (SFT,
3x3 conv, ReLU, SFT, 3x3 conv, plus the skip), one more SFT layer and a
3x3 conv under a long skip from ``conv0``; then the HR branch: conv 64 ->
256, pixel shuffle x2, ReLU, twice, conv 64 -> 64, ReLU, conv 64 -> 3.

Departures from the published code, each as the program has it:

* DASR's shipped forward comments out the SFT branch (sft_arch.py:76-83),
  so its net is conv0 straight into the HR branch; this is the published
  architecture with the branch, as the program runs it (``nn/sft.py``);
* every weight is drawn from the seed (``sftnet_spec``): no SFTGAN
  ``.pth`` is in the repository.
"""

from __future__ import annotations

import math
from typing import Callable, List

import torch
import torch.nn.functional as F

from port_bench.reference import costs, nets
from port_bench.reference.nets import Params, Spec

NF, COND, CLASSES, HIDDEN = 64, 32, 8, 128


def _lrelu01(v):
    return F.leaky_relu(v, 0.1)


def _kaiming(cin: int, k: int, scale: float = 1.0) -> tuple:
    return ("normal", math.sqrt(2.0 / (cin * k * k)) * scale)


def _sft_spec(spec: Spec, pre: str) -> None:
    for kind in ("scale", "shift"):
        nets._conv_spec(spec, f"{pre}.SFT_{kind}_conv0", COND, COND, 1)
        nets._conv_spec(spec, f"{pre}.SFT_{kind}_conv1", COND, NF, 1)


def sftnet_spec(n_blocks: int = 16) -> Spec:
    """SFTNet's parameters and the law each is drawn by: the residual
    blocks' 3x3 convs kaiming fan-in x 0.1 (BasicSR's
    ``initialize_weights(scale=0.1)`` for residual branches), every other
    conv lecun-normal, zero biases."""
    spec: Spec = {}
    nets._conv_spec(spec, "conv0", 3, NF, 3)
    for i in range(n_blocks):
        _sft_spec(spec, f"sft_branch.{i}.sft0")
        nets._conv_spec(spec, f"sft_branch.{i}.conv0", NF, NF, 3, law=_kaiming(NF, 3, 0.1))
        _sft_spec(spec, f"sft_branch.{i}.sft1")
        nets._conv_spec(spec, f"sft_branch.{i}.conv1", NF, NF, 3, law=_kaiming(NF, 3, 0.1))
    _sft_spec(spec, f"sft_branch.{n_blocks}")
    nets._conv_spec(spec, f"sft_branch.{n_blocks + 1}", NF, NF, 3)
    for name, cout in (("HR_branch.0", 4 * NF), ("HR_branch.3", 4 * NF), ("HR_branch.6", NF),
                       ("HR_branch.8", 3)):
        nets._conv_spec(spec, name, NF, cout, 3)
    nets._conv_spec(spec, "CondNet.0", CLASSES, HIDDEN, 4)
    for j in (2, 4, 6):
        nets._conv_spec(spec, f"CondNet.{j}", HIDDEN, HIDDEN, 1)
    nets._conv_spec(spec, "CondNet.8", HIDDEN, COND, 1)
    return spec


def _sft(p: Params, pre: str, fea, cond, conv: Callable):
    def branch(kind):
        h = _lrelu01(conv(cond, p[f"{pre}.SFT_{kind}_conv0.weight"],
                          p[f"{pre}.SFT_{kind}_conv0.bias"]))
        return conv(h, p[f"{pre}.SFT_{kind}_conv1.weight"], p[f"{pre}.SFT_{kind}_conv1.bias"])

    return fea * (branch("scale") + 1) + branch("shift")


def _conv3(p: Params, name: str, x, conv: Callable):
    return conv(x, p[f"{name}.weight"], p[f"{name}.bias"], 1, 1)


def sftnet(p: Params, img, seg, conv: Callable = nets.conv_f32, n_blocks: int = 16):
    """NCHW LR image (B, 3, h, w) and maps (B, 8, 4h, 4w) -> NCHW x4 SR."""
    cond = _lrelu01(conv(seg, p["CondNet.0.weight"], p["CondNet.0.bias"], 4))
    for j in (2, 4, 6):
        cond = _lrelu01(conv(cond, p[f"CondNet.{j}.weight"], p[f"CondNet.{j}.bias"]))
    cond = conv(cond, p["CondNet.8.weight"], p["CondNet.8.bias"])
    fea = _conv3(p, "conv0", img, conv)
    h = fea
    for i in range(n_blocks):
        r = _sft(p, f"sft_branch.{i}.sft0", h, cond, conv)
        r = F.relu(_conv3(p, f"sft_branch.{i}.conv0", r, conv))
        r = _sft(p, f"sft_branch.{i}.sft1", r, cond, conv)
        h = h + _conv3(p, f"sft_branch.{i}.conv1", r, conv)
    h = _sft(p, f"sft_branch.{n_blocks}", h, cond, conv)
    h = fea + _conv3(p, f"sft_branch.{n_blocks + 1}", h, conv)
    for name in ("HR_branch.0", "HR_branch.3"):
        h = F.relu(F.pixel_shuffle(_conv3(p, name, h, conv), 2))
    h = F.relu(_conv3(p, "HR_branch.6", h, conv))
    return _conv3(p, "HR_branch.8", h, conv)


def sft_image(p: Params, lr_u8: torch.Tensor, seg: torch.Tensor, conv: Callable = nets.conv_f32,
              n_blocks: int = 16) -> torch.Tensor:
    """The x4 SR image of one HWC uint8 LR image and its CHW f32 maps, as
    HWC f32: the whole image at once."""
    x = lr_u8.permute(2, 0, 1)[None].float() / 255.0
    with torch.no_grad():
        out = sftnet(p, x, seg[None].float(), conv, n_blocks)
    return out[0].permute(1, 2, 0)


def sftnet_convs(h: int, w: int, n_blocks: int = 16) -> List[costs.Conv]:
    """SFTNet's convs on one h x w LR image and its 4h x 4w maps: CondNet
    (its stride-4 conv gives h x w), conv0, each SFT layer's four 1x1
    convs, the branch's 3x3 convs, the HR branch at 1, 4 and 16 times the
    LR pixels."""
    px = h * w
    convs = [costs.Conv(CLASSES, HIDDEN, 4, px)] + [costs.Conv(HIDDEN, HIDDEN, 1, px)] * 3
    convs += [costs.Conv(HIDDEN, COND, 1, px), costs.Conv(3, NF, 3, px)]
    sft = [costs.Conv(COND, COND, 1, px), costs.Conv(COND, NF, 1, px)] * 2
    for _ in range(n_blocks):
        convs += sft + [costs.Conv(NF, NF, 3, px)] + sft + [costs.Conv(NF, NF, 3, px)]
    convs += sft + [costs.Conv(NF, NF, 3, px)]
    convs += [costs.Conv(NF, 4 * NF, 3, px), costs.Conv(NF, 4 * NF, 3, 4 * px),
              costs.Conv(NF, NF, 3, 16 * px), costs.Conv(NF, 3, 3, 16 * px)]
    return convs


def sftnet_flop(h: int, w: int, n_blocks: int = 16) -> int:
    """Forward FLOP of SFTNet on one h x w LR image (5.69 M an LR pixel at
    16 blocks: the branch's 3x3 convs 2.43 M, the HR branch 2.71 M, the 33
    SFT layers 0.41 M, CondNet 0.14 M); the affine maps, activations and
    pixel shuffles are not counted."""
    return sum(c.flop for c in sftnet_convs(h, w, n_blocks))
