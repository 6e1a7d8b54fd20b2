"""The plain reference of ESRGAN as DASR ships it (model 'srragan',
train_SRGAN.json): the VGG19-54 feature net, the conv-block VGG
discriminators, the paired batch, the train step and its model FLOPs, in
float32 PyTorch over dicts of parameters named as the program's
``state_dict``.

Followed from the published code (ShuhangGu/DASR codes/SRN, BasicSR's
ESRGAN): the feature net ``VGGFeatureExtractor`` (architecture.py:1060-1088,
networks.py:247-261: VGG19 ``features`` through layer 34, conv5_4 before
its ReLU, ImageNet input normalisation); the discriminators
``Discriminator_VGG_192`` and ``_48`` (architecture.py:544-830:
``conv_block``s of a conv with its bias, BatchNorm but on the first,
LeakyReLU 0.2, then Linear(8 nf k k, 100), LeakyReLU, Linear(100, 1) on the
NCHW flatten); the 'LRHR' train crop (an LR crop whose x4 window fits in
its HR, one dihedral augment on both); and ``SRRaGANModel.
optimize_parameters`` (SRRaGAN_model.py:113-187): G's loss the pixel l1,
the feature l1 and the relativistic-average pair against D's detached
scores of the HR, weighted; D's loss the pair of its scores of the HR and
of the detached SR, halved; both gradients at the parameters from before
the step, then Adam on each (lr 1e-4, beta1 0.9).

Departures from the published code, each as the program has it:

* D's BatchNorm statistics move on D's own two forwards (HR, then the
  detached SR), not on all four: the published D runs in training mode in
  G's loss too. That changes the running buffers only; a training-mode
  forward normalises by its batch either way;
* the running variance is the batch's biased variance (flax's), where
  torch keeps the unbiased one;
* every weight is drawn from the seed, VGG19's included: no ImageNet VGG19
  is in the repository. VGG19's convs take torchvision's own init
  (``kaiming_normal_``, fan out, ReLU gain), which keeps the activations'
  scale through its sixteen layers as trained weights do; the generator's
  RDB convs kaiming fan-in x 0.1, every other conv and linear
  lecun-normal, zero biases, BatchNorm scale 1 and shift 0.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from port_bench.reference import costs, nets, sampling, steps
from port_bench.reference.nets import Params, Spec

# -- VGG19-54 -------------------------------------------------------------------------

# VGG19 ``features`` through conv5_4: channels of each conv, 'M' a 2x2 max pool
_VGG19 = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
          512, 512, 512, 512)
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def vgg19_54_spec() -> Spec:
    """The sixteen convs ``stack.conv{i}``: torchvision's VGG init, std
    sqrt(2 / (9 out channels)), zero biases."""
    spec: Spec = {}
    cin, i = 3, 0
    for item in _VGG19:
        if item == "M":
            continue
        nets._conv_spec(spec, f"stack.conv{i}", cin, item, 3,
                        law=("normal", math.sqrt(2.0 / (item * 9))))
        cin, i = item, i + 1
    return spec


def vgg19_54(p: Params, x, conv: Callable = nets.conv_f32):
    """NCHW images in [0, 1] -> conv5_4's output before its ReLU."""
    mean = torch.tensor(_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(_STD, device=x.device).view(1, 3, 1, 1)
    h = (x - mean) / std
    n = sum(1 for item in _VGG19 if item != "M")
    i = 0
    for item in _VGG19:
        if item == "M":
            h = F.max_pool2d(h, 2, 2)
            continue
        h = conv(h, p[f"stack.conv{i}.weight"], p[f"stack.conv{i}.bias"], 1, 1)
        if i < n - 1:
            h = F.relu(h)
        i += 1
    return h


# -- the conv-block VGG discriminators --------------------------------------------------

# (channel multiple of nf, kernel, stride, BatchNorm) of each conv_block
_D_192 = ((1, 3, 1, False), (1, 4, 2, True), (2, 3, 1, True), (2, 4, 2, True),
          (4, 3, 1, True), (4, 4, 2, True), (8, 3, 1, True), (8, 4, 2, True),
          (8, 3, 1, True), (8, 4, 2, True), (8, 3, 1, True), (8, 4, 2, True))
_D_48 = ((1, 3, 1, False), (1, 4, 1, True), (2, 3, 1, True), (2, 4, 1, True),
         (4, 3, 1, True), (4, 4, 1, True), (8, 3, 1, True), (8, 4, 2, True),
         (8, 3, 1, True), (8, 4, 2, True), (8, 3, 1, True), (8, 4, 2, True))
# name: (stages, the input size the head is sized for)
D_VARIANTS = {"discriminator_vgg_192": (_D_192, 192), "discriminator_vgg_48": (_D_48, 48)}
BN_EPS, BN_MOMENTUM = 1e-5, 0.1


def _d_layers(which: str, nf: int):
    """[(index in ``features``, cin multiple, cout, kernel, stride, BatchNorm)],
    the head's input features: a block is (conv, act) or (conv, norm, act)."""
    stages, size = D_VARIANTS[which]
    out, idx, cin = [], 0, None
    for mult, k, s, bn in stages:
        out.append((idx, cin, nf * mult, k, s, bn))
        cin = nf * mult
        idx += 3 if bn else 2
        size = (size + 2 * ((k - 1) // 2) - k) // s + 1
    return out, cin * size * size


def vgg_d_spec(which: str, in_nc: int = 3, nf: int = 64) -> Spec:
    """``features.{i}`` convs (with biases) and BatchNorms, ``classifier.0``
    and ``classifier.2``: lecun-normal convs and linears, zero biases,
    BatchNorm scale 1 and shift 0."""
    spec: Spec = {}
    layers, flat = _d_layers(which, nf)
    for idx, cin, cout, k, _, bn in layers:
        nets._conv_spec(spec, f"features.{idx}", cin or in_nc, cout, k)
        if bn:
            spec[f"features.{idx + 1}.weight"] = ((cout,), ("const", 1.0))
            spec[f"features.{idx + 1}.bias"] = ((cout,), ("const", 0.0))
    for name, shape in (("classifier.0", (100, flat)), ("classifier.2", (1, 100))):
        spec[f"{name}.weight"] = (shape, nets._lecun(shape))
        spec[f"{name}.bias"] = ((shape[0],), ("const", 0.0))
    return spec


def vgg_d_stats(which: str, nf: int, device) -> Dict[str, torch.Tensor]:
    """Fresh running statistics of the D's BatchNorms, by the program's
    buffer names, and the count of the forwards that moved them."""
    stats = {"updates": torch.zeros((), device=device)}
    for idx, _, cout, _, _, bn in _d_layers(which, nf)[0]:
        if bn:
            stats[f"features.{idx + 1}.running_mean"] = torch.zeros(cout, device=device)
            stats[f"features.{idx + 1}.running_var"] = torch.ones(cout, device=device)
    return stats


def vgg_d(p: Params, x, which: str, nf: int, conv: Callable = nets.conv_f32,
          stats: Optional[Dict[str, torch.Tensor]] = None):
    """(B, 1) logits of NCHW images: every BatchNorm in training mode (the
    batch's mean and biased variance); with ``stats``, each moves its
    running mean and variance towards them by the momentum, in place."""
    layers, _ = _d_layers(which, nf)
    h = x
    for idx, _, _, k, s, bn in layers:
        h = conv(h, p[f"features.{idx}.weight"], p[f"features.{idx}.bias"], s, (k - 1) // 2)
        if bn:
            name = f"features.{idx + 1}"
            mean = h.mean((0, 2, 3))
            var = h.var((0, 2, 3), unbiased=False)
            if stats is not None:
                with torch.no_grad():
                    stats[f"{name}.running_mean"].lerp_(mean.detach(), BN_MOMENTUM)
                    stats[f"{name}.running_var"].lerp_(var.detach(), BN_MOMENTUM)
            h = ((h - mean[:, None, None]) * torch.rsqrt(var + BN_EPS)[:, None, None]
                 * p[f"{name}.weight"][:, None, None] + p[f"{name}.bias"][:, None, None])
        h = nets.lrelu(h)
    if stats is not None:
        stats["updates"] += 1
    h = nets.lrelu(F.linear(h.flatten(1), p["classifier.0.weight"], p["classifier.0.bias"]))
    return F.linear(h, p["classifier.2.weight"], p["classifier.2.bias"])


# -- the batch and the step -------------------------------------------------------------


def paired_batch(banks: Dict[str, tuple], row: torch.Tensor, gen: torch.Generator, hr: int,
                 scale: int, flip: bool, rot: bool) -> Dict[str, torch.Tensor]:
    """The 'LRHR' batch of the indices ``row``: from (B, 5) uniforms drawn on
    ``gen``, the first two the LR crop's offsets within the span where its
    x``scale`` window fits in the HR, the last three the augment bits;
    the LR crop and that HR window, each item augmented alike. ``banks``:
    'lr', 'hr' -> (data NHWC uint8, sizes (N, 2) int32). NCHW f32 in [0, 1]."""
    b = row.shape[0]
    u = torch.rand((b, 5), generator=gen, device=gen.device)
    lr = hr // scale
    idx = row.long()
    ls, hs = banks["lr"][1][idx], banks["hr"][1][idx]
    span = torch.clamp(torch.minimum(ls - lr, (hs - lr * scale) // scale), min=0)
    tl = torch.minimum((u[:, 0:2] * (span + 1).float()).int(), span).tolist()
    aug = (u[:, 2:5] < 0.5).tolist()
    lrs, hrs = [], []
    for j, i in enumerate(idx.tolist()):
        t, l = tl[j]
        lrs.append(sampling._crop(banks["lr"][0], i, t, l, lr, aug[j], flip, rot))
        hrs.append(sampling._crop(banks["hr"][0], i, t * scale, l * scale, hr, aug[j], flip, rot))
    return {"LR": torch.stack(lrs).permute(0, 3, 1, 2).float() / 255.0,
            "HR": torch.stack(hrs).permute(0, 3, 1, 2).float() / 255.0}


def _bce(logits, target: float):
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))


def _ragan(a, b):
    """``a`` against ``b``'s batch mean as real, ``b`` against ``a``'s as
    fake, halved."""
    return (_bce(a - b.mean(0, keepdim=True), 1.0) + _bce(b - a.mean(0, keepdim=True), 0.0)) / 2


def srragan_steps(params: Dict[str, Params], batch_at: Callable[[int], Dict[str, torch.Tensor]],
                  n_steps: int, opt: dict, conv=nets.conv_f32) -> dict:
    """``n_steps`` srragan steps from ``params`` ('G', 'D', 'VGG');
    ``batch_at(i)`` gives step i's batch (NCHW f32: LR, HR). ``opt``: the
    configuration. Returns what ``steps.dasr_steps`` returns, and ``bn``:
    D's running statistics after the last step, with ``updates``, the D
    forwards that moved them."""
    tr, ng, nd = opt["train"], opt["network_G"], opt["network_D"]
    if opt["model"] != "srragan" or tr.get("gan_type", "vanilla") != "vanilla":
        raise ValueError("the reference's step is srragan's, vanilla")
    which, d_nf = nd["which_model_D"], nd["nf"]
    g, d = steps._leaves(params["G"]), steps._leaves(params["D"])
    vgg = {k: v.detach() for k, v in params["VGG"].items()}
    start = {n: {k: v.detach().clone() for k, v in net.items()} for n, net in (("G", g),
                                                                             ("D", d))}
    adam_g = steps.Adam(g, tr["lr_G"], tr["beta1_G"])
    adam_d = steps.Adam(d, tr["lr_D"], tr["beta1_D"])
    stats = vgg_d_stats(which, d_nf, next(iter(g.values())).device)
    pw, fw, gw = tr["pixel_weight"], tr["feature_weight"], tr["gan_weight"]
    losses, first = [], None
    for i in range(n_steps):
        bt = batch_at(i)
        sr = nets.rrdbnet(g, bt["LR"], conv, ng["nb"])
        l_pix = pw * (sr - bt["HR"]).abs().mean()
        with torch.no_grad():
            f_real = vgg19_54(vgg, bt["HR"], conv)
        l_fea = fw * (vgg19_54(vgg, sr, conv) - f_real).abs().mean()
        pred_fake = vgg_d(d, sr, which, d_nf, conv)
        with torch.no_grad():
            pred_real = vgg_d(d, bt["HR"], which, d_nf, conv)
        l_gan = gw * _ragan(pred_fake, pred_real)
        total = l_pix + l_fea + l_gan
        g_grads = dict(zip(g, torch.autograd.grad(total, list(g.values()))))
        pr = vgg_d(d, bt["HR"], which, d_nf, conv, stats)
        pf = vgg_d(d, sr.detach(), which, d_nf, conv, stats)
        d_loss = _ragan(pr, pf)
        d_grads = dict(zip(d, torch.autograd.grad(d_loss, list(d.values()))))
        if first is None:
            first = {"G": steps._norms(g_grads), "D": steps._norms(d_grads)}
        adam_d.step(d_grads)
        adam_g.step(g_grads)
        losses.append({"loss/l_g_total": float(total.detach()),
                       "loss/l_d_total": float(d_loss.detach())})
    out = steps._result(losses, first, start, {"G": g, "D": d})
    out["bn"] = stats
    return out


# -- model FLOPs -------------------------------------------------------------------------


def vgg19_54_convs(h: int, w: int) -> List[costs.Conv]:
    """VGG19's sixteen convs through conv5_4 on an h x w image."""
    convs, cin = [], 3
    for item in _VGG19:
        if item == "M":
            h, w = h // 2, w // 2
            continue
        convs.append(costs.Conv(cin, item, 3, h * w))
        cin = item
    return convs


def vgg_d_convs(which: str, nf: int = 64, in_nc: int = 3) -> List[costs.Conv]:
    """The D's convs on its input size, and its two linears as 1x1 convs on
    one pixel."""
    stages, size = D_VARIANTS[which]
    convs, cin = [], in_nc
    for mult, k, s, _ in stages:
        size = (size + 2 * ((k - 1) // 2) - k) // s + 1
        convs.append(costs.Conv(cin, nf * mult, k, size * size))
        cin = nf * mult
    return convs + [costs.Conv(cin * size * size, 100, 1, 1), costs.Conv(100, 1, 1, 1)]


def srragan_step_flop(batch: int, hr: int, scale: int = 4, nf: int = 64, nb: int = 23,
                      gc: int = 32, which_d: str = "discriminator_vgg_192",
                      d_nf: int = 64) -> int:
    """Model FLOPs of one srragan step on ``batch`` pairs: G forward, weight
    and input gradients (not the stem's input) on the LRs; VGG19-54 forward
    on HR and SR and its input gradient on SR (its weights are frozen); D
    in G's loss on SR (forward and input gradients) and on HR (forward),
    then in its own loss on HR and the detached SR (forward, weight
    gradients, input gradients past its first conv)."""
    lr = hr // scale
    g = costs.rrdbnet_convs(lr, lr, nf, nb, gc, scale=scale)
    vgg = vgg19_54_convs(hr, hr)
    d = vgg_d_convs(which_d, d_nf)
    total = costs._fwd(g, batch) * 2 + costs._dgrad(g, batch, first=False)
    total += costs._fwd(vgg, 2 * batch) + costs._dgrad(vgg, batch, first=True)
    total += costs._fwd(d, 2 * batch) + costs._dgrad(d, batch, first=True)
    total += costs._fwd(d, 2 * batch) * 2 + costs._dgrad(d, 2 * batch, first=False)
    return total
