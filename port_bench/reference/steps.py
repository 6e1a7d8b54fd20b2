"""The reference train steps: DASR's stage-3 step and DSN's stage-1 step in
float32 from the reference networks, with a plain Adam.

Each follows its published step (codes/SRN/models/DASR_model.py:192-330,
codes/DSN/train.py:199-291): G's gradient through D at D's parameters from
before the update; D's loss on the detached SR; both Adams step after both
gradients exist. Each returns what the program's run is held to: each
step's losses, every leaf's gradient norm at the first step, and every
leaf's change after the last.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from port_bench.reference import nets, ops
from port_bench.reference.nets import Params


class Adam:
    """Adam (beta2 0.999, eps 1e-8) with a constant LR, bias-corrected."""

    def __init__(self, params: Params, lr: float, beta1: float):
        self.p, self.lr, self.b1, self.b2, self.eps = params, lr, beta1, 0.999, 1e-8
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            self.p[k].addcdiv_(self.m[k], denom, value=-self.lr / c1)


def _leaves(p: Params) -> Params:
    return {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}


def _norms(t: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in t.items()}


def _result(losses, first_grads, start: Dict[str, Params], nets_: Dict[str, Params]):
    change = {n: _norms({k: nets_[n][k].detach() - start[n][k] for k in start[n]})
              for n in start}
    return {"losses": losses, "grad": first_grads, "change": change}


def dasr_steps(params: Dict[str, Params], batch_at: Callable[[int], Dict[str, torch.Tensor]],
               steps: int, opt: dict, conv=nets.conv_f32) -> dict:
    """``steps`` DASR steps from ``params`` ('G', 'D', 'LPIPS'); ``batch_at(i)``
    gives step i's batch (NCHW f32: LR_fake, LR_real, HR, HR_unpair,
    fake_w). ``opt``: the configuration (its ``network_G``, ``network_D``
    and ``train`` blocks)."""
    tr, ng, nd = opt["train"], opt["network_G"], opt["network_D"]
    g, d = _leaves(params["G"]), _leaves(params["D"])
    lp = {k: v.detach() for k, v in params["LPIPS"].items()}
    start = {"G": {k: v.detach().clone() for k, v in g.items()},
             "D": {k: v.detach().clone() for k, v in d.items()}}
    adam_g = Adam(g, tr["lr_G"], tr["beta1_G"])
    adam_d = Adam(d, tr["lr_D"], tr["beta1_D"])
    pw, llw, fw, gw = (tr["pixel_weight"], tr["pixel_LL_weight"], tr["feature_weight"],
                       tr["gan_H_target"])
    losses, first = [], None
    for i in range(steps):
        bt = batch_at(i)
        b = bt["LR_fake"].shape[0]
        var_l = torch.cat([bt["LR_fake"], bt["LR_real"]])
        var_h = torch.cat([bt["HR"], bt["HR_unpair"]])
        weights = F.interpolate(bt["fake_w"], size=var_h.shape[-2:], mode="bilinear",
                                align_corners=False)
        real_ll, real_hc = nets.haar_bands(var_h)
        sr = nets.rrdbnet(g, var_l, conv, ng["nb"])
        fake_ll, fake_hc = nets.haar_bands(sr)
        # the published step applies the pixel weight twice (DASR_model.py:214-218)
        l_pix = pw * torch.mean(weights * (sr[:b] - var_h[:b]).abs())
        total = pw * l_pix + llw * (fake_ll[:b] - real_ll[:b]).abs().mean()
        total = total + fw * nets.lpips(lp, sr[:b], var_h[:b], conv).mean()
        pred = nets.nlayer(d, fake_hc[b:], conv, nd["n_layers"])
        total = total + gw * F.binary_cross_entropy_with_logits(pred, torch.ones_like(pred))
        g_grads = dict(zip(g, torch.autograd.grad(total, list(g.values()))))
        pr = nets.nlayer(d, real_hc[b:], conv, nd["n_layers"])
        pf = nets.nlayer(d, fake_hc[b:].detach(), conv, nd["n_layers"])
        d_loss = (F.binary_cross_entropy_with_logits(pr, torch.ones_like(pr))
                  + F.binary_cross_entropy_with_logits(pf, torch.zeros_like(pf))) / 2
        d_grads = dict(zip(d, torch.autograd.grad(d_loss, list(d.values()))))
        if first is None:
            first = {"G": _norms(g_grads), "D": _norms(d_grads)}
        adam_d.step(d_grads)
        adam_g.step(g_grads)
        losses.append({"loss/l_g_total": float(total.detach()),
                       "loss/l_d_target_total": float(d_loss.detach())})
    return _result(losses, first, start, {"G": g, "D": d})


def dsn_steps(params: Dict[str, Params], batch_at: Callable[[int], Dict[str, torch.Tensor]],
              steps: int, args: dict, conv=nets.conv_f32) -> dict:
    """``steps`` DSN steps from ``params`` ('G', 'D', 'LPIPS'); ``batch_at(i)``
    gives step i's ``input`` HR and ``disc`` noisy LR crops (NCHW f32).
    ``args``: the configuration's ``args`` (the launcher's flags)."""
    scale, nb, ks = args["upscale_factor"], args["num_res_blocks"], args["kernel_size"]
    g, d = _leaves(params["G"]), _leaves(params["D"])
    lp = {k: v.detach() for k, v in params["LPIPS"].items()}
    start = {"G": {k: v.detach().clone() for k, v in g.items()},
             "D": {k: v.detach().clone() for k, v in d.items()}}
    adam_g = Adam(g, args["learning_rate"], args["adam_beta_1"])
    adam_d = Adam(d, args["learning_rate"], args["adam_beta_1"])
    eps = 1e-8
    losses, first = [], None
    for i in range(steps):
        bt = batch_at(i)
        target = ops.bicubic(bt["input"], 1.0 / scale)
        fake = nets.deresnet(g, bt["input"], conv, nb, scale)
        l_tex = (-torch.log(nets.fsd(d, fake, conv, ks) + eps)).mean()
        l_col = (F.avg_pool2d(fake, ks, 1, 0) - F.avg_pool2d(target, ks, 1, 0)).abs().mean()
        loss = args["w_col"] * l_col + args["w_tex"] * l_tex
        loss = loss + args["w_per"] * nets.lpips(lp, fake, target, conv).mean()
        g_grads = dict(zip(g, torch.autograd.grad(loss, list(g.values()))))
        real = nets.fsd(d, bt["disc"], conv, ks)
        fk = nets.fsd(d, fake.detach(), conv, ks)
        d_loss = -torch.log(real + eps).mean() - torch.log(1 - fk + eps).mean()
        d_grads = dict(zip(d, torch.autograd.grad(d_loss, list(d.values()))))
        if first is None:
            first = {"G": _norms(g_grads), "D": _norms(d_grads)}
        adam_g.step(g_grads)
        adam_d.step(d_grads)
        losses.append({"loss/g_overall_loss": float(loss.detach()),
                       "loss/d_tex_loss": float(d_loss.detach())})
    return _result(losses, first, start, {"G": g, "D": d})


# the published DASR model tiles an image of this many LR pixels or more
# (codes/SRN/models/DASR_model.py:337)
CHOP_PIXELS = 320000


def sr_image(g: Params, lr_u8: torch.Tensor, nb: int, conv=nets.conv_f32):
    """The x4 SR image of one HWC uint8 LR image as HWC f32: the whole image
    at once, or tiled from ``CHOP_PIXELS`` on."""
    tiled = lr_u8.shape[0] * lr_u8.shape[1] >= CHOP_PIXELS
    x = lr_u8.permute(2, 0, 1)[None].float() / 255.0
    with torch.no_grad():
        def model(t):
            return nets.rrdbnet(g, t, conv, nb)

        out = ops.tiled(x, model) if tiled else model(x)
    return out[0].permute(1, 2, 0)
