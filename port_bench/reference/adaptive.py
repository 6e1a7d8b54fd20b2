"""The plain reference of the DASR Adaptive model: its generator, its patch
discriminator with the Gaussian front end, the train step with the online
domain-distance map (DDM), its batches and its model FLOPs, in float32
PyTorch over dicts of parameters named as the program's ``state_dict``.

Followed from the published model (ShuhangGu/DASR,
codes/SRN/models/DASR_Adaptive_model.py:23-515; the generator
``RRDBNet_Residual_conv``, architecture.py:208-297 and block.py:462-488; the
FSD patch D, codes/DSN/model.py:60-118 and 227-293). A step
(DASR_Adaptive_model.py:208-230): the patch D scores the whole LR batch
(source half, then target half); those scores, the (B, 1, h, w) map,
condition every one of G's adaptive blocks; the source half, resized
bilinearly to HR, weights the pixel loss; the rest of the step is the DASR
step of ``steps.dasr_steps``, with its double ``pixel_weight``.

Departures from the published model, each as the program has it:

* the patch D's weights are drawn from the seed (the published flow loads
  them from stage 1's ``.tar``, which is not in the repository);
* the patch D runs as the program runs it: its InstanceNorms carry no
  running statistics, so train and eval mode agree;
* with ``use_patchD_opt`` on, the patch D takes its Adam step (lr 1e-4,
  the configuration's ``beta1_D``, a constant LR) on
  ``dsn_discriminator_loss`` of its own scores (:217-222) before G's
  forward, and the step uses the scores of the parameters from before that
  update;
* the DDM switch is the configuration's ``use_domain_distance_map``
  (default on); off, the pixel loss is the plain L1.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from port_bench.reference import costs, nets, sampling, steps
from port_bench.reference.nets import Params, Spec

EPS = 1e-8
LR_PATCHD = 1e-4


def rrdbnet_residual_conv_spec(nf: int = 64, nb: int = 19, gc: int = 32, nb_ada: int = 4,
                               in_nc: int = 3, out_nc: int = 3) -> Spec:
    """The Adaptive generator's parameters: RDB convs kaiming fan-in x 0.1,
    the others lecun-normal, zero biases (the law of ``nets.rrdbnet_spec``)."""
    spec: Spec = {}
    nets._conv_spec(spec, "fea_conv.0", in_nc, nf, 3)

    def rdbs(pre: str):
        for j in (1, 2, 3):
            for k in range(5):
                cin, cout = nf + k * gc, gc if k < 4 else nf
                law = ("normal", math.sqrt(2.0 / (cin * 9)) * 0.1)
                nets._conv_spec(spec, f"{pre}.RDB{j}.conv{k + 1}.0", cin, cout, 3, law=law)

    for i in range(nb_ada):
        rdbs(f"ada_blocks.{i}")
        for name in ("res_conv.0", "res_conv.2"):
            nets._conv_spec(spec, f"ada_blocks.{i}.{name}", nf, nf, 3)
    for i in range(nb):
        rdbs(f"trunk.{i}")
    for name in ("lr_conv.0", "tail.1", "tail.4", "tail.6"):
        nets._conv_spec(spec, name, nf, nf, 3)
    nets._conv_spec(spec, "tail.8", nf, out_nc, 3)
    return spec


def rrdbnet_residual_conv(p: Params, x, w, conv: Callable = nets.conv_f32, nb: int = 19,
                          nb_ada: int = 4):
    """NCHW LR and the (B, 1, h, w) map -> NCHW x4 SR: the stem; ``nb_ada``
    blocks ``RDB3(RDB2(RDB1(h))) * w + res_conv(h) * 0.1``, ``res_conv`` two
    leaky 3x3 convs; ``nb`` RRDBs; the trunk conv under the long skip; two
    nearest x2 upconvs; two HR convs."""
    fea = conv(x, p["fea_conv.0.weight"], p["fea_conv.0.bias"], 1, 1)
    h = fea
    for i in range(nb_ada):
        pre = f"ada_blocks.{i}"
        r = h
        for j in (1, 2, 3):
            r = nets._rdb(p, f"{pre}.RDB{j}", r, conv)
        res = h
        for name in ("res_conv.0", "res_conv.2"):
            res = nets.lrelu(conv(res, p[f"{pre}.{name}.weight"], p[f"{pre}.{name}.bias"], 1, 1))
        h = r * w + res * 0.1
    for i in range(nb):
        r = h
        for j in (1, 2, 3):
            r = nets._rdb(p, f"trunk.{i}.RDB{j}", r, conv)
        h = h + 0.2 * r
    h = fea + conv(h, p["lr_conv.0.weight"], p["lr_conv.0.bias"], 1, 1)
    for name in ("tail.1", "tail.4"):
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = nets.lrelu(conv(h, p[f"{name}.weight"], p[f"{name}.bias"], 1, 1))
    h = nets.lrelu(conv(h, p["tail.6.weight"], p["tail.6.bias"], 1, 1))
    return conv(h, p["tail.8.weight"], p["tail.8.bias"], 1, 1)


def gaussian_window(k: int, device) -> torch.Tensor:
    """The (k, k) window exp(-((x - m)^2 + (y - m)^2) / (2 (k / 6)^2)),
    m = (k - 1) / 2, normalised to sum 1."""
    c = torch.arange(k, dtype=torch.float64)
    m, var = (k - 1) / 2.0, (k / 6.0) ** 2
    d2 = (c[None, :] - m) ** 2 + (c[:, None] - m) ** 2
    win = torch.exp(-d2 / (2 * var))
    return (win / win.sum()).float().to(device)


def fsd_gau(p: Params, x, conv: Callable = nets.conv_f32, kernel_size: int = 5):
    """The patch D: sigmoid(FSD body(0.5 + 0.5 (x - low))), ``low`` each
    channel convolved with the Gaussian window, zero-padded to the same
    size; the body as ``nets.fsd``'s. The fixed low-pass is exact f32 in
    every precision (it is no layer of the network)."""
    c = x.shape[1]
    win = gaussian_window(kernel_size, x.device).expand(c, 1, kernel_size, kernel_size)
    low = F.conv2d(x, win, padding=(kernel_size - 1) // 2, groups=c)
    h = 0.5 + 0.5 * (x - low)
    h = nets.lrelu(conv(h, p["net.net.0.weight"], p["net.net.0.bias"], 1, 2))
    for idx in (2, 5):
        h = conv(h, p[f"net.net.{idx}.weight"], p[f"net.net.{idx}.bias"], 1, 2)
        h = nets.lrelu(F.instance_norm(h, eps=1e-5))
    return torch.sigmoid(conv(h, p["net.net.8.weight"], p["net.net.8.bias"], 1, 0))


def adaptive_batch(banks: Dict[str, tuple], row: torch.Tensor, gen: torch.Generator, hr: int,
                   scale: int, flip: bool, rot: bool) -> Dict[str, torch.Tensor]:
    """The batch of ``sampling.dasr_batch``'s law on banks with no DDM bank
    (the Adaptive model computes its map): its draws and crops of LR_fake,
    LR_real, HR and HR_unpair; a view of ones stands in for the DDM bank,
    holding no memory, and its crop is dropped."""
    data, sizes = banks["fake"]
    ones = torch.ones((), device=data.device).expand(*data.shape[:3], 1)
    out = sampling.dasr_batch(dict(banks, ddm=(ones, sizes)), row, gen, hr, scale, flip, rot)
    out.pop("fake_w")
    return out


def adaptive_steps(params: Dict[str, Params], batch_at: Callable[[int], Dict[str, torch.Tensor]],
                   n_steps: int, opt: dict, conv=nets.conv_f32) -> dict:
    """``n_steps`` Adaptive steps from ``params`` ('G', 'D', 'PatchD',
    'LPIPS'); ``batch_at(i)`` gives step i's batch (NCHW f32: LR_fake,
    LR_real, HR, HR_unpair). ``opt``: the configuration. Returns what
    ``steps.dasr_steps`` returns; the patch D is among the networks held
    to the program where it trains (``use_patchD_opt``)."""
    tr, ng, nd = opt["train"], opt["network_G"], opt["network_D"]
    k = (opt.get("network_patchD") or {}).get("kernel_size", 5)
    use_ddm = opt.get("use_domain_distance_map", True)
    trains_pd = bool(tr.get("use_patchD_opt", False))
    g, d, pd = (steps._leaves(params[n]) for n in ("G", "D", "PatchD"))
    lp = {key: v.detach() for key, v in params["LPIPS"].items()}
    held = {"G": g, "D": d, **({"PatchD": pd} if trains_pd else {})}
    start = {n: {key: v.detach().clone() for key, v in net.items()} for n, net in held.items()}
    adam_g = steps.Adam(g, tr["lr_G"], tr["beta1_G"])
    adam_d = steps.Adam(d, tr["lr_D"], tr["beta1_D"])
    adam_pd = steps.Adam(pd, LR_PATCHD, tr["beta1_D"])
    pw, llw, fw, gw = (tr["pixel_weight"], tr["pixel_LL_weight"], tr["feature_weight"],
                       tr["gan_H_target"])
    losses, first = [], None
    for i in range(n_steps):
        bt = batch_at(i)
        b = bt["LR_fake"].shape[0]
        var_l = torch.cat([bt["LR_fake"], bt["LR_real"]])
        var_h = torch.cat([bt["HR"], bt["HR_unpair"]])
        loss = {}
        if trains_pd:
            scores = fsd_gau(pd, var_l, conv, k)
            pd_loss = (-torch.log(scores[b:] + EPS).mean()
                       - torch.log(1 - scores[:b] + EPS).mean())
            pd_grads = dict(zip(pd, torch.autograd.grad(pd_loss, list(pd.values()))))
            adam_pd.step(pd_grads)
            loss["loss/patch_D_gan_loss"] = float(pd_loss.detach())
            ada_w = scores.detach()
        else:
            with torch.no_grad():
                ada_w = fsd_gau(pd, var_l, conv, k)
        real_ll, real_hc = nets.haar_bands(var_h)
        sr = rrdbnet_residual_conv(g, var_l, ada_w, conv, ng["nb"], ng["ada_nb"])
        fake_ll, fake_hc = nets.haar_bands(sr)
        if use_ddm:
            weights = F.interpolate(ada_w[:b], size=var_h.shape[-2:], mode="bilinear",
                                    align_corners=False)
            # the published step applies the pixel weight twice (DASR_model.py:214-218)
            l_pix = pw * torch.mean(weights * (sr[:b] - var_h[:b]).abs())
        else:
            l_pix = (sr[:b] - var_h[:b]).abs().mean()
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
            first = {"G": steps._norms(g_grads), "D": steps._norms(d_grads)}
            if trains_pd:
                first["PatchD"] = steps._norms(pd_grads)
        adam_d.step(d_grads)
        adam_g.step(g_grads)
        loss.update({"loss/l_g_total": float(total.detach()),
                     "loss/l_d_target_total": float(d_loss.detach())})
        losses.append(loss)
    return steps._result(losses, first, start, held)


def adaptive_step_flop(batch: int, hr: int, scale: int = 4, nf: int = 64, nb: int = 19,
                       gc: int = 32, nb_ada: int = 4, d_nf: int = 64, d_layers: int = 2,
                       trains_patchd: bool = False) -> int:
    """Model FLOPs of one Adaptive step with ``batch`` fake + ``batch`` real
    items: the DASR step's count (``costs.dasr_step_flop``) with the
    ``nb + nb_ada`` RRDBs of G, the adaptive blocks' two res convs each
    (forward, weight and input gradients), and the patch D's body on the
    2 ``batch`` LRs: its forward, and where it trains its weight gradients
    and its input gradients past the first conv."""
    lr = hr // scale
    two = 2 * batch
    total = costs.dasr_step_flop(batch, hr, scale, nf, nb + nb_ada, gc, d_nf, d_layers)
    total += 3 * two * 2 * nb_ada * costs.Conv(nf, nf, 3, lr * lr).flop
    pd = costs.fsd_convs(lr, lr)
    total += two * sum(c.flop for c in pd)
    if trains_patchd:
        total += two * (sum(c.flop for c in pd) + sum(c.flop for c in pd[1:]))
    return total
