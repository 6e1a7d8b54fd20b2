"""Core residual blocks of the x4 ESRGAN generator.

Counterpart of ``dasr_tpu.nn.blocks``:
  * ``RDB5C`` / ``RRDB``   — ESRGAN residual-dense core
                             (reference: codes/SRN/models/modules/block.py:254-309)
  * ``upconv``             — nearest-x`factor` + conv + act (block.py:854-861)
  * ``pixelshuffle_block`` — conv + ``nn.PixelShuffle`` + act (block.py:838-851)
  * ``RRDBResidualConv`` / ``RRDBResidualConvConcat`` — the DDM-conditioned
                             RRDBs of the Adaptive generator (block.py:462-528)
  * ``ShortcutBlock`` / ``sequential`` — the reference's containers, so a
    module tree carries the reference's parameter names.
  * ``ResidualBlock``      — the DSN generators' conv-PReLU-conv + skip
                             (codes/DSN/model.py:213-224)
  * ``ResNetBlock``        — the SRN's two-conv-block residual block of
                             SRResNet and De_Resnet (block.py:221-251)

``RDB5C`` runs ``ops.rdb.fused_rdb`` (the hand-written kernel on the card,
its plain version on the CPU; under grad mode through its autograd
Function); with a norm layer, another activation or another conv order it
runs the literal dense chain of ``nn`` layers. ``prepared_rdb_weights``
wraps a generator's forward: under grad mode at bf16 on the card it fills
the network's ``ops.rdb.RDBWeightPlan`` once and hands each fused RDB its
slot. The
grouped-scatter regrouping of the JAX module is a TPU rewrite and is not
ported.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Optional

import torch
import torch.nn as nn

from dasr_tpu_torch.nn.layers import Conv2d, PReLU, act_fn, conv_block
from dasr_tpu_torch.ops.rdb import PlannedKernels, RDBWeightPlan, fused_rdb, prepare_weights


def sequential(*args) -> nn.Module:
    """The reference's ``B.sequential``: one level of nested
    ``nn.Sequential``s is flattened into the result."""
    if len(args) == 1:
        if isinstance(args[0], OrderedDict):
            raise NotImplementedError("sequential does not support OrderedDict input")
        return args[0]
    modules = []
    for module in args:
        if isinstance(module, nn.Sequential):
            modules.extend(module.children())
        elif isinstance(module, nn.Module):
            modules.append(module)
    return nn.Sequential(*modules)


class ShortcutBlock(nn.Module):
    """x + sub(x) (reference: block.py:97-111)."""

    def __init__(self, submodule: nn.Module):
        super().__init__()
        self.sub = submodule

    def forward(self, x):
        return x + self.sub(x)


class RDB5C(nn.Module):
    """Residual Dense Block, 5 convs (block.py:254-286); out = x + 0.2 * conv5.

    ``conv{k}`` are reference-named conv blocks (OIHW f32 weights). The
    kernel path takes the same weights as HWIO in the working dtype. Under
    grad mode it takes the parameters' HWIO views, so the gradients reach
    the parameters with no cast recorded around it: ``fused_rdb``'s
    autograd Function casts them itself, or takes the bf16 kernels its
    network's weight plan made for this forward (``prepared_rdb_weights``);
    otherwise they are prepared once per parameter version (an optimizer
    step bumps ``_version``) and cached here."""

    def __init__(self, nc: int = 64, gc: int = 32, norm_type: Optional[str] = None,
                 act_type: str = "leakyrelu", mode: str = "CNA"):
        super().__init__()
        for k in range(5):
            setattr(self, f"conv{k + 1}", conv_block(
                nc + k * gc, gc if k < 4 else nc, 3, norm_type=norm_type,
                act_type=act_type if k < 4 else None, mode="CNA",
            ))
        self.fused = (
            norm_type is None and mode == "CNA"
            and act_type.lower() in ("leakyrelu", "lrelu")
        )
        self._cache = None
        # this RDB's slot of its network's weight plan while the network's
        # forward runs (prepared_rdb_weights), else None
        self._prepared = None

    def convs(self):
        return [getattr(self, f"conv{k + 1}")[0] for k in range(5)]

    def kernel_weights(self, dtype):
        """(HWIO kernels in ``dtype``, f32 biases) for ``fused_rdb``; under
        grad mode the parameters' HWIO views and biases as they are."""
        convs = self.convs()
        if torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters()):
            ks = PlannedKernels(c.weight.permute(2, 3, 1, 0) for c in convs)
            ks.prepared = self._prepared
            return ks, tuple(c.bias.float() for c in convs)
        key = (dtype,) + tuple(
            (p.device, p.data_ptr(), p._version) for c in convs for p in (c.weight, c.bias)
        )
        if self._cache is None or self._cache[0] != key:
            weights = prepare_weights(
                [c.weight.permute(2, 3, 1, 0) for c in convs], [c.bias for c in convs], dtype
            )
            self._cache = (key, weights)
        return self._cache[1]

    def forward(self, x):
        if not self.fused:
            # literal chain (block.py:280-286), with the optional norm
            feats = [x]
            for k in range(4):
                feats.append(getattr(self, f"conv{k + 1}")(torch.cat(feats, 1)))
            return x + self.conv5(torch.cat(feats, 1)) * 0.2
        ks, bs = self.kernel_weights(x.dtype)
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        return fused_rdb(nhwc, ks, bs).permute(0, 3, 1, 2)


def fused_rdbs(net: nn.Module) -> list:
    """``net``'s RDB5Cs that run ``fused_rdb``, in module order: those a
    weight plan covers (a normed RDB runs the literal chain)."""
    return [m for m in net.modules() if isinstance(m, RDB5C) and m.fused]


def _weight_plan(net: nn.Module, dtype: torch.dtype) -> Optional[RDBWeightPlan]:
    """``net``'s weight plan where one applies to this forward: grad mode,
    bf16, fused RDBs whose parameters are on the card and want gradients.
    ``net._rdb_plan`` keeps (its fused RDBs, the plan or None); the plan is
    made on first use and whenever a parameter was replaced or moved,
    outside a CUDA graph's capture (which cannot copy the plan's table from
    the host)."""
    if dtype != torch.bfloat16 or not torch.is_grad_enabled():
        return None
    if net._rdb_plan is None:
        net._rdb_plan = (fused_rdbs(net), None)
    rdbs, plan = net._rdb_plan
    weights = [tuple(c.weight for c in m.convs()) for m in rdbs]
    if not rdbs or not weights[0][0].is_cuda or not any(
            w.requires_grad for ws in weights for w in ws):
        return None
    if plan is not None and plan.current(weights):
        return plan
    if torch.cuda.is_current_stream_capturing():
        return None
    plan = RDBWeightPlan(weights, dtype)
    net._rdb_plan = (rdbs, plan)
    return plan


@contextlib.contextmanager
def prepared_rdb_weights(net: nn.Module, dtype: torch.dtype):
    """Around a generator's forward: where a weight plan applies
    (``_weight_plan``), one launch prepares every fused RDB's bf16 kernels
    and dgrad weight images from the parameters as they are now, and each
    RDB holds its slot (``RDB5C._prepared``) for the forward's duration;
    elsewhere nothing. One preparation is live per network until its
    backward: the plan's buffers are shared by every forward, so a second
    forward before the first one's backward leaves that backward to raise
    (``RDBWeightPlan.prepare``)."""
    plan = _weight_plan(net, dtype)
    if plan is None:
        yield
        return
    plan.prepare()
    rdbs = net._rdb_plan[0]
    for m, slot in zip(rdbs, plan.slots):
        m._prepared = slot
    try:
        yield
    finally:
        for m in rdbs:
            m._prepared = None


class ResidualBlock(nn.Module):
    """x + conv2(prelu(conv1(x))), 3x3 convs with zero padding 1 and one
    PReLU slope; named ``conv1``/``prelu``/``conv2`` as the reference."""

    def __init__(self, channels: int = 64):
        super().__init__()
        self.conv1 = Conv2d(channels, channels, 3, padding=1)
        self.prelu = PReLU()
        self.conv2 = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(self.prelu(self.conv1(x)))


class ResNetBlock(nn.Module):
    """x + res(x), ``res`` the reference's flattened sequential of
    two 3x3 conv blocks (block.py:221-251): the first with the norm and the
    activation, the second with the norm, and with the activation only in
    NAC mode (CNA drops it). ``dasr_tpu``'s ``SRResNet`` drops it in NAC
    mode too (``dasr_tpu/nn/generators.py:340-347``); the port follows the
    reference, as ``dasr_tpu``'s own ``ResNetBlock`` does (ROADMAP C.2)."""

    def __init__(self, nf: int = 64, norm_type: Optional[str] = None,
                 act_type: Optional[str] = "relu", mode: str = "NAC"):
        super().__init__()
        self.res = sequential(
            conv_block(nf, nf, 3, norm_type=norm_type, act_type=act_type, mode=mode),
            conv_block(nf, nf, 3, norm_type=norm_type,
                       act_type=None if mode == "CNA" else act_type, mode=mode))

    def forward(self, x):
        return x + self.res(x)


class RRDB(nn.Module):
    """Residual-in-Residual Dense Block (block.py:289-309)."""

    def __init__(self, nc: int = 64, gc: int = 32, norm_type: Optional[str] = None,
                 act_type: str = "leakyrelu"):
        super().__init__()
        self.RDB1 = RDB5C(nc, gc, norm_type, act_type)
        self.RDB2 = RDB5C(nc, gc, norm_type, act_type)
        self.RDB3 = RDB5C(nc, gc, norm_type, act_type)

    def forward(self, x):
        return x + self.RDB3(self.RDB2(self.RDB1(x))) * 0.2


def upconv(in_ch: int, out_ch: int, factor: int = 2,
           act_type: Optional[str] = "relu") -> nn.Sequential:
    """Nearest-neighbour x`factor` upsample + conv + act (block.py:854-861)."""
    return sequential(
        nn.Upsample(scale_factor=factor, mode="nearest"),
        conv_block(in_ch, out_ch, 3, act_type=act_type),
    )


def pixelshuffle_block(in_ch: int, out_ch: int, factor: int = 2,
                       act_type: Optional[str] = "relu") -> nn.Sequential:
    """conv to r^2*C, ``nn.PixelShuffle``, act (block.py:838-851): the
    reference's layer and channel order (c, i, j), so a reference ``.pth``
    loads as it is. ``dasr_tpu``'s depth-to-space reads the conv's channels
    as (i, j, c); ``checkpoints.ps_conv_from_jax`` permutes a JAX kernel's
    output channels into this order."""
    act = act_fn(act_type)
    mods = [conv_block(in_ch, out_ch * factor * factor, 3, act_type=None),
            nn.PixelShuffle(factor)]
    return sequential(*mods, *([act] if act is not None else []))


class RRDBResidualConv(nn.Module):
    """DDM-conditioned RRDB, 'resconv' flavor (block.py:462-488):
    ``RDB3(RDB2(RDB1(x))) * (w * 1.0) + res_conv(x) * 0.1``, where ``w``,
    the (B, 1, h, w) adaptive map, broadcasts over the channels and
    ``res_conv`` is two leaky-ReLU conv blocks."""

    def __init__(self, nc: int = 64, gc: int = 32):
        super().__init__()
        self.RDB1 = RDB5C(nc, gc)
        self.RDB2 = RDB5C(nc, gc)
        self.RDB3 = RDB5C(nc, gc)
        self.res_conv = sequential(conv_block(nc, nc, 3, act_type="leakyrelu"),
                                   conv_block(nc, nc, 3, act_type="leakyrelu"))

    def forward(self, x, w):
        out = self.RDB3(self.RDB2(self.RDB1(x)))
        return out * (w.to(out.dtype) * 1.0) + self.res_conv(x) * 0.1


class RRDBResidualConvConcat(nn.Module):
    """DDM-conditioned RRDB, 'concat' flavor (block.py:490-528): one shared
    two-conv ``ada_conv`` stack maps ``[v, 0.2 w]`` (nc + 1 channels) back
    to nc before each of the three RDBs, and the residual is the two-conv
    ``res_conv([x, w])``; ``out * 0.2 + res``."""

    def __init__(self, nc: int = 64, gc: int = 32):
        super().__init__()

        def stack():
            return sequential(conv_block(nc + 1, nc, 3, act_type="leakyrelu"),
                              conv_block(nc, nc, 3, act_type="leakyrelu"))

        self.ada_conv = stack()
        self.RDB1 = RDB5C(nc, gc)
        self.RDB2 = RDB5C(nc, gc)
        self.RDB3 = RDB5C(nc, gc)
        self.res_conv = stack()

    def forward(self, x, w):
        w = w.to(x.dtype)

        def ada(v):
            return self.ada_conv(torch.cat([v, w * 0.2], 1))

        out = self.RDB3(ada(self.RDB2(ada(self.RDB1(ada(x))))))
        return out * 0.2 + self.res_conv(torch.cat([x, w * 1.0], 1))
