"""Reference-format checkpoints for the port.

The port's modules carry the reference's parameter names, so a reference
``*_G.pth`` or ``*_D_target.pth``/``*_D_source.pth``
(codes/SRN/models/base_model.py:50-74 layout) loads with plain
``load_state_dict``. ``*_state_dict_from_jax`` turn JAX parameter trees
into such state dicts, through the key maps of
``dasr_tpu.train.checkpoints`` (copied here, since the port does not import
the JAX package).

The port saves a train state as one torch file (``save_train_state``) and,
on request, in the reference's layout (``save_reference_formats``:
``{iter}_G.pth``, ``{iter}_D_target.pth``, ``{iter}.state`` with the Adam
state dicts). ``load_train_state`` resumes either stage from the port's
own saves; ``load_reference_training_state`` and ``import_adam_state``
resume the SRN stage from a reference ``{iter}.state``. The DSN stage's
reference checkpoint is one ``.tar`` (``save_dsn_tar`` / ``load_dsn_tar``,
the key schema of codes/DSN/train.py:361-373), which the JAX package writes
too.
"""

from __future__ import annotations

import glob
import math
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _j2t_conv(w: np.ndarray) -> np.ndarray:
    """flax HWIO conv kernel -> torch OIHW."""
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def _conv_t(kernel) -> torch.Tensor:
    """A flax HWIO kernel as a writable f32 OIHW tensor."""
    return torch.from_numpy(np.array(_j2t_conv(np.asarray(kernel, np.float32))))


def rrdbnet_key_map(nb: int = 23):
    """Ordered (torch_prefix, flax_path, kind) for RRDBNet: ``model.0`` stem,
    ``model.1.sub.{i}.RDB{j}.conv{k}.0`` trunk, ``model.1.sub.{nb}`` trunk
    conv, ``model.3/6`` upconv convs, ``model.8/10`` HR convs
    (architecture.py:174-205 + block.py sequential/ShortcutBlock)."""
    out = [("model.0", ("conv_block_0", "Conv_0"), "conv")]
    for i in range(nb):
        for j in range(3):
            for k in range(5):
                out.append((
                    f"model.1.sub.{i}.RDB{j + 1}.conv{k + 1}.0",
                    (f"RRDB_{i}", f"RDB5C_{j}", f"conv{k}"),
                    "rdbconv",
                ))
    out += [
        (f"model.1.sub.{nb}", ("conv_block_1", "Conv_0"), "conv"),
        ("model.3", ("upconv_0", "conv_block_0", "Conv_0"), "conv"),
        ("model.6", ("upconv_1", "conv_block_0", "Conv_0"), "conv"),
        ("model.8", ("conv_block_2", "Conv_0"), "conv"),
        ("model.10", ("conv_block_3", "Conv_0"), "conv"),
    ]
    return out


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A reference ``.pth`` (optionally under a ``state_dict`` key) -> numpy."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.numpy() for k, v in obj.items() if hasattr(v, "numpy")}


def load_pth(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a reference-named ``.pth`` (``*_G.pth``, ``*_D_target.pth``, ...)
    into ``model`` (strict)."""
    sd = {k: torch.from_numpy(v) for k, v in load_torch_state_dict(path).items()}
    model.load_state_dict(sd, strict=True)
    return model


def rrdbnet_state_dict_from_jax(params_np: Dict[str, Any], nb: int,
                                upsample_mode: str = "upconv") -> Dict[str, torch.Tensor]:
    """JAX ``RRDBNet`` parameters (nested dicts of arrays, with or without the
    top ``params`` level) -> reference-named f32 state dict. With
    ``upsample_mode`` 'pixelshuffle' the upsampler convs sit at ``model.2``
    and ``model.5``, their output channels put in ``nn.PixelShuffle``'s
    order (``ps_conv_from_jax``)."""
    params = params_np.get("params", params_np)

    def node(path):
        n = params
        for p in path:
            n = n[p]
        return n

    sd: Dict[str, torch.Tensor] = {}
    for tkey, fpath, kind in rrdbnet_key_map(nb):
        if kind == "rdbconv":
            n = node(fpath[:-1])
            kernel, bias = n[fpath[-1] + "_kernel"], n[fpath[-1] + "_bias"]
            sd[tkey + ".weight"] = _conv_t(kernel)
            sd[tkey + ".bias"] = _vec_t(bias)
        elif fpath[0].startswith("upconv") and upsample_mode == "pixelshuffle":
            i = int(fpath[0][-1])
            sd.update(ps_conv_from_jax(params[f"pixelshuffle_block_{i}"]["conv_block_0"],
                                       f"model.{2 + 3 * i}"))
        else:
            sd.update(_conv_block_sd(node(fpath[:-1]), tkey))
    return sd


def _vec_t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32).reshape(-1))


def _conv_block_sd(node, prefix: str) -> Dict[str, torch.Tensor]:
    """A flax ``conv_block`` (``Conv_0``), or a bare ``nn.Conv`` node, as
    ``{prefix}.weight`` / ``{prefix}.bias``."""
    conv = node.get("Conv_0", node)
    return {prefix + ".weight": _conv_t(conv["kernel"]), prefix + ".bias": _vec_t(conv["bias"])}


def _ps_perm(cout: int, r: int = 2) -> np.ndarray:
    """Output-channel order that takes a ``dasr_tpu`` depth-to-space conv to
    ``nn.PixelShuffle``'s (see ``ps_conv_from_jax``)."""
    return np.arange(cout).reshape(r, r, cout // (r * r)).transpose(2, 0, 1).reshape(-1)


def ps_conv_from_jax(node, prefix: str, r: int = 2) -> Dict[str, torch.Tensor]:
    """A JAX ``pixelshuffle_block``'s conv (``conv_block_0`` node): the
    depth-to-space of ``dasr_tpu`` reads output channel (i r + j) C + c as
    offset (i, j) of channel c, ``nn.PixelShuffle`` reads c r^2 + i r + j,
    so the output channels are permuted (the inverse of
    ``dasr_tpu.train.checkpoints.import_sftnet_params``'s ``conv_ps``)."""
    sd = _conv_block_sd(node, prefix)
    perm = torch.from_numpy(_ps_perm(sd[prefix + ".bias"].shape[0], r))
    return {k: v[perm].contiguous() for k, v in sd.items()}


def _rdb_sd(node, prefix: str) -> Dict[str, torch.Tensor]:
    """A JAX ``RDB5C`` (``conv{k}_kernel`` / ``conv{k}_bias``) as the port's
    ``{prefix}.conv{k + 1}.0``."""
    sd = {}
    for k in range(5):
        sd[f"{prefix}.conv{k + 1}.0.weight"] = _conv_t(node[f"conv{k}_kernel"])
        sd[f"{prefix}.conv{k + 1}.0.bias"] = _vec_t(node[f"conv{k}_bias"])
    return sd


def _rdbs_sd(node, prefix: str, names=("RDB1", "RDB2", "RDB3")) -> Dict[str, torch.Tensor]:
    """A block's three ``RDB5C_j`` at ``{prefix}.{names[j]}``."""
    sd = {}
    for j, name in enumerate(names):
        sd.update(_rdb_sd(node[f"RDB5C_{j}"], f"{prefix}{name}"))
    return sd


def _stack_sd(nodes, prefix: str) -> Dict[str, torch.Tensor]:
    """Conv blocks of a port ``sequential`` of (conv, act) pairs."""
    sd = {}
    for i, node in enumerate(nodes):
        sd.update(_conv_block_sd(node, f"{prefix}{2 * i}"))
    return sd


def _scalar(node, name: str, prefix: str) -> Dict[str, torch.Tensor]:
    return {prefix + name: _vec_t(node[name])}


_RDBS = tuple(f"RDBs.{j}" for j in range(3))


def adaptive_block_state_dict_from_jax(kind: str, params_np: Dict[str, Any], prefix: str = "",
                                       ada_nb: int = 4) -> Dict[str, torch.Tensor]:
    """The JAX parameters of one DDM-conditioned or channel-attention block
    (``kind``: its class name in ``dasr_tpu.nn.blocks`` /
    ``dasr_tpu.nn.adaptive_blocks``) -> the port module's state dict, keys
    under ``prefix``. ``ada_nb``: ``AdaptiveModule``'s chain length."""
    p = params_np.get("params", params_np)
    sd: Dict[str, torch.Tensor] = {}
    if kind == "RRDB":
        sd.update(_rdbs_sd(p, prefix))
    elif kind == "RRDBResidualConv":
        sd.update(_rdbs_sd(p, prefix))
        sd.update(_stack_sd([p["conv_block_0"], p["conv_block_1"]], f"{prefix}res_conv."))
    elif kind == "RRDBResidualConvConcat":
        sd.update(_stack_sd([p["ada_conv_0"], p["ada_conv_1"]], f"{prefix}ada_conv."))
        sd.update(_rdbs_sd(p, prefix))
        sd.update(_stack_sd([p["res_conv_0"], p["res_conv_1"]], f"{prefix}res_conv."))
    elif kind == "AffineModule":
        sd.update(_stack_sd([p["conv_block_0"], p["conv_block_1"]], f"{prefix}ddm_conv1."))
        for name in ("gamma1", "bias1"):
            sd.update(_scalar(p, name, prefix))
    elif kind == "RRDBAffine":
        sd.update(_rdbs_sd(p, prefix, _RDBS))
        for j in range(3):
            sd.update(adaptive_block_state_dict_from_jax(
                "AffineModule", p[f"AffineModule_{j}"], f"{prefix}affines.{j}."))
    elif kind == "SEANModule":
        cb = [p[f"conv_block_{i}"] for i in range(7)]
        for name, nodes in (("rep_gamma", cb[0:2]),
                            ("rep_beta_dormant", [p["rep_beta_dormant_0"],
                                                  p["rep_beta_dormant_1"]]),
                            ("ddm_conv", cb[2:3]), ("ddm_gamma", cb[3:5]), ("ddm_beta", cb[5:7])):
            sd.update(_stack_sd(nodes, f"{prefix}{name}."))
        for name in ("alpha_gamma", "alpha_beta"):
            sd.update(_scalar(p, name, prefix))
    elif kind == "RRDBSEAN":
        sd.update(_rdbs_sd(p, prefix, _RDBS))
        for i in range(3):
            sd.update(adaptive_block_state_dict_from_jax(
                "SEANModule", p[f"SEANModule_{i}"], f"{prefix}seans.{i}."))
            sd.update(_conv_block_sd(p[f"conv_block_{i}"], f"{prefix}convs.{i}.0"))
    elif kind == "RRDBAda":
        sd.update(_scalar(p, "lda", prefix))
        sd.update(_rdbs_sd(p, prefix, _RDBS))
    elif kind == "AdaptiveModule":
        for i in range(2 * ada_nb):
            side = "real" if i < ada_nb else "fake"
            sd.update(_rdbs_sd(p[f"RRDB_{i}"], f"{prefix}{side}.{i % ada_nb}."))
    elif kind == "RRDBCatInput":
        for i in range(3):
            sd.update(_conv_block_sd(p[f"conv_block_{i}"], f"{prefix}merges.{i}.0"))
        sd.update(_rdbs_sd(p, prefix, _RDBS))
    elif kind == "RRDBWithFeatureOut":
        sd.update(_rdbs_sd(p, prefix, _RDBS))
        sd.update(_conv_block_sd(p["conv_block_0"], f"{prefix}tap.0"))
    elif kind == "CALayer":
        sd.update(_conv_block_sd(p["Conv_0"], f"{prefix}conv_du.0"))
        sd.update(_conv_block_sd(p["Conv_1"], f"{prefix}conv_du.2"))
    elif kind == "RCAB":
        sd.update(_conv_block_sd(p["Conv_0"], f"{prefix}body.0"))
        sd.update(_conv_block_sd(p["Conv_1"], f"{prefix}body.2"))
        sd.update(adaptive_block_state_dict_from_jax("CALayer", p["CALayer_0"],
                                                     f"{prefix}body.3."))
    elif kind == "CARRDB":
        sd.update(_rdbs_sd(p, prefix, _RDBS))
        for i in range(2):
            sd.update(adaptive_block_state_dict_from_jax("RCAB", p[f"RCAB_{i}"],
                                                         f"{prefix}RCABs.{i}."))
    else:
        raise NotImplementedError(f"no carry-over for block [{kind}]")
    return sd


def conditioned_g_state_dict_from_jax(params_np: Dict[str, Any], nb: int, nb_ada: int,
                                      block: str, upscale: int = 4,
                                      upsample_mode: str = "upconv") -> Dict[str, torch.Tensor]:
    """JAX ``RRDBNetResidualConv`` (``block`` 'RRDBResidualConv' or
    'RRDBResidualConvConcat') or ``RRDBNetSEAN`` (``block`` 'RRDBSEAN')
    parameters -> the port generator's state dict: ``fea_conv``,
    ``ada_blocks``, ``trunk``, ``lr_conv`` and ``tail`` (its upsampler
    convs permuted for ``nn.PixelShuffle`` in 'pixelshuffle' mode)."""
    p = params_np.get("params", params_np)
    sd = _conv_block_sd(p["conv_block_0"], "fea_conv.0")
    for i in range(nb_ada):
        sd.update(adaptive_block_state_dict_from_jax(block, p[f"{block}_{i}"],
                                                     f"ada_blocks.{i}."))
    for i in range(nb):
        sd.update(_rdbs_sd(p[f"RRDB_{i}"], f"trunk.{i}."))
    sd.update(_conv_block_sd(p["conv_block_1"], "lr_conv.0"))
    n_up = 1 if upscale == 3 else int(math.log2(upscale))
    for i in range(n_up):
        if upsample_mode == "pixelshuffle":
            sd.update(ps_conv_from_jax(p[f"pixelshuffle_block_{i}"]["conv_block_0"],
                                       f"tail.{3 * i}"))
        else:
            sd.update(_conv_block_sd(p[f"upconv_{i}"]["conv_block_0"], f"tail.{3 * i + 1}"))
    sd.update(_conv_block_sd(p["conv_block_2"], f"tail.{3 * n_up}"))
    sd.update(_conv_block_sd(p["conv_block_3"], f"tail.{3 * n_up + 2}"))
    return sd


def deresnet_state_dict_from_jax(params_np: Dict[str, Any], n_res_blocks: int,
                                 scale: int = 4) -> Dict[str, torch.Tensor]:
    """JAX ``DeResnet`` (or ``DSGANGenerator``, ``scale=1``) parameters ->
    the reference-named state dict (``block_input.{0,1}``,
    ``res_blocks.{i}.conv1/prelu/conv2``, ``down_sample.{0..3}``,
    ``block_output``; the port's side of ``export_deresnet_state_dict``)."""
    p = params_np.get("params", params_np)

    def t(v, shape=None):
        a = np.array(v, dtype=np.float32)
        return torch.from_numpy(a.reshape(shape) if shape else a)

    def conv(prefix, node):
        return {prefix + ".weight": _conv_t(node["kernel"]), prefix + ".bias": t(node["bias"])}

    sd = {**conv("block_input.0", p["Conv_0"]),
          "block_input.1.weight": t(p["PReLU_0"]["slope"], (1,))}
    for i in range(n_res_blocks):
        b = p[f"ResidualBlock_{i}"]
        sd.update(conv(f"res_blocks.{i}.conv1", b["Conv_0"]))
        sd[f"res_blocks.{i}.prelu.weight"] = t(b["PReLU_0"]["slope"], (1,))
        sd.update(conv(f"res_blocks.{i}.conv2", b["Conv_1"]))
    n_down = {1: 0, 2: 1, 4: 2}[scale]
    for d in range(n_down):
        sd.update(conv(f"down_sample.{2 * d}", p[f"Conv_{d + 1}"]))
        sd[f"down_sample.{2 * d + 1}.weight"] = t(p[f"PReLU_{d + 1}"]["slope"], (1,))
    sd.update(conv("block_output", p[f"Conv_{n_down + 1}"]))
    return sd


def _zip_into(net: torch.nn.Module, convs, bns=(), prelus=(), linears=(),
              sns=()) -> Dict[str, torch.Tensor]:
    """``net``'s state dict from flax nodes, paired with the port's layers
    type by type in registration order: ``convs`` ((node, ps) for each
    ``Conv2d`` or ``ConvTranspose2d``; ps True, or the factor r, permutes
    the output channels for an ``nn.PixelShuffle(r)`` after it; a transposed
    conv's kernel is flipped, as lax.conv_transpose does not flip it),
    ``bns`` ((params, stats) for each ``BatchNorm2d``), ``prelus`` (nodes),
    ``linears`` ((node, (C, H, W) of an NHWC-flattened input, or None) for
    each ``Linear``) and ``sns`` ((u, sigma) for each spectral-norm layer).
    Fails unless every layer and node pairs up."""
    from dasr_tpu_torch.nn.layers import Conv2d, Linear, PReLU, _SpectralNorm

    queues = {k: list(v) for k, v in (("conv", convs), ("bn", bns), ("prelu", prelus),
                                       ("linear", linears), ("sn", sns))}

    def pop(kind, name):
        if not queues[kind]:
            raise ValueError(f"no flax {kind} node left for {name}")
        return queues[kind].pop(0)

    sd: Dict[str, torch.Tensor] = {}
    for name, m in net.named_modules():
        if isinstance(m, Conv2d):
            node, ps = pop("conv", name)
            w, b = _conv_t(node["kernel"]), node.get("bias")
            b = None if b is None else _vec_t(b)
            if ps:
                perm = torch.from_numpy(_ps_perm(w.shape[0], 2 if ps is True else ps))
                w, b = w[perm].contiguous(), b[perm].contiguous()
            sd[f"{name}.weight"] = w
            if b is not None:
                sd[f"{name}.bias"] = b
        elif isinstance(m, torch.nn.ConvTranspose2d):
            node, _ = pop("conv", name)
            k = np.asarray(node["kernel"], np.float32)[::-1, ::-1].transpose(2, 3, 0, 1)
            sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(k))
            sd[f"{name}.bias"] = _vec_t(node["bias"])
        elif isinstance(m, Linear):
            node, chw = pop("linear", name)
            wt = np.asarray(node["kernel"], np.float32).T
            if chw is not None:
                c, h, w = chw
                wt = wt.reshape(-1, h, w, c).transpose(0, 3, 1, 2).reshape(wt.shape[0], -1)
            sd[f"{name}.weight"] = torch.from_numpy(np.array(wt, np.float32))
            sd[f"{name}.bias"] = _vec_t(node["bias"])
        elif isinstance(m, torch.nn.BatchNorm2d):
            p, st = pop("bn", name)
            for key, v in (("weight", p["scale"]), ("bias", p["bias"]),
                           ("running_mean", st["mean"]), ("running_var", st["var"])):
                sd[f"{name}.{key}"] = _vec_t(v)
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif isinstance(m, PReLU):
            sd[f"{name}.weight"] = _vec_t(pop("prelu", name)["slope"])
        if isinstance(m, _SpectralNorm):
            u, sigma = pop("sn", name)
            sd[f"{name}.u"] = torch.from_numpy(np.array(u, np.float32).reshape(1, -1))
            sd[f"{name}.sigma"] = torch.tensor(float(np.asarray(sigma)))
    left = {k: len(v) for k, v in queues.items() if v}
    if left:
        raise ValueError(f"flax nodes left over after {type(net).__name__}'s layers: {left}")
    return sd


def _indexed(tree: Dict[str, Any], prefix: str):
    """``tree``'s ``{prefix}{i}`` nodes in the order of ``i``."""
    keys = [k for k in tree if k.startswith(prefix) and k[len(prefix):].isdigit()]
    return [tree[k] for k in sorted(keys, key=lambda k: int(k[len(prefix):]))]


def _conv_block_nodes(blocks, stats_blocks, ps=()):
    """(convs, bns, prelus) of flax ``conv_block`` nodes in order; the
    blocks whose index is in ``ps`` are pixelshuffle convs."""
    convs, bns, prelus = [], [], []
    for i, (node, st) in enumerate(zip(blocks, stats_blocks)):
        convs.append((node["Conv_0"], i in ps))
        if "BatchNorm_0" in node:
            bns.append((node["BatchNorm_0"], st["BatchNorm_0"]))
        if "PReLU_0" in node:
            prelus.append(node["PReLU_0"])
    return convs, bns, prelus


def state_dict_from_jax(net: torch.nn.Module,
                        variables_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax variables (``params`` and ``batch_stats``, numpy) of the
    ``dasr_tpu`` counterpart of ``net`` -> ``net``'s state dict: flax's
    nodes paired with the port's layers type by type in the module's order
    (``_zip_into``). ``ResNetBlock``, ``SRResNet`` and SFTNet (their
    pixelshuffle convs permuted, as ``ps_conv_from_jax`` does),
    ``DeResnetSRN``, ``FSDiscriminator`` and its bodies ``DiscriminatorBasic``
    and ``NLayerDiscriminator``, ``DiscriminatorVGG``,
    ``make_vgg_discriminator``'s stacks and ``ACDVGGBN96`` (their BatchNorm
    statistics; the first linear's input features permuted from flax's
    NHWC flatten to the reference's NCHW one), ``DiscriminatorVGG128SN``
    (each layer's ``u`` and ``sigma``), ``VGG19Feature54``, the
    ``misc_nets`` zoo (``ResnetGenerator``'s transposed convs flipped),
    ``LPIPS`` of every net (its backbone and its heads, flax's (C, 1)) and
    ``Dist2LogitLayer``. The older networks keep their own carry-overs
    (``rrdbnet_state_dict_from_jax`` and the rest, ROADMAP A.13); any other
    network raises."""
    from dasr_tpu_torch.nn import misc_nets
    from dasr_tpu_torch.nn.discriminators import (
        DiscriminatorBasic,
        DiscriminatorVGG,
        DiscriminatorVGG128SN,
        DiscriminatorVGGStack,
        FSDiscriminator,
        NLayerDiscriminator,
    )
    from dasr_tpu_torch.nn.blocks import ResNetBlock
    from dasr_tpu_torch.nn.generators import DeResnetSRN, SRResNet
    from dasr_tpu_torch.nn.sft import ACDVGGBN96, SFTNet
    from dasr_tpu_torch.losses.lpips import LPIPS
    from dasr_tpu_torch.losses.lpips_train import Dist2LogitLayer
    from dasr_tpu_torch.nn.vgg import _SQUEEZE_FIRES, SqueezeNetFeatures, VGG19Feature54

    p = variables_np.get("params", variables_np)
    st = variables_np.get("batch_stats", {})

    def _get(tree, path):
        for k in path.split("/"):
            tree = tree.get(k, {})
        return tree

    if isinstance(net, SRResNet):
        n_res = sum(isinstance(m, ResNetBlock) for m in net.model[1].sub)
        ups = sorted(k for k in p if k.startswith("pixelshuffle_block_"))
        names = ([f"conv_block_{i}" for i in range(2 * n_res + 2)]
                 + [f"{u}/conv_block_0" for u in ups]
                 + [f"conv_block_{2 * n_res + 2}", f"conv_block_{2 * n_res + 3}"])
        ps = {2 * n_res + 2 + i for i in range(len(ups))}
        nodes = [_get(p, n) for n in names]
        return _zip_into(net, *_conv_block_nodes(nodes, [_get(st, n) for n in names], ps))
    if isinstance(net, ResNetBlock):
        names = ["conv_block_0", "conv_block_1"]
        nodes = [_get(p, n) for n in names]
        return _zip_into(net, *_conv_block_nodes(nodes, [_get(st, n) for n in names]))
    if isinstance(net, DeResnetSRN):
        n_res = len(_indexed(p, "ResNetBlock_"))
        names = ["conv_block_0"]
        for i in range(n_res):
            names += [f"ResNetBlock_{i}/conv_block_0", f"ResNetBlock_{i}/conv_block_1"]
        names += [f"conv_block_{i}" for i in range(1, len(_indexed(p, "conv_block_")))]
        nodes = [_get(p, n) for n in names]
        return _zip_into(net, *_conv_block_nodes(nodes, [_get(st, n) for n in names]))
    if isinstance(net, DiscriminatorVGG):
        convs = [(n, False) for n in _indexed(p, "Conv_")]
        bns = list(zip(_indexed(p, "BatchNorm_"), _indexed(st, "BatchNorm_")))
        c = net.linear1.in_features
        ch = convs[-1][0]["kernel"].shape[-1]
        hw = int(round(math.sqrt(c // ch)))
        return _zip_into(net, convs, bns,
                         linears=[(p["Dense_0"], (ch, hw, hw)), (p["Dense_1"], None)])
    if isinstance(net, DiscriminatorVGGStack):
        names = [f"conv_block_{i}" for i in range(len(_indexed(p, "conv_block_")))]
        nodes = [_get(p, n) for n in names]
        convs, bns, prelus = _conv_block_nodes(nodes, [_get(st, n) for n in names])
        linears = []
        if net.classifier is not None:
            ch = convs[-1][0]["kernel"].shape[-1]
            hw = int(round(math.sqrt(net.classifier[0].in_features // ch)))
            linears = [(p["Dense_0"], (ch, hw, hw)), (p["Dense_1"], None)]
        return _zip_into(net, convs, bns, prelus, linears)
    if isinstance(net, DiscriminatorVGG128SN):
        n_conv = len(net._CHANS)
        sn = [_indexed(st, "SpectralNorm_")[i] for i in range(n_conv + 2)]
        layer = [f"conv{i}" for i in range(n_conv)] + ["linear0", "linear1"]
        sns = [(s[f"{n}/kernel/u"], s[f"{n}/kernel/sigma"]) for s, n in zip(sn, layer)]
        return _zip_into(net, [(p[n], False) for n in layer[:n_conv]],
                         linears=[(p["linear0"], (512, 4, 4)), (p["linear1"], None)], sns=sns)
    if isinstance(net, VGG19Feature54):
        return _zip_into(net, [(n, False) for n in _indexed(p["stack"], "conv")])
    if isinstance(net, LPIPS):
        bb = p["backbone"]
        if isinstance(net.backbone, SqueezeNetFeatures):
            nodes = [bb["conv0"]] + [bb[f"fire{i}"][part] for i in _SQUEEZE_FIRES
                                     for part in ("squeeze", "expand1x1", "expand3x3")]
        else:
            nodes = _indexed(bb["stack"], "conv")
        sd = {f"backbone.{k}": v
              for k, v in _zip_into(net.backbone, [(n, False) for n in nodes]).items()}
        for name, _ in net.named_parameters(recurse=False):
            sd[name] = _vec_t(p[name])
        return sd
    if isinstance(net, Dist2LogitLayer):
        return _zip_into(net, [(n, False) for n in _indexed(p, "Conv_")])
    convs = [(n, False) for n in _indexed(p, "Conv_")]
    bns = list(zip(_indexed(p, "BatchNorm_"), _indexed(st, "BatchNorm_")))
    if isinstance(net, FSDiscriminator):
        body = ("DiscriminatorBasic_0" if isinstance(net.net, DiscriminatorBasic)
                else "NLayerDiscriminator_0")
        sd = state_dict_from_jax(net.net, {"params": p[body], "batch_stats": st.get(body, {})})
        return {f"net.{k}": v for k, v in sd.items()}
    if isinstance(net, (DiscriminatorBasic, NLayerDiscriminator, misc_nets.ResNet101Features,
                        misc_nets.EDSRResBlock, misc_nets.ResidualBlockNoBN, misc_nets.MINCNet)):
        return _zip_into(net, convs, bns)
    if isinstance(net, misc_nets.Upsampler):
        r = next(m.upscale_factor for m in net if isinstance(m, torch.nn.PixelShuffle))
        return _zip_into(net, [(n, r) for n, _ in convs])
    if isinstance(net, misc_nets.ResnetGenerator):
        ups = [(n, False) for n in _indexed(p, "ConvTranspose_")]
        return _zip_into(net, convs[:-1] + ups + convs[-1:])
    if isinstance(net, ACDVGGBN96):
        ch = convs[-1][0]["kernel"].shape[-1]
        hw = int(round(math.sqrt(net.gan[0].in_features // ch)))
        # flax names each head's outer Dense first: Dense_0 / Dense_2 are the
        # gan / cls outputs, Dense_1 / Dense_3 their hidden layers
        return _zip_into(net, convs, bns, linears=[
            (p["Dense_1"], (ch, hw, hw)), (p["Dense_0"], None),
            (p["Dense_3"], (ch, hw, hw)), (p["Dense_2"], None)])
    if isinstance(net, SFTNet):
        def sft(node):
            return [(node[k], False) for k in ("scale_conv0", "scale_conv1", "shift_conv0",
                                               "shift_conv1")]

        nodes = [(p["conv0"], False)]
        for i in range(len(net.sft_branch) - 2):
            b = p[f"block{i}"]
            nodes += sft(b["sft0"]) + [(b["conv0"], False)] + sft(b["sft1"]) + [(b["conv1"], False)]
        nodes += sft(p["sft_tail"]) + [(p["conv_tail"], False), (p["up0"], True), (p["up1"], True),
                                       (p["hr_conv"], False), (p["out_conv"], False)]
        return _zip_into(net, nodes + [(p[f"cond{i}"], False) for i in range(5)])
    raise NotImplementedError(f"no carry-over from JAX for [{type(net).__name__}]")


def _nets(state):
    """(label, NetState) of every network of a train state: G, D_target,
    D_source, and the Adaptive trainer's patch D."""
    return [(label, net) for label, net in (("G", state.g), ("D_target", state.d_target),
                                            ("D_source", state.d_source),
                                            ("patchD", getattr(state, "patchd", None)))
            if net is not None]


def save_train_state(ckpt_dir: str, state, iter_step: int) -> str:
    """The whole train state (every network's weights, Adam and scheduler
    state, the step) as one torch file ``{ckpt_dir}/{iter_step}.pt``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{iter_step}.pt")
    torch.save({
        "step": state.step,
        **{label: {"net": ns.net.state_dict(), "opt": ns.opt.state_dict(),
                   "sched": ns.sched.state_dict()} for label, ns in _nets(state)},
    }, path)
    return path


def latest_train_state(ckpt_dir: str) -> Optional[str]:
    """The ``{iter}.pt`` with the largest ``iter`` in ``ckpt_dir``, if any."""
    found = [(int(os.path.basename(p)[:-3]), p)
             for p in glob.glob(os.path.join(ckpt_dir, "*.pt"))
             if os.path.basename(p)[:-3].isdigit()]
    return max(found)[1] if found else None


def load_train_state(path: str, state) -> int:
    """Load a ``save_train_state`` file into ``state`` in place (each
    network's weights, Adam and scheduler state, the step); returns the
    step. A directory means its latest ``{iter}.pt``."""
    if os.path.isdir(path):
        found = latest_train_state(path)
        if found is None:
            raise FileNotFoundError(f"{path} holds no train state ({{iter}}.pt)")
        path = found
    saved = torch.load(path, map_location="cpu", weights_only=True)
    for label, ns in _nets(state):
        ns.net.load_state_dict(saved[label]["net"])
        ns.opt.load_state_dict(saved[label]["opt"])
        ns.sched.load_state_dict(saved[label]["sched"])
        set_schedule_count(ns, ns.sched.last_epoch)
    state.step = int(saved["step"])
    return state.step


def set_schedule_count(ns, count: int) -> None:
    """Put a network's LR schedule at ``count`` updates. A saved LR is the
    old run's schedule at that count; this run's schedule (a LambdaLR of the
    count, as optax's) sets the next one."""
    ns.sched.last_epoch = count
    ns.set_lr(ns.sched.base_lrs[0] * ns.sched.lr_lambdas[0](count))


def load_reference_training_state(path: str) -> Dict[str, Any]:
    """A reference ``{iter}.state`` pickle (base_model.py:65-74): ``epoch``,
    ``iter``, ``schedulers`` and ``optimizers``. Not ``weights_only``: the
    reference's MultiStepLR state holds its milestones as a ``Counter``."""
    return torch.load(path, map_location="cpu", weights_only=False)


def import_adam_state(ns, adam_sd: Dict[str, Any]) -> int:
    """Write a torch Adam state dict's moments into ``ns.opt`` by parameter
    index and put the network's Adam count and LR schedule at the largest
    ``step`` in it; returns that count (the counterpart of
    ``dasr_tpu.train.checkpoints.import_adam_state``).

    The port's modules register their parameters in the reference's order,
    so index i of the state dict is ``ns.params()[i]``; each moment's shape
    is checked against its parameter's. As in JAX, the moments and the
    count are taken and the saved ``param_groups`` are not: a JAX-written
    ``.state`` carries lr 1e-4 and the default betas whatever the run used,
    so the config's lr and betas stay. JAX keeps one count a network; here
    every parameter's ``step`` is set to it (a parameter the state dict
    lacks starts from zero moments at that count, as in JAX). ``step`` is a
    tensor, on the parameter's device where the Adam is ``capturable`` or
    ``fused``."""
    params = ns.params()
    state = adam_sd["state"]
    saved = {}
    for key, st in state.items():
        idx = int(key)
        if not 0 <= idx < len(params):
            raise ValueError(f"Adam state index {idx} is past the network's {len(params)} "
                             f"parameters")
        for name in ("exp_avg", "exp_avg_sq"):
            shape = tuple(torch.as_tensor(st[name]).shape)
            if shape != tuple(params[idx].shape):
                raise ValueError(f"Adam state {idx} {name}: shape {shape}, parameter "
                                 f"{tuple(params[idx].shape)}")
        saved[idx] = st
    count = max((int(st["step"]) for st in saved.values()), default=0)
    group = ns.opt.param_groups[0]
    on_device = group.get("capturable") or group.get("fused")
    ns.opt.state.clear()
    for idx, p in enumerate(params):
        moments = [torch.zeros_like(p, memory_format=torch.preserve_format) for _ in range(2)]
        if idx in saved:
            for m, name in zip(moments, ("exp_avg", "exp_avg_sq")):
                m.copy_(torch.as_tensor(saved[idx][name]))
        ns.opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32,
                                 device=p.device if on_device else "cpu"),
            "exp_avg": moments[0], "exp_avg_sq": moments[1],
        }
    set_schedule_count(ns, count)
    return count


def save_dsn_tar(path: str, g: torch.nn.Module, d: torch.nn.Module, epoch: int = 0,
                 iteration: int = 0, fs_type: str = "avg_pool", fs_kernel_size: int = 5,
                 d_type: str = "FSD") -> str:
    """A DSN-format ``.tar`` (codes/DSN/train.py:361-373 key schema,
    including the ``models_d_state_dict`` [sic] key), which the reference's
    create_dataset_modified.py and both packages' dsn_create_dataset read."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({
        "epoch": epoch, "iteration": iteration, "fs_type": fs_type,
        "fs_kernel_size": fs_kernel_size, "D_type": d_type,
        "model_g_state_dict": {k: v.detach().cpu() for k, v in g.state_dict().items()},
        "models_d_state_dict": {k: v.detach().cpu() for k, v in d.state_dict().items()},
    }, path)
    return path


def load_dsn_tar(path: str) -> Dict[str, Any]:
    """A DSN ``.tar`` checkpoint's dict, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_patchd_tar(patchd: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a DSN ``.tar``'s discriminator (``models_d_state_dict``, or the
    whole dict) into an FSD ``FSDiscriminator``, strict: the ``.tar`` of
    either package's ``save_dsn_tar`` (the counterpart of
    ``dasr_tpu.train.checkpoints.import_fsd_discriminator_params``)."""
    ckpt = load_dsn_tar(path)
    patchd.load_state_dict(ckpt.get("models_d_state_dict", ckpt), strict=True)
    return patchd


def save_reference_formats(out_dir: str, state, iter_step: int) -> str:
    """Reference-layout ``{iter}_G.pth``, ``{iter}_D_target.pth`` (and
    ``_D_source``) and ``{iter}.state`` (base_model.py:50-86). The modules
    register their parameters in the reference's order, so torch's Adam
    state dicts are already the reference's."""
    os.makedirs(out_dir, exist_ok=True)
    for label, ns in _nets(state):
        torch.save(ns.net.state_dict(), os.path.join(out_dir, f"{iter_step}_{label}.pth"))
    torch.save({
        "epoch": 0, "iter": iter_step,
        "schedulers": [ns.sched.state_dict() for _, ns in _nets(state)],
        "optimizers": [ns.opt.state_dict() for _, ns in _nets(state)],
    }, os.path.join(out_dir, f"{iter_step}.state"))
    return out_dir
