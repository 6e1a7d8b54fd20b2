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
state dicts). Resuming from either waits for ROADMAP A.5.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch


def _j2t_conv(w: np.ndarray) -> np.ndarray:
    """flax HWIO conv kernel -> torch OIHW."""
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


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


def rrdbnet_state_dict_from_jax(params_np: Dict[str, Any], nb: int) -> Dict[str, torch.Tensor]:
    """JAX ``RRDBNet`` parameters (nested dicts of arrays, with or without the
    top ``params`` level) -> reference-named f32 state dict."""
    params = params_np.get("params", params_np)

    def node(path):
        n = params
        for p in path:
            n = n[p]
        return n

    def t(v):
        return torch.from_numpy(np.array(v, dtype=np.float32))

    sd: Dict[str, torch.Tensor] = {}
    for tkey, fpath, kind in rrdbnet_key_map(nb):
        if kind == "rdbconv":
            n = node(fpath[:-1])
            kernel, bias = n[fpath[-1] + "_kernel"], n[fpath[-1] + "_bias"]
        else:
            n = node(fpath)
            kernel, bias = n["kernel"], n["bias"]
        sd[tkey + ".weight"] = t(_j2t_conv(np.asarray(kernel)))
        sd[tkey + ".bias"] = t(bias)
    return sd


def nlayer_d_key_map(n_layers: int = 3):
    """SRN NLayerDiscriminator (architecture.py:983-1024): sequential
    ``model.{idx}`` convs at 0, 2+3n (n=1..n_layers-1), 2+3(n_layers-1)+3
    stride-1, then the 1-channel head; InstanceNorm carries no params."""
    idxs = [0] + [2 + 3 * (n - 1) for n in range(1, n_layers)]
    idxs.append(2 + 3 * (n_layers - 1))
    idxs.append(idxs[-1] + 3)
    return [(f"model.{t}", (f"Conv_{j}",), "conv") for j, t in enumerate(idxs)]


def nlayer_d_state_dict_from_jax(params_np: Dict[str, Any], n_layers: int) -> Dict[str, torch.Tensor]:
    """JAX ``NLayerDiscriminator`` parameters -> reference-named state dict
    (bias-free convs stay bias-free)."""
    params = params_np.get("params", params_np)
    sd: Dict[str, torch.Tensor] = {}
    for tkey, (name,), _ in nlayer_d_key_map(n_layers):
        node = params[name]
        sd[tkey + ".weight"] = torch.from_numpy(_j2t_conv(np.asarray(node["kernel"], np.float32)))
        if "bias" in node:
            sd[tkey + ".bias"] = torch.from_numpy(np.array(node["bias"], dtype=np.float32))
    return sd


def lpips_state_dict_from_jax(variables_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``LPIPS(net='alex')`` variables -> the port's ``LPIPS`` state
    dict: the backbone convs and the five heads."""
    params = variables_np.get("params", variables_np)
    stack = params["backbone"]["stack"]
    sd: Dict[str, torch.Tensor] = {}
    for i in range(5):
        node = stack[f"conv{i}"]
        sd[f"backbone.stack.conv{i}.weight"] = torch.from_numpy(
            _j2t_conv(np.asarray(node["kernel"], np.float32)))
        sd[f"backbone.stack.conv{i}.bias"] = torch.from_numpy(np.array(node["bias"], np.float32))
        sd[f"lin{i}"] = torch.from_numpy(np.array(params[f"lin{i}"], np.float32)[:, 0])
    return sd


def _nets(state):
    return [(label, net) for label, net in (("G", state.g), ("D_target", state.d_target),
                                            ("D_source", state.d_source)) if net is not None]


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
