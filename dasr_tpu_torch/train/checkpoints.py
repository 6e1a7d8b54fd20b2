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
state dicts). ``load_train_state`` resumes the DSN stage from the port's
own saves; resuming the SRN stage waits for ROADMAP A.5. The DSN stage's
reference checkpoint is one ``.tar`` (``save_dsn_tar`` / ``load_dsn_tar``,
the key schema of codes/DSN/train.py:361-373), which the JAX package writes
too.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Optional

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


def _conv_t(kernel) -> torch.Tensor:
    """A flax HWIO kernel as a writable f32 OIHW tensor."""
    return torch.from_numpy(np.array(_j2t_conv(np.asarray(kernel, np.float32))))


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


def fsd_state_dict_from_jax(variables_np: Dict[str, Any], d_arch: str = "FSD",
                            norm_layer: str = "Instance") -> Dict[str, torch.Tensor]:
    """JAX ``FSDiscriminator`` variables -> the port's state dict: the FSD
    body's convs at ``net.net.{0,2,5,8}`` (BatchNorm at 3 and 6, with its
    running statistics), or an NLayer body at ``net.model.*`` (the port's
    side of ``export_fsd_state_dict``)."""
    params = variables_np["params"]
    if d_arch.lower() != "fsd":
        sd = nlayer_d_state_dict_from_jax(params["NLayerDiscriminator_0"], n_layers=2)
        return {f"net.{k}": v for k, v in sd.items()}
    body = params["DiscriminatorBasic_0"]
    sd: Dict[str, torch.Tensor] = {}
    for j, i in enumerate((0, 2, 5, 8)):
        node = body[f"Conv_{j}"]
        sd[f"net.net.{i}.weight"] = _conv_t(node["kernel"])
        sd[f"net.net.{i}.bias"] = torch.from_numpy(np.array(node["bias"], np.float32))
    if norm_layer.lower() == "batch":
        stats = variables_np["batch_stats"]["DiscriminatorBasic_0"]
        for j, i in enumerate((3, 6)):
            bn, st = body[f"BatchNorm_{j}"], stats[f"BatchNorm_{j}"]
            for name, v in (("weight", bn["scale"]), ("bias", bn["bias"]),
                            ("running_mean", st["mean"]), ("running_var", st["var"])):
                sd[f"net.net.{i}.{name}"] = torch.from_numpy(np.array(v, np.float32))
            sd[f"net.net.{i}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
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
        # the saved LR is the old run's schedule at this count; this run's
        # schedule (a LambdaLR of the count, as optax's) sets the next one
        for group, base, factor in zip(ns.opt.param_groups, ns.sched.base_lrs,
                                       ns.sched.lr_lambdas):
            group["lr"] = base * factor(ns.sched.last_epoch)
    state.step = int(saved["step"])
    return state.step


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
