"""Reference-format checkpoints for the port.

The port's modules carry the reference's parameter names, so a reference
``*_G.pth`` (codes/SRN/models/base_model.py:50-74 layout) loads with plain
``load_state_dict``. ``rrdbnet_state_dict_from_jax`` turns a JAX
``RRDBNet`` parameter tree into such a state dict, through the key map of
``dasr_tpu.train.checkpoints`` (copied here, since the port does not import
the JAX package).
"""

from __future__ import annotations

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


def load_rrdbnet_pth(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a reference-named ``*_G.pth`` into ``model`` (strict)."""
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
