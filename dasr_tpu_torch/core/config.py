"""SRN commented-JSON options (reference: codes/SRN/options/options.py:8-104)
and the ``paths.yml`` dataset registry.

Framework-free host code, copied from ``dasr_tpu.core.config`` so that the
port never imports the JAX package: comment stripping, phase/scale
injection, experiment-dir derivation, missing keys read as ``None``
(``NoneDict``), the legacy model-name normalisation, ``check_resume``, and
the registry's ``[dataset][artifact][source|target|valid_hr|valid_lr]``
lookup.
"""

from __future__ import annotations

import json
import os
import re
from collections import OrderedDict
from typing import Any


class NoneDict(dict):
    """dict whose missing keys read as None (reference: options.py:76-83)."""

    def __missing__(self, key):
        return None

    def __getattr__(self, key):
        if key.startswith("__"):
            raise AttributeError(key)
        return self[key]


def dict_to_nonedict(opt: Any) -> Any:
    if isinstance(opt, dict):
        return NoneDict({k: dict_to_nonedict(v) for k, v in opt.items()})
    if isinstance(opt, (list, tuple)):
        return [dict_to_nonedict(v) for v in opt]
    return opt


_MODEL_ALIASES = {
    # Auto_Reproduce writes this legacy name; the reference would crash on it.
    "dasr_fs_esrgan_patchgan": "DASR",
    "degrationmodel": "De_Resnet",
    "degradationmodel": "De_Resnet",
}


def normalize_model_name(name: str) -> str:
    if name is None:
        return name
    low = name.lower()
    if low in _MODEL_ALIASES:
        return _MODEL_ALIASES[low]
    if low.startswith("dasr_adaptive"):
        return "DASR_Adaptive_Model"
    if low.startswith("dasr"):
        return "DASR"
    return name


def _strip_json_comments(text: str) -> str:
    # Remove // comments outside string literals (reference JSONs use them
    # only at line level, so a line-based strip is faithful).
    out = []
    for line in text.splitlines():
        in_str = False
        for i, ch in enumerate(line):
            if ch == '"' and (i == 0 or line[i - 1] != "\\"):
                in_str = not in_str
            if not in_str and ch == "/" and line[i : i + 2] == "//":
                line = line[:i]
                break
        out.append(line)
    return "\n".join(out)


def parse_srn_options(json_path: str, is_train: bool = True) -> NoneDict:
    """Load an SRN options JSON (reference: codes/SRN/options/options.py:8-73)."""
    with open(json_path) as f:
        opt = json.loads(_strip_json_comments(f.read()), object_pairs_hook=OrderedDict)

    opt["is_train"] = is_train
    opt["model"] = normalize_model_name(opt.get("model"))
    scale = opt.get("scale", 4)

    for phase, dataset in (opt.get("datasets") or {}).items():
        dataset["phase"] = phase.split("_")[0]
        dataset["scale"] = scale
        if dataset.get("dataroot_HR") is not None:
            dataset["dataroot_HR"] = os.path.expanduser(dataset["dataroot_HR"])
            if dataset["dataroot_HR"].endswith("lmdb"):
                dataset["data_type"] = "lmdb"
            else:
                dataset.setdefault("data_type", "img")
        if dataset.get("dataroot_LR") is not None:
            dataset["dataroot_LR"] = os.path.expanduser(dataset["dataroot_LR"])

    path = opt.setdefault("path", {})
    path["root"] = os.path.expanduser(path.get("root", "."))
    if is_train:
        experiments_root = os.path.join(path["root"], opt["name"])
        path["experiments_root"] = experiments_root
        path["models"] = os.path.join(experiments_root, "models")
        path["training_state"] = os.path.join(experiments_root, "training_state")
        path["log"] = experiments_root
        path["val_images"] = os.path.join(experiments_root, "val_images")
        if "debug" in opt["name"]:
            # debug overrides (reference: options.py:55-59)
            opt.setdefault("train", {})["val_freq"] = 8
            opt.setdefault("logger", {})["print_freq"] = 2
            opt.setdefault("logger", {})["save_checkpoint_freq"] = 8
    else:
        results_root = os.path.join(path["root"], "results", opt["name"])
        path["results_root"] = results_root
        path["log"] = results_root

    return dict_to_nonedict(opt)


def check_resume(opt: NoneDict) -> NoneDict:
    """Point the pretrain paths at a reference ``{iter}.state``'s networks
    (reference: options.py:107-122): ``{models}/{iter}_G.pth``, and
    ``_D_target.pth`` / ``_D_source.pth`` for the discriminators the DASR
    trainer builds (``gan_H_target`` / ``gan_H_source`` > 0).

    Two deviations from ``dasr_tpu.core.config.check_resume``:

    * (ROADMAP C.2) it applies only when ``resume_state`` ends in
      ``.state``. The JAX function rewires every resume path, so a
      directory resume there points ``pretrain_model_G`` at
      ``{models}/0_G.pth``; the port's own ``{iter}.pt`` resume carries its
      networks and is left as it is.
    * an absent ``gan_H_target`` reads as the trainer's default, 0.005, as
      ``models/registry.py:srn_config`` reads it. The JAX function reads it
      as 0, so there a config without the key trains a D_target that a
      resume leaves at its fresh init."""
    state_path = opt["path"]["resume_state"]
    if not (state_path or "").endswith(".state"):
        return opt
    m = re.search(r"(\d+)\.state$", os.path.basename(state_path))
    it = int(m.group(1)) if m else 0
    models = opt["path"]["models"]
    train = opt.get("train") or {}
    opt["path"]["pretrain_model_G"] = os.path.join(models, f"{it}_G.pth")
    for key, label, default in (("gan_H_target", "D_target", 0.005),
                                ("gan_H_source", "D_source", 0.0)):
        if train.get(key, default):
            opt["path"][f"pretrain_model_{label}"] = os.path.join(models, f"{it}_{label}.pth")
    return opt


def load_paths_yml(path: str) -> NoneDict:
    import yaml

    with open(path) as f:
        return dict_to_nonedict(yaml.safe_load(f))


def dataset_paths(paths_yml: str, dataset: str, artifact: str) -> NoneDict:
    reg = load_paths_yml(paths_yml)
    if dataset not in reg or artifact not in reg[dataset]:
        raise KeyError(f"paths.yml has no entry [{dataset}][{artifact}]")
    return reg[dataset][artifact]


def dict2str(opt: dict, indent_l: int = 1) -> str:
    """Pretty printing (reference: options.py:94-104)."""
    msg = ""
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_l * 2) + k + ":[\n"
            msg += dict2str(v, indent_l + 1)
            msg += " " * (indent_l * 2) + "]\n"
        else:
            msg += " " * (indent_l * 2) + k + ": " + str(v) + "\n"
    return msg
