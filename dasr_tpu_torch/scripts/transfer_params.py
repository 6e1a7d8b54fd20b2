"""Generator weight surgery, the port of ``dasr_tpu.scripts.transfer_params``
on torch state dicts:

    python -m dasr_tpu_torch.scripts.transfer_params --src x2_G.pth --out x4_G.pth
    python -m dasr_tpu_torch.scripts.transfer_params --sft --src SRGAN.pth --out sft_init.pth

Two modes, mirroring the two reference scripts:

  * default — x2 -> x4 RRDB transfer (codes/SRN/scripts/transfer_params.py):
    copy every tensor that exists with a matching shape in a source
    generator (a reference ``*_G.pth`` or the port's ``{iter}.pt``) into a
    freshly initialised target ``RRDBNet`` (seeded); the extra upsampler
    stage keeps its init. The upsampler and HR convs are matched by their
    role (upconv i, HR_conv0, HR_conv1), whose reference index moves with
    the scale, as the JAX package matches them by its module paths. The
    output is a reference-format ``.pth``.
  * ``--sft`` — SRResNet/SRGAN -> SFT-net initialization
    (codes/SRN/scripts/transfer_params_sft.py): re-init an SFT net with
    kaiming-normal*0.1 weights / zero biases, then graft the pretrained
    torso — conv0, the 16 residual blocks' convs into
    ``sft_branch.{i}.conv{0,1}``, the trunk conv into
    ``sft_branch.{nb+1}``, and the HR branch (``model.{2,5,8,10}`` ->
    ``HR_branch.{0,3,6,8}``). The SFT layers and CondNet keep their fresh
    init, drawn from numpy as the JAX package draws it, so a seed gives
    the same file. The output is a ``.pth`` that ``sftgan_test`` loads.
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np


def transfer(src_sd: Dict[str, np.ndarray], dst_sd: Dict[str, np.ndarray]
             ) -> Tuple[Dict[str, np.ndarray], int]:
    """``dst_sd`` with every tensor of ``src_sd`` of the same key and shape
    copied in; returns it and the number copied."""
    out, copied = {}, 0
    for k, leaf in dst_sd.items():
        s = src_sd.get(k)
        if s is not None and np.shape(s) == np.shape(leaf):
            out[k], copied = np.asarray(s), copied + 1
        else:
            out[k] = np.asarray(leaf)
    return out, copied


def rrdb_roles(sd: Dict[str, np.ndarray]) -> Dict[str, str]:
    """Reference RRDBNet key -> its role key: the tail's convs
    (``model.{i}`` past the trunk ``model.1``) named ``upconv{j}``,
    ``HRconv0`` and ``HRconv1``; the others keep their key."""
    tail = sorted({int(k.split(".")[1]) for k in sd if k.startswith("model.")} - {0, 1})
    names = {t: f"upconv{j}" for j, t in enumerate(tail[:-2])}
    names.update({tail[-2]: "HRconv0", tail[-1]: "HRconv1"})
    roles = {}
    for k in sd:
        parts = k.split(".")
        if parts[0] == "model" and int(parts[1]) in names:
            roles[k] = ".".join(["model", names[int(parts[1])]] + parts[2:])
        else:
            roles[k] = k
    return roles


def transfer_rrdb(src_sd, dst_sd):
    """``transfer`` between two reference RRDBNet state dicts, matched by
    role: an x2 source fills an x4 target's trunk, first upconv and HR
    convs; its second upconv keeps the target's init."""
    src_roles, dst_roles = rrdb_roles(src_sd), rrdb_roles(dst_sd)
    merged, copied = transfer({src_roles[k]: v for k, v in src_sd.items()},
                              {dst_roles[k]: v for k, v in dst_sd.items()})
    back = {r: k for k, r in dst_roles.items()}
    return {back[r]: v for r, v in merged.items()}, copied


def _kaiming_reinit(sd, rng):
    """Reference raw-net init (transfer_params_sft.py:8-15): weights
    kaiming_normal(a=0, fan_in)*0.1, biases zero. OIHW fan_in = I*kh*kw."""
    out = {}
    for k, v in sd.items():
        a = np.asarray(v)
        if k.endswith(".weight") and a.ndim == 4:
            fan_in = a.shape[1] * a.shape[2] * a.shape[3]
            std = float(np.sqrt(2.0 / fan_in)) * 0.1
            out[k] = rng.standard_normal(a.shape).astype(np.float32) * std
        else:
            out[k] = np.zeros_like(a, dtype=np.float32)
    return out


def sft_surgery(src_sd, n_blocks: int = 16, seed: int = 0):
    """Build an SFT-net torch state dict initialized from a pretrained
    SRResNet/SRGAN ``model.*`` state dict (transfer_params_sft.py:17-37)."""
    from dasr_tpu_torch.nn.sft import SFTNet

    raw = _kaiming_reinit({k: v.numpy() for k, v in SFTNet(n_blocks=n_blocks).state_dict().items()},
                          np.random.default_rng(seed))

    copy = {"conv0": "model.0"}
    for i in range(n_blocks):
        copy[f"sft_branch.{i}.conv0"] = f"model.1.sub.{i}.res.0"
        copy[f"sft_branch.{i}.conv1"] = f"model.1.sub.{i}.res.2"
    copy[f"sft_branch.{n_blocks + 1}"] = f"model.1.sub.{n_blocks}"
    for dst, src in zip((0, 3, 6, 8), (2, 5, 8, 10)):
        copy[f"HR_branch.{dst}"] = f"model.{src}"
    for dst, src in copy.items():
        for suffix in (".weight", ".bias"):
            raw[dst + suffix] = np.asarray(src_sd[src + suffix], dtype=np.float32)
    return raw


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--src", required=True, help="source (*_G.pth or the port's {iter}.pt)")
    p.add_argument("--out", required=True, help="output .pth (reference format)")
    p.add_argument("--sft", action="store_true",
                   help="SRResNet/SRGAN .pth -> SFT-net init .pth")
    p.add_argument("--dst_nf", type=int, default=64)
    p.add_argument("--dst_nb", type=int, default=23)
    p.add_argument("--dst_gc", type=int, default=32)
    p.add_argument("--dst_scale", type=int, default=4)
    p.add_argument("--sft_nb", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    from dasr_tpu_torch.scripts.net_interp import load_g_state_dict

    def save(sd):
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                   args.out)

    if args.sft:
        out_sd = sft_surgery(load_g_state_dict(args.src), n_blocks=args.sft_nb, seed=args.seed)
        save(out_sd)
        print(f"SFT init written -> {args.out}")
        return out_sd

    from dasr_tpu_torch.nn.generators import RRDBNet

    dst = RRDBNet(nf=args.dst_nf, nb=args.dst_nb, gc=args.dst_gc, upscale=args.dst_scale)
    dst.init_weights(torch.Generator().manual_seed(args.seed))
    merged, copied = transfer_rrdb(load_g_state_dict(args.src),
                                   {k: v.numpy() for k, v in dst.state_dict().items()})
    save(merged)
    print(f"copied {copied} matching tensors -> {args.out}")
    return merged, copied


if __name__ == "__main__":
    main()
