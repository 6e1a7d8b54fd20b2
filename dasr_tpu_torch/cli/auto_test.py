"""Checkpoint-sweep tester of the port — ``python -m
dasr_tpu_torch.cli.auto_test -opt <test JSON> --models_dir <dir>
[--device cuda]`` (the port of ``dasr_tpu.cli.auto_test``, reference:
codes/SRN/auto_test.py:10-33).

For every ``{iter}_G.pth`` in ``--models_dir`` (the files ``srn_train``
saves with ``save_ref_formats``), or the iterations of ``--iters``, the
test options are rewritten with ``pretrain_model_G`` set to that file and
the name ``{name}_{iter}``, and the port's ``srn_test`` runs them. The JAX
CLI also sweeps orbax step directories; they are JAX-only, and the port
names and skips them. Returns ``{iter: srn_test's per-set averages}``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-opt", required=True, help="test options JSON template")
    p.add_argument("--models_dir", required=True, help="directory with {iter}_G.pth files")
    p.add_argument("--iters", type=str, default=None,
                   help="comma-separated iteration list (default: all found)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run srn_test on the GPU or on the CPU (plain PyTorch)")
    args = p.parse_args(argv)

    from dasr_tpu_torch.cli import srn_test

    with open(args.opt) as f:
        template = json.load(f)
    if args.iters:
        candidates = [it.strip() for it in args.iters.split(",")]
    else:
        candidates = sorted({e.split("_")[0] for e in os.listdir(args.models_dir)
                             if e.endswith("_G.pth") or e.isdigit()},
                            key=lambda s: int(s) if s.isdigit() else 0)
    if not candidates:
        raise SystemExit(f"no checkpoints found under {args.models_dir}")

    base_name = template.get("name", "auto_test")
    averages = {}
    with tempfile.TemporaryDirectory() as tmp:
        for it in candidates:
            pth = os.path.join(args.models_dir, f"{it}_G.pth")
            if not os.path.exists(pth):
                print(f"===== checkpoint {it}: no {it}_G.pth in {args.models_dir}; orbax step "
                      f"directories are JAX-only, skipped =====", flush=True)
                continue
            cfg = json.loads(json.dumps(template))
            cfg["name"] = f"{base_name}_{it}"
            cfg.setdefault("path", {})["pretrain_model_G"] = pth
            path = os.path.join(tmp, f"{it}.json")
            with open(path, "w") as f:
                json.dump(cfg, f)
            print(f"===== testing checkpoint {it} =====", flush=True)
            averages[it] = srn_test.main(["-opt", path, "--device", args.device])
    return averages


if __name__ == "__main__":
    main()
