"""Readings that set a cell's limits: its comparison numbers for sound runs,
for the control (the reference computed in float8 in the program's place)
and for planted faults, seed by seed, several runs in one process.

    python -m port_bench.controls --workload <cell> --seeds 11,12,13 \
        [--arms sound,control,half_batch] [--seconds 1]

Each reading is a whole run of the cell at its own size (set-up, a short
window, the comparison); one JSON line a reading. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from port_bench import run as run_mod


def reading(root, cell: str, seed: int, seconds: float, device, arm: str = "sound") -> dict:
    """One run of ``cell`` under ``arm``: 'sound'; 'control' (the reference
    in float8 in the program's place); or a fault of ``faults.FAULTS``. Its
    numbers, whether they are within the limits, and what the comparison
    looked at."""
    import torch

    from port_bench import harness

    options = {"control": "fp8"} if arm == "control" else {"fault": arm} if arm != "sound" else {}
    run = harness.Run(harness.Bench(root), cell, seed, seconds, False, device, **options)
    out = run_mod.execute(run, time.time())
    look = run.record.get("look")
    del run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"cell": cell, "seed": seed, "arm": arm, "correct": out["correct"],
            "numbers": {k: v["value"] for k, v in out["checks"].items()},
            "look": look}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--arms", default="sound,control")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    run_mod.caches(run_mod.ROOT)
    from dasr_tpu_torch.core.device import resolve_device

    device = resolve_device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        for arm in args.arms.split(","):
            print(json.dumps(reading(run_mod.ROOT, args.workload, seed, args.seconds, device,
                                     arm)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
