"""A checkout of the benchmark at tiny sizes, for the CPU tests: the
repository's ``BENCHMARK.json`` and ``port_bench/`` copied under a
temporary root, with small configurations and cells beside the real ones.
"""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_CELLS = {
    "tiny_srn_train": ("tiny_srn", "tiny_bank", "srn_banked_window", {
        "steps_per_call": 2, "checked_calls": [1, 2], "read_every": 32, "trace_windows": 1,
        "banks": {"fake": [6, 16, 16, 3], "hr": [6, 64, 64, 3], "real": [6, 16, 16, 3],
                  "ddm": [6, 16, 16, 1]}}, ["grad_gap", "grad_gap_d_median", "change_gap_median"]),
    "tiny_dsn_train": ("tiny_dsn", "tiny_bank", "dsn_banked_window", {
        "steps_per_call": 1, "checked_calls": [1, 1, 1], "read_every": None,
        "trace_windows": 2, "banks": {"clean": [4, 160, 160, 3], "noisy": [6, 40, 40, 3]}},
        ["grad_gap", "grad_gap_d_median", "change_gap_median"]),
    "tiny_srn_serve": ("tiny_srn", "tiny_lr", "closed_loop_serve", {
        "chop": True, "shapes": [[16, 24, 2], [24, 16, 1]], "check_images": 2,
        "trace_seconds": 0.5}, ["sr_rms_vs_bf16", "sr_max_vs_bf16"]),
}


def tiny_configs():
    srn = json.loads((REPO / "port_bench/configs/dasr_srn.json").read_text())
    srn = copy.deepcopy(srn)
    srn["name"] = "tiny_srn"
    srn["opt"]["network_G"].update(nf=32, nb=1, gc=32)
    srn["opt"]["network_D"].update(nf=8)
    srn["opt"]["datasets"]["train"].update(batch_size=2, HR_size=32)
    dsn = json.loads((REPO / "port_bench/configs/dasr_dsn.json").read_text())
    dsn["name"] = "tiny_dsn"
    dsn["args"].update(num_res_blocks=1, crop_size=128, batch_size=2)
    return {"tiny_srn": srn, "tiny_dsn": dsn}


def make_root(tmp: Path, limits=None) -> Path:
    """A checkout under ``tmp`` with the tiny cells; ``limits``: name ->
    limit for every tiny cell (generous ones by default)."""
    root = Path(tmp)
    shutil.copytree(REPO / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, cfg in tiny_configs().items():
        (root / "port_bench/configs" / f"{name}.json").write_text(json.dumps(cfg))
    for cell, (config, traffic, kind, params, numbers) in TINY_CELLS.items():
        lim = {k: (limits or {}).get(k, 1e9) for k in numbers}
        (root / "port_bench/workloads" / f"{cell}.json").write_text(json.dumps(
            {"kind": kind, "params": params, "limits": lim}))
        spec["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                  "chips": 1, "why": "CPU test"})
        group = "train" if "train" in cell else "serve"
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m and any(group in w for w in m["workloads"]):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def run_tiny(root: Path, cell: str, seed: int = 5, seconds: float = 0.5, trace: int = 0,
             **options) -> dict:
    """One CPU run of a tiny cell; its result line as a dict (None where it
    printed none) and its exit code."""
    import contextlib
    import io

    from port_bench import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], root=root, device="cpu", **options)
    lines = buf.getvalue().strip().splitlines()
    return {"rc": rc, "result": json.loads(lines[-1]) if rc == 0 and lines else None}
