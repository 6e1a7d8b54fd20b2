"""One run of one cell of the port's benchmark.

    python -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run loads the cell's configuration and
traffic, builds the program (``dasr_tpu_torch``) and its inputs from the
seed on the card, warms up every shape the traffic uses (the set-up,
``setup_s``, counted from the process's start), measures for ``--seconds``,
then frees the program's state and holds what the timed path produced
against the plain reference (``port_bench/reference``). A traced run
reports the per-layer metrics: those read on the host's clock from the
same untraced window, those read from the device's trace from a second,
shorter window of the cell's own length traced after it. Its last line on
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` a ``breakdown``,
and last ``checks``, each compared number beside its limit, which also
end standard error, after the host-clock readings (``host ...``).

It exits with 2, printing no result, where no CUDA card (or fewer than the
cell needs) is there, and with 3 where ``jax``, ``jaxlib``, ``flax`` or the
JAX package was loaded in this process or the reference imports the
program. Every build and kernel cache stays in the checkout's ``build/``.
"""

from __future__ import annotations

import argparse
import ast
import gc
import json
import os
import sys
import time
from pathlib import Path

from port_bench import compare, harness, trace

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "dasr_tpu")
PROGRAM = "dasr_tpu_torch"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def caches(root: Path) -> None:
    """Fixed cache directories inside the checkout: the kernel library
    (``kernels/build.py``: ``build/dasr_tpu_torch``) and Triton's."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    for var in ("DASR_TPU_LPIPS_LIN", "DASR_TPU_LPIPS_BACKBONE", "DASR_BANK_HOST_CACHE"):
        os.environ.pop(var, None)


def loaded_forbidden():
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def reference_imports_program(root: Path):
    """Files of ``port_bench/reference`` that import the program (by the
    top-level name of each import, compared whole)."""
    bad = []
    for path in sorted((root / "port_bench" / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            if any(n.split(".")[0] in (PROGRAM,) + FORBIDDEN for n in names):
                bad.append(path.name)
    return sorted(set(bad))


def device_info(run, peak: int) -> dict:
    import torch

    if run.device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
                "count": run.workload["chips"], "memory_peak_bytes": peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    if run.trace is not None:
        info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    return info


def traced_window(run, traffic, state) -> None:
    """The traced run's second window, under ``torch.profiler``: its trace,
    record and counters go to ``run.trace``, ``run.trace_record`` and
    ``run.trace_counters``; the measured window's stay where they were."""
    measured = run.record, run.spans, run.counters
    run.record, run.spans, run.counters = {}, harness.Spans(), {}
    run.tracing = True
    with trace.device_trace(run):
        with run.spans("window"):
            traffic.window(run, state)
    run.tracing = False
    run.trace_record, run.trace_counters = run.record, run.counters
    run.record, run.spans, run.counters = measured


def host_readings(run) -> dict:
    """The measured window's end-to-end numbers, the per-layer metrics read
    on the host's clock from it, and its rate in each quarter where the
    traffic gives one: printed on standard error by every run (a traced
    run's result line holds none of the end-to-end ones), as a witness of
    where a run's numbers came from."""
    traffic = run.bench.traffic(run.workload["kind"])
    out = dict(traffic.end_to_end(run))
    out.update({m["name"]: run.bench.reader(m["name"]).read(run)
                for m in run.bench.metrics_for(run.workload["name"], "per_layer")
                if m["source"] == "host_clock"})
    quarters = getattr(traffic, "quarters", None)
    if quarters is not None:
        out["window_quarters"] = quarters(run)
    return out


def execute(run, t_start: float) -> dict:
    """Set-up, window, comparison and metrics of ``run``; the result's
    fields."""
    import torch

    traffic = run.bench.traffic(run.workload["kind"])
    with run.exit:
        state = traffic.setup(run)
        setup_s = time.time() - t_start
        if run.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(run.device)
        with run.spans("window"):
            traffic.window(run, state)
        if run.traced:
            traced_window(run, traffic, state)
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    e2e = dict(traffic.end_to_end(run), setup_s=setup_s)
    traffic.release(state)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    correct, rows = compare.judge(traffic.check(run, state), run.workload["limits"])
    cell = run.workload["name"]
    if run.traced:
        metrics = {}
        for m in run.bench.metrics_for(cell, "per_layer"):
            value = run.bench.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in run.bench.metrics_for(cell, "end_to_end")}
    out = {"correct": bool(correct), "attempted": run.record["attempted"],
           "failed": run.record["failed"], "metrics": metrics,
           "device": device_info(run, int(peak))}
    if run.trace is not None:
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    run.host = host_readings(run)
    return out


def main(argv=None, root: Path = ROOT, device: str = "cuda", **options) -> int:
    """A run from ``root``; ``device`` 'cpu' and ``options`` (``fault``,
    ``control``) only for the tests and the readings of the limits."""
    t_start = harness.process_start_time()
    args = parse(argv)
    caches(root)
    import torch

    run = harness.Run(harness.Bench(root), args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cpu"), **options)
    if device == "cuda":
        need = run.workload["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"port_bench: the cell needs {need} CUDA card(s); "
                  f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                  f"device_count() {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        from dasr_tpu_torch.core.device import resolve_device

        run.device = resolve_device("cuda")
    out = execute(run, t_start)
    bad_mods, bad_ref = loaded_forbidden(), reference_imports_program(root)
    if bad_mods or bad_ref:
        print(f"port_bench: loaded in this process: {bad_mods}; files of port_bench/reference "
              f"that import the program: {bad_ref}", file=sys.stderr)
        return 3
    for name, value in run.host.items():
        print(f"host {name} {value!r}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
