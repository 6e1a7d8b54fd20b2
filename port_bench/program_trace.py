"""A run of one cell with the program's own recorder on: its spans, counters
and device phases (``dasr_tpu_torch/utils/trace.py``) read per window, and
the traced window's idle gaps named by them.

    python -m port_bench.program_trace --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs ``port_bench.run`` with the same arguments and three differences: the
recorder is on from before set-up (so the train cells' graphs are captured
with their phase marks), each traffic window ends with a sync and leaves
in its record the spans it recorded (``program_spans``), the change of the
program's counters (``program_counters``) and the phases of its last step
(``phase_ms``), and after the run's own lines one more line on standard
error, ``program {...}``: the readings of ``readings`` from the measured
window and, with ``--trace 1``, ``named_gaps`` of the traced one. The
harness's files are used as they are; the run wraps their functions.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Tuple

from port_bench import harness, trace

PHASES = {"gather_ms_per_step": "batch", "g_forward_ms_per_step": "g_forward",
          "g_backward_ms_per_step": "g_backward", "d_ms_per_step": "d",
          "adam_ms_per_step": "adam"}
HOST_WORK = ("window.upload", "graph.draw", "graph.stage", "graph.host_step")
SERVE = {"serve_upload_ms": "serve.upload", "serve_forward_issue_ms": "serve.forward",
         "serve_eval_mode_ms": "serve.eval_mode", "serve_tiles_ms": "serve.tiles",
         "serve_crop_ms": "serve.crop"}


def span_ms(spans, names) -> float:
    """The summed length of the spans named in ``names``, in ms."""
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans if s.name in names)


def readings(record: Dict) -> Dict[str, float]:
    """A window's per-layer readings from what it recorded: each phase of
    the last step (ms, on the device's clock); the host's work a step in
    the step graph's spans and the index upload (ms); the serving facade's
    upload and forward issue an image (ms) and its LR pixels forwarded
    over those served. Only those the window has something for."""
    spans, counts = record["program_spans"], record["program_counters"]
    out = {m: record["phase_ms"][p] for m, p in PHASES.items() if p in record["phase_ms"]}
    steps = record.get("steps")
    if steps:
        out["host_work_ms_per_step"] = span_ms(spans, HOST_WORK) / steps
        out["replay_ms_per_step"] = span_ms(spans, ("graph.replay",)) / steps
    images = counts.get("serve.images")
    if images:
        out.update({m: span_ms(spans, (name,)) / images for m, name in SERVE.items()})
        out["tile_overcompute"] = counts["serve.tile_lr_px"] / counts["serve.image_lr_px"]
    return out


def named_gaps(reduced: trace.Reduced, spans, t0_ns: int) -> List[Tuple[str, float, float]]:
    """Each idle gap of the traced window as (name, start s, length s): the
    harness span the host was in when it began, then ``/`` and the
    innermost program span that holds its start, where one does
    (``issue/graph.draw``). ``t0_ns``: the window's start on the spans'
    clock."""
    prog = [((s.start_ns - t0_ns) * 1e-9, (s.end_ns - t0_ns) * 1e-9, s.name) for s in spans]
    busy = trace.union([(a, b) for a, b, _ in reduced.events])
    out = []
    for a, b in trace.gaps(busy, 0.0, reduced.window_s):
        name, inner = trace.name_at(a, reduced.host), trace.name_at(a, prog)
        out.append((name if inner == "harness" else f"{name}/{inner}", a, b - a))
    return out


def wire(captured: Dict):
    """Wrap the harness: every traffic window records the program's spans,
    counter changes and phases; the traced window's start and the run
    itself go into ``captured``. Returns the function that unwraps it."""
    from dasr_tpu_torch.utils import trace as program

    from port_bench import run

    load_traffic, reduce_events, execute = harness.Bench.traffic, trace.reduce_events, run.execute

    def traffic(bench, kind):
        mod = load_traffic(bench, kind)
        inner = mod.window

        def window(run_, state):
            program.drain()
            before = program.counters()
            inner(run_, state)
            harness.sync(run_.device)
            run_.record.update(
                program_spans=program.drain(), phase_ms=program.phase_ms(),
                program_counters={k: v - before.get(k, 0)
                                  for k, v in program.counters().items()})

        mod.window = window
        return mod

    def reduce(raw):
        out = reduce_events(raw)
        if out is not None:
            captured["t0_ns"] = min(s for s, _, n, dev, _ in raw if n == trace.WINDOW and not dev)
        return out

    def execute_(run_, t_start):
        captured["run"] = run_
        return execute(run_, t_start)

    harness.Bench.traffic, trace.reduce_events, run.execute = traffic, reduce, execute_

    def unwire():
        harness.Bench.traffic, trace.reduce_events, run.execute = (load_traffic, reduce_events,
                                                                   execute)

    return unwire


def main(argv=None, **options) -> int:
    """``port_bench.run.main`` with the recorder on and wired; ``options``
    as that takes them (the tests' CPU runs)."""
    from dasr_tpu_torch.utils import trace as program

    from port_bench import run

    captured: Dict = {}
    unwire = wire(captured)
    program.enable()
    try:
        rc = run.main(argv, **options)
    finally:
        program.disable()
        unwire()
    if rc:
        return rc
    r = captured["run"]
    out = {"cell": r.workload["name"], "seed": r.seed, "measured": readings(r.record),
           "counters": r.record["program_counters"]}
    if r.trace is not None:
        out["traced"] = readings(r.trace_record)
        gaps = named_gaps(r.trace, r.trace_record["program_spans"], captured["t0_ns"])
        out["gaps_1ms"] = [g for g in gaps if g[2] >= 1e-3]
        out["gap_s_by_name"] = {}
        for name, _, length in gaps:
            out["gap_s_by_name"][name] = out["gap_s_by_name"].get(name, 0.0) + length
    print("program " + json.dumps(out), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
