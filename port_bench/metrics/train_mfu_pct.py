"""``train_mfu_pct``: the step's model FLOPs (the benchmark's count from the
conv shapes, ``reference/costs.py``: forwards, and input and weight
gradients where the step needs them; no recomputation) times the steps,
over the window times the H100's bf16 peak."""

from port_bench.reference.costs import PEAK_FLOPS_BF16


def read(run):
    r = run.record
    if not r.get("steps") or "step_flop" not in r:
        return None
    return 100.0 * r["step_flop"] * r["steps"] / (r["window_s"] * PEAK_FLOPS_BF16)
