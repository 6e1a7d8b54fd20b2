"""``kernels_per_step``: the device events (kernels, copies, memsets) in the
traced window over the steps it ran."""


def read(run):
    steps = (run.trace_record or {}).get("steps")
    if run.trace is None or not steps:
        return None
    return len(run.trace.events) / steps
