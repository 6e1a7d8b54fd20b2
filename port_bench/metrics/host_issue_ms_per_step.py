"""``host_issue_ms_per_step``: the host's time inside the measured
(untraced) window's train calls (the draws, the copies, ``replay()``) over
the steps they ran. Under a CUDA graph this holds the wait of a full
launch queue as well as host work."""


def read(run):
    steps = run.record.get("steps")
    return 1e3 * run.spans.total("issue") / steps if steps else None
