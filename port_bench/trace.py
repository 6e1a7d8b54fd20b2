"""The device trace of a traced run and what the per-layer metrics read
from it.

``torch.profiler`` (CUPTI) records the device's kernels, copies and
memsets, and the harness's spans as annotations on the host (``bench.*``,
``harness.Spans``). The window is the annotation ``bench.window``. Busy
time is the union of the device events inside it (overlapping events,
such as the RDB kernel's programmatic dependent launches, count once),
and every gap between them is named by the harness span the host was in
when the gap began.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Tuple

WINDOW = "bench.window"


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) spans, as disjoint spans in order."""
    out: List[list] = []
    for s0, s1 in sorted(spans):
        if out and s0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s1)
        else:
            out.append([s0, s1])
    return [(a, b) for a, b in out]


def union_length(spans) -> float:
    return sum(b - a for a, b in union(spans))


def gaps(busy: List[Tuple[float, float]], t0: float, t1: float) -> List[Tuple[float, float]]:
    """The idle spans of [t0, t1] around the disjoint ``busy`` spans."""
    out, at = [], t0
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if t1 > at:
        out.append((at, t1))
    return out


def name_at(t: float, host: List[Tuple[float, float, str]]) -> str:
    """The innermost host span that holds ``t`` (the latest to start), or
    'harness' outside them all."""
    best = None
    for s0, s1, name in host:
        if s0 <= t < s1 and (best is None or s0 >= best[0]):
            best = (s0, name)
    return best[1] if best else "harness"


class Reduced(NamedTuple):
    """A traced window, times in seconds: its length, the device's busy
    time, its device events (start, end, name) relative to the window's
    start, and the host spans (start, end, name) in the same frame."""

    window_s: float
    busy_s: float
    events: List[Tuple[float, float, str]]
    host: List[Tuple[float, float, str]]

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s0, s1, name in self.events:
            out[name] = out.get(name, 0.0) + (s1 - s0)
        return out

    def union_of(self, part: str) -> Optional[float]:
        """The union of the device time of events whose name holds
        ``part``; None where none ran."""
        sel = [(a, b) for a, b, n in self.events if part in n]
        return union_length(sel) if sel else None

    def idle_pct(self) -> float:
        """The share of the window in which no device event ran."""
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def idle_gaps(self) -> List[Tuple[str, float]]:
        busy = union([(a, b) for a, b, _ in self.events])
        return [(name_at(a, self.host), b - a) for a, b in gaps(busy, 0.0, self.window_s)]

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(self.idle_gaps(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}


def reduce_events(raw) -> Optional[Reduced]:
    """``Reduced`` from (start_ns, end_ns, name, on_device, is_annotation)
    tuples; None without a ``bench.window`` span or a device event in it."""
    win = [(s, e) for s, e, n, dev, _ in raw if n == WINDOW and not dev]
    if not win:
        return None
    t0, t1 = win[0]
    events, host = [], []
    for s, e, n, dev, ann in raw:
        if dev and not ann and not n.startswith(("bench.", "Optimizer.")):
            s, e = max(s, t0), min(e, t1)
            if e > s:
                events.append(((s - t0) * 1e-9, (e - t0) * 1e-9, n))
        elif not dev and n.startswith("bench.") and n != WINDOW:
            host.append(((s - t0) * 1e-9, (e - t0) * 1e-9, n[len("bench."):]))
    if not events:
        return None
    events.sort()
    busy = union_length([(a, b) for a, b, _ in events])
    return Reduced((t1 - t0) * 1e-9, busy, events, host)


@contextlib.contextmanager
def device_trace(run):
    """Trace the block with ``torch.profiler`` and put its reduction in
    ``run.trace``; the block runs its window inside ``run.spans('window')``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.device.type == "cuda" else [])
    run.spans.annotate = True
    with profile(activities=acts) as prof:
        yield
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
    run.spans.annotate = False
    raw = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() != DeviceType.CPU
        if run.device.type == "cpu":  # CPU runs (tests): CPU ops stand for device ones
            dev = not e.name().startswith("bench.")
        raw.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), dev,
                    bool(e.is_user_annotation())))
    run.trace = reduce_events(raw)
