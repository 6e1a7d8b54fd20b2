"""The port's own spans, counters and device phases.

* **Spans** (``span(name, id)``): a context manager around host work, such
  as a replay's staging copy or the serving facade's upload. Off by default
  (``enable()`` / ``disable()``): off, ``span`` returns one shared null
  context and records nothing. On, each span appends ``Span(name,
  start_ns, end_ns, parent, id)`` to an in-memory list, ``parent`` the name
  of the enclosing open span of the same thread, ``id`` the caller's (a
  trainer's ``state.step``, the facade's image count); ``drain()`` takes
  the list. Stamps are Unix nanoseconds (``time.time_ns``), the frame in
  which ``torch.profiler``'s kineto events report host annotations and
  CUPTI's device events (``e.start_ns()``), so a span can be laid against a
  device trace without a profiler annotation of its own.
* **Counters** (``count(name, n)``): integers, always on, one dict add a
  call; ``counters()`` is a copy, with the RDB kernel's launch counts read
  from ``ops/rdb.py:fused_rdb``'s attributes, where they are kept;
  ``credit`` adds a ``(name, n)`` delta to either store. The Adam
  step counts ``adam.kernel_tensors`` (tensors updated by the kernel of
  ``ops/adam.py``), ``adam.torch_tensors`` (by ``torch.optim.Adam``) and
  ``adam.launches`` (the kernel's launches) in ``NetState.update``;
  ``ops/rdb.py`` counts ``rdb_prep.launches`` (the RDB weight plan's
  launches); ``nn/layers.py:BatchNorm2d`` counts ``bn.layer_updates`` (a
  layer's forward that moved its running statistics) and
  ``SRGANTrainer._d`` ``bn.stat_updates`` (a D forward that moved any).
  The serving facade (``models/registry.py:_InferenceModel.test_async``)
  counts ``serve.images``, ``serve.image_lr_px`` and ``serve.tile_lr_px``;
  'sftgan''s ``serve.cond_bytes`` (the segmentation maps' bytes copied to
  the device), its upload a span ``serve.cond_upload`` nested in
  ``serve.upload``.
* **Device phases** (``phase(name)``, ``end_phases()``, ``phase_ms()``):
  marks of where each part of a train step (or of SFTNet's forward:
  ``cond``, ``sft_branch``, ``hr_branch``) starts on the current stream,
  made only while tracing is on. In a process that has initialised CUDA a
  mark records a timing event with ``external=True``, which inside a CUDA
  graph's capture becomes an event-record node, so every replay records it
  again; elsewhere a mark stamps the host clock. One set of events serves
  the process (its ``i``-th mark of a step reuses the ``i``-th event), so
  ``phase_ms`` reads the most recent recorded step, after a sync.

The counters and spans are written by the thread that issues the work to
the device (the trainers' and the facade's callers), with no lock.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    id: Optional[int]


_NULL = contextlib.nullcontext()
_on = False
_spans: List[Span] = []
_open = threading.local()
_counts: Dict[str, int] = {}


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


class _Open:
    __slots__ = ("name", "id", "start", "parent")

    def __init__(self, name: str, id: Optional[int]):
        self.name, self.id = name, id

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _open.stack.pop()
        _spans.append(Span(self.name, self.start, end, self.parent, self.id))
        return False


def span(name: str, id: Optional[int] = None):
    """A context manager that records the block as a span while tracing is
    on; off, the shared null context."""
    return _Open(name, id) if _on else _NULL


def drain() -> List[Span]:
    """The spans recorded since the last drain, in the order they closed;
    the list is emptied."""
    global _spans
    out, _spans = _spans, []
    return out


def count(name: str, n: int = 1) -> int:
    """Add ``n`` to the counter ``name``; its new value."""
    value = _counts[name] = _counts.get(name, 0) + n
    return value


def counters() -> Dict[str, int]:
    """Every counter of the process, with the RDB kernels' counts:
    ``fused_rdb.launches`` and ``fused_rdb.launches_f32`` (forward
    launches), ``fused_rdb.backward_launches``, the backward calls on
    the card that took the kernels (``fused_rdb.bwd_kernel``) or
    ``rdb_chain`` (``fused_rdb.bwd_chain``), and the bf16 calls on the card
    under autograd that took a weight plan's kernels (``fused_rdb.prepared``)
    or cast their own (``fused_rdb.cast``)."""
    from dasr_tpu_torch.ops.rdb import fused_rdb

    return dict(_counts, **{f"fused_rdb.{name}": getattr(fused_rdb, name) for name in (
        "launches", "launches_f32", "backward_launches", "bwd_kernel", "bwd_chain", "prepared",
        "cast")})


def credit(counts: Iterable[Tuple[str, int]]) -> None:
    """Add each ``(name, n)`` of ``counts`` to the counter ``name`` of
    ``counters()``, in the store it is read from (a replay credits what its
    capture counted)."""
    from dasr_tpu_torch.ops.rdb import fused_rdb

    for name, n in counts:
        if name.startswith("fused_rdb."):
            attr = name[len("fused_rdb."):]
            setattr(fused_rdb, attr, getattr(fused_rdb, attr) + n)
        else:
            _counts[name] = _counts.get(name, 0) + n


def write_chrome_trace(spans: List[Span], path: str, base_ns: int = 0) -> None:
    """``spans`` as Chrome trace events (complete events of this process, on
    one track, ``ts`` in microseconds after ``base_ns``) in ``path``; with
    the ``baseTimeNanoseconds`` of a ``torch.profiler`` trace, the two
    files' events lie on one clock."""
    pid = os.getpid()
    events = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
               "args": {"name": "dasr_tpu_torch spans"}}]
    events += [{"name": s.name, "ph": "X", "cat": "dasr_tpu_torch", "pid": pid, "tid": 0,
                "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                "args": {"id": s.id, "parent": s.parent}} for s in spans]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "baseTimeNanoseconds": base_ns}, f)


# -- device phases ---------------------------------------------------------

_marks: list = []  # the i-th mark of a step: a CUDA event, or host ns
_current: List[str] = []  # the phases marked in the step being recorded
_last: List[str] = []  # the phases of the most recent closed step


def _mark(i: int) -> None:
    import torch

    if torch.cuda.is_initialized():
        while len(_marks) <= i:
            _marks.append(torch.cuda.Event(enable_timing=True, external=True))
        _marks[i].record()
    else:
        while len(_marks) <= i:
            _marks.append(0)
        _marks[i] = time.perf_counter_ns()


def phase(name: str) -> None:
    """Mark the start of the step's phase ``name`` (ending the one before)
    on the current stream, while tracing is on."""
    if _on:
        _mark(len(_current))
        _current.append(name)


def end_phases() -> None:
    """Close the step's last phase; the step becomes the one ``phase_ms``
    reads."""
    global _current, _last
    if _on and _current:
        _mark(len(_current))
        _current, _last = [], _current


def phase_ms() -> Dict[str, float]:
    """{phase: ms} of the most recent recorded step (a name marked twice
    sums); read after the device finished it. Empty where none was."""
    out: Dict[str, float] = {}
    for i, name in enumerate(_last):
        a, b = _marks[i], _marks[i + 1]
        ms = a.elapsed_time(b) if hasattr(a, "elapsed_time") else (b - a) * 1e-6
        out[name] = out.get(name, 0.0) + ms
    return out
