"""A train step captured once as a CUDA graph and replayed once a step.

Counterpart of the compiled window of the JAX package's banked trainers
(``dasr_tpu.train.srn_trainer._train_banked``, ``dsn_trainer.py:310-341``:
``jax.jit`` over ``lax.scan`` of the step, so that a K-step window costs one
dispatch). Here the graph plays the part of the scan's body: the step's
device work (the gather from the banks, the forward, the gradients, Adam)
is captured once and each step of a window is one replay, where the eager
loop issues some 16k ops from Python. One graph serves any window length.

What changes from step to step is small and is written into the graph's
static input buffers, outside the graph, before each replay: the index row
and the draws (made eagerly on the window's generator, in the eager loop's
order, so the random stream is bit for bit the loop's), and the DSN's
WGAN-GP mixing draws. Each network's LR is a device tensor that
``NetState.advance`` writes between replays; Adam is capturable, its count
on the device.

* Warm-up: the first step of a key runs eagerly on the capture stream. It
  is a real step of the run (counted, scheduled), and it is where Adam
  makes its moments and cuDNN, cuBLAS and the kernel library set up, since
  a capture executes nothing.
* A capture or a replay that fails raises: nothing goes back to the eager
  loop on the card.
* The graph's outputs (the metrics) live in its pool and the next replay
  overwrites them, so a window returns clones of its last step's.
* The RDB kernels' counts (``ops/rdb.py:fused_rdb``: forward and backward
  launches, backward calls) and the Adam step's (``adam.kernel_tensors``,
  ``adam.torch_tensors``, ``adam.launches``: ``train/state.py``) count at
  Python call time, which a replay skips: each replay adds the counts its
  capture recorded, and the capture itself adds none.
* The graph bakes in the addresses of the parameters, Adam's state, the LR
  tensors and the banks. Loading a train state replaces Adam's state
  tensors, so a key is captured again when any of those addresses moved
  (counted as ``graph.recaptures``, beside ``graph.captures`` and
  ``graph.replays``: ``utils/trace.py``).
* With tracing on, each step's host work is a span of the step's id:
  ``graph.draw`` (taking the next item of ``inputs``: the eager draws),
  ``graph.stage`` (the copies into the static buffers), ``graph.replay``
  (``replay()``, which waits while the launch queue is full),
  ``graph.host_step``, and once a key ``graph.warmup`` and
  ``graph.capture``. A step captured with tracing on also carries the
  trainer's device phase marks.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
from typing import Callable, Dict, Hashable, Iterable, Optional

import torch

from dasr_tpu_torch.core import dist
from dasr_tpu_torch.ops.rdb import fused_rdb
from dasr_tpu_torch.utils import trace

_COUNTS = ("launches", "launches_f32", "backward_launches", "bwd_kernel", "bwd_chain")
_PROGRAM_COUNTS = ("adam.kernel_tensors", "adam.torch_tensors", "adam.launches")


def replays_on(device: torch.device) -> bool:
    """Whether a banked window on ``device`` is replayed from a graph: on
    CUDA, in a world of one rank without a process group (capturing the
    collectives of ``core/dist.py`` is a step of its own: a torchrun world,
    even of one NCCL rank, runs the eager loop), under grad mode."""
    return device.type == "cuda" and dist.current().group is None and torch.is_grad_enabled()


@functools.lru_cache(maxsize=None)
def _capture_stream(index: int) -> torch.cuda.Stream:
    """The side stream of every warm-up and capture on card ``index``: cuBLAS
    keeps a workspace for each stream it has run on, for the life of the
    process, so a stream per trainer would leave one behind each."""
    return torch.cuda.Stream(torch.device("cuda", index))


def cuda_capture(step: Callable, args, stream: torch.cuda.Stream) -> Callable:
    """Capture ``step(*args)`` on ``stream`` into a CUDA graph with a pool of
    its own; returns the replay, which gives the captured outputs."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = step(*args)

    def replay():
        graph.replay()
        return out

    return replay


def _flat(x):
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for item in x for t in _flat(item)]


def _static_like(x):
    """Buffers of ``x``'s structure (tensors, tuples, NamedTuples, None)."""
    if x is None or isinstance(x, torch.Tensor):
        return None if x is None else x.clone()
    items = [_static_like(item) for item in x]
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


def _fingerprint(tensors: Iterable[torch.Tensor]):
    return tuple(t.data_ptr() for t in tensors)


class _Graph:
    def __init__(self, replay, static, fingerprint, launches, counts):
        self.replay, self.static = replay, static
        self.fingerprint, self.launches, self.counts = fingerprint, launches, counts


class StepGraphs:
    """One trainer's captured steps, by static key. ``capture``: how a step
    is captured (``cuda_capture``; the CPU tests pass an eager stand-in)."""

    def __init__(self, device: torch.device, capture: Callable = cuda_capture):
        self.device = torch.device(device)
        self.capture = capture
        self._graphs: Dict[Hashable, _Graph] = {}
        self._stream: Optional[torch.cuda.Stream] = None

    def _on_stream(self):
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            index = self.device.index
            self._stream = _capture_stream(torch.cuda.current_device() if index is None
                                           else index)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self._stream)

    def window(self, key: Hashable, tensors: Callable[[], Iterable[torch.Tensor]],
               step: Callable, inputs: Iterable, host_step: Callable[[], None],
               first: int = 0):
        """Run one step per item of ``inputs`` (each a tuple of the step's
        per-step tensors, made when the item is taken): ``step(*item)``, the
        device part, then ``host_step()``. The first step of a new ``key``
        runs eagerly and is then captured; every later one writes its item
        into the static inputs and replays. ``tensors()``: every tensor
        whose address the step bakes in; ``first``: the id of the window's
        first step (the trainer's ``state.step``), the spans' ids. Returns
        the last step's outputs (a dict of tensors) as tensors of their
        own."""
        graph = self._graphs.get(key)
        if graph is not None and graph.fingerprint != _fingerprint(tensors()):
            graph = None  # a train state was loaded under it
        out, replayed = None, False
        items = iter(inputs)
        for i in itertools.count(first):
            with trace.span("graph.draw", i):
                args = next(items, None)
            if args is None:
                break
            if graph is None:
                with trace.span("graph.warmup", i):
                    with self._on_stream():
                        out = step(*args)
                    if self._stream is not None:
                        torch.cuda.current_stream(self.device).wait_stream(self._stream)
                with trace.span("graph.host_step", i):
                    host_step()
                with trace.span("graph.capture", i):
                    graph = self._capture(key, step, args, tensors)
                replayed = False
                continue
            with trace.span("graph.stage", i):
                for buf, value in zip(_flat(graph.static), _flat(args)):
                    buf.copy_(value)
            with trace.span("graph.replay", i):
                out = graph.replay()
            trace.count("graph.replays")
            for name, n in zip(_COUNTS, graph.launches):
                setattr(fused_rdb, name, getattr(fused_rdb, name) + n)
            for name, n in zip(_PROGRAM_COUNTS, graph.counts):
                trace.count(name, n)
            with trace.span("graph.host_step", i):
                host_step()
            replayed = True
        return {k: v.clone() for k, v in out.items()} if replayed else out

    def _capture(self, key, step, args, tensors) -> _Graph:
        static = _static_like(args)
        before = tuple(getattr(fused_rdb, name) for name in _COUNTS)
        before_counts = trace.counters()
        replay = self.capture(step, static, self._stream)
        launches = tuple(getattr(fused_rdb, name) - n for name, n in zip(_COUNTS, before))
        for name, n in zip(_COUNTS, before):
            setattr(fused_rdb, name, n)
        after_counts = trace.counters()
        counts = tuple(after_counts.get(name, 0) - before_counts.get(name, 0)
                       for name in _PROGRAM_COUNTS)
        for name, n in zip(_PROGRAM_COUNTS, counts):
            if n:
                trace.count(name, -n)
        trace.count("graph.captures")
        if key in self._graphs:
            trace.count("graph.recaptures")
        graph = self._graphs[key] = _Graph(replay, static, _fingerprint(tensors()), launches,
                                           counts)
        return graph
