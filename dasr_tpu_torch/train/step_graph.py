"""A banked train window, each step replayed from a CUDA graph or looped.

Counterpart of the compiled window of the JAX package's banked trainers
(``dasr_tpu.train.srn_trainer._train_banked``, ``dsn_trainer.py:310-341``:
``jax.jit`` over ``lax.scan`` of the step, so that a K-step window costs one
dispatch). A trainer hands ``StepGraphs.window`` its step, per-step inputs
and host step. Where ``replays_on`` the device the graph plays the part of
the scan's body: the step's device work (the gather from the banks, the
forward, the gradients, Adam) is captured once and each step of a window is
one replay, where the eager loop issues some 16k ops from Python. One graph
serves any window length. Elsewhere (the CPU, torchrun) the window is a
Python loop of the step and the host step: the plain version the card is
held against.

What changes from step to step is small and is written into the graph's
static input buffers, outside the graph, before each replay: the index row
and the draws (made eagerly on the window's generator, in the eager loop's
order, so the random stream is bit for bit the loop's), and the DSN's
WGAN-GP mixing draws. Each network's LR is a device tensor that
``NetState.advance`` writes between replays; Adam's step is the kernel of
``ops/adam.py``, its count on the device.

* Warm-up: the first step of a key runs eagerly on the capture stream. It
  is a real step of the run (counted, scheduled), and it is where Adam
  makes its moments and cuDNN, cuBLAS and the kernel library set up, since
  a capture executes nothing.
* A capture or a replay that fails raises: nothing goes back to the eager
  loop on the card.
* The graph's outputs (the metrics) live in its pool and the next replay
  overwrites them, so a window returns clones of its last step's.
* The kernels' and the Adam step's counters (``utils/trace.py``) count at
  Python call time, which a replay skips. The capture's change of
  ``trace.counters()`` is kept by name, taken back (a capture adds none)
  and credited again on every replay, whatever counters the step keeps.
* The graph bakes in the addresses of the parameters, Adam's state, the LR
  tensors and the banks. Loading a train state replaces Adam's state
  tensors, so a key is captured again when any of those addresses moved
  (counted as ``graph.recaptures``, beside ``graph.captures`` and
  ``graph.replays``).
* With tracing on, each replayed step's host work is a span of the step's
  id: ``graph.draw`` (taking the next item of ``inputs``: the eager draws),
  ``graph.stage`` (the copies into the static buffers), ``graph.replay``
  (``replay()``, which waits while the launch queue is full),
  ``graph.host_step``, and once a key ``graph.warmup`` and
  ``graph.capture``. A step captured with tracing on also carries the
  trainer's device phase marks. The eager loop records no span of its own.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
from typing import Callable, Dict, Hashable, Iterable, Optional

import torch

from dasr_tpu_torch.core import dist
from dasr_tpu_torch.utils import trace


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
    def __init__(self, replay, static, fingerprint, credit):
        self.replay, self.static, self.fingerprint = replay, static, fingerprint
        self.credit = credit  # the (name, n) a replay adds: its capture's, one graph.replays


class StepGraphs:
    """One trainer's captured steps, by static key. ``capture``: how a step
    is captured: ``cuda_capture``, which replays where ``replays_on`` the
    device and loops elsewhere; a stand-in, which always replays (the CPU
    tests'); None, the eager loop everywhere (the reference the card tests
    hold the replay against)."""

    def __init__(self, device: torch.device, capture: Optional[Callable] = cuda_capture):
        self.device = torch.device(device)
        self.capture = capture
        self._graphs: Dict[Hashable, _Graph] = {}
        self._stream: Optional[torch.cuda.Stream] = None

    def _replays(self) -> bool:
        if self.capture is cuda_capture:
            return replays_on(self.device)
        return self.capture is not None

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
        device part, then ``host_step()``. Where the window replays, the
        first step of a new ``key`` runs eagerly and is then captured; every
        later one writes its item into the static inputs and replays.
        ``tensors()``: every tensor whose address the step bakes in;
        ``first``: the id of the window's first step (the trainer's
        ``state.step``), the spans' ids. Returns the last step's outputs (a
        dict of tensors) as tensors of their own."""
        out = {}
        if not self._replays():
            for args in inputs:
                out = step(*args)
                host_step()
            return out
        graph = self._graphs.get(key)
        if graph is not None and graph.fingerprint != _fingerprint(tensors()):
            graph = None  # a train state was loaded under it
        replayed = False
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
            trace.credit(graph.credit)
            with trace.span("graph.host_step", i):
                host_step()
            replayed = True
        return {k: v.clone() for k, v in out.items()} if replayed else out

    def _capture(self, key, step, args, tensors) -> _Graph:
        static = _static_like(args)
        before = trace.counters()
        replay = self.capture(step, static, self._stream)
        counted = tuple((name, n - before.get(name, 0)) for name, n in trace.counters().items()
                        if n != before.get(name, 0))
        trace.credit((name, -n) for name, n in counted)
        trace.count("graph.captures")
        if key in self._graphs:
            trace.count("graph.recaptures")
        graph = self._graphs[key] = _Graph(replay, static, _fingerprint(tensors()),
                                           counted + (("graph.replays", 1),))
        return graph
