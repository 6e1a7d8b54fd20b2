"""What every run of the benchmark shares: finding a cell's files by name,
the run's state, the harness's spans, and the inputs and weights it draws
from the seed on the device.

A cell is its entry in ``BENCHMARK.json`` (its configuration, its traffic
mix, its chips) and ``workloads/<cell>.json`` (the traffic kind, that
kind's parameters, the limits of its comparison); a configuration is
``configs/<config>.json``; a traffic kind is the module
``traffic/<kind>.py``; a per-layer metric is the module
``metrics/<metric>.py``. Each is found by its name under the checkout's
``port_bench/`` and loaded from its file, so adding one is adding a file.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np

PKG = "port_bench"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """The module in ``path``, loaded under ``name`` (a metric's file name
    may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The benchmark of the checkout at ``root``: ``BENCHMARK.json`` and the
    files under ``port_bench/``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")
        self.dir = self.root / PKG

    def cell(self, name: str) -> dict:
        entries = [w for w in self.spec["workloads"] if w["name"] == name]
        if not entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        wl = load_json(self.dir / "workloads" / f"{name}.json")
        return dict(wl, **{k: entries[0][k] for k in ("name", "config", "traffic", "chips")})

    def config(self, name: str) -> dict:
        return load_json(self.dir / "configs" / f"{name}.json")

    def traffic(self, kind: str) -> ModuleType:
        return load_module(self.dir / "traffic" / f"{kind}.py", f"{PKG}_traffic_{kind}")

    def metrics_for(self, cell: str, group: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports: those
        that list it, and those that list no cells."""
        return [m for m in self.spec[group] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           f"{PKG}_metric_{metric.replace('.', '_')}")


class Spans:
    """The harness's spans around its calls into the program: (name, start,
    end) on the host clock, and, while a trace runs, the same ranges as
    profiler annotations, so that the trace can name what the host did in
    each idle gap."""

    def __init__(self):
        self.items: List[tuple] = []
        self.annotate = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        ctx = contextlib.nullcontext()
        if self.annotate:
            from torch.profiler import record_function

            ctx = record_function(f"bench.{name}")
        t0 = time.perf_counter()
        with ctx:
            yield
        self.items.append((name, t0, time.perf_counter()))

    def total(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.items if n == name)


class Run:
    """One run: its arguments, the cell, its configuration, and what the
    traffic and the trace record. ``record``, ``spans``, ``counters``: the
    measured window's (set by ``traffic.window``). A traced run traces a
    second, shorter window after it (``tracing`` is True while it runs):
    ``trace`` is its reduced device trace (``trace.Reduced``), and
    ``trace_record`` and ``trace_counters`` are its record and counters;
    else None."""

    def __init__(self, bench: Bench, cell: str, seed: int, seconds: float, trace: bool,
                 device, fault: Optional[str] = None, control: Optional[str] = None):
        self.bench, self.seed, self.seconds, self.traced = bench, int(seed), seconds, trace
        self.workload = bench.cell(cell)
        self.config = bench.config(self.workload["config"])
        self.params = self.workload["params"]
        self.device = device
        self.fault, self.control = fault, control
        self.spans = Spans()
        self.exit = contextlib.ExitStack()
        self.record: Dict = {}
        self.counters: Dict[str, float] = {}
        self.tracing = False
        self.trace = self.trace_record = self.trace_counters = None


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream (``tag``) of a run seeded ``seed``."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32] + list(tag.encode())
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, tag: str, device):
    import torch

    return torch.Generator(device=device).manual_seed(derive_seed(seed, tag))


def draw_params(spec: Dict[str, tuple], seed: int, tag: str, device) -> Dict:
    """A network's f32 parameters drawn on ``device`` from the seed in one
    call: a standard normal the size of all of them, each tensor its slice
    times its law's std, constants filled."""
    import torch

    n = sum(int(np.prod(shape)) for shape, (law, _) in spec.values() if law == "normal")
    flat = torch.randn(n, generator=generator(seed, tag, device), device=device)
    out, at = {}, 0
    for name, (shape, (law, value)) in spec.items():
        if law == "normal":
            size = int(np.prod(shape))
            out[name] = flat[at:at + size].view(shape).mul(value)
            at += size
        else:
            out[name] = torch.full(shape, float(value), device=device)
    return out


def load_params(module, params: Dict, what: str) -> None:
    """Copy ``params`` into ``module``'s parameters of the same names; every
    parameter of the module must be among them and match in shape."""
    import torch

    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise ValueError(f"{what}: parameters missing {missing[:4]}, unknown {extra[:4]}")
    with torch.no_grad():
        for name, p in own.items():
            if tuple(p.shape) != tuple(params[name].shape):
                raise ValueError(f"{what}: {name} is {tuple(p.shape)}, drawn "
                                 f"{tuple(params[name].shape)}")
            p.copy_(params[name])


def images_u8(shape, seed: int, tag: str, device, chunk_bytes: int = 1 << 30):
    """(N, H, W, C) uint8 images drawn on ``device``: each image uniform
    noise over a range of its own (32 to 255 levels wide, at an offset of
    its own), so that images differ in brightness and contrast as photos
    do; drawn in chunks of about ``chunk_bytes``."""
    import torch

    gen = generator(seed, tag, device)
    n = shape[0]
    width = torch.randint(32, 256, (n,), generator=gen, device=device)
    offset = (torch.rand((n,), generator=gen, device=device) * (256 - width)).long()
    out = torch.empty(shape, dtype=torch.uint8, device=device)
    out.random_(0, 256, generator=gen)
    per = max(1, chunk_bytes // max(1, out[0].numel() * 4))
    view = (-1,) + (1,) * (len(shape) - 1)
    for s in range(0, n, per):
        part = out[s:s + per].to(torch.int32)
        part = offset[s:s + per].view(view) + (part * width[s:s + per].view(view)) // 256
        out[s:s + per] = part.to(torch.uint8)
    return out


def maps_f32(shape, seed: int, tag: str, device):
    """(N, H, W, C) f32 maps in [0, 1] drawn on ``device``: each uniform up
    to a ceiling of its own in [0.2, 1]."""
    import torch

    gen = generator(seed, tag, device)
    ceil = 0.2 + 0.8 * torch.rand((shape[0],) + (1,) * (len(shape) - 1), generator=gen,
                                  device=device)
    return torch.rand(shape, generator=gen, device=device).mul_(ceil)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def process_start_time() -> float:
    """The wall-clock time this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
