"""Readings that set the ``sftgan_serve`` cell's limits: its comparison
numbers for sound runs, for the control (the reference computed in float8
in the program's place) and for faults planted here with
``unittest.mock``, seed by seed, several runs in one process.

    python -m port_bench.sftgan_limits --seeds 11,12,13 \\
        [--arms sound,control,altered,bypass,other_maps,uniform_maps] [--seconds 1]

The faults: ``altered`` (every SFTNet output has an 8x8 block at its
centre set to 0: ``faults.py``'s, for a generator call that also takes
the maps); ``bypass`` (every SFT layer returns its features unchanged, as
DASR's shipped forward runs the net); ``other_maps`` (each image is served
with the maps of the image of its shape served last before it, or, for a
shape no other image has, with its own maps mirrored left to right);
``uniform_maps`` (every map 1/8 everywhere). Each reading is a whole run of
the cell at its own size (``controls.reading``); one JSON line a reading.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from unittest import mock

import numpy as np

from port_bench import controls
from port_bench import run as run_mod

CELL = "sftgan_serve"
FAULTS = ("altered", "bypass", "other_maps", "uniform_maps")


def _swapped_maps(test_async, swap):
    def wrapped(self, lr_img, seg=None):
        return test_async(self, lr_img, swap(seg))

    return wrapped


def _other(seen: dict):
    def swap(seg):
        last = seen.get(seg.shape)
        seen[seg.shape] = seg
        return last if last is not None and last is not seg else np.flip(seg, -1).copy()

    return swap


@contextlib.contextmanager
def planted(arm: str):
    """``arm``'s fault under the program for the block."""
    from dasr_tpu_torch.models import registry
    from dasr_tpu_torch.nn import sft

    model = registry.SFTGANModel
    with contextlib.ExitStack() as stack:
        if arm == "altered":
            apply_g = model._apply_g

            def altered(self, x, *cond):
                out = apply_g(self, x, *cond)
                h, w = out.shape[-2] // 2, out.shape[-1] // 2
                out[..., h:h + 8, w:w + 8] = 0
                return out

            stack.enter_context(mock.patch.object(model, "_apply_g", altered))
        elif arm == "bypass":
            stack.enter_context(mock.patch.object(sft.SFTLayer, "forward",
                                                  lambda self, fea, cond: fea))
        elif arm == "other_maps":
            stack.enter_context(mock.patch.object(
                model, "test_async", _swapped_maps(model.test_async, _other({}))))
        elif arm == "uniform_maps":
            stack.enter_context(mock.patch.object(model, "test_async", _swapped_maps(
                model.test_async, lambda seg: np.full_like(seg, 1.0 / seg.shape[0]))))
        else:
            raise ValueError(f"unknown fault {arm!r}: {', '.join(FAULTS)}")
        yield


def reading(seed: int, seconds: float, device, arm: str) -> dict:
    if arm in ("sound", "control"):
        return controls.reading(run_mod.ROOT, CELL, seed, seconds, device, arm)
    with planted(arm):
        out = controls.reading(run_mod.ROOT, CELL, seed, seconds, device)
    return dict(out, arm=arm)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--arms", default="sound,control")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    run_mod.caches(run_mod.ROOT)
    from dasr_tpu_torch.core.device import resolve_device

    device = resolve_device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        for arm in args.arms.split(","):
            print(json.dumps(reading(seed, args.seconds, device, arm)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
