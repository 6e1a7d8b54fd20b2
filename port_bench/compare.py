"""The numbers that decide ``correct``: how far what the timed path produced
lies from the plain reference's, each held to its cell's limit.

Train cells (the first steps, which set-up drives through the window's own
call). A leaf's gap is the gap between the program's and the reference's
norm of it, against the reference's norm of that leaf or of the median
leaf, whichever is larger.

* ``grad_gap``: the worst leaf's gap of the first gradient, as the
  program's Adam got it, over every network;
* ``grad_gap_d_median``: the discriminator's median leaf's gap of the
  first gradient, the number that parts bf16 from float8 on every seed
  read (the worst leaf of either network does not: the generator's 115
  bf16 layers widen its gap on some seeds, and one-element leaves swing);
* ``change_gap_median``: the median leaf's gap of the change over the
  steps, the larger over the networks (the worst leaf is a one-element
  PReLU slope or bias, which Adam moves by one or three LRs as the sign of
  its gradient turns). Leaves whose first gradient in the reference is under
  a thousandth of the median leaf's move by round-off alone and are left
  out of the change.

The losses of each step are read (``loss_gaps``) and not compared: after
the first step they part as the trajectories part, and the first step's
reads alike on bf16 and on the faults.

Serve cells (a sample of the images served in the window): each image's
relative RMS error and largest pixel error against the f32 reference, as
multiples of the same errors of the network computed in plain bf16
(``reference/nets.py:Bf16Conv``) on that image; the worst image's. The
random weights' outputs range from an RMS of 2 to 80 from seed to seed,
and with them how far any bf16 computation lies from f32 (0.3% to 2.4% for
the plain one): the multiple is steady (1.4 to 2.2 for the program, whose
activations stay bf16 between convs; 9 and up for float8).
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np

Norms = Dict[str, Dict[str, float]]  # network -> leaf -> norm


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys: List[str]) -> List[float]:
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def loss_gaps(prog: dict, ref: dict) -> List[Dict[str, float]]:
    """Each step's relative gap of each loss, for the look (not compared:
    see the module's note)."""
    return [{k: abs(p[k] - r[k]) / max(abs(r[k]), 1e-12) for k in r}
            for p, r in zip(prog["losses"], ref["losses"])]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {'losses': [{name: value}] a step, 'grad':
    Norms at the first step, 'change': Norms after the last}."""
    grad_gap = max(max(_gaps(prog["grad"][n], g, list(g))) for n, g in ref["grad"].items())
    d = ref["grad"]["D"]
    change = 0.0
    for n, g in ref["grad"].items():
        med = statistics.median(g.values())
        keep = [k for k, v in g.items() if v >= 1e-3 * med]
        change = max(change, statistics.median(_gaps(prog["change"][n], ref["change"][n], keep)))
    return {"grad_gap": grad_gap,
            "grad_gap_d_median": statistics.median(_gaps(prog["grad"]["D"], d, list(d))),
            "change_gap_median": change}


def worst_leaves(prog: dict, ref: dict, top: int = 3) -> dict:
    """For the look at a train cell's readings: each network's ``top``
    leaves by their gap, for the first gradient and the change, with both
    norms, and the median leaf's gap."""
    out = {}
    for what in ("grad", "change"):
        for n, r in ref[what].items():
            g = ref["grad"][n]
            med_g = statistics.median(g.values())
            keys = [k for k in r if what == "grad" or g[k] >= 1e-3 * med_g]
            med = statistics.median(r[k] for k in keys)
            gaps = sorted(((abs(prog[what][n][k] - r[k]) / max(r[k], med, 1e-30), k)
                           for k in keys), reverse=True)
            out[f"{what}.{n}"] = {
                "median_gap": statistics.median(x for x, _ in gaps),
                "worst": [(k, x, prog[what][n][k], r[k]) for x, k in gaps[:top]]}
    return out


def _rel_rms(a, r) -> float:
    d = np.asarray(a, np.float64) - r
    return float(np.sqrt((d * d).sum() / max((r * r).sum(), 1e-30)))


def serve_numbers(triples) -> Dict[str, float]:
    """``triples``: (served, reference, plain bf16) HWC f32 arrays. Each
    image's relative RMS error and largest pixel error, as multiples of the
    plain bf16 network's on the same image; the worst image's."""
    rms, mx = 0.0, 0.0
    for served, ref, plain in triples:
        r = np.asarray(ref, np.float64)
        rms = max(rms, _rel_rms(served, r) / max(_rel_rms(plain, r), 1e-30))
        mx = max(mx, float(np.abs(np.asarray(served, np.float64) - r).max())
                 / max(float(np.abs(np.asarray(plain, np.float64) - r).max()), 1e-30))
    return {"sr_rms_vs_bf16": rms, "sr_max_vs_bf16": mx}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every number at or under its
    limit, and finite."""
    rows = [(k, float(numbers[k]), float(limits[k])) for k in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
