"""What the two banked train kinds share: the first calls that set-up
drives and the reference follows, the window of K-step calls with the CLIs'
lagged metric reads, and the program's side of the comparison read from
its train state.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator

import numpy as np

from port_bench import compare, harness
from port_bench.reference import sampling


def first_grad_norms(ns, beta1: float) -> Dict[str, float]:
    """Each leaf's first gradient as its Adam got it, from the Adam's state
    after one step: the first moment is (1 - beta1) g; an Adam that never
    stepped got none."""
    out = {}
    for k, p in ns.net.named_parameters():
        if p.requires_grad:
            m = ns.opt.state.get(p, {}).get("exp_avg")
            out[k] = 0.0 if m is None else float(m.double().norm()) / (1 - beta1)
    return out


def change_norms(net, start: Dict) -> Dict[str, float]:
    return {k: float((p.detach() - start[k]).double().norm())
            for k, p in net.named_parameters() if p.requires_grad}


def rows_from(seed: int, n: int, batch: int) -> Iterator[np.ndarray]:
    """Index rows epoch after epoch, as the train CLIs draw them."""
    epoch = 0
    while True:
        yield from sampling.epoch_rows(seed, epoch, n, batch)
        epoch += 1


def checked_calls(run, call: Callable, to_host: Callable, rows: Iterator, nets: Dict,
                  betas: Dict[str, float], start: Dict[str, Dict]) -> dict:
    """The first calls, through the window's own call (``call(rows (k, B),
    first iteration)``), of ``params['checked_calls']`` rows each: the first
    of one row, so that Adam's state holds the first gradient; then as the
    window calls, K rows a call. The last step's losses of each call
    (``loss_steps``: those steps), the first gradients, the change from
    ``start`` after them all, and the calls as (first iteration, rows).
    ``nets``: name -> the program's ``NetState``."""
    sizes = run.params["checked_calls"]
    if sizes[0] != 1:
        raise ValueError("the first checked call has to run one step")
    losses, grad, used, calls, step = [], None, [], [], 0
    for k in sizes:
        rows_k = np.stack([next(rows) for _ in range(k)])
        used.extend(rows_k)
        calls.append((step, k))
        losses.append(to_host(call(rows_k, step)))
        step += k
        if grad is None:
            grad = {n: first_grad_norms(ns, betas[n]) for n, ns in nets.items()}
    change = {n: change_norms(ns.net, start[n]) for n, ns in nets.items()}
    return {"losses": losses, "loss_steps": [s + k - 1 for s, k in calls], "grad": grad,
            "change": change, "rows": used, "calls": calls}


def look(prog: dict, ref: dict, loss_steps) -> dict:
    """What a train cell's comparison looked at: the losses at the last step
    of each checked call on both sides (``prog``'s are those already), their
    gaps, the worst leaves."""
    ref_l = [ref["losses"][i] for i in loss_steps]
    gaps = compare.loss_gaps(prog, {"losses": ref_l})
    return {"losses": {"program": prog["losses"], "reference": ref_l, "gaps": gaps},
            "leaves": compare.worst_leaves(prog, ref)}


def window(run, call: Callable, to_host: Callable, rows: Iterator, step0: int,
           log_every: int) -> None:
    """Issue K-step windows (``call(rows (K, B), first iteration)``) until the
    host clock passes the run's seconds (the traced window: its
    ``trace_windows`` windows), then wait for the card. A window's metrics
    are read after the next window is issued, for a window that crossed a
    ``log_every`` boundary, and where ``params['read_every']`` is set, one
    read every that many unread windows bounds how far the host runs ahead,
    as the train CLI of the cell does (``srn_train``: 32; ``dsn_train``:
    none)."""
    p = run.params
    k, cap = p["steps_per_call"], p.get("read_every")
    step, lagged, runahead, windows, issued = step0, None, 0, 0, []
    t0 = time.perf_counter()
    while True:
        rows_k = np.stack([next(rows) for _ in range(k)])
        with run.spans("issue"):
            metrics = call(rows_k, step)
        issued.append(time.perf_counter() - t0)
        step += k
        windows += 1
        prev, lagged = lagged, (step, metrics)
        if prev is not None:
            if prev[0] // log_every > (prev[0] - k) // log_every:
                with run.spans("metrics"):
                    to_host(prev[1])
                runahead = 0
            else:
                runahead += 1
                if cap and runahead >= cap:
                    with run.spans("metrics"):
                        to_host(prev[1])
                    runahead = 0
        if (windows >= p["trace_windows"] if run.tracing
                else time.perf_counter() - t0 >= run.seconds):
            break
    with run.spans("sync"):
        harness.sync(run.device)
    run.record.update(window_s=time.perf_counter() - t0, steps=step - step0, attempted=step - step0,
                      failed=0, issued_s=issued, steps_per_call=k)


def end_to_end(run) -> Dict[str, float]:
    r = run.record
    return {"train_step_ms": r["window_s"] / r["steps"] * 1e3}


def quarters(run):
    """Steps issued a second in each quarter of the window (under a CUDA
    graph the host is held back by the launch queue, so this follows the
    card's pace one queue behind)."""
    r = run.record
    q = r["window_s"] / 4
    n = [0] * 4
    for t in r["issued_s"]:
        n[min(3, int(t / q))] += r["steps_per_call"]
    return [x / q for x in n]
