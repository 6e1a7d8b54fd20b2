"""Traffic kind ``closed_loop_serve``: one client serving x4 SR images
through the 'DASR' model's inference entry, ``test_async``, as ``srn_test``
does.

Set-up builds the inference model of the configuration's options with
``chop`` as the cell says and no ``pad_bucket``, draws G's weights on the
card from the seed, makes the cell's LR images (``params['shapes']``: h, w
and how many; pixels drawn on the card, ``harness.images_u8``, handed to the entry as
uint8 HWC host arrays, served cycle after cycle, each cycle all of them in
an order of its own drawn from the seed, so that every seed serves the same
mix and which image follows which does not stay fixed by the seed) and runs
each distinct shape once. In the window each image is issued, then the
one before it is read back to the host, as ``srn_test`` reads image i
while i + 1 runs; an image's latency runs from its issue to its readback.
A sample of the measured window's images, drawn from the seed with the
largest image in it, is compared with the reference after the window (a
traced run's traced window is not sampled).
"""

from __future__ import annotations

import copy
import statistics
import time

import numpy as np
import torch

from port_bench import compare, harness
from port_bench.reference import nets, ops, steps


def _forward_shape(h: int, w: int):
    """(batch, h, w) of the generator's forward for one image: whole under
    the chop gate, else the tile batch."""
    if h * w < steps.CHOP_PIXELS:
        return 1, h, w
    nh, nw, t = ops.tile_plan(h, w)
    return nh * nw, t, t


def setup(run):
    from dasr_tpu_torch.models.registry import create_model

    p, dev = run.params, run.device
    opt = copy.deepcopy(run.config["opt"])
    opt["is_train"] = False
    opt["chop"] = bool(p["chop"])
    opt.pop("pad_bucket", None)
    model = create_model(opt, dev)
    model.g.to(dev, memory_format=torch.channels_last).eval()
    ng = opt["network_G"]
    weights = harness.draw_params(nets.rrdbnet_spec(ng["nf"], ng["nb"], ng["gc"], ng["in_nc"],
                                                    ng["out_nc"]), run.seed, "G", dev)
    harness.load_params(model.g, weights, "G")
    if run.fault:
        from port_bench import faults

        faults.plant(run, model)

    shapes = [(h, w) for h, w, n in p["shapes"] for _ in range(n)]
    images = [harness.images_u8((1, h, w, 3), run.seed, f"lr{i}", dev)[0].cpu().numpy()
              for i, (h, w) in enumerate(shapes)]
    for hw in sorted(set(shapes)):
        model.test(images[shapes.index(hw)])
    harness.sync(dev)
    order = np.random.default_rng(harness.derive_seed(run.seed, "order"))
    return {"model": model, "images": images, "order": order, "weights": weights,
            "nb": ng["nb"]}


def window(run, state):
    from dasr_tpu_torch.ops.rdb import fused_rdb

    model, images = state["model"], state["images"]
    k = run.params["check_images"]
    largest = max(im.shape[0] * im.shape[1] for im in images)
    rng = np.random.default_rng(harness.derive_seed(run.seed, "sample"))
    sample, first_largest = [], None
    served, latency, forwards, done, lr_pixels = 0, [], [], [], []
    seconds = run.params["trace_seconds"] if run.tracing else run.seconds
    launches0 = fused_rdb.launches

    def readback(prev):
        nonlocal first_largest, served
        out, t_in, lr = prev
        with run.spans("readback"):
            arr = out.cpu().numpy()
        t_out = time.perf_counter()
        latency.append(t_out - t_in)
        done.append(t_out - t0)
        item = (lr, arr)
        if first_largest is None and lr.shape[0] * lr.shape[1] == largest:
            first_largest = item
        elif len(sample) < k:
            sample.append(item)
        else:
            j = rng.integers(0, served + 1)
            if j < k:
                sample[j] = item
        served += 1

    prev, i = None, 0
    t0 = time.perf_counter()
    while True:
        if i % len(images) == 0:
            cycle = state["order"].permutation(len(images))
        lr = images[cycle[i % len(images)]]
        lr_pixels.append(lr.shape[0] * lr.shape[1])
        t_in = time.perf_counter()
        with run.spans("issue"):
            out = model.test_async(lr)
        forwards.append(_forward_shape(lr.shape[0], lr.shape[1]))
        if prev is not None:
            readback(prev)
        prev, i = (out, t_in, lr), i + 1
        if time.perf_counter() - t0 >= seconds:
            break
    readback(prev)
    window_s = time.perf_counter() - t0
    run.counters["rdb_launches"] = fused_rdb.launches - launches0
    run.record.update(
        window_s=window_s, attempted=i, failed=i - served, latency_s=latency,
        issue_s=[t1 - t0_ for n, t0_, t1 in run.spans.items if n == "issue"][-i:],
        lr_pixels=lr_pixels, forwards=forwards, done_s=done)
    if not run.tracing:
        state["sample"] = [first_largest] + sample


def end_to_end(run):
    r = run.record
    out_px = 16 * sum(r["lr_pixels"])
    return {"serve_mpix_per_s": out_px / r["window_s"] / 1e6,
            "serve_p95_ms": statistics.quantiles(r["latency_s"], n=100,
                                                 method="inclusive")[94] * 1e3}


def quarters(run):
    """Output Mpix/s of the images read back in each quarter of the window."""
    r = run.record
    q = r["window_s"] / 4
    px = [0.0] * 4
    for t, n in zip(r["done_s"], r["lr_pixels"]):
        px[min(3, int(t / q))] += 16 * n
    return [x / q / 1e6 for x in px]


def check(run, state) -> dict:
    """The sampled images against the reference's, each beside the same
    network computed in plain bf16 (the configuration's precision); the
    control computes the reference in float8 in the program's place
    (``run.control``: a key of ``nets.PRECISIONS``)."""
    triples = []
    with nets.f32_exact():
        for lr, served in state["sample"]:
            x = torch.as_tensor(lr, device=run.device)

            def sr(conv=nets.conv_f32):
                return steps.sr_image(state["weights"], x, state["nb"], conv).cpu().numpy()

            ref, plain = sr(), sr(nets.Bf16Conv())
            if run.control:
                served = sr(nets.PRECISIONS[run.control]())
            triples.append((served, ref, plain))
    run.record["look"] = [compare.serve_numbers([t]) | {"hw": list(t[1].shape[:2])}
                          for t in triples]
    return compare.serve_numbers(triples)


def release(state) -> None:
    """Drop the program's objects; the benchmark's inputs stay."""
    state.pop("model", None)
