"""Traffic kind ``sft_closed_loop_serve``: one client serving x4 SR images
with their segmentation probability maps through model 'sftgan''s
inference entry, ``test_async(lr, seg)``, as ``sftgan_test`` does.

Set-up builds the inference model of the configuration's options with
``chop`` as the cell says, draws SFTNet's weights on the card from the seed
(``reference/sftgan.py:sftnet_spec``), makes the cell's LR images
(``params['shapes']``: h, w and how many; pixels drawn on the card,
``harness.images_u8``, handed to the entry as uint8 HWC host arrays) and
each image's maps (``seg_maps``: f32 CHW host arrays at 4h x 4w, as
``sftgan_test.load_seg`` gives them), and runs each distinct shape once.
The window is ``closed_loop_serve``'s: every cycle serves all the images
in an order of its own drawn from the seed; each image is issued, then the
one before it is read back, as ``sftgan_test`` writes image i while i + 1
runs; an image's latency runs from its issue to its readback. Its record
holds the keys ``closed_loop_serve.end_to_end`` and ``quarters`` read, so
both metrics mean what they mean in srn_serve, and ``flop``, the
reference's count of SFTNet's FLOPs for the images issued. A sample of the
measured window's images, drawn from the seed with the largest image in
it, is compared with the reference after the window.

In a traced run the program's recorder (``dasr_tpu_torch/utils/trace.py``)
is on through the traced window, and its record keeps the device phases of
the window's last image (``phase_ms``).

A program without model 'sftgan' fails at once, at ``create_model``.
``faults.plant``'s ``altered`` wraps a generator call of one argument and
stops this cell at its first image; ``port_bench/sftgan_limits.py`` plants
this cell's faults.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch
import torch.nn.functional as F

from port_bench import compare, harness
from port_bench.reference import nets, sftgan
from port_bench.traffic import closed_loop_serve

end_to_end = closed_loop_serve.end_to_end
quarters = closed_loop_serve.quarters


def seg_maps(h: int, w: int, p: dict, seed: int, tag: str, device) -> torch.Tensor:
    """(classes, 4h, 4w) f32 probability maps of an h x w LR image, drawn on
    ``device``: standard normal logits at 1/16 of the HR size, scaled by
    ``p['seg_logit_scale']``, upsampled bilinearly to the HR size, softmax
    over the classes: regions with soft boundaries, most pixels confident,
    as a segmentation net's probabilities are."""
    gen = harness.generator(seed, tag, device)
    logits = torch.randn((1, p["seg_classes"], -(-h // 4), -(-w // 4)), generator=gen,
                         device=device).mul_(p["seg_logit_scale"])
    logits = F.interpolate(logits, size=(4 * h, 4 * w), mode="bilinear", align_corners=False)
    return torch.softmax(logits, 1)[0]


def _program_trace():
    """The program's recorder, or None where the program has none."""
    try:
        from dasr_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def setup(run):
    from dasr_tpu_torch.models.registry import create_model

    p, dev = run.params, run.device
    opt = copy.deepcopy(run.config["opt"])
    opt["is_train"] = False
    opt["chop"] = bool(p["chop"])
    opt.pop("pad_bucket", None)
    model = create_model(opt, dev)
    model.g.to(dev, memory_format=torch.channels_last).eval()
    nb = opt["network_G"].get("nb", 16)
    weights = harness.draw_params(sftgan.sftnet_spec(nb), run.seed, "G", dev)
    harness.load_params(model.g, weights, "G")
    if run.fault:
        from port_bench import faults

        faults.plant(run, model)

    shapes = [(h, w) for h, w, n in p["shapes"] for _ in range(n)]
    images = [harness.images_u8((1, h, w, 3), run.seed, f"lr{i}", dev)[0].cpu().numpy()
              for i, (h, w) in enumerate(shapes)]
    segs = [seg_maps(h, w, p, run.seed, f"seg{i}", dev).cpu().numpy()
            for i, (h, w) in enumerate(shapes)]
    for hw in sorted(set(shapes)):
        k = shapes.index(hw)
        model.test(images[k], segs[k])
    harness.sync(dev)
    order = np.random.default_rng(harness.derive_seed(run.seed, "order"))
    return {"model": model, "images": images, "segs": segs, "order": order,
            "weights": weights, "nb": nb,
            "flop": [sftgan.sftnet_flop(h, w, nb) for h, w in shapes]}


def window(run, state):
    model, images, segs = state["model"], state["images"], state["segs"]
    k = run.params["check_images"]
    largest = max(im.shape[0] * im.shape[1] for im in images)
    rng = np.random.default_rng(harness.derive_seed(run.seed, "sample"))
    sample, first_largest = [], None
    served, latency, done, lr_pixels, flop = 0, [], [], [], 0
    seconds = run.params["trace_seconds"] if run.tracing else run.seconds
    program = _program_trace() if run.tracing else None
    if program is not None:
        program.enable()

    def readback(prev):
        nonlocal first_largest, served
        out, t_in, j = prev
        with run.spans("readback"):
            arr = out.cpu().numpy()
        t_out = time.perf_counter()
        latency.append(t_out - t_in)
        done.append(t_out - t0)
        item = (j, arr)
        if first_largest is None and images[j].shape[0] * images[j].shape[1] == largest:
            first_largest = item
        elif len(sample) < k:
            sample.append(item)
        else:
            r = rng.integers(0, served + 1)
            if r < k:
                sample[r] = item
        served += 1

    prev, i = None, 0
    t0 = time.perf_counter()
    while True:
        if i % len(images) == 0:
            cycle = state["order"].permutation(len(images))
        j = int(cycle[i % len(images)])
        lr_pixels.append(images[j].shape[0] * images[j].shape[1])
        flop += state["flop"][j]
        t_in = time.perf_counter()
        with run.spans("issue"):
            out = model.test_async(images[j], segs[j])
        if prev is not None:
            readback(prev)
        prev, i = (out, t_in, j), i + 1
        if time.perf_counter() - t0 >= seconds:
            break
    readback(prev)
    window_s = time.perf_counter() - t0
    run.record.update(
        window_s=window_s, attempted=i, failed=i - served, latency_s=latency,
        issue_s=[t1 - t0_ for n, t0_, t1 in run.spans.items if n == "issue"][-i:],
        lr_pixels=lr_pixels, done_s=done, flop=flop)
    if program is not None:
        program.disable()
        run.record["phase_ms"] = program.phase_ms()
    if not run.tracing:
        state["sample"] = [first_largest] + sample


def check(run, state) -> dict:
    """The sampled images against the reference's, each beside the same
    network computed in plain bf16 (the configuration's precision); the
    control computes the reference in float8 in the program's place
    (``run.control``: a key of ``nets.PRECISIONS``)."""
    triples = []
    with nets.f32_exact():
        for j, served in state["sample"]:
            x = torch.as_tensor(state["images"][j], device=run.device)
            seg = torch.as_tensor(state["segs"][j], device=run.device)

            def sr(conv=nets.conv_f32):
                return sftgan.sft_image(state["weights"], x, seg, conv,
                                        state["nb"]).cpu().numpy()

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
