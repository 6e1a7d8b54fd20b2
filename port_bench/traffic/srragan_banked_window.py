"""Traffic kind ``srragan_banked_window``: ESRGAN's training (model
'srragan') on paired banks resident on the card, K steps a call.

Set-up builds the model as ``srn_train`` does (``create_model`` of the
configuration's options, ``init``), draws every weight on the card from
the seed (G, the VGG D, VGG19-54), and makes the two banks there (LR and
HR, row i of one the pair of row i of the other; the counts and sizes of
``params['banks']``; ``harness.images_u8``). It puts them where
``SRGANModel.setup_device_bank`` puts the banks it uploads, and calls
``train_banked_window_async`` as ``srn_train --device_bank
--steps_per_call K`` does: index rows of a seeded epoch order, the window's
first iteration, the metrics read one window late. The first calls
(``checked_calls``: one row, then a whole window of K rows) are compared
with the reference (``reference/esrgan.py``), and so are D's BatchNorm
running statistics after them; one K-step window warms up; the measured
window follows.

A program without the paired banks (``PairedBanks``) fails at once, at
its import, before anything is drawn.

In a traced run the program's recorder (``dasr_tpu_torch/utils/trace.py``)
is on from before set-up, so the step is captured with its device phase
marks, and the traced window's record holds the phases of its last step
(``phase_ms``).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from port_bench import compare, harness, trainloop
from port_bench.reference import esrgan, nets, sampling

BANKS = ("lr", "hr")


def _program_trace():
    """The program's recorder, or None where the program has none."""
    try:
        from dasr_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def _spec(opt):
    ng, nd = opt["network_G"], opt["network_D"]
    return {"G": nets.rrdbnet_spec(ng["nf"], ng["nb"], ng.get("gc", 32), ng["in_nc"],
                                   ng["out_nc"]),
            "D": esrgan.vgg_d_spec(nd["which_model_D"], nd["in_nc"], nd["nf"]),
            "VGG": esrgan.vgg19_54_spec()}


def bn_stats(net) -> dict:
    """The running statistics of a network's BatchNorms (f32 copies), and
    ``updates``: how many forwards moved them (the first BatchNorm's
    ``num_batches_tracked``)."""
    out, updates = {}, None
    for name, buf in net.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            out[name] = buf.detach().float().clone()
        elif name.endswith("num_batches_tracked") and updates is None:
            updates = buf.detach().float().clone()
    out["updates"] = updates
    return out


def bn_stats_gap(prog: dict, ref: dict) -> float:
    """The worst of D's BatchNorms: the gap between the program's and the
    reference's running statistics, the norm of (mean, variance) gaps over
    the norm of the reference's (mean, variance); and the gap of the count
    of forwards that moved them, relative to the reference's."""
    gaps = [abs(float(prog["updates"]) - float(ref["updates"])) / max(float(ref["updates"]), 1.0)]
    for name in ref:
        if name.endswith("running_mean"):
            var = name[:-len("mean")] + "var"
            d = torch.cat([prog[name] - ref[name], prog[var] - ref[var]]).double().norm()
            gaps.append(float(d / torch.cat([ref[name], ref[var]]).double().norm()))
    return max(gaps)


def setup(run):
    from dasr_tpu_torch.data.device_bank import ImageBank, PairedBanks
    from dasr_tpu_torch.models.registry import create_model

    p, dev = run.params, run.device
    program = _program_trace()
    if run.traced and program is not None:
        program.enable()
        run.exit.callback(program.drain)
        run.exit.callback(program.disable)
    opt = copy.deepcopy(run.config["opt"])
    opt["is_train"] = True
    opt["train"]["manual_seed"] = run.seed
    tr_opt = opt["datasets"]["train"]
    hr, bs = tr_opt["HR_size"], tr_opt["batch_size"]
    flip, rot = tr_opt["use_flip"], tr_opt["use_rot"]

    model = create_model(opt, dev).init(run.seed)
    tr = model.trainer
    weights = {n: harness.draw_params(s, run.seed, n, dev) for n, s in _spec(opt).items()}
    harness.load_params(tr.state.g.net, weights["G"], "G")
    harness.load_params(tr.state.d_target.net, weights["D"], "D")
    harness.load_params(tr.vgg, weights["VGG"], "VGG")

    banks = {}
    for name in BANKS:
        n, h, w, c = p["banks"][name]
        data = harness.images_u8((n, h, w, c), run.seed, name, dev)
        banks[name] = (data, torch.tensor([[h, w]] * n, dtype=torch.int32, device=dev))
    # what setup_device_bank leaves after its upload
    if not model.supports_multi_step:
        raise ValueError(f"the banked window: {model.single_step_reason}")
    model._banks = PairedBanks(*(ImageBank(*banks[n]) for n in BANKS))
    model._bank_args = (hr, flip, rot)

    rows = trainloop.rows_from(run.seed, p["banks"]["lr"][0], bs)
    tr_cfg = opt["train"]
    call, to_host = model.train_banked_window_async, model.metrics_to_host
    if run.fault:
        from port_bench import faults

        faults.plant(run, model)
    held = {"G": tr.state.g, "D": tr.state.d_target}
    prog = trainloop.checked_calls(run, call, to_host, rows, held,
                                   {"G": tr_cfg["beta1_G"], "D": tr_cfg["beta1_D"]},
                                   {n: weights[n] for n in held})
    prog["bn"] = bn_stats(tr.state.d_target.net)
    step = sum(p["checked_calls"])
    to_host(call(np.stack([next(rows) for _ in range(p["steps_per_call"])]), step))
    step += p["steps_per_call"]
    harness.sync(dev)
    ng, nd = opt["network_G"], opt["network_D"]
    run.record["step_flop"] = esrgan.srragan_step_flop(
        bs, hr, opt["scale"], ng["nf"], ng["nb"], ng.get("gc", 32), nd["which_model_D"],
        nd["nf"])
    return {"model": model, "call": call, "to_host": to_host, "rows": rows, "step": step,
            "weights": weights, "banks": banks, "prog": prog, "opt": opt, "program": program}


def window(run, state):
    trainloop.window(run, state["call"], state["to_host"], state["rows"], state["step"],
                     run.config["opt"]["logger"]["print_freq"])
    program = state.get("program")
    if run.tracing and program is not None:
        run.record["phase_ms"] = program.phase_ms()


end_to_end = trainloop.end_to_end
quarters = trainloop.quarters


def check(run, state) -> dict:
    """The first calls' steps against the reference's, each step's batch
    drawn from its call's generator in turn, and D's running statistics
    after them (``bn_stats_gap``); the control computes the reference in
    float8 in the program's place."""
    opt, dev, prog = state["opt"], run.device, state["prog"]
    tr_opt = opt["datasets"]["train"]
    rows = prog["rows"]

    def batches():
        gens = sampling.call_generators(run.seed, prog["calls"], dev)
        return lambda i: esrgan.paired_batch(
            state["banks"], torch.as_tensor(rows[i], device=dev), next(gens),
            tr_opt["HR_size"], opt["scale"], tr_opt["use_flip"], tr_opt["use_rot"])

    with nets.f32_exact():
        ref = esrgan.srragan_steps(state["weights"], batches(), len(rows), opt)
        if run.control:
            prog = esrgan.srragan_steps(state["weights"], batches(), len(rows), opt,
                                        nets.PRECISIONS[run.control]())
            prog["losses"] = [prog["losses"][i] for i in state["prog"]["loss_steps"]]
    run.record["look"] = trainloop.look(prog, ref, state["prog"]["loss_steps"])
    numbers = compare.train_numbers(prog, ref)
    numbers["bn_stats_gap"] = bn_stats_gap(prog["bn"], ref["bn"])
    run.record["look"]["bn_updates"] = {"program": float(prog["bn"]["updates"]),
                                        "reference": float(ref["bn"]["updates"])}
    return numbers


def release(state) -> None:
    """Drop the program's objects; the benchmark's inputs stay."""
    for key in ("model", "call", "to_host"):
        state.pop(key, None)
