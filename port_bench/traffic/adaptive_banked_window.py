"""Traffic kind ``adaptive_banked_window``: the DASR Adaptive model's
training on banks resident on the card, K steps a call, the domain-distance
map computed in every step by the patch D.

Set-up builds the model as ``srn_train`` does (``create_model`` of the
configuration's options, ``init``), draws every weight on the card from
the seed (G, the NLayer D, the patch D, LPIPS), and makes the three banks
there (fake LR, HR, real LR; the counts and sizes of ``params['banks']``;
``harness.images_u8``), with no DDM bank. It puts them where
``DASRModel.setup_device_bank`` puts the banks it uploads, and calls
``DASRModel.train_banked_window_async`` as ``srn_train --device_bank
--steps_per_call K`` does: index rows of a seeded epoch order, the window's
first iteration, the metrics read one window late. The first calls
(``checked_calls``: one row, then a whole window of K rows) are compared
with the reference (``reference/adaptive.py``); one K-step window warms up;
the measured window follows.

In a traced run the program's recorder (``dasr_tpu_torch/utils/trace.py``)
is on from before set-up, so the step is captured with its device phase
marks, and the traced window's record holds the phases of its last step
(``phase_ms``); a program without the recorder leaves it out.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from port_bench import compare, harness, trainloop
from port_bench.reference import adaptive, nets, sampling

BANKS = ("fake", "hr", "real")


def _program_trace():
    """The program's recorder, or None where the program has none."""
    try:
        from dasr_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def _spec(opt):
    ng, nd = opt["network_G"], opt["network_D"]
    return {"G": adaptive.rrdbnet_residual_conv_spec(ng["nf"], ng["nb"], ng["gc"], ng["ada_nb"],
                                                     ng["in_nc"], ng["out_nc"]),
            "D": nets.nlayer_spec(nd["in_nc"], nd["nf"], nd["n_layers"]),
            "PatchD": nets.fsd_spec(),
            "LPIPS": nets.lpips_spec()}


def setup(run):
    from dasr_tpu_torch.data.device_bank import ImageBank, SrnBanks
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
    trains_pd = bool(opt["train"].get("use_patchD_opt", False))

    model = create_model(opt, dev).init(run.seed)
    tr = model.trainer
    weights = {n: harness.draw_params(s, run.seed, n, dev) for n, s in _spec(opt).items()}
    harness.load_params(tr.state.g.net, weights["G"], "G")
    harness.load_params(tr.state.d_target.net, weights["D"], "D_target")
    harness.load_params(tr.state.patchd.net, weights["PatchD"], "PatchD")
    harness.load_params(tr.lpips, weights["LPIPS"], "LPIPS")

    banks = {}
    for name in BANKS:
        n, h, w, c = p["banks"][name]
        data = harness.images_u8((n, h, w, c), run.seed, name, dev)
        banks[name] = (data, torch.tensor([[h, w]] * n, dtype=torch.int32, device=dev))
    # what setup_device_bank leaves after its upload
    if not model.supports_multi_step:
        raise ValueError("the banked window needs G_update_inter == D_update_inter == 1")
    model._banks = SrnBanks(*(ImageBank(*banks[n]) for n in BANKS), None)
    model._bank_args = (hr, flip, rot)

    rows = trainloop.rows_from(run.seed, p["banks"]["fake"][0], bs)
    tr_cfg = opt["train"]
    call, to_host = model.train_banked_window_async, model.metrics_to_host
    if run.fault:
        from port_bench import faults

        faults.plant(run, model)
    held = {"G": tr.state.g, "D": tr.state.d_target}
    betas = {"G": tr_cfg["beta1_G"], "D": tr_cfg["beta1_D"]}
    if trains_pd:
        held["PatchD"], betas["PatchD"] = tr.state.patchd, tr_cfg["beta1_D"]
    prog = trainloop.checked_calls(run, call, to_host, rows, held, betas,
                                   {n: weights[n] for n in held})
    step = sum(p["checked_calls"])
    to_host(call(np.stack([next(rows) for _ in range(p["steps_per_call"])]), step))
    step += p["steps_per_call"]
    harness.sync(dev)
    ng, nd = opt["network_G"], opt["network_D"]
    run.record["step_flop"] = adaptive.adaptive_step_flop(
        bs, hr, opt["scale"], ng["nf"], ng["nb"], ng["gc"], ng["ada_nb"], nd["nf"],
        nd["n_layers"], trains_pd)
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
    drawn from its call's generator in turn; the control computes the
    reference in float8 in the program's place."""
    opt, dev, prog = state["opt"], run.device, state["prog"]
    tr_opt = opt["datasets"]["train"]
    rows = prog["rows"]

    def batches():
        gens = sampling.call_generators(run.seed, prog["calls"], dev)
        return lambda i: adaptive.adaptive_batch(
            state["banks"], torch.as_tensor(rows[i], device=dev), next(gens),
            tr_opt["HR_size"], opt["scale"], tr_opt["use_flip"], tr_opt["use_rot"])

    with nets.f32_exact():
        ref = adaptive.adaptive_steps(state["weights"], batches(), len(rows), opt)
        if run.control:
            prog = adaptive.adaptive_steps(state["weights"], batches(), len(rows), opt,
                                           nets.PRECISIONS[run.control]())
            prog["losses"] = [prog["losses"][i] for i in state["prog"]["loss_steps"]]
    run.record["look"] = trainloop.look(prog, ref, state["prog"]["loss_steps"])
    return compare.train_numbers(prog, ref)


def release(state) -> None:
    """Drop the program's objects; the benchmark's inputs stay."""
    for key in ("model", "call", "to_host"):
        state.pop(key, None)
