"""Traffic kind ``dsn_banked_window``: DSN's stage-1 training on banks
resident on the card, K steps a call.

Set-up builds the trainer as ``dsn_train`` does (``make_trainer`` of the
launcher's flags in the configuration, ``init_state``), draws every
weight on the card from the seed, and makes the clean (HR) and noisy (LR)
banks there (the counts and sizes of ``params['banks']``,
``harness.images_u8``).
It calls ``DSNTrainer.train_banked_step`` as ``dsn_train --device_bank``
does (K steps a call, K 1 by default): index rows of a seeded epoch
order, the window's first iteration, the metrics read one window late at
the CLI's 50-step boundaries. The first calls (``checked_calls``) are
compared with the reference; one K-step window warms up; the measured
window follows.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench import compare, harness, trainloop
from port_bench.reference import costs, nets, sampling, steps

LOG_EVERY = 50  # dsn_train reads a window's metrics at these boundaries


def _argv(args: dict):
    out = []
    for k, v in args.items():
        if isinstance(v, bool):
            out += [f"--{k}"] if v else []
        else:
            out += [f"--{k}", str(v)]
    return out


def setup(run):
    from dasr_tpu_torch.cli import dsn_train
    from dasr_tpu_torch.data.device_bank import ImageBank

    p, dev = run.params, run.device
    args = dict(run.config["args"], seed=run.seed)
    opt = dsn_train.build_argparser().parse_args(_argv(args))
    crop = opt.crop_size - opt.crop_size % opt.upscale_factor
    banks = {}
    for name in ("clean", "noisy"):
        n, h, w, c = p["banks"][name]
        banks[name] = (harness.images_u8((n, h, w, c), run.seed, name, dev),
                       torch.tensor([[h, w]] * n, dtype=torch.int32, device=dev))
    n_noisy = p["banks"]["noisy"][0]
    trainer = dsn_train.make_trainer(opt, dev, steps_per_epoch=n_noisy // opt.batch_size)
    st = trainer.init_state()
    weights = {"G": harness.draw_params(nets.deresnet_spec(opt.num_res_blocks,
                                                           scale=opt.upscale_factor),
                                        run.seed, "G", dev),
               "D": harness.draw_params(nets.fsd_spec(), run.seed, "D", dev),
               "LPIPS": harness.draw_params(nets.lpips_spec(), run.seed, "LPIPS", dev)}
    harness.load_params(st.g.net, weights["G"], "G")
    harness.load_params(st.d_target.net, weights["D"], "D")
    harness.load_params(trainer.lpips, weights["LPIPS"], "LPIPS")
    clean, noisy = ImageBank(*banks["clean"]), ImageBank(*banks["noisy"])

    def call(rows_k, start):
        idx = torch.from_numpy(np.stack(rows_k).astype(np.int64)).to(dev)
        return trainer.train_banked_step(clean, noisy, idx, start, crop, opt.flips,
                                         opt.rotations)

    def to_host(metrics):
        return dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))

    if run.fault:
        from port_bench import faults

        faults.plant(run, trainer)
    rows = trainloop.rows_from(run.seed, n_noisy, opt.batch_size)
    prog = trainloop.checked_calls(run, call, to_host, rows, {"G": st.g, "D": st.d_target},
                                   {"G": opt.adam_beta_1, "D": opt.adam_beta_1},
                                   {"G": weights["G"], "D": weights["D"]})
    step = sum(p["checked_calls"])
    to_host(call(np.stack([next(rows) for _ in range(p["steps_per_call"])]), step))
    step += p["steps_per_call"]
    harness.sync(dev)
    run.record["step_flop"] = costs.dsn_step_flop(opt.batch_size, crop, opt.num_res_blocks,
                                                  opt.upscale_factor)
    return {"trainer": trainer, "call": call, "to_host": to_host, "rows": rows, "step": step,
            "weights": weights, "banks": banks, "prog": prog, "args": vars(opt), "crop": crop}


def window(run, state):
    trainloop.window(run, state["call"], state["to_host"], state["rows"], state["step"],
                     LOG_EVERY)


end_to_end = trainloop.end_to_end
quarters = trainloop.quarters


def check(run, state) -> dict:
    """The first calls' steps against the reference's, each step's batch
    drawn from its call's generator in turn; the control computes the
    reference in float8 in the program's place."""
    a, dev, prog = state["args"], run.device, state["prog"]
    rows = prog["rows"]

    def batches():
        gens = sampling.call_generators(run.seed, prog["calls"], dev)
        return lambda i: sampling.dsn_batch(
            state["banks"]["clean"], state["banks"]["noisy"],
            torch.as_tensor(rows[i], device=dev), next(gens), state["crop"],
            a["upscale_factor"], a["flips"], a["rotations"])

    with nets.f32_exact():
        ref = steps.dsn_steps(state["weights"], batches(), len(rows), a)
        if run.control:
            prog = steps.dsn_steps(state["weights"], batches(), len(rows), a,
                                   nets.PRECISIONS[run.control]())
            prog["losses"] = [prog["losses"][i] for i in state["prog"]["loss_steps"]]
    run.record["look"] = trainloop.look(prog, ref, state["prog"]["loss_steps"])
    return compare.train_numbers(prog, ref)


def release(state) -> None:
    """Drop the program's objects; the benchmark's inputs stay."""
    for key in ("trainer", "call", "to_host"):
        state.pop(key, None)
