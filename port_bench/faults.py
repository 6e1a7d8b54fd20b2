"""Faults planted under the timed path, so that a test (or a reading of
the limits on the card) can see the comparison fail. A run plants
``run.fault`` after set-up has built the program's objects and before the
first step or image; ``run.exit`` undoes it when the run ends.

* ``unchanged``: every network update does nothing (a step that returns
  its state unchanged);
* ``half_batch``: each banked step trains on the first half of its batch
  (the losses are means over the rest);
* ``reused_draws``: every step of a K-step call takes the call's first
  step's draws (crop offsets, picks, augments) again;
* ``altered``: every output of the generator in a served image has an
  8x8 block at its centre set to 0 (where a tile's output is kept).
"""

from __future__ import annotations

from unittest import mock

FAULTS = ("unchanged", "half_batch", "reused_draws", "altered")


def _half(gather):
    def wrapped(*args, **kwargs):
        batch = gather(*args, **kwargs)
        return {k: v[: v.shape[0] // 2] for k, v in batch.items()}

    return wrapped


def _reused(draw):
    first = {}

    def wrapped(gen, *args, **kwargs):
        if gen not in first:
            first[gen] = draw(gen, *args, **kwargs)
        return first[gen]

    return wrapped


def plant(run, program) -> None:
    from dasr_tpu_torch.train import dsn_trainer, srn_trainer, state

    if run.fault == "unchanged":
        run.exit.enter_context(mock.patch.object(state.NetState, "update",
                                                 lambda self, grads: None))
    elif run.fault == "half_batch":
        run.exit.enter_context(mock.patch.object(srn_trainer, "gather_dasr",
                                                 _half(srn_trainer.gather_dasr)))
        run.exit.enter_context(mock.patch.object(dsn_trainer, "gather_dsn",
                                                 _half(dsn_trainer.gather_dsn)))
    elif run.fault == "reused_draws":
        run.exit.enter_context(mock.patch.object(srn_trainer, "draw_dasr",
                                                 _reused(srn_trainer.draw_dasr)))
        run.exit.enter_context(mock.patch.object(dsn_trainer, "draw_dsn",
                                                 _reused(dsn_trainer.draw_dsn)))
    elif run.fault == "altered":
        apply_g = program._apply_g

        def altered(x):
            out = apply_g(x)
            h, w = out.shape[-2] // 2, out.shape[-1] // 2
            out[..., h:h + 8, w:w + 8] = 0
            return out

        run.exit.enter_context(mock.patch.object(program, "_apply_g", altered))
    else:
        raise ValueError(f"unknown fault {run.fault!r}: {', '.join(FAULTS)}")
