"""The port's recorder (``dasr_tpu_torch/utils/trace.py``) on the CPU: off,
``span`` is one shared null context and records nothing; nested spans carry
their parent and id, and ``drain`` empties the list; counters add up; a
span holds the kineto interval of a ``record_function`` block inside it
(one clock); phase marks come back in the order they were made, from a
hand-made sequence and from the DSN step; and the serving facade's spans
(with G's switches into eval mode and back) and pixel counters, where a
chopped 678 x 1020 image forwards 48 tiles of 160 x 160 (1.7769 times its
pixels)."""

import time

import numpy as np
import pytest
import torch

from dasr_tpu_torch.data import device_bank as bank
from dasr_tpu_torch.models.registry import create_model
from dasr_tpu_torch.ops.rdb import fused_rdb
from dasr_tpu_torch.train.dsn_trainer import DSNConfig, DSNTrainer
from dasr_tpu_torch.utils import trace

PHASES = ["batch", "g_forward", "g_backward", "d", "adam"]


@pytest.fixture
def tracing():
    """The recorder on for one test, from an empty list; off after it."""
    trace.drain()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.drain()


def test_off_span_is_the_shared_null_context():
    trace.drain()
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b", 3)
    with trace.span("a", 1):
        trace.phase("p")
    trace.end_phases()
    assert trace.drain() == []


def test_nested_spans_carry_parent_and_id(tracing):
    with trace.span("outer", 7):
        with trace.span("inner", 7):
            pass
        with trace.span("inner"):
            pass
    spans = trace.drain()
    assert [(s.name, s.parent, s.id) for s in spans] == [
        ("inner", "outer", 7), ("inner", "outer", None), ("outer", None, 7)]
    outer = spans[-1]
    assert all(outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns for s in spans[:2])
    assert trace.drain() == []


def test_counters_add_up():
    base = trace.counters()
    assert trace.count("test.things") == base.get("test.things", 0) + 1
    assert trace.count("test.things", 4) == base.get("test.things", 0) + 5
    fused_rdb.launches += 2
    fused_rdb.backward_launches += 8
    fused_rdb.bwd_kernel += 1
    try:
        got = trace.counters()
        assert got["test.things"] - base.get("test.things", 0) == 5
        assert got["fused_rdb.launches"] == base["fused_rdb.launches"] + 2
        assert got["fused_rdb.launches_f32"] == base["fused_rdb.launches_f32"]
        assert got["fused_rdb.backward_launches"] == base["fused_rdb.backward_launches"] + 8
        assert got["fused_rdb.bwd_kernel"] == base["fused_rdb.bwd_kernel"] + 1
        assert got["fused_rdb.bwd_chain"] == base["fused_rdb.bwd_chain"]
    finally:
        fused_rdb.launches -= 2
        fused_rdb.backward_launches -= 8
        fused_rdb.bwd_kernel -= 1


def test_span_holds_its_record_function_block(tracing):
    """The profiler's kineto events and the spans share one clock: the
    block's interval lies inside the span around it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            time.sleep(0.002)
            with record_function("test.block"):
                torch.ones(64).sum()
            time.sleep(0.002)
    (s,) = trace.drain()
    (e,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "test.block"]
    assert s.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= s.end_ns


def test_phase_marks_come_back_in_order(tracing):
    for name in ("a", "b", "a2"):
        trace.phase(name)
        time.sleep(0.001)
    trace.end_phases()
    got = trace.phase_ms()
    assert list(got) == ["a", "b", "a2"] and all(ms >= 1.0 for ms in got.values())
    # with tracing off a step marks nothing: the last recorded step stays
    trace.disable()
    trace.phase("c")
    trace.end_phases()
    assert list(trace.phase_ms()) == ["a", "b", "a2"]


def test_dsn_step_marks_its_five_phases(tracing):
    """The DSN banked step (eager on the CPU) marks the same five phases as
    the replayed one."""
    rng = np.random.default_rng(1)

    def mk(n, hw):
        data = rng.integers(0, 256, (n, *hw, 3)).astype(np.uint8)
        return bank.ImageBank(torch.from_numpy(data), torch.tensor([hw] * n, dtype=torch.int32))

    tr = DSNTrainer(DSNConfig(num_res_blocks=1, use_per_loss=False, filter="avg_pool", seed=3))
    tr.init_state()
    tr.train_banked_step(mk(3, (70, 66)), mk(4, (20, 22)), torch.tensor([[0, 1]]), 0, 64)
    got = trace.phase_ms()
    assert list(got) == PHASES and all(ms > 0 for ms in got.values())


class _Upscale(torch.nn.Module):
    """A stand-in x4 generator: each image's mean, broadcast (a view) to four
    times its size, so a large chopped forward costs no memory."""

    def forward(self, x):
        n, c, h, w = x.shape
        return x.mean((2, 3), keepdim=True).expand(n, c, 4 * h, 4 * w)


def _facade(chop):
    opt = {"model": "DASR", "is_train": False, "scale": 4, "chop": chop, "val_lpips": False,
           "network_G": {"which_model_G": "RRDB_net", "norm_type": None, "mode": "CNA",
                         "nf": 4, "nb": 1, "in_nc": 3, "out_nc": 3, "gc": 4}}
    model = create_model(opt, torch.device("cpu"))
    model.g = _Upscale()
    return model


@pytest.mark.parametrize("hw, chop, tiles", [((20, 28), False, None),
                                             ((678, 1020), True, 48)])
def test_serving_spans_and_pixel_counters(tracing, hw, chop, tiles):
    model = _facade(chop)
    base = trace.counters()
    lr = np.random.default_rng(0).integers(0, 256, (*hw, 3)).astype(np.uint8)
    out = model.test_async(lr)
    assert tuple(out.shape) == (4 * hw[0], 4 * hw[1], 3)
    got = {k: v - base.get(k, 0) for k, v in trace.counters().items()}
    n = trace.counters()["serve.images"]
    assert got["serve.images"] == 1 and got["serve.image_lr_px"] == hw[0] * hw[1]
    drained = trace.drain()
    spans = {s.name: s for s in drained}
    assert {"serve.upload", "serve.forward", "serve.crop"} <= set(spans)
    # G into eval mode and back, each walking its modules
    assert [s.parent for s in drained if s.name == "serve.eval_mode"] == [None, None]
    assert all(spans[k].id == n for k in ("serve.upload", "serve.forward", "serve.crop"))
    if tiles is None:
        assert "serve.tiles" not in spans and spans["serve.forward"].parent is None
        assert got["serve.tile_lr_px"] == hw[0] * hw[1]
    else:
        # 128-px tiles with a 16-px halo over 768 x 1024: 6 x 8 tiles of 160
        assert spans["serve.forward"].parent == "serve.tiles"
        assert got["serve.tile_lr_px"] == tiles * 160 * 160
        assert got["serve.tile_lr_px"] / got["serve.image_lr_px"] == pytest.approx(1.7769,
                                                                                 abs=5e-5)
