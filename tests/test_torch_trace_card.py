"""The device phases of a step replayed from a CUDA graph, on the card: a
graph captured with tracing on carries the five phase marks of the DASR
step (RRDBNet nf 32 nb 1 gc 32, LPIPS alex, HR 64, batch 4 + 4) and of the
DSN step (DeResnet nb 1, FSD, LPIPS alex, crop 128, batch 4), each replay
records them again, and the phases add up to the replay's own time, taken
by a pair of events around ``replay()`` (within 3%); a graph captured with
tracing off records none.

Imports neither jax nor the JAX package, so it runs where only the port is
installed, without the suite's conftest:

    python3 -m pytest --noconftest tests/test_torch_trace_card.py

Every test is marked ``cuda`` and skips without a card."""

import numpy as np
import pytest
import torch

from dasr_tpu_torch.core.device import resolve_device
from dasr_tpu_torch.data import device_bank as bank
from dasr_tpu_torch.train.dsn_trainer import DSNConfig, DSNTrainer
from dasr_tpu_torch.train.srn_trainer import SRNConfig, SRNTrainer
from dasr_tpu_torch.utils import trace

PHASES = ["batch", "g_forward", "g_backward", "d", "adam"]
K, B = 3, 4


def _bank(rng, n, hw, c=3, f32=False):
    data = (rng.random((n, *hw, c), dtype=np.float32) if f32
            else rng.integers(0, 256, (n, *hw, c)).astype(np.uint8))
    return bank.upload(bank.ImageBank(data, np.array([hw] * n, np.int32)), "cuda")


def _window(kind):
    """A trainer on the card and a call of one K-step banked window."""
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, 4, (K, B))).cuda()
    if kind == "dasr":
        banks = bank.SrnBanks(_bank(rng, 4, (20, 22)), _bank(rng, 4, (80, 88)),
                              _bank(rng, 4, (18, 17)), _bank(rng, 4, (20, 22), 1, f32=True))
        tr = SRNTrainer(SRNConfig(nf=32, nb=1, gc=32, d_nf=16, seed=5), "cuda")
        tr.init_state()
        return tr, lambda: tr.train_banked_step(banks, idx, 0, 64)
    clean, noisy = _bank(rng, 4, (140, 132)), _bank(rng, 4, (40, 44))
    tr = DSNTrainer(DSNConfig(num_res_blocks=1, filter="avg_pool", seed=3), "cuda")
    tr.init_state()
    return tr, lambda: tr.train_banked_step(clean, noisy, idx, 0, 128, True, True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dasr", "dsn"])
def test_replayed_phases_add_up_to_the_replay(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    resolve_device("cuda")
    tr, window = _window(kind)
    trace.enable()
    try:
        window()  # the warm-up, the capture, K - 1 replays
    finally:
        trace.disable()
        trace.drain()
    (graph,) = tr.graphs._graphs.values()
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        got, step_ms = trace.phase_ms(), a.elapsed_time(b)
        assert list(got) == PHASES and all(ms > 0 for ms in got.values()), got
        assert abs(sum(got.values()) - step_ms) <= 0.03 * step_ms, (got, step_ms)


@pytest.mark.cuda
def test_graph_captured_untraced_records_no_phases():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    resolve_device("cuda")
    trace.enable()
    trace.phase("marker")
    torch.cuda._sleep(100_000)
    trace.end_phases()
    trace.disable()
    torch.cuda.synchronize()
    marked = trace.phase_ms()
    tr, window = _window("dsn")
    window()  # the warm-up, the capture, replays: none re-records the events
    torch.cuda.synchronize()
    assert trace.phase_ms() == marked and marked["marker"] > 0
