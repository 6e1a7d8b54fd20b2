"""The banked train steps of the port on the CPU, held against the port's
own ``train_step`` (which tests/test_torch_srn_step_*.py and
tests/test_torch_dsn_step_*.py hold against JAX): a K = 2 window sampled on
the device equals two ``train_step`` calls on the batches the plain gather
gives for the same draws (f32; losses and params within 1e-6 relative), for
the DASR step (RRDBNet nf 16 nb 1) and the DSN step (DeResnet nb 1); and a
run resumed from a saved train state replays the same windows."""

import numpy as np
import pytest
import torch

from dasr_tpu_torch.data import device_bank as bank
from dasr_tpu_torch.train.checkpoints import load_train_state, save_train_state
from dasr_tpu_torch.train.dsn_trainer import DSNConfig, DSNTrainer
from dasr_tpu_torch.train.srn_trainer import SRNConfig, SRNTrainer

RTOL = 1e-6
HR_SIZE, SCALE = 32, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small ops: torch's intra-op threads only contend with the other
    test workers for the cores (as in tests/test_torch_dsn_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bank(rng, n, hw, c=3, f32=False):
    data = (rng.random((n, *hw, c), dtype=np.float32) if f32
            else rng.integers(0, 256, (n, *hw, c)).astype(np.uint8))
    return bank.ImageBank(torch.from_numpy(data), torch.tensor([hw] * n, dtype=torch.int32))


@pytest.fixture(scope="module")
def srn_banks():
    rng = np.random.default_rng(0)
    return bank.SrnBanks(_bank(rng, 3, (12, 14)), _bank(rng, 3, (48, 56)),
                         _bank(rng, 2, (10, 9)), _bank(rng, 3, (12, 14), 1, f32=True))


def _srn_trainer():
    tr = SRNTrainer(SRNConfig(nf=16, nb=1, gc=8, d_nf=16, d_n_layers=2, seed=5,
                              lr_steps=(1,)))
    tr.init_state()
    return tr


def _params(nets):
    return torch.cat([p.detach().flatten() for net in nets for p in net.parameters()])


def _assert_close(a, b):
    torch.testing.assert_close(a, b, rtol=RTOL, atol=RTOL * float(b.abs().max()))


def _nchw(batch):
    return {k: v.permute(0, 3, 1, 2) for k, v in batch.items()}


def test_srn_banked_window_equals_train_steps(srn_banks):
    idx = torch.tensor([[0, 2], [1, 1]])
    a, b = _srn_trainer(), _srn_trainer()
    got = a.train_banked_step(srn_banks, idx, 7, HR_SIZE)
    gen = bank.window_generator(b.cfg.seed, 7, "cpu")
    for row in idx:
        d = bank.draw_dasr(gen, 2, 2, 3)
        want = b.train_step(_nchw(bank.gather_dasr_plain(srn_banks, row, d, HR_SIZE, SCALE)))
    assert a.state.step == b.state.step == 2 and set(got) == set(want)
    for k in want:
        _assert_close(got[k], want[k])
    for na, nb in ((a.state.g.net, b.state.g.net), (a.state.d_target.net, b.state.d_target.net)):
        _assert_close(_params([na]), _params([nb]))


def test_dsn_banked_window_equals_train_steps():
    rng = np.random.default_rng(1)
    clean, noisy = _bank(rng, 3, (70, 66)), _bank(rng, 4, (20, 22))

    def trainer():
        tr = DSNTrainer(DSNConfig(num_res_blocks=1, use_per_loss=False, filter="avg_pool",
                                  seed=3))
        tr.init_state()
        return tr

    idx = torch.tensor([[3, 0], [1, 2]])
    a, b = trainer(), trainer()
    got = a.train_banked_step(clean, noisy, idx, 4, 64, flips=True, rotations=True)
    gen = bank.window_generator(b.cfg.seed, 4, "cpu")
    for row in idx:
        d = bank.draw_dsn(gen, 2, 3)
        want = b.train_step(_nchw(bank.gather_dsn_plain(clean, noisy, row, d, 64, 4, True, True)))
    assert a.state.step == b.state.step == 2 and set(got) == set(want)
    for k in want:
        _assert_close(got[k], want[k])
    _assert_close(_params([a.g_model, a.d_model]), _params([b.g_model, b.d_model]))


def test_srn_resume_replays_the_windows(srn_banks, tmp_path):
    """Two windows straight, against one window, a save, a fresh trainer
    loading it, and the second window from the same iteration."""
    windows = [(0, torch.tensor([[0, 1], [2, 0]])), (2, torch.tensor([[1, 2], [0, 0]]))]
    straight = _srn_trainer()
    for start, idx in windows:
        straight.train_banked_step(srn_banks, idx, start, HR_SIZE)
    first = _srn_trainer()
    first.train_banked_step(srn_banks, windows[0][1], 0, HR_SIZE)
    path = save_train_state(str(tmp_path), first.state, 2)
    resumed = SRNTrainer(SRNConfig(nf=16, nb=1, gc=8, d_nf=16, d_n_layers=2, seed=5,
                                   lr_steps=(1,)))
    resumed.init_state(seed=99)
    assert load_train_state(path, resumed.state) == 2
    got = resumed.train_banked_step(srn_banks, windows[1][1], 2, HR_SIZE)
    assert resumed.state.step == straight.state.step == 4
    for s, r in ((straight.state.g, resumed.state.g),
                 (straight.state.d_target, resumed.state.d_target)):
        assert torch.equal(_params([s.net]), _params([r.net]))
    assert torch.isfinite(torch.stack(list(got.values()))).all()
