"""The DASR Adaptive model's device-bank window on the CPU: with no DDM bank
(the 'LRHR_unpair' mode), the port's gather on the draws of JAX's
``sample_dasr_batch`` with ``ddm_bank=None`` equals JAX's batch bit for
bit; a K = 2 window of the Adaptive trainer equals two ``train_step`` calls
on the plain gather's batches of the same draws (f32, 1e-6 relative, as
tests/test_torch_banked_step.py holds the DASR window)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.data import device_bank as jbank
from dasr_tpu_torch.data import device_bank as bank
from test_torch_banked_step import _assert_close, _bank, _nchw, _params
from test_torch_device_bank import _jax_bank, _jax_dasr_draws
from torch_adaptive_step_case import port_trainer

HR_SIZE, SCALE = 32, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small ops: torch's intra-op threads only contend with the other
    test workers for the cores (as in tests/test_torch_dsn_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def banks():
    rng = np.random.default_rng(2)
    return bank.SrnBanks(_bank(rng, 3, (12, 14)), _bank(rng, 3, (48, 56)), _bank(rng, 2, (10, 9)),
                         None)


@pytest.mark.parametrize("flags", [(True, True), (False, False)], ids=["flip_rot", "none"])
def test_gather_without_a_ddm_bank_equals_jax(banks, flags):
    idx = np.array([0, 2, 1], np.int32)
    key = jax.random.key(4)
    want = jbank.sample_dasr_batch(*(_jax_bank(b) for b in banks[:3]), None, jnp.asarray(idx),
                                   key, HR_SIZE, SCALE, *flags)
    draws = _jax_dasr_draws(key, len(idx), 2, 3)
    got = bank.gather_dasr(banks, torch.from_numpy(idx), draws, HR_SIZE, SCALE, *flags)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    assert bool((got["fake_w"] == 1).all())


def test_adaptive_banked_window_equals_train_steps(banks):
    def trainer():
        tr = port_trainer(dict(nf=16, nb=1, gc=8, d_nf=16, d_n_layers=2, seed=5,
                               lr_steps=(1,), use_patchD_opt=True), concat=False)
        tr.init_state()
        return tr

    idx = torch.tensor([[0, 2], [1, 1]])
    a, b = trainer(), trainer()
    got = a.train_banked_step(banks, idx, 7, HR_SIZE)
    gen = bank.window_generator(b.cfg.seed, 7, "cpu")
    for row in idx:
        d = bank.draw_dasr(gen, 2, 2, 3)
        batch = bank.gather_dasr_plain(banks, row, d, HR_SIZE, SCALE)
        want = b.train_step(_nchw({k: v for k, v in batch.items() if k != "fake_w"}))
    assert a.state.step == b.state.step == 2 and set(got) == set(want)
    assert "loss/patch_D_gan_loss" in got
    for k in want:
        _assert_close(got[k], want[k])
    for na, nb in ((a.state.g.net, b.state.g.net), (a.state.d_target.net, b.state.d_target.net),
                   (a.state.patchd.net, b.state.patchd.net)):
        _assert_close(_params([na]), _params([nb]))
