"""Three 'De_patch_wavelet_GAN' steps of the port against dasr_tpu's, f32 on
the CPU.

``dasr_tpu_torch.train.depatch_trainer.DePatchTrainer`` runs against
``dasr_tpu.train.depatch_trainer.DePatchTrainer``, which is handed JAX's
``DeResnetSRN`` of the same ``define_G`` config through ``g_model=``; the
port's G is its ``define_G``'s, D the FSD on the 9 Haar high bands, both
carried over from JAX's init with ``state_dict_from_jax``, and LPIPS alex
with JAX's weights. nb 2 at HR 128, so that LPIPS sees 32 px; the same
numpy batches, ``ref`` at LR size. Losses within 2e-5 + 2e-3 rel; after
three steps G's params within 2e-5, and D's but for two kinds of element.
D's two biases before its no-affine InstanceNorms have a true gradient of
zero: they are pinned near zero, as tests/test_misc_step_oracles.py does.
And the InstanceNorm backward subtracts means, so f32 rounding puts D's
gradients ~7e-4 apart in norm (one torch thread; tests/torch_dsn_step_case.py
finds the same in the DSN step), and Adam, which divides each element by
its own RMS, can move an element whose gradient is that small up to lr a
step either way: D is held by its Adam first moments in norm
(``D_MOMENT_RTOL``) and its params within 2e-5 but for at most
``STRAY_SHARE`` of a tensor, none past 2 x 3 x lr (measured: 2 of the
819200 elements of ``net.net.5.weight``, 3.6e-5 and 2.7e-5 off). Then
``realness_map`` of an LR image within 1e-5 of JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.models import registry as jreg
from dasr_tpu.train.depatch_trainer import DePatchConfig as JConfig
from dasr_tpu.train.depatch_trainer import DePatchTrainer as JTrainer
from dasr_tpu_torch.losses.lpips import LPIPS
from dasr_tpu_torch.models import registry
from dasr_tpu_torch.train import checkpoints as ck
from dasr_tpu_torch.train.depatch_trainer import DePatchConfig, DePatchTrainer, realness_map

NB, NF, B, HR, LR = 2, 16, 2, 128, 32
RTOL, ATOL, PARAM_ATOL, MAP_ATOL = 2e-3, 2e-5, 2e-5, 1e-5
CANCELLED = {"net.net.2.bias", "net.net.5.bias"}
D_MOMENT_RTOL, STRAY_SHARE, STRAY_ATOL = 5e-3, 1e-5, 2 * 3 * 1e-4
OPT = {"scale": 4, "bf16": False,
       "network_G": {"which_model_G": "De_Resnet", "nf": NF, "nb": NB, "norm_type": None,
                     "mode": "CNA"}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(t):
    return jax.tree.map(np.asarray, jax.device_get(t))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def test_three_steps_match_jax():
    rng = np.random.default_rng(5)
    jtr = JTrainer(JConfig(nb=NB), g_model=jreg.define_G(OPT))
    state = jtr.init_state(jax.random.key(0), hr_size=HR)
    lpips = LPIPS()
    lpips.load_state_dict(ck.state_dict_from_jax(lpips, np_tree(jtr.lpips_variables)))
    tr = DePatchTrainer(DePatchConfig(), registry.define_G(OPT), lpips=lpips.requires_grad_(False))
    st = tr.init_state()
    for ns, params in ((st.g, state.g.params), (st.d_target, state.d_target.params)):
        ns.net.load_state_dict(ck.state_dict_from_jax(ns.net, np_tree(params)), strict=True)

    for i in range(3):
        b = {"HR": rng.random((B, HR, HR, 3), dtype=np.float32),
             "LR": rng.random((B, LR, LR, 3), dtype=np.float32),
             "ref": rng.random((B, LR, LR, 3), dtype=np.float32)}
        state, want = jtr.train_step(state, b)
        got = tr.train_step({k: _nchw(v) for k, v in b.items()})
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k]), float(v), rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i}: {k}")
    assert st.step == 3

    for side, ns, jns in (("G", st.g, state.g), ("D", st.d_target, state.d_target)):
        want = ck.state_dict_from_jax(ns.net, np_tree(jns.params))
        ours = ns.net.state_dict()
        assert set(ours) == set(want), side
        if side == "G":
            for k in want:
                np.testing.assert_allclose(ours[k].numpy(), want[k].numpy(), atol=PARAM_ATOL,
                                           rtol=0, err_msg=f"G {k}")
            continue
        mu = ck.state_dict_from_jax(ns.net, np_tree(jns.opt_state[0].mu))
        params = dict(ns.net.named_parameters())
        for k in sorted(set(want) - CANCELLED):
            err = np.abs(ours[k].numpy() - want[k].numpy())
            stray = int((err > PARAM_ATOL).sum())
            assert stray <= err.size * STRAY_SHARE and err.max() <= STRAY_ATOL, (
                f"D {k}: {stray} of {err.size} elements past {PARAM_ATOL}, max {err.max():.3e}")
            m = ns.opt.state[params[k]]["exp_avg"]
            assert (m - mu[k]).norm() <= D_MOMENT_RTOL * mu[k].norm(), k
        for k in CANCELLED:
            assert max(float(ours[k].abs().max()), float(want[k].abs().max())) < 1e-3, k

    lr = rng.random((1, 36, 44, 3), dtype=np.float32)
    want = np.asarray(jtr.realness_map(state.d_target.params, jnp.asarray(lr)))
    got = realness_map(st.d_target.net, _nchw(lr)).numpy()
    assert got.shape == want.shape == (1, 18, 22)
    np.testing.assert_allclose(got, want, atol=MAP_ATOL, rtol=0)
