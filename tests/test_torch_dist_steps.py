"""Data-parallel train steps of the port: two ranks of a gloo world on the
CPU (``core/dist.py``), each on its rows of the global batches, against one
process on the whole batches, three steps from one seeded init, f32
(``tests/torch_dist_case.py``): the DASR step (wavelet; RaGAN with the
source-domain D), the DSN step (vanilla; RaGAN with WGAN-GP), 'srragan'
with define_D's BatchNorm VGG D, the Adaptive step with its patch D's
optimizer, and a banked window, whose draws are the global row's.

The limits are the three-step cases' against JAX (tests/torch_srn_step_case.py,
torch_dsn_step_case.py, test_torch_srgan_steps.py, torch_adaptive_step_case.py):
losses rtol 2e-3 / atol 2e-5; D scores atol 1e-4, and under RaGAN both
carry the head bias's walk, their difference held at 1e-4; params within
2e-5 but for strays (G 1e-3 of its elements, a D 2e-2), none past 2 x 3 x
lr; the biases that a following norm cancels, and under RaGAN or WGAN the
head's bias, whose gradient is rounding noise that Adam walks by up to lr a
step, within 2 x 3 x lr; Adam's moments in norm, G 1e-3 and a D 5e-2
(the DSN case's, the InstanceNorm backward's rounding). Under srragan G's
gradient passes through D's BatchNorms and its conv biases walk, and G's
moments are held at 5e-2 too: one process on the same batches with the
ranks' halves swapped moves them by 1.8e-3, as two ranks do. BatchNorm's
running variance within 2e-5 and its running mean, which takes the walked
biases, within 2 x 3 x lr."""

import numpy as np
import pytest
import torch

import torch_dist_case as case
from dasr_tpu_torch.core import dist

RTOL, ATOL, PARAM_ATOL, SCORE_ATOL, STATS_ATOL = 2e-3, 2e-5, 2e-5, 1e-4, 2e-5
WALK = 2 * 3 * 1e-4
STRAY_SHARE = {"G": 1e-3}  # a discriminator: 2e-2
MOMENT_RTOL = {"G": 1e-3}  # a discriminator: 5e-2
NAMES = list(case.CASES) + ["banked"]
WALKING_HEAD = {"dasr_ragan_source", "dsn_ragan_wgan", "srragan_bn"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_ranks():
    """Every case in one spawn of two ranks; rank 1's results too."""
    return case.run_ranks(case.run_cases, 2, NAMES)


def _counterpart(k):
    return k.replace("real", "fake") if "real" in k else None


def _check_metrics(name, got, want):
    walk = WALK if name in WALKING_HEAD else 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (sorted(g), sorted(w))
        for k, v in w.items():
            rtol, atol = (RTOL, ATOL) if k.startswith("loss/") else (0, SCORE_ATOL + walk)
            np.testing.assert_allclose(g[k], v, rtol=rtol, atol=atol,
                                       err_msg=f"{name} step {i}: {k}")
            other = _counterpart(k)
            if not k.startswith("loss/") and other in w:
                np.testing.assert_allclose(g[k] - g[other], v - w[other], rtol=0,
                                           atol=SCORE_ATOL,
                                           err_msg=f"{name} step {i}: {k} - {other}")


def _check_net(name, side, got, want, cancelled):
    share = STRAY_SHARE.get(side, 2e-2)
    moment_rtol = 5e-2 if name == "srragan_bn" else MOMENT_RTOL.get(side, 5e-2)
    params = want["params"]
    head = [k for k in params if k.endswith("bias")][-1]
    for k, w in params.items():
        err = (got["params"][k] - w).abs()
        if k in cancelled or (side != "G" and k == head and name in WALKING_HEAD):
            assert float(err.max()) <= WALK, f"{name} {side} {k}: {float(err.max()):.3e}"
            continue
        stray = int((err > PARAM_ATOL).sum())
        assert stray <= err.numel() * share and float(err.max()) <= WALK, (
            f"{name} {side} {k}: {stray} of {err.numel()} past {PARAM_ATOL}, max "
            f"{float(err.max()):.3e}")
    for k, w in want["buffers"].items():
        g = got["buffers"][k]
        if k.endswith("num_batches_tracked"):
            assert torch.equal(g, w), k
            continue
        atol = WALK if k.endswith("running_mean") else STATS_ATOL
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=atol,
                                   err_msg=f"{name} {side} {k}")
    for k in ("exp_avg", "exp_avg_sq"):
        g, w = got[k], want[k]
        assert float((g - w).norm()) <= moment_rtol * float(w.norm()) + 1e-12, (
            f"{name} {side} {k}: {float((g - w).norm()):.3e} of {float(w.norm()):.3e}")


@pytest.mark.parametrize("name", NAMES)
def test_two_ranks_equal_one_rank_on_the_global_batch(two_ranks, name):
    want = case.run_case(name, dist.SINGLE)
    got = two_ranks[0][name]
    # the replicated state is equal on both ranks (run_case checks it there);
    # the metrics are the global batch's on both
    assert got["metrics"] == two_ranks[1][name]["metrics"]
    _check_metrics(name, got["metrics"], want["metrics"])
    assert set(got["nets"]) == set(want["nets"])
    for side in want["nets"]:
        _check_net(name, side, got["nets"][side], want["nets"][side], want["cancelled"][side])


def test_a_batch_the_world_does_not_divide_is_refused():
    """JAX shrinks its mesh to gcd(batch, devices); a world cannot shrink."""
    world = dist.World(rank=1, size=2)
    assert world.batch_slice(6) == slice(3, 6)
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        world.batch_slice(5)
