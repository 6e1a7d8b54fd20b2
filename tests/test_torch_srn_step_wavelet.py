"""The port's DASR train step against the JAX SRNTrainer, fs wavelet (the
shipped auto-reproduce configuration): three steps, losses within rtol 2e-3
and atol 2e-5, updated G and D params within atol 2e-5, f32 on the CPU."""

import pytest

from torch_srn_step_case import run_trajectory


@pytest.mark.parametrize("ragan", [False, True])
def test_three_step_trajectory_matches_jax(rng, ragan):
    run_trajectory(rng, "wavelet", ragan)
