"""The port's DASR train step against the JAX SRNTrainer, fs gau (the shipped
``configs/train/train_DASR.json`` filter), with and without RaGAN; the
RaGAN case also trains the source-domain D. Three steps, losses within
rtol 2e-3 and atol 2e-5, updated params within atol 2e-5, f32 on the CPU."""

import pytest

from torch_srn_step_case import run_trajectory


@pytest.mark.parametrize("ragan", [False, True])
def test_three_step_trajectory_matches_jax(rng, ragan):
    run_trajectory(rng, "gau", ragan, gan_h_source=0.005 if ragan else 0.0)
