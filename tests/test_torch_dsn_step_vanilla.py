"""The port's DSN train step against the JAX DSNTrainer, the vanilla GAN on
uint8 batches with the bicubic computed in the step (the launcher's
``--transfer_uint8 --device_bicubic`` path). Three steps, losses within
rtol 2e-3 and atol 2e-5, updated params within atol 2e-5 (Adam's
strays aside, see torch_dsn_step_case.py), f32 on the CPU."""

from torch_dsn_step_case import run_trajectory


def test_three_step_trajectory_matches_jax(rng):
    run_trajectory(rng, wgan=False, uint8=True)
