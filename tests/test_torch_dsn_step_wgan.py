"""The port's DSN train step against the JAX DSNTrainer, WGAN-GP with the
JAX step's interpolation draws passed in, on f32 batches that carry their
bicubic. Three steps, losses within rtol 2e-3 and atol 2e-5, updated params
within atol 2e-5, f32 on the CPU."""

from torch_dsn_step_case import run_trajectory


def test_three_step_trajectory_matches_jax(rng):
    run_trajectory(rng, wgan=True, uint8=False)
