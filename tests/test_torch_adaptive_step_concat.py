"""Three DASR Adaptive steps of the port against dasr_tpu's trainer, with
the RRDB_Residual_conv_concat generator and a frozen patch D
(tests/torch_adaptive_step_case.py)."""

from torch_adaptive_step_case import run_trajectory


def test_adaptive_concat_trajectory_matches_jax(rng):
    run_trajectory(rng, concat=True, use_patchd_opt=False)
