"""Three DASR Adaptive steps of the port against dasr_tpu's trainer, with
the RRDB_Residual_conv generator, the patch D frozen and trained
(tests/torch_adaptive_step_case.py)."""

import pytest

from torch_adaptive_step_case import run_trajectory


@pytest.mark.parametrize("use_patchd_opt", [False, True])
def test_adaptive_resconv_trajectory_matches_jax(rng, use_patchd_opt):
    run_trajectory(rng, concat=False, use_patchd_opt=use_patchd_opt)
