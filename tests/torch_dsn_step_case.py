"""Shared body of the port's DSN train-step trajectory tests: three steps of
``dasr_tpu_torch.train.dsn_trainer.DSNTrainer`` against
``dasr_tpu.train.dsn_trainer.DSNTrainer`` from one JAX init, f32 on the CPU,
at nb 2, HR 128 / LR 32 (alex LPIPS needs 32 px), FSD on the avg-pool
high-pass, on the same numpy batches (the check of
tests/test_dsn_step_oracle.py, with the port's modules in place of its
functional replicas)."""

import jax
import numpy as np
import torch

from dasr_tpu.train import checkpoints as jck
from dasr_tpu.train.dsn_trainer import DSNConfig as JConfig
from dasr_tpu.train.dsn_trainer import DSNTrainer as JTrainer
from dasr_tpu_torch.losses.lpips import LPIPS
from dasr_tpu_torch.train import checkpoints as ck
from dasr_tpu_torch.train.dsn_trainer import DSNConfig, DSNTrainer

NB, B, HR, LR = 2, 2, 128, 32
RTOL, ATOL, PARAM_ATOL = 2e-3, 2e-5, 2e-5
# Adam divides each gradient element by its own running RMS, so an element
# whose gradient is of the order of the two frameworks' rounding moves up to
# lr a step either way. Each network is therefore held by Adam's moments
# (linear in the gradients) in norm, and its params within PARAM_ATOL except
# a share of strays, none past 2 x 3 x lr (the most three steps can move two
# runs apart). G: moments 1e-3 (measured <= 4.5e-4), strays 1e-4 (two of a
# 64x64x3x3 kernel measured, 6.6e-5 off). D: the backward of a no-affine
# InstanceNorm subtracts means, so f32 rounding alone moves the gradients of
# the convs before one by ~5e-4 of their norm (f32 against f64, one D loss),
# and WGAN-GP's double backward goes through it twice: moments 5e-2
# (measured <= 2.5e-2), strays 2% (measured <= 0.77%).
LIMITS = {"G": (1e-3, 1e-4), "D": (5e-2, 2e-2)}
STRAY_ATOL = 2 * 3 * 1e-4
CANCELLED = {"net.net.2.bias", "net.net.5.bias"}


def batch(rng, uint8):
    if uint8:  # the --transfer_uint8 wire form, the bicubic computed in the step
        return {"input": rng.integers(0, 256, (B, HR, HR, 3), dtype=np.uint8),
                "disc": rng.integers(0, 256, (B, LR, LR, 3), dtype=np.uint8)}
    hr = rng.random((B, HR, HR, 3), dtype=np.float32)
    return {"input": hr, "bicubic": hr.reshape(B, LR, 4, LR, 4, 3).mean((2, 4)),
            "disc": rng.random((B, LR, LR, 3), dtype=np.float32)}


def to_torch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
            for k, v in b.items()}


def run_trajectory(rng, wgan: bool, uint8: bool):
    kw = dict(generator="DeResnet", discriminator="FSD", filter="avg_pool", w_tex=0.006,
              num_res_blocks=NB, wgan=wgan)
    jtr = JTrainer(JConfig(**kw))
    state = jtr.init_state(jax.random.key(0), lr_size=LR, hr_size=HR)
    np_tree = lambda t: jax.tree.map(np.asarray, jax.device_get(t))  # noqa: E731

    lpips = LPIPS()
    lpips.load_state_dict(ck.state_dict_from_jax(lpips, np_tree(jtr.lpips_variables)))
    tr = DSNTrainer(DSNConfig(**kw), lpips=lpips.requires_grad_(False))
    st = tr.init_state()
    st.g.net.load_state_dict(ck.deresnet_state_dict_from_jax(np_tree(state.g.params), NB))
    st.d_target.net.load_state_dict(ck.state_dict_from_jax(st.d_target.net,
                                                          np_tree(state.d_target.params)))

    for i in range(3):
        b = batch(rng, uint8)
        alpha = None
        if wgan:  # the JAX step's draws (dsn_trainer.py:251-255), passed in
            key = jax.random.fold_in(jax.random.key(0), int(state.step))
            alpha = torch.from_numpy(np.array(jax.random.uniform(key, (B, 1, 1, 1))))
        state, want = jtr.train_step(state, b)
        got = tr.train_step(to_torch(b), gp_alpha=alpha)
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k]), float(v), rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i}: {k}")
    assert st.step == 3

    export = {"G": lambda t: jck.export_deresnet_state_dict(np_tree(t), NB),
              "D": lambda t: jck.export_fsd_state_dict(np_tree(t))}
    for side, ns, jns in (("G", st.g, state.g), ("D", st.d_target, state.d_target)):
        ours, want = ns.net.state_dict(), export[side](jns.params)
        assert set(ours) == set(want), side
        adam = jns.opt_state[0]  # optax's scale_by_adam state
        moments = {"exp_avg": export[side](adam.mu), "exp_avg_sq": export[side](adam.nu)}
        params = dict(ns.net.named_parameters())
        moment_rtol, stray_share = LIMITS[side]
        for k in sorted(set(want) - CANCELLED):
            err = np.abs(ours[k].numpy() - want[k].numpy())
            stray = int((err > PARAM_ATOL).sum())
            assert stray <= err.size * stray_share and err.max() <= STRAY_ATOL, (
                f"{side} {k}: {stray} of {err.size} elements past {PARAM_ATOL}, "
                f"max |err| {err.max():.3e}")
            for name, theirs in moments.items():
                mo, mw = ns.opt.state[params[k]][name].numpy(), theirs[k].numpy()
                # (WGAN's head bias has a zero gradient: both moments are 0)
                assert np.linalg.norm(mo - mw) <= moment_rtol * np.linalg.norm(mw) + 1e-12, (
                    f"{side} {k} {name}: {np.linalg.norm(mo - mw):.3e} of "
                    f"{np.linalg.norm(mw):.3e}")
