"""Shared body of the port's DASR Adaptive train-step trajectory tests: three
steps of ``dasr_tpu_torch.train.dasr_adaptive_trainer.DASRAdaptiveTrainer``
against ``dasr_tpu.train.dasr_adaptive_trainer.DASRAdaptiveTrainer`` from one
JAX init carried across (G, D_target, the patch D, LPIPS), f32 on the CPU,
on the same numpy batches; the limits of tests/torch_srn_step_case.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dasr_tpu.losses.gan import dsn_discriminator_loss as jdsn_loss
from dasr_tpu.train.dasr_adaptive_trainer import AdaptiveConfig as JConfig
from dasr_tpu.train.dasr_adaptive_trainer import DASRAdaptiveTrainer as JTrainer
from dasr_tpu_torch.losses.lpips import LPIPS
from dasr_tpu_torch.nn.discriminators import FSDiscriminator
from dasr_tpu_torch.nn.generators import RRDBNetResidualConv
from dasr_tpu_torch.train import checkpoints as ck
from dasr_tpu_torch.train.dasr_adaptive_trainer import AdaptiveConfig, DASRAdaptiveTrainer
from torch_srn_step_case import ATOL, PARAM_ATOL, RTOL, SCORE_ATOL

NB, NB_ADA, NF, GC, D_NF, D_LAYERS = 1, 1, 16, 8, 16, 2
B, LR_SIZE, SCALE = 2, 16, 4
HR_SIZE = LR_SIZE * SCALE
# Adam divides each gradient element by its own running RMS, so an element
# whose gradient is of the order of the two frameworks' rounding moves up to
# lr a step either way (tests/torch_dsn_step_case.py; the DDM's
# multiplicative conditioning makes such elements in G, as
# tests/test_adaptive_step_oracle.py finds against its torch oracle). Each
# network's params are held within PARAM_ATOL but for a share of strays,
# none past 2 x 3 x lr (the most three steps can move two runs apart), and
# G's Adam first moments, linear in its gradients, within MOMENT_RTOL in
# norm. Shares: G 1e-3 (the oracle test's 99.9%); D_target none; the patch
# D none but for the biases before its no-affine InstanceNorms
# (``CANCELLED``), whose gradient the norm cancels: each step checks that
# JAX's gradient of them is zero to f32 rounding (``CANCELLED_RTOL`` of the
# patch D's largest gradient element).
STRAY_SHARE = {"G": 1e-3, "D_target": 0.0, "patchD": 0.0}
STRAY_ATOL = 2 * 3 * 1e-4
MOMENT_RTOL = 1e-3
CANCELLED = {"net.net.2.bias", "net.net.5.bias"}
CANCELLED_RTOL = 1e-5


def batch(rng):
    return {
        "LR_fake": rng.random((B, LR_SIZE, LR_SIZE, 3)).astype(np.float32),
        "LR_real": rng.random((B, LR_SIZE, LR_SIZE, 3)).astype(np.float32),
        "HR": rng.random((B, HR_SIZE, HR_SIZE, 3)).astype(np.float32),
        "HR_unpair": rng.random((B, HR_SIZE, HR_SIZE, 3)).astype(np.float32),
    }


def to_torch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
            for k, v in b.items()}


def np_tree(t):
    return jax.tree.map(np.asarray, jax.device_get(t))


def config_kw(use_patchd_opt: bool):
    return dict(nf=NF, nb=NB, gc=GC, d_nf=D_NF, d_n_layers=D_LAYERS,
                use_patchD_opt=use_patchd_opt)


def port_trainer(kw, concat: bool, lpips=None) -> DASRAdaptiveTrainer:
    """The port's trainer over the networks JAX's ``AdaptiveConfig`` builds
    with its defaults (an avg_pool FSD patch D, kernel 5, InstanceNorm)."""
    g = RRDBNetResidualConv(nf=NF, nb=NB, gc=GC, nb_ada=NB_ADA, concat=concat)
    return DASRAdaptiveTrainer(AdaptiveConfig(**kw), g, patch_d(), lpips=lpips)


def patch_d() -> FSDiscriminator:
    """The patch D JAX's ``AdaptiveConfig`` defaults to."""
    return FSDiscriminator(d_arch="FSD", filter_type="avg_pool", kernel_size=5,
                           norm_layer="Instance")


def assert_cancelled_grads_vanish(jtr, patchd_params, b):
    """JAX's gradient of the patch-D loss for ``b``: zero to rounding on the
    ``CANCELLED`` biases."""
    var_l = jnp.concatenate([b["LR_fake"], b["LR_real"]])
    n = b["LR_fake"].shape[0]

    def loss(pd):
        w = jtr.patchd_model.apply(pd, var_l)
        return jdsn_loss(w[n:], w[:n])

    grads = ck.state_dict_from_jax(patch_d(), np_tree(jax.grad(loss)(patchd_params)))
    top = max(float(g.abs().max()) for g in grads.values())
    for k in CANCELLED:
        assert float(grads[k].abs().max()) <= CANCELLED_RTOL * top, (k, top)


def state_dicts(params_g, params_d, patchd_vars, concat: bool, d_net):
    """The port's G, D_target (``d_net``'s) and patch D state dicts of JAX
    trees."""
    block = "RRDBResidualConvConcat" if concat else "RRDBResidualConv"
    return {"G": ck.conditioned_g_state_dict_from_jax(np_tree(params_g), NB, NB_ADA, block),
            "D_target": ck.state_dict_from_jax(d_net, np_tree(params_d)),
            "patchD": ck.state_dict_from_jax(patch_d(), np_tree(patchd_vars))}


def carried_pair(concat: bool, use_patchd_opt: bool):
    """The JAX trainer and state, and the port's trainer started from it."""
    kw = config_kw(use_patchd_opt)
    jtr = JTrainer(JConfig(nb_ada=NB_ADA, concat=concat, **kw))
    state = jtr.init_state(jax.random.key(0), lr_size=LR_SIZE)
    lpips = LPIPS()
    lpips.load_state_dict(ck.state_dict_from_jax(lpips, np_tree(jtr.lpips_variables)))
    tr = port_trainer(kw, concat, lpips=lpips.requires_grad_(False))
    st = tr.init_state()
    sds = state_dicts(state.base.g.params, state.base.d_target.params, state.patchd.params,
                      concat, st.d_target.net)
    for net, sd in zip((st.g.net, st.d_target.net, st.patchd.net), sds.values()):
        net.load_state_dict(sd, strict=True)
    return jtr, state, tr


def run_trajectory(rng, concat: bool, use_patchd_opt: bool):
    jtr, state, tr = carried_pair(concat, use_patchd_opt)
    st = tr.state
    for i in range(3):
        b = batch(rng)
        if use_patchd_opt:
            assert_cancelled_grads_vanish(jtr, state.patchd.params, b)
        state, want = jtr.train_step(state, b)
        got = tr.train_step(to_torch(b))
        assert set(got) == set(want), (sorted(got), sorted(want))
        assert ("loss/patch_D_gan_loss" in got) == use_patchd_opt
        for k, v in want.items():
            rtol, atol = (RTOL, ATOL) if k.startswith("loss/") else (0, SCORE_ATOL)
            np.testing.assert_allclose(float(got[k]), float(v), rtol=rtol, atol=atol,
                                       err_msg=f"step {i}: {k}")
    assert st.step == 3

    wants = state_dicts(state.base.g.params, state.base.d_target.params, state.patchd.params,
                        concat, st.d_target.net)
    for side, net in (("G", st.g.net), ("D_target", st.d_target.net), ("patchD", st.patchd.net)):
        ours = net.state_dict()
        assert set(ours) == set(wants[side]), side
        for k, v in wants[side].items():
            err = np.abs(ours[k].numpy() - v.numpy())
            cancelled = use_patchd_opt and side == "patchD" and k in CANCELLED
            share = 1.0 if cancelled else STRAY_SHARE[side]
            stray = int((err > PARAM_ATOL).sum())
            assert stray <= err.size * share and err.max() <= STRAY_ATOL, (
                f"{side} {k}: {stray} of {err.size} elements past {PARAM_ATOL}, "
                f"max |err| {err.max():.3e}")
    block = "RRDBResidualConvConcat" if concat else "RRDBResidualConv"
    mu = ck.conditioned_g_state_dict_from_jax(np_tree(state.base.g.opt_state[0].mu), NB, NB_ADA,
                                              block)
    params = dict(st.g.net.named_parameters())
    for k, want in mu.items():
        got = st.g.opt.state[params[k]]["exp_avg"].numpy()
        assert np.linalg.norm(got - want.numpy()) <= MOMENT_RTOL * np.linalg.norm(want.numpy()), k
