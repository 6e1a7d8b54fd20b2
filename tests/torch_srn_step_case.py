"""Shared body of the port's DASR train-step trajectory tests: three steps
of ``dasr_tpu_torch.train.srn_trainer.SRNTrainer`` against
``dasr_tpu.train.srn_trainer.SRNTrainer`` from one JAX init, f32 on the
CPU, on the same numpy batches (the check of tests/test_dasr_step_oracle.py,
with the port's modules in place of its functional replicas)."""

import jax
import numpy as np
import torch

from dasr_tpu.train import checkpoints as jck
from dasr_tpu.train.srn_trainer import SRNConfig as JConfig
from dasr_tpu.train.srn_trainer import SRNTrainer as JTrainer
from dasr_tpu_torch.losses.lpips import LPIPS
from dasr_tpu_torch.train import checkpoints as ck
from dasr_tpu_torch.train.srn_trainer import SRNConfig, SRNTrainer

NB, NF, GC, D_NF, D_LAYERS = 2, 16, 8, 16, 2
B, LR_SIZE, SCALE = 2, 16, 4
HR_SIZE = LR_SIZE * SCALE
RTOL, ATOL, PARAM_ATOL = 2e-3, 2e-5, 2e-5
# the D scores are means of logits that nearly cancel (|mean| ~ 1e-2 of
# logits ~ 1): a relative limit on the mean says little, so they are held
# to an absolute one, 1e-4 of the logits' unit
SCORE_ATOL = 1e-4


def batch(rng):
    return {
        "LR_fake": rng.random((B, LR_SIZE, LR_SIZE, 3)).astype(np.float32),
        "LR_real": rng.random((B, LR_SIZE, LR_SIZE, 3)).astype(np.float32),
        "HR": rng.random((B, HR_SIZE, HR_SIZE, 3)).astype(np.float32),
        "HR_unpair": rng.random((B, HR_SIZE, HR_SIZE, 3)).astype(np.float32),
        "fake_w": rng.random((B, LR_SIZE // 2, LR_SIZE // 2, 1)).astype(np.float32),
    }


def to_torch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2))) for k, v in b.items()}


def run_trajectory(rng, fs: str, ragan: bool, gan_h_source: float = 0.0):
    kw = dict(nf=NF, nb=NB, gc=GC, d_nf=D_NF, d_n_layers=D_LAYERS, fs=fs, ragan=ragan,
              d_in_nc=9 if fs == "wavelet" else 3, gan_H_source=gan_h_source)
    jtr = JTrainer(JConfig(**kw))
    state = jtr.init_state(jax.random.key(0), lr_size=LR_SIZE)
    np_tree = lambda t: jax.tree.map(np.asarray, jax.device_get(t))  # noqa: E731

    lpips = LPIPS()
    lpips.load_state_dict(ck.state_dict_from_jax(lpips, np_tree(jtr.lpips_variables)))
    tr = SRNTrainer(SRNConfig(**kw), lpips=lpips.requires_grad_(False))
    st = tr.init_state()
    st.g.net.load_state_dict(ck.rrdbnet_state_dict_from_jax(np_tree(state.g.params), NB))
    pairs = [("G", st.g.net, lambda s: s.g.params, jck.rrdbnet_key_map(NB)),
             ("D_target", st.d_target.net, lambda s: s.d_target.params,
              jck.nlayer_d_key_map(D_LAYERS))]
    st.d_target.net.load_state_dict(
        ck.state_dict_from_jax(st.d_target.net, np_tree(state.d_target.params)))
    if gan_h_source > 0:
        st.d_source.net.load_state_dict(
            ck.state_dict_from_jax(st.d_source.net, np_tree(state.d_source.params)))
        pairs.append(("D_source", st.d_source.net, lambda s: s.d_source.params,
                      jck.nlayer_d_key_map(D_LAYERS)))

    for i in range(3):
        b = batch(rng)
        state, want = jtr.train_step(state, b)
        got = tr.train_step(to_torch(b))
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k, v in want.items():
            rtol, atol = (RTOL, ATOL) if k.startswith("loss/") else (0, SCORE_ATOL)
            np.testing.assert_allclose(float(got[k]), float(v), rtol=rtol, atol=atol,
                                       err_msg=f"step {i}: {k}")
    assert st.step == 3

    # Under RaGAN the D head's bias adds to every logit on both sides of each
    # difference, so its gradient is zero up to rounding, and Adam turns
    # that rounding noise into steps of up to lr: the two frameworks may
    # move it apart by 2 lr per step. The other params are held as usual.
    head_bias = f"{jck.nlayer_d_key_map(D_LAYERS)[-1][0]}.bias"
    for side, net, params, key_map in pairs:
        want = jck.export_params_to_state_dict(params(state), key_map)
        ours = net.state_dict()
        assert set(ours) == set(want), side
        for k in want:
            atol = 2 * 3 * 1e-4 if ragan and side != "G" and k == head_bias else PARAM_ATOL
            np.testing.assert_allclose(ours[k].numpy(), want[k].numpy(), atol=atol,
                                       rtol=0, err_msg=f"{side} {k}")
