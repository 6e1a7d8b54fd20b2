"""The 'sr' and 'De_Resnet' facades of the port against dasr_tpu's, f32 on the
CPU, from one JAX init carried across: three train steps on the same numpy
batches (losses at rtol 2e-3 / atol 2e-5, G's params at 2e-5 after), l1
and l2; 'sr''s geometric self-ensemble ``test_x8`` against JAX's; and the
deviation of the 'sr' step (ROADMAP C.2): the port weights the pixel loss
by ``pixel_weight``, as the reference's SR_model.py does, where
``dasr_tpu``'s ``SRModel`` leaves the weight out.

As in tests/test_misc_step_oracles.py, the pixel targets are offset by +2,
so that prediction - target never crosses zero: L1's gradient is its sign,
which f32 noise may flip in one framework and not the other, and Adam
turns such a flip into a step of lr."""

import jax
import numpy as np
import pytest
import torch

from dasr_tpu.models.registry import create_model as jax_create_model
from dasr_tpu_torch.models.registry import create_model
from dasr_tpu_torch.train import checkpoints as ck

NF, NB, GC, B, LR = 16, 1, 8, 2, 8
RTOL, ATOL, PARAM_ATOL = 2e-3, 2e-5, 2e-5
TARGET_OFFSET = 2.0
RRDB = {"which_model_G": "RRDB_net", "nf": NF, "nb": NB, "gc": GC}
DE_RESNET = {"which_model_G": "De_Resnet", "nf": 8, "nb": 2, "norm_type": None, "mode": "NAC",
             "act_type": "prelu"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt(model, net_g, criterion="l1", weight=1.0):
    return {"model": model, "scale": 4, "bf16": False, "is_train": True, "network_G": net_g,
            "train": {"lr_G": 1e-4, "lr_steps": [10 ** 6], "pixel_criterion": criterion,
                      "pixel_weight": weight, "manual_seed": 0}}


def _np_tree(t):
    return jax.tree.map(np.asarray, jax.device_get(t))


def _pair(model, net_g, criterion, weight=1.0):
    """(JAX facade, the port's facade with JAX's G carried in, JAX's G
    params getter)."""
    jm = jax_create_model(_opt(model, net_g, criterion, weight)).init(lr_size=LR)
    tm = create_model(_opt(model, net_g, criterion, weight)).init()
    params = (lambda: jm.params) if model == "sr" else (lambda: jm.state.params)
    tm.g.load_state_dict(ck.state_dict_from_jax(tm.g, _np_tree(params()))
                         if model != "sr" else ck.rrdbnet_state_dict_from_jax(
                             _np_tree(params()), NB))
    return jm, tm, params


def _batch(rng, model):
    lr = rng.random((B, LR, LR, 3), dtype=np.float32)
    hr = rng.random((B, 4 * LR, 4 * LR, 3), dtype=np.float32)
    if model == "sr":
        return {"LR": lr, "HR": hr + TARGET_OFFSET}
    return {"LR": lr + TARGET_OFFSET, "HR": hr}


@pytest.mark.parametrize("model,criterion", [
    ("sr", "l1"), ("sr", "l2"), ("De_Resnet", "l1"), ("De_Resnet", "l2")])
def test_three_steps_match_jax(rng, model, criterion):
    net_g = RRDB if model == "sr" else DE_RESNET
    jm, tm, params = _pair(model, net_g, criterion)
    for i in range(3):
        b = _batch(rng, model)
        want, got = jm.train_step(b), tm.train_step(b)
        assert set(got) == set(want) == {"loss/l_pix"}
        np.testing.assert_allclose(got["loss/l_pix"], want["loss/l_pix"], rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {i}")
    assert tm.step == 3
    if model == "sr":
        want_sd = ck.rrdbnet_state_dict_from_jax(_np_tree(params()), NB)
    else:
        want_sd = ck.state_dict_from_jax(tm.g, _np_tree(params()))
    ours = tm.g.state_dict()
    assert set(ours) == set(want_sd)
    for k, v in want_sd.items():
        np.testing.assert_allclose(ours[k].numpy(), v.numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=k)


def test_sr_pixel_weight_is_applied_as_the_reference(rng):
    """ROADMAP C.2: with ``pixel_weight`` 0.5 the port's loss is half of
    dasr_tpu's, whose SRModel never reads the weight."""
    jm, tm, _ = _pair("sr", RRDB, "l1", weight=0.5)
    b = _batch(rng, "sr")
    want, got = jm.train_step(b), tm.train_step(b)
    np.testing.assert_allclose(got["loss/l_pix"], 0.5 * want["loss/l_pix"], rtol=RTOL, atol=ATOL)


def test_test_x8_matches_jax(rng):
    """The mean of the eight dihedral forwards, on a non-square image (the
    transposed forwards take another shape), against JAX's and against the
    mean of the port's own eight forwards."""
    jm = jax_create_model(dict(_opt("sr", RRDB), is_train=False)).init(lr_size=LR)
    opt = dict(_opt("sr", RRDB), is_train=False)
    tm = create_model(opt).init()
    tm.g.load_state_dict(ck.rrdbnet_state_dict_from_jax(_np_tree(jm.params), NB))
    lr = rng.random((7, 9, 3), dtype=np.float32)
    got = tm.test_x8(lr)
    np.testing.assert_allclose(got, jm.test_x8(lr), atol=1e-5, rtol=0)
    outs = []
    for k in range(8):
        t = np.rot90(lr, k % 4)
        t = t[:, ::-1] if k >= 4 else t
        sr = tm.test(np.ascontiguousarray(t))
        sr = sr[:, ::-1] if k >= 4 else sr
        outs.append(np.rot90(sr, -(k % 4)))
    np.testing.assert_allclose(got, np.mean(outs, axis=0), atol=1e-6, rtol=0)
