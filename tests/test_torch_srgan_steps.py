"""The port's 'srgan' / 'srragan' facade against dasr_tpu's ``SRGANTrainer``,
f32 on the CPU, from one JAX init carried across: G (RRDBNet nf 16 nb 1),
D ``DiscriminatorVGG(input_size=32)`` (nf 16, its BatchNorm statistics
included; handed to JAX's trainer through ``d_model=``, and to the port's
facade in place of ``define_D``'s) and the VGG19-54 feature net. Three
steps on the same numpy batches, for vanilla, RaGAN and WGAN-GP (the
penalty's ``alpha`` drawn by JAX from the step's key and injected into the
port's step), and the facade's D-gate with ``D_update_ratio`` 2 and
``D_init_iters`` 1: the logged losses (rtol 2e-3, atol 2e-5) and D scores
(atol 1e-4 as in tests/torch_srn_step_case.py), G's and D's params after
(2e-5) and D's running statistics (2e-5: means of the two sides' D inputs,
which differ by the G outputs' 2e-5).

This D, the reference's Discriminator_VGG_128 layout, has no conv bias
before a BatchNorm. The conv-block stacks of ``make_vgg_discriminator`` do
(the reference's layout too), and such a bias has a zero gradient: Adam
steps it by f32 dust, up to lr either way, and the noise spreads into the
other params (on the CPU, 3 steps of ``discriminator_vgg_48`` left 0.2% of
G's elements past 2e-5, and 3.3% with WGAN-GP). One step of that D
through the facade is held here at the losses' limits.

Two deviations are named here (ROADMAP C.2): the gate counts iterations
from 1, as the reference's ``current_step`` (SRGAN_model.py
``optimize_parameters``), where dasr_tpu's ``SRGANModel.train_step`` counts
from 0 and so skips G's update on the reference's first G iteration; and
the port trains the configured ``which_model_D``, where dasr_tpu's facade
trains ``DiscriminatorVGG(input_size=HR_size)`` whatever the config names.
A third, of the spectral-norm D: its ``u`` moves in D's own forwards, as
the reference's spectral norm moves it in training mode, where JAX's step
applies the SN D without ``update_stats`` and never moves it.

RaGAN: the relativistic pairs do not change when every D output shifts by
one constant, so the head's last bias has a zero gradient and the one
before it nearly zero; Adam turns the f32 dust on them into steps of up to
lr, so those two are held to 2 x 3 x lr (tests/test_srgan_step_oracle.py
handles the degeneracy so), and so are the two D scores, which carry the
last bias, while their difference, which does not, is held at 1e-4."""

import jax
import numpy as np
import pytest
import torch

from dasr_tpu.models.registry import create_model as jax_create_model
from dasr_tpu.nn.discriminators import DiscriminatorVGG, make_vgg_discriminator
from dasr_tpu.nn.generators import RRDBNet
from dasr_tpu.train.srgan_trainer import SRGANConfig, SRGANTrainer
from dasr_tpu_torch.models import registry
from dasr_tpu_torch.models.registry import create_model
from dasr_tpu_torch.nn.discriminators import DiscriminatorVGG as TDiscriminatorVGG
from dasr_tpu_torch.nn.discriminators import DiscriminatorVGGStack
from dasr_tpu_torch.train import checkpoints as ck

NF, NB, GC, D_NF, B, LR = 16, 1, 8, 16, 2, 8
HR = 4 * LR
RTOL, ATOL, PARAM_ATOL, SCORE_ATOL, STATS_ATOL = 2e-3, 2e-5, 2e-5, 1e-4, 2e-5
WALK = 2 * 3 * 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    return jax.tree.map(np.asarray, jax.device_get(t))


def _opt(model, gan_type, **train):
    return {"model": model, "scale": 4, "bf16": False, "is_train": True,
            "datasets": {"train": {"HR_size": HR}},
            "network_G": {"which_model_G": "RRDB_net", "nf": NF, "nb": NB, "gc": GC},
            "network_D": {"which_model_D": "discriminator_vgg_48", "nf": D_NF},
            "train": {"gan_type": gan_type, "manual_seed": 0, **train}}


@pytest.fixture(scope="module")
def jax_trainers():
    """One JAX trainer (and so one compile of each of its steps) per
    configuration, shared by the cases."""
    trainers = {}

    def get(ragan, gan_type):
        if (ragan, gan_type) not in trainers:
            cfg = SRGANConfig(nf=NF, nb=NB, gc=GC, ragan=ragan, gan_type=gan_type, lr_steps=())
            trainers[ragan, gan_type] = SRGANTrainer(
                cfg, g_model=RRDBNet(nf=NF, nb=NB, gc=GC),
                d_model=DiscriminatorVGG(input_size=HR, nf=D_NF))
        return trainers[ragan, gan_type]

    return get


def _d_vars(state):
    return _np_tree({"params": state.d_target.params["params"],
                     "batch_stats": state.d_target.extra})


def _batch(rng):
    return {"LR": rng.random((B, LR, LR, 3), dtype=np.float32),
            "HR": rng.random((B, HR, HR, 3), dtype=np.float32)}


CASES = {
    "vanilla": ("srgan", "vanilla", {}),
    "ragan": ("srragan", "vanilla", {}),
    "wgan_gp": ("srgan", "wgan-gp", {}),
    "gate": ("srgan", "vanilla", {"D_update_ratio": 2, "D_init_iters": 1}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_jax(rng, monkeypatch, jax_trainers, case):
    model, gan_type, train = CASES[case]
    ragan = model == "srragan"
    jtr = jax_trainers(ragan, gan_type)
    state = jtr.init_state(jax.random.key(0), lr_size=LR)

    monkeypatch.setattr(registry, "define_D", lambda opt: TDiscriminatorVGG(HR, nf=D_NF))
    tm = create_model(_opt(model, gan_type, **train)).init()
    tr = tm.trainer
    assert isinstance(tr.d_model, TDiscriminatorVGG) and tr.cfg.ragan == ragan
    tm.g.load_state_dict(ck.rrdbnet_state_dict_from_jax(_np_tree(state.g.params), NB))
    tr.d_model.load_state_dict(ck.state_dict_from_jax(tr.d_model, _d_vars(state)))
    tr.vgg.load_state_dict(ck.state_dict_from_jax(tr.vgg, _np_tree(jtr.vgg_variables)))

    # the reference's gate on its 1-based iteration; dasr_tpu's facade
    # (registry.py:726) uses the 0-based step
    ratio, init = train.get("D_update_ratio", 1), train.get("D_init_iters", 0)
    gates = [it % ratio == 0 and it > init for it in range(1, 4)]
    jax_facade_gates = [s % ratio == 0 and s > init for s in range(3)]
    if case == "gate":
        assert gates == [False, True, False] and jax_facade_gates == [False, False, True]
    for i in range(3):
        b = _batch(rng)
        key = jax.random.key(100 + i)
        state, want = jtr.train_step(state, b, rng=key, do_g=gates[i])
        if gan_type == "wgan-gp":
            alpha = torch.from_numpy(np.array(jax.random.uniform(key, (B, 1, 1, 1))))
            got = tm.metrics_to_host(tr.train_step(tm._to_device(b), do_g=gates[i],
                                                   alpha=alpha))
        else:
            got = tm.train_step(b)
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k, v in want.items():
            # under RaGAN both scores carry the head bias's walk (below)
            rtol, atol = ((RTOL, ATOL) if k.startswith("loss/")
                          else (0, SCORE_ATOL + (WALK if ragan else 0)))
            np.testing.assert_allclose(got[k], float(v), rtol=rtol, atol=atol,
                                       err_msg=f"{case} step {i}: {k}")
        if ragan:
            np.testing.assert_allclose(
                got["disc_Score/D_real"] - got["disc_Score/D_fake"],
                float(want["disc_Score/D_real"] - want["disc_Score/D_fake"]), rtol=0,
                atol=SCORE_ATOL, err_msg=f"{case} step {i}: D_real - D_fake")
    assert tm.step == 3

    walk = {"linear1.bias", "linear2.bias"} if ragan else set()
    for side, net, want_sd in (
            ("G", tm.g, ck.rrdbnet_state_dict_from_jax(_np_tree(state.g.params), NB)),
            ("D", tr.d_model, ck.state_dict_from_jax(tr.d_model, _d_vars(state)))):
        ours = net.state_dict()
        assert set(ours) == set(want_sd), side
        for k, v in want_sd.items():
            if k.endswith("num_batches_tracked"):
                continue
            stats = k.endswith(("running_mean", "running_var"))
            atol = WALK if k in walk else STATS_ATOL if stats else PARAM_ATOL
            np.testing.assert_allclose(ours[k].numpy(), v.numpy(), atol=atol, rtol=0,
                                       err_msg=f"{case} {side} {k}")


def test_one_step_of_define_ds_stack_matches_jax(rng):
    """The facade's own D, define_D's discriminator_vgg_48 (nf 8, HR 48),
    one step against JAX's trainer given the same stack: losses and D
    scores as above."""
    opt = _opt("srgan", "vanilla")
    opt["datasets"]["train"]["HR_size"] = 48
    opt["network_D"]["nf"] = 8
    jtr = SRGANTrainer(SRGANConfig(nf=NF, nb=NB, gc=GC, lr_steps=()),
                       g_model=RRDBNet(nf=NF, nb=NB, gc=GC),
                       d_model=make_vgg_discriminator("discriminator_vgg_48", nf=8))
    state = jtr.init_state(jax.random.key(0), lr_size=12)
    tm = create_model(opt).init()
    tr = tm.trainer
    assert isinstance(tr.d_model, DiscriminatorVGGStack)
    tm.g.load_state_dict(ck.rrdbnet_state_dict_from_jax(_np_tree(state.g.params), NB))
    tr.d_model.load_state_dict(ck.state_dict_from_jax(tr.d_model, _d_vars(state)))
    tr.vgg.load_state_dict(ck.state_dict_from_jax(tr.vgg, _np_tree(jtr.vgg_variables)))
    b = {"LR": rng.random((B, 12, 12, 3), dtype=np.float32),
         "HR": rng.random((B, 48, 48, 3), dtype=np.float32)}
    _, want = jtr.train_step(state, b)
    got = tm.train_step(b)
    for k, v in want.items():
        rtol, atol = (RTOL, ATOL) if k.startswith("loss/") else (0, SCORE_ATOL)
        np.testing.assert_allclose(got[k], float(v), rtol=rtol, atol=atol, err_msg=k)


def test_jax_facade_trains_a_d_of_hr_size_whatever_the_config_names():
    """ROADMAP C.2: dasr_tpu's SRGANModel builds its trainer without
    define_D (srgan_trainer.py:64-66), so the shipped train_SRGAN.json's
    discriminator_vgg_192 trains as a DiscriminatorVGG(input_size=192); the
    port trains the named conv-block stack."""
    opt = _opt("srragan", "vanilla")
    opt["datasets"]["train"]["HR_size"] = 192
    opt["network_D"] = {"which_model_D": "discriminator_vgg_192", "nf": 4}
    jm = jax_create_model(opt)
    assert type(jm.trainer.d_model) is DiscriminatorVGG and jm.trainer.d_model.input_size == 192
    tm = create_model(opt)
    assert isinstance(tm.trainer.d_model, DiscriminatorVGGStack)
    assert tm.trainer.d_model.classifier[0].in_features == 8 * 4 * 3 * 3


def test_spectral_norm_d_moves_u_in_ds_own_forwards(rng):
    """ROADMAP C.2: one step of the port with discriminator_vgg_128_SN moves
    the SN layers' ``u`` (D's forwards of real and fake), and D's forward
    inside G's loss alone does not; JAX's step applies the SN D as its
    ``_d_apply`` does, without ``update_stats``, which leaves ``u``."""
    import types

    import jax.numpy as jnp

    from dasr_tpu.nn.discriminators import DiscriminatorVGG128SN

    opt = _opt("srgan", "vanilla", feature_weight=0)
    opt["network_G"].update(nf=8, nb=1, gc=4)
    opt["datasets"]["train"]["HR_size"] = 128
    opt["network_D"] = {"which_model_D": "discriminator_vgg_128_SN"}
    tm = create_model(opt).init()
    us = lambda: {k: v.clone() for k, v in tm.trainer.d_model.state_dict().items()  # noqa: E731
                  if k.endswith(".u")}
    before = us()
    b = {"LR": rng.random((1, 32, 32, 3), dtype=np.float32),
         "HR": rng.random((1, 128, 128, 3), dtype=np.float32)}
    with torch.no_grad():
        tm.trainer._d(tm._to_device(b)["HR"], update=False)
    assert all(torch.equal(v, before[k]) for k, v in us().items())
    tm.train_step(b)
    assert sum(not torch.equal(v, before[k]) for k, v in us().items()) >= 11

    jnet = DiscriminatorVGG128SN()
    x = jnp.asarray(b["HR"])
    variables = jnet.init(jax.random.key(0), x)
    _, stats = SRGANTrainer._d_apply(types.SimpleNamespace(d_model=jnet),
                                     {"params": variables["params"]},
                                     variables["batch_stats"], x)
    assert all(np.array_equal(a, c) for a, c in zip(jax.tree.leaves(stats),
                                                     jax.tree.leaves(variables["batch_stats"])))
