"""The port's training-side networks and losses against the JAX package's,
f32 on the CPU, from flax params carried across: NLayerDiscriminator,
AlexNetFeatures, VGG19Feature54, LPIPS; gan_loss and ragan_pair_loss;
the multistep LR against optax."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dasr_tpu.losses import gan as jgan
from dasr_tpu.losses.lpips import LPIPS as JLPIPS
from dasr_tpu.nn.discriminators import NLayerDiscriminator as JNLayer
from dasr_tpu.nn.vgg import AlexNetFeatures as JAlex
from dasr_tpu.nn.vgg import VGG19Feature54 as JVGG19
from dasr_tpu.train.schedules import multistep as jmultistep
from dasr_tpu_torch.losses import gan
from dasr_tpu_torch.losses.lpips import LPIPS
from dasr_tpu_torch.nn.discriminators import NLayerDiscriminator
from dasr_tpu_torch.nn.vgg import AlexNetFeatures, VGG19Feature54
from dasr_tpu_torch.train import checkpoints as ck
from dasr_tpu_torch.train.schedules import multistep

ATOL = 1e-4  # several convs deep, two conv implementations at f32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _stack_sd(params, n):
    sd = {}
    for i in range(n):
        node = params["stack"][f"conv{i}"]
        sd[f"stack.conv{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(node["kernel"], (3, 2, 0, 1))))
        sd[f"stack.conv{i}.bias"] = torch.from_numpy(np.array(node["bias"]))
    return sd


@pytest.mark.parametrize("n_layers,in_ch,bias_middle", [(2, 9, False), (3, 3, None)])
def test_nlayer_discriminator_matches_jax(rng, n_layers, in_ch, bias_middle):
    x = rng.random((2, 32, 32, in_ch), dtype=np.float32)
    jd = JNLayer(in_ch=in_ch, ndf=16, n_layers=n_layers, norm_layer="Instance", stride=2,
                 use_bias_middle=bias_middle)
    variables = _np(jd.init(jax.random.key(2), jnp.asarray(x)))
    d = NLayerDiscriminator(in_ch=in_ch, ndf=16, n_layers=n_layers, use_bias_middle=bias_middle)
    d.load_state_dict(ck.state_dict_from_jax(d, variables), strict=True)
    with torch.no_grad():
        got = d(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jd.apply(variables, jnp.asarray(x))),
                               atol=ATOL, rtol=0)


def test_alexnet_features_match_jax(rng):
    x = rng.random((1, 64, 64, 3), dtype=np.float32)
    ja = JAlex()
    variables = _np(ja.init(jax.random.key(3), jnp.asarray(x)))
    net = AlexNetFeatures()
    net.load_state_dict(_stack_sd(variables["params"], 5))
    with torch.no_grad():
        got = net(_nchw(x))
    want = ja.apply(variables, jnp.asarray(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        scale = float(np.abs(np.asarray(w)).max()) + 1.0
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=ATOL * scale, rtol=0)


def test_vgg19_feature54_matches_jax(rng):
    x = rng.random((1, 32, 32, 3), dtype=np.float32)
    jv = JVGG19()
    variables = _np(jv.init(jax.random.key(4), jnp.asarray(x)))
    net = VGG19Feature54()
    net.load_state_dict(_stack_sd(variables["params"], 16))
    with torch.no_grad():
        got = net(_nchw(x)).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jv.apply(variables, jnp.asarray(x)))
    assert got.shape == want.shape == (1, 2, 2, 512)
    np.testing.assert_allclose(got, want, atol=ATOL * (np.abs(want).max() + 1), rtol=0)


@pytest.mark.parametrize("normalize", [True, False])
def test_lpips_matches_jax(rng, normalize):
    a = rng.random((2, 48, 40, 3), dtype=np.float32)
    b = rng.random((2, 48, 40, 3), dtype=np.float32)
    jl = JLPIPS(net="alex")
    variables = _np(jl.init(jax.random.key(5), jnp.asarray(a), jnp.asarray(b)))
    # heads away from their constant init, so the carry-over is checked
    for k in range(5):
        variables["params"][f"lin{k}"] = rng.random(variables["params"][f"lin{k}"].shape,
                                                    dtype=np.float32)
    lp = LPIPS()
    lp.load_state_dict(ck.state_dict_from_jax(lp, variables), strict=True)
    with torch.no_grad():
        got = lp(_nchw(a), _nchw(b), normalize=normalize).numpy()
    want = np.asarray(jl.apply(variables, jnp.asarray(a), jnp.asarray(b), normalize=normalize))
    assert got.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(got[:, 0, 0, 0], want[:, 0, 0, 0], rtol=1e-4, atol=1e-6)


def test_lpips_refuses_inputs_too_small():
    with pytest.raises(RuntimeError, match="too small"):
        LPIPS()(torch.zeros(1, 3, 16, 16), torch.zeros(1, 3, 16, 16))


@pytest.mark.parametrize("gan_type", ["vanilla", "lsgan", "wgan-gp"])
@pytest.mark.parametrize("real", [True, False])
def test_gan_losses_match_jax(rng, gan_type, real):
    pf = rng.normal(0, 2, (3, 4, 4, 1)).astype(np.float32)
    pr = rng.normal(0, 2, (3, 4, 4, 1)).astype(np.float32)
    got = gan.gan_loss(_nchw(pf), real, gan_type).item()
    np.testing.assert_allclose(got, float(jgan.gan_loss(jnp.asarray(pf), real, gan_type)),
                               rtol=1e-6, atol=1e-7)
    got = gan.ragan_pair_loss(_nchw(pf), _nchw(pr), gan_type).item()
    want = float(jgan.ragan_pair_loss(jnp.asarray(pf), jnp.asarray(pr), gan_type))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_multistep_lr_matches_optax_at_the_milestones():
    """The LR of update n (0-based) one before, at and after each milestone."""
    milestones, base, gamma = (3, 7), 1e-4, 0.5
    sched = jmultistep(base, milestones, gamma)
    p = torch.nn.Parameter(torch.zeros(()))
    opt = torch.optim.Adam([p], lr=base)
    lr = multistep(opt, milestones, gamma)
    for n in range(10):
        assert opt.param_groups[0]["lr"] == pytest.approx(float(sched(n)), rel=1e-7), n
        p.grad = torch.ones(())
        opt.step()
        lr.step()
    assert float(sched(2)) == pytest.approx(base) and float(sched(3)) == pytest.approx(base * gamma)


def test_adam_update_matches_optax(rng):
    """One Adam per network, b2 0.999, eps 1e-8: three updates as optax's."""
    w0 = rng.normal(size=(5,)).astype(np.float32)
    grads = [rng.normal(size=(5,)).astype(np.float32) for _ in range(3)]
    tx = optax.adam(1e-3, b1=0.5, b2=0.999)
    w, st = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = torch.optim.Adam([p], lr=1e-3, betas=(0.5, 0.999), eps=1e-8)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, w)
        w = optax.apply_updates(w, upd)
        p.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), atol=1e-7, rtol=0)
