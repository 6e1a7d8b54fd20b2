"""The port's DSN-stage networks and ops against the JAX package's, f32 on
the CPU, from flax params carried across by the ``*_state_dict_from_jax``
maps: DeResnet (x1/x2/x4) and DSGANGenerator, FSDiscriminator over every
body, front end and output, the tensor imresize, the DSN losses and the
WGAN-GP penalty on the same draws, dsn_linear_decay step by step, and
ddm_splat against JAX and a brute-force loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.losses import gan as jgan
from dasr_tpu.nn.discriminators import FSDiscriminator as JFSD
from dasr_tpu.nn.generators import DeResnet as JDeResnet
from dasr_tpu.nn.generators import DSGANGenerator as JDSGAN
from dasr_tpu.ops import rf_splat as jrf
from dasr_tpu.ops.resize import imresize as jimresize
from dasr_tpu.train.schedules import dsn_linear_decay as jdecay
from dasr_tpu_torch.losses import gan
from dasr_tpu_torch.nn.discriminators import FSDiscriminator
from dasr_tpu_torch.nn.generators import DeResnet, DSGANGenerator
from dasr_tpu_torch.ops import rf_splat
from dasr_tpu_torch.ops.resize import imresize
from dasr_tpu_torch.train import checkpoints as ck
from dasr_tpu_torch.train.schedules import dsn_linear_decay
from dasr_tpu_torch.train.state import NetState
from test_rf_splat import _brute_splat

ATOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("generator,scale", [("DeResnet", 1), ("DeResnet", 2), ("DeResnet", 4),
                                             ("DSGAN", 1)])
def test_generators_match_jax(rng, generator, scale):
    x = rng.random((2, 30, 34, 3), dtype=np.float32)
    if generator == "DSGAN":
        jg, g = JDSGAN(n_res_blocks=2), DSGANGenerator(2)
    else:
        jg, g = JDeResnet(n_res_blocks=2, scale=scale), DeResnet(2, scale)
    params = _np(jg.init(jax.random.key(1), jnp.asarray(x)))
    g.load_state_dict(ck.deresnet_state_dict_from_jax(params, 2, scale), strict=True)
    want = np.asarray(jg.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(g(_nchw(x)))
    assert got.shape == want.shape == (2, -(-30 // scale), -(-34 // scale), 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("wgan", [False, True], ids=["sigmoid", "wgan"])
@pytest.mark.parametrize("filter_type", ["gau", "avg_pool", "wavelet", None])
@pytest.mark.parametrize("arch", ["FSD", "nld_s1", "nld_s2"])
def test_fs_discriminator_matches_jax(rng, arch, filter_type, wgan):
    # nld_s2 halves twice after the wavelet front end's halving: 32 -> 2
    x = rng.random((2, 32, 28, 3), dtype=np.float32)
    y = rng.random((2, 32, 28, 3), dtype=np.float32)
    kw = dict(d_arch=arch, filter_type=filter_type, norm_layer="Instance", wgan=wgan)
    jd, d = JFSD(**kw), FSDiscriminator(**kw)
    variables = _np(jd.init(jax.random.key(2), jnp.asarray(x)))
    d.load_state_dict(ck.fsd_state_dict_from_jax(variables, arch), strict=True)
    for other in (None, y):
        want = np.asarray(jd.apply(variables, jnp.asarray(x),
                                   None if other is None else jnp.asarray(other)))
        with torch.no_grad():
            got = _nhwc(d(_nchw(x), None if other is None else _nchw(other)))
        assert got.shape == want.shape
        # raw logits (wgan) reach ~10: the limit scales with them
        np.testing.assert_allclose(got, want, atol=ATOL * max(1.0, np.abs(want).max()), rtol=0,
                                   err_msg=f"y={'none' if other is None else 'given'}")


def test_fsd_batch_norm_in_eval_matches_jax(rng):
    x = rng.random((2, 16, 16, 3), dtype=np.float32)
    jd = JFSD(d_arch="FSD", filter_type="avg_pool", norm_layer="Batch", use_running_average=True)
    variables = _np(jd.init(jax.random.key(3), jnp.asarray(x)))
    stats = variables["batch_stats"]["DiscriminatorBasic_0"]
    for name in stats:  # non-trivial running statistics
        stats[name]["mean"] = rng.normal(0, 0.1, stats[name]["mean"].shape).astype(np.float32)
        stats[name]["var"] = rng.uniform(0.5, 2, stats[name]["var"].shape).astype(np.float32)
    d = FSDiscriminator(d_arch="FSD", filter_type="avg_pool", norm_layer="Batch").eval()
    d.load_state_dict(ck.fsd_state_dict_from_jax(variables, "FSD", "Batch"), strict=True)
    with torch.no_grad():
        got = _nhwc(d(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jd.apply(variables, jnp.asarray(x))), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("shape,scale", [((2, 64, 48), 0.25), ((1, 37, 53), 0.25),
                                         ((1, 30, 22), 0.5)])
def test_imresize_matches_jax(rng, shape, scale):
    b, h, w = shape
    x = rng.random((b, h, w, 3), dtype=np.float32)
    want = np.asarray(jimresize(jnp.asarray(x), scale))
    got = _nhwc(imresize(_nchw(x), scale))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # bf16 inputs are resized in f32
    assert imresize(_nchw(x).bfloat16(), scale).dtype == torch.float32


def test_dsn_losses_and_gradient_penalty_match_jax(rng):
    real = rng.uniform(0.05, 0.95, (3, 4, 4, 1)).astype(np.float32)
    fake = rng.uniform(0.05, 0.95, (3, 4, 4, 1)).astype(np.float32)
    for wgan in (False, True):
        got = gan.dsn_generator_adv_loss(_nchw(fake), wgan)
        np.testing.assert_allclose(float(got), float(jgan.dsn_generator_adv_loss(fake, wgan)),
                                   rtol=1e-6)
        got = gan.dsn_discriminator_loss(_nchw(real), _nchw(fake), wgan, grad_penalty=0.25)
        want = jgan.dsn_discriminator_loss(real, fake, wgan, grad_penalty=0.25)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

    # the penalty through a WGAN FSD, on the same per-sample draws
    x_real = rng.random((3, 16, 16, 3), dtype=np.float32)
    x_fake = rng.random((3, 16, 16, 3), dtype=np.float32)
    jd = JFSD(d_arch="FSD", filter_type="avg_pool", wgan=True)
    variables = _np(jd.init(jax.random.key(4), jnp.asarray(x_real)))
    d = FSDiscriminator(d_arch="FSD", filter_type="avg_pool", wgan=True)
    d.load_state_dict(ck.fsd_state_dict_from_jax(variables, "FSD"))
    key = jax.random.key(5)
    alpha = np.array(jax.random.uniform(key, (3, 1, 1, 1)))
    want = jgan.gradient_penalty(lambda v: jd.apply(variables, v), jnp.asarray(x_real),
                                 jnp.asarray(x_fake), key)
    gp = gan.gradient_penalty(d, _nchw(x_real), _nchw(x_fake), torch.from_numpy(alpha))
    np.testing.assert_allclose(gp.item(), float(want), rtol=1e-5)
    # a double backward: the penalty trains D (all but the head's bias, which
    # no input gradient depends on)
    grads = torch.autograd.grad(gp, list(d.parameters())[:-1])
    assert all(bool(g.isfinite().all()) for g in grads) and float(grads[0].abs().sum()) > 0


def test_dsn_linear_decay_matches_jax_per_network():
    """Each network's LR at each of its updates, with disc_freq 2 and
    gen_freq 3, against the JAX schedule at optax's per-optimizer count."""
    epochs, decay, spe, base = 5, 3, 4, 1e-4
    want = jdecay(base, epochs, decay, spe)
    nets = {}
    for name in ("g", "d"):
        net = torch.nn.Linear(1, 1)
        opt = torch.optim.Adam(net.parameters(), lr=base, betas=(0.5, 0.999))
        nets[name] = NetState(net, opt, dsn_linear_decay(opt, epochs, decay, spe))
    counts = {"g": 0, "d": 0}
    for iteration in range(1, 48 + 1):  # past the end of the decay
        for name, freq in (("g", 3), ("d", 2)):
            if iteration % freq:
                continue
            ns = nets[name]
            np.testing.assert_allclose(ns.opt.param_groups[0]["lr"], float(want(counts[name])),
                                       rtol=1e-6, atol=1e-12,
                                       err_msg=f"{name} update {counts[name]}")
            ns.step([torch.ones_like(p) for p in ns.params()])
            counts[name] += 1
    assert counts == {"g": 16, "d": 24}
    assert nets["g"].opt.param_groups[0]["lr"] < base  # inside the decay
    assert nets["d"].opt.param_groups[0]["lr"] == 0.0  # past its end


@pytest.mark.parametrize("arch", ["FSD", "nld_s1", "nld_s2"])
@pytest.mark.parametrize("size", [(48, 40), (37, 53)])
def test_ddm_splat_matches_jax_and_brute_force(rng, arch, size):
    out_h, out_w = size
    convnet = rf_splat.CONVNETS[arch]
    assert convnet == jrf.CONVNETS[arch]
    n_h = rf_splat.receptive_field(out_h, convnet)[0]
    n_w = rf_splat.receptive_field(out_w, convnet)[0]
    assert (n_h, n_w) == (jrf.receptive_field(out_h, convnet)[0],
                          jrf.receptive_field(out_w, convnet)[0])
    scores = rng.random((n_h + 1, n_w), dtype=np.float32)  # a row more than the grid
    got = rf_splat.ddm_splat(torch.from_numpy(scores), out_h, out_w, convnet).numpy()
    want = np.asarray(jrf.ddm_splat(jnp.asarray(scores), out_h, out_w, convnet))
    assert got.shape == (out_h, out_w) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, _brute_splat(scores[:n_h].astype(np.float64), out_h, out_w,
                                                 convnet), atol=1e-6, rtol=0)
    assert rf_splat.ddm_shape_for("wavelet", 37, 53) == jrf.ddm_shape_for("wavelet", 37, 53)
