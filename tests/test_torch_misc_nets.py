"""Every class of the port's nn/misc_nets.py against dasr_tpu's flax module,
at the smallest input it takes, carried over by the type-paired
``state_dict_from_jax``, within 1e-5 (f32, CPU); ``make_layer`` and
``flow_warp`` too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.nn import misc_nets as jm
from dasr_tpu_torch.nn import misc_nets as tm
from dasr_tpu_torch.train import checkpoints as ck

ATOL = 1e-5


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# name: (flax module, port module, input (B, H, W, C))
NETS = {
    "MeanShift": (lambda: jm.MeanShift(rgb_std=(0.5, 1.0, 2.0)),
                  lambda: tm.MeanShift(rgb_std=(0.5, 1.0, 2.0)), (2, 4, 5, 3)),
    "EDSRResBlock": (lambda: jm.EDSRResBlock(nf=8, res_scale=0.1),
                     lambda: tm.EDSRResBlock(nf=8, res_scale=0.1), (2, 6, 5, 8)),
    "Upsampler_x4": (lambda: jm.Upsampler(scale=4, nf=4), lambda: tm.Upsampler(scale=4, nf=4),
                     (1, 3, 4, 4)),
    "Upsampler_x3": (lambda: jm.Upsampler(scale=3, nf=4), lambda: tm.Upsampler(scale=3, nf=4),
                     (1, 3, 4, 4)),
    "ResidualBlockNoBN": (lambda: jm.ResidualBlockNoBN(nf=8), lambda: tm.ResidualBlockNoBN(nf=8),
                          (2, 5, 6, 8)),
    "MINCNet": (jm.MINCNet, tm.MINCNet, (1, 16, 16, 3)),
    "ResNet101Features": (jm.ResNet101Features, tm.ResNet101Features, (1, 16, 16, 3)),
    "ResnetGenerator": (lambda: jm.ResnetGenerator(ngf=4, n_blocks=2),
                        lambda: tm.ResnetGenerator(ngf=4, n_blocks=2), (2, 12, 16, 3)),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_misc_net_matches_flax(rng, name):
    make_j, make_t, shape = NETS[name]
    x = rng.random(shape, dtype=np.float32)
    jnet, tnet = make_j(), make_t()
    variables = _np(jnet.init(jax.random.key(3), jnp.asarray(x)))
    for stats in variables.get("batch_stats", {}).values():  # non-trivial running statistics
        stats["mean"] = rng.normal(0, 0.1, stats["mean"].shape).astype(np.float32)
        stats["var"] = rng.uniform(0.5, 2.0, stats["var"].shape).astype(np.float32)
    if variables.get("params"):
        tnet.load_state_dict(ck.state_dict_from_jax(tnet, variables), strict=True)
        assert sum(p.numel() for p in tnet.parameters()) == sum(
            v.size for v in jax.tree.leaves(variables["params"]))
    want = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tnet.eval()(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_make_layer_matches_flax(rng):
    import flax.linen as fnn

    class Stack(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return jm.make_layer(lambda: jm.ResidualBlockNoBN(nf=4), 3)(x)

    x = rng.random((1, 5, 5, 4), dtype=np.float32)
    variables = _np(Stack().init(jax.random.key(4), jnp.asarray(x)))
    tnet = tm.make_layer(lambda: tm.ResidualBlockNoBN(nf=4), 3)
    sd = {}
    for i, block in enumerate(tnet):
        node = {"params": variables["params"][f"ResidualBlockNoBN_{i}"]}
        sd.update({f"{i}.{k}": v for k, v in ck.state_dict_from_jax(block, node).items()})
    tnet.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = _nhwc(tnet(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(Stack().apply(variables, jnp.asarray(x))),
                               atol=ATOL, rtol=0)


def test_flow_warp_matches_jax(rng):
    """Flows past the border on both sides, and fractional ones."""
    x = rng.random((2, 6, 7, 3), dtype=np.float32)
    flow = rng.uniform(-3, 3, (2, 6, 7, 2)).astype(np.float32)
    want = np.asarray(jm.flow_warp(jnp.asarray(x), jnp.asarray(flow)))
    got = _nhwc(tm.flow_warp(_nchw(x), torch.from_numpy(flow)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
