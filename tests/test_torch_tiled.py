"""The port's forward_chop / tiled_apply against dasr_tpu's, with the same
tiny RRDBNet on both sides (f32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.nn.generators import RRDBNet as JRRDBNet
from dasr_tpu.ops import tiled as jtiled
from dasr_tpu_torch.nn.generators import RRDBNet
from dasr_tpu_torch.ops import tiled
from dasr_tpu_torch.ops.rdb import TOLERANCES
from dasr_tpu_torch.train.checkpoints import rrdbnet_state_dict_from_jax

ATOL, _ = TOLERANCES["jax_network"]


@pytest.fixture(scope="module")
def nets():
    jnet = JRRDBNet(nf=16, nb=1, gc=8)
    variables = jnet.init(jax.random.key(5), jnp.zeros((1, 16, 16, 3)))
    japply = jax.jit(lambda v: jnet.apply(variables, v))
    net = RRDBNet(nf=16, nb=1, gc=8)
    net.load_state_dict(rrdbnet_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables), 1))
    return japply, net


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_forward_chop_matches_jax(rng, nets):
    japply, net = nets
    x = rng.random((1, 85, 57, 3), dtype=np.float32)
    want = np.asarray(jtiled.forward_chop(jnp.asarray(x), 4, japply, shave=10, min_size=600))
    with torch.no_grad():
        got = tiled.forward_chop(_nchw(x), 4, net, shave=10, min_size=600)
    assert want.shape == (1, 340, 228, 3)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=0)


def test_tiled_apply_matches_jax(rng, nets):
    japply, net = nets
    x = rng.random((1, 37, 29, 3), dtype=np.float32)
    want = np.asarray(jtiled.tiled_apply(jnp.asarray(x), japply, scale=4, tile=16, halo=4))
    with torch.no_grad():
        got = tiled.tiled_apply(_nchw(x), net, scale=4, tile=16, halo=4)
    assert want.shape == (1, 148, 116, 3)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n,before,after", [(5, 2, 3), (3, 7, 11), (2, 4, 1), (1, 2, 2), (9, 0, 0)])
def test_reflect_index_is_numpy_reflect(n, before, after):
    want = np.pad(np.arange(n), (before, after), mode="reflect")
    np.testing.assert_array_equal(tiled.reflect_index(n, before, after), want)


def test_pad_reflect_matches_jnp_pad(rng):
    x = rng.random((1, 2, 5, 4), dtype=np.float32)
    want = np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (6, 9), (3, 8)), mode="reflect"))
    got = tiled.pad_reflect(torch.from_numpy(x), 6, 9, 3, 8).numpy()
    np.testing.assert_array_equal(got, want)
