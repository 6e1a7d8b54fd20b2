"""``spatially_sharded_apply`` of the port over two ranks of a gloo world on
the CPU (``tests/torch_dist_case.py``) against JAX's on a 2-device mesh of
the suite's CPU devices, as tests/test_spatial_shard.py holds JAX's
against the unsharded forward: an x4 RRDB on the same weights at an H the
ranks divide and at one they do not, and a scale-1 blur."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_case as case
from dasr_tpu.core import mesh as meshlib
from dasr_tpu.nn.generators import RRDBNet as JRRDBNet
from dasr_tpu.ops.spatial_shard import spatially_sharded_apply as jsharded
from dasr_tpu_torch.train import checkpoints as ck

NF, NB, GC = 16, 1, 8
HS = {"even_h": 96, "uneven_h": 91}
W = 24


@pytest.fixture(scope="module")
def rrdb():
    """A JAX x4 RRDBNet's variables, the port's state dict of them, the
    images, and the port's sharded outputs of all of them from one spawn."""
    model = JRRDBNet(nf=NF, nb=NB, gc=GC, upscale=4)
    v = model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    sd = ck.rrdbnet_state_dict_from_jax(jax.tree.map(np.asarray, v["params"]), NB)
    rng = np.random.default_rng(0)
    xs = {k: rng.random((1, h, W, 3), dtype=np.float32) for k, h in HS.items()}
    got = case.run_ranks(case.run_sharded_rrdbs, 2, sd, NF, NB, GC, xs, 20)
    return model, v, xs, got


@pytest.mark.parametrize("case_id", list(HS))
def test_sharded_rrdb_matches_jax(rrdb, case_id):
    """96 rows: 48 a rank; 91: reflect-padded to 92, 46 a rank, the
    bottom strip recomputed from the real edge. Halo 20 > the RRDB's
    receptive influence (tests/test_spatial_shard.py)."""
    model, v, xs, got = rrdb
    x, h = xs[case_id], HS[case_id]
    want = np.asarray(jsharded(jnp.asarray(x), lambda t: model.apply(v, t), scale=4, halo=20,
                               mesh=meshlib.make_mesh(n_data=2)))
    ours, theirs = got[0][case_id], got[1][case_id]
    assert ours.shape == want.shape == (1, 4 * h, 4 * W, 3)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_allclose(ours, want, atol=2e-5, rtol=0)


def test_sharded_identity_scale1_matches_jax(rng):
    x = rng.random((2, 32, 16, 3), dtype=np.float32)

    def blur(t):
        k = jnp.tile(jnp.ones((3, 3, 1, 1), t.dtype) / 9.0, (1, 1, 1, t.shape[-1]))
        return jax.lax.conv_general_dilated(t, k, (1, 1), "SAME",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                            feature_group_count=t.shape[-1])

    want = np.asarray(jsharded(jnp.asarray(x), blur, scale=1, halo=2,
                               mesh=meshlib.make_mesh(n_data=2)))
    got = case.run_ranks(case.run_sharded_blur, 2, x, 2)[0]
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # and the blur's own unsharded output: the halo exchange is exact
    plain = case.blur3(torch.from_numpy(x.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-6, rtol=0)
