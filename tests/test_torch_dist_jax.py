"""The port's multi-rank DASR step against the JAX package's mesh, on the
same weights: three steps of the port's ``SRNTrainer`` on two ranks of a
gloo world on the CPU (``tests/torch_dist_case.py``) against
``dasr_tpu``'s ``SRNTrainer`` on a 2-device 'data' mesh of the suite's CPU
devices, from one JAX init carried across, with the limits of
tests/torch_srn_step_case.py. And ``tiled_apply`` over two ranks against
one, with a tile count two does not divide (the wrap-padded batch).
``spatially_sharded_apply`` against JAX's: tests/test_torch_dist_shard.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_case as case
import torch_srn_step_case as srn
from dasr_tpu.core import mesh as meshlib
from dasr_tpu.nn.generators import RRDBNet as JRRDBNet
from dasr_tpu.train import checkpoints as jck
from dasr_tpu.train.srn_trainer import SRNConfig as JConfig
from dasr_tpu.train.srn_trainer import SRNTrainer as JTrainer
from dasr_tpu_torch.losses.lpips import LPIPS
from dasr_tpu_torch.ops.tiled import tiled_apply
from dasr_tpu_torch.train import checkpoints as ck

NF, NB, GC = 16, 1, 8


def _np(t):
    return jax.tree.map(np.asarray, jax.device_get(t))


@pytest.fixture(scope="module")
def rrdb():
    """A JAX x4 RRDBNet's variables and the port's state dict of them."""
    model = JRRDBNet(nf=NF, nb=NB, gc=GC, upscale=4)
    v = model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    return model, v, ck.rrdbnet_state_dict_from_jax(_np(v["params"]), NB)


def test_two_ranks_match_jaxs_two_device_mesh(rng):
    mesh = meshlib.make_mesh(n_data=2)
    kw = dict(nf=srn.NF, nb=srn.NB, gc=srn.GC, d_nf=srn.D_NF, d_n_layers=srn.D_LAYERS,
              fs="wavelet")
    jtr = JTrainer(JConfig(**kw), mesh=mesh)
    state = jtr.init_state(jax.random.key(0), lr_size=srn.LR_SIZE)
    lpips = LPIPS()
    lpips.load_state_dict(ck.state_dict_from_jax(lpips, _np(jtr.lpips_variables)))
    d = srn.SRNTrainer(srn.SRNConfig(**kw)).make_d()
    sds = {"G": ck.rrdbnet_state_dict_from_jax(_np(state.g.params), srn.NB),
           "D_target": ck.state_dict_from_jax(d, _np(state.d_target.params)),
           "LPIPS": lpips.state_dict()}
    batches = [srn.batch(rng) for _ in range(3)]
    want = []
    for b in batches:
        state, m = jtr.train_step(state, meshlib.shard_batch(mesh, b))
        want.append({k: float(v) for k, v in m.items()})

    got = case.run_ranks(case.run_srn_steps, 2, sds, batches, kw)[0]
    for i, (g, w) in enumerate(zip(got["metrics"], want)):
        assert set(g) == set(w)
        for k, v in w.items():
            rtol, atol = (srn.RTOL, srn.ATOL) if k.startswith("loss/") else (0, srn.SCORE_ATOL)
            np.testing.assert_allclose(g[k], v, rtol=rtol, atol=atol, err_msg=f"step {i}: {k}")
    for side, params, key_map in (
            ("G", state.g.params, jck.rrdbnet_key_map(srn.NB)),
            ("D_target", state.d_target.params, jck.nlayer_d_key_map(srn.D_LAYERS))):
        theirs = jck.export_params_to_state_dict(params, key_map)
        assert set(got[side]) == set(theirs), side
        for k, v in theirs.items():
            np.testing.assert_allclose(got[side][k].numpy(), v.numpy(), atol=srn.PARAM_ATOL,
                                       rtol=0, err_msg=f"{side} {k}")


def test_tiled_apply_over_two_ranks_equals_one(rng, rrdb):
    """Three 16-px tiles: the batch is wrap-padded to four, two a rank,
    and the fourth (tile 0 again) is dropped; one process runs all three."""
    _, _, sd = rrdb
    x = rng.random((1, 48, 16, 3), dtype=np.float32)
    got = case.run_ranks(case.run_tiled_rrdb, 2, sd, NF, NB, GC, x, 16, 4)
    assert [g[1] for g in got] == [[2], [2]]
    np.testing.assert_array_equal(got[0][0], got[1][0])
    net = srn.SRNTrainer(srn.SRNConfig(nf=NF, nb=NB, gc=GC)).g_model
    net.load_state_dict(sd)
    seen = []
    with torch.no_grad():
        one = tiled_apply(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                          lambda t: seen.append(t.shape[0]) or net(t), 4, tile=16, halo=4)
    assert seen == [3]
    np.testing.assert_allclose(got[0][0], one.permute(0, 2, 3, 1).numpy(), atol=1e-6, rtol=0)
