"""The port's DDM-conditioned generators and factories against dasr_tpu's, f32
on the CPU, from one flax init carried across: RRDBNetResidualConv (both
flavors), RRDBNetSEAN (upconv and pixelshuffle), the pixelshuffle RRDBNet,
define_G's RRDB_Residual_conv[_concat] / RRDB_SEAN and define_patchD, at nf
16, nb 1, ada_nb 1, gc 8, on a 16x16 LR and a (B, 16, 16, 1) map."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.models import registry as jreg
from dasr_tpu.nn.generators import RRDBNet as JRRDBNet
from dasr_tpu.nn.generators import RRDBNetResidualConv as JResConv
from dasr_tpu.nn.generators import RRDBNetSEAN as JSEAN
from dasr_tpu_torch.models import registry
from dasr_tpu_torch.nn.generators import RRDBNet, RRDBNetResidualConv, RRDBNetSEAN
from dasr_tpu_torch.ops.rdb import TOLERANCES
from dasr_tpu_torch.train import checkpoints as ck

ATOL, _ = TOLERANCES["jax_network"]
NF, NB, NB_ADA, GC = 16, 1, 1, 8


def _inputs(rng):
    return (rng.random((2, 16, 16, 3), dtype=np.float32),
            rng.random((2, 16, 16, 1), dtype=np.float32))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _check(jnet, tnet, make_sd, args):
    variables = jax.tree.map(np.asarray, jnet.init(jax.random.key(4), *map(jnp.asarray, args)))
    want = np.asarray(jnet.apply(variables, *map(jnp.asarray, args)))
    tnet.load_state_dict(make_sd(variables), strict=True)
    with torch.no_grad():
        got = tnet(*map(_nchw, args)).permute(0, 2, 3, 1).float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    n_flax = sum(v.size for v in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in tnet.parameters()) == n_flax


@pytest.mark.parametrize("concat", [False, True])
def test_residual_conv_generator_matches_jax(rng, concat):
    block = "RRDBResidualConvConcat" if concat else "RRDBResidualConv"
    _check(JResConv(nf=NF, nb=NB, gc=GC, nb_ada=NB_ADA, concat=concat),
           RRDBNetResidualConv(nf=NF, nb=NB, gc=GC, nb_ada=NB_ADA, concat=concat),
           lambda v: ck.conditioned_g_state_dict_from_jax(v, NB, NB_ADA, block), _inputs(rng))


@pytest.mark.parametrize("upsample_mode", ["upconv", "pixelshuffle"])
def test_sean_generator_matches_jax(rng, upsample_mode):
    _check(JSEAN(nf=NF, nb=NB, gc=GC, nb_ada=NB_ADA, upsample_mode=upsample_mode),
           RRDBNetSEAN(nf=NF, nb=NB, gc=GC, nb_ada=NB_ADA, upsample_mode=upsample_mode),
           lambda v: ck.conditioned_g_state_dict_from_jax(v, NB, NB_ADA, "RRDBSEAN",
                                                          upsample_mode=upsample_mode),
           _inputs(rng))


def test_pixelshuffle_rrdbnet_matches_jax(rng):
    """ROADMAP C.1: the reference's PixelShuffle order in the port, JAX's
    parameters permuted on the way in."""
    _check(JRRDBNet(nf=NF, nb=NB, gc=GC, upsample_mode="pixelshuffle"),
           RRDBNet(nf=NF, nb=NB, gc=GC, upsample_mode="pixelshuffle"),
           lambda v: ck.rrdbnet_state_dict_from_jax(v, NB, "pixelshuffle"), _inputs(rng)[:1])


def _opt(which, **net):
    return {"scale": 4, "bf16": False,
            "network_G": {"which_model_G": which, "nf": NF, "nb": NB, "gc": GC, "ada_nb": NB_ADA},
            "network_patchD": net}


@pytest.mark.parametrize("which,block", [("RRDB_Residual_conv", "RRDBResidualConv"),
                                         ("RRDB_Residual_conv_concat", "RRDBResidualConvConcat"),
                                         ("RRDB_SEAN", "RRDBSEAN")])
def test_define_g_matches_jax(rng, which, block):
    opt = _opt(which)
    tnet = registry.define_G(opt)
    assert isinstance(tnet, RRDBNetSEAN if which == "RRDB_SEAN" else RRDBNetResidualConv)
    _check(jreg.define_G(opt), tnet,
           lambda v: ck.conditioned_g_state_dict_from_jax(v, NB, NB_ADA, block), _inputs(rng))


@pytest.mark.parametrize("net", [{}, {"FS_type": "avg_pool", "kernel_size": 11}])
def test_define_patchd_matches_jax(rng, net):
    opt = _opt("RRDB_net", **net)
    tnet = registry.define_patchD(opt)
    _check(jreg.define_patchD(opt), tnet, lambda v: ck.state_dict_from_jax(tnet, v),
           _inputs(rng)[:1])
    with pytest.raises(NotImplementedError, match="not recognized"):
        registry.define_patchD(_opt("RRDB_net", which_patchD="nld_s1"))
