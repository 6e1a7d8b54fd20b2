"""The port's DDM-conditioned and channel-attention blocks against the flax
modules of dasr_tpu, f32 on the CPU: each block from a flax init carried
across (``checkpoints.adaptive_block_state_dict_from_jax``), on the same
numpy inputs (a 12x10 map), and its parameter count equal to flax's,
SEAN's dormant beta stack included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.nn import adaptive_blocks as jab
from dasr_tpu.nn import blocks as jblocks
from dasr_tpu_torch.nn import adaptive_blocks as ab
from dasr_tpu_torch.nn import blocks
from dasr_tpu_torch.ops.rdb import TOLERANCES
from dasr_tpu_torch.train import checkpoints as ck

ATOL, _ = TOLERANCES["jax_blocks"]
NC, GC, H, W = 16, 8, 12, 10

# (class name, flax module, port module, second input: None, "map" (B, 1)
# per pixel, "mask" (B,), "cond" 3 channels, "stream" 4 channels); the input
# width is the module's nc
CASES = [
    ("RRDBResidualConv", jblocks.RRDBResidualConv(nc=NC, gc=GC),
     lambda: blocks.RRDBResidualConv(NC, GC), "map"),
    ("RRDBResidualConvConcat", jblocks.RRDBResidualConvConcat(nc=32, gc=16),
     lambda: blocks.RRDBResidualConvConcat(32, 16), "map"),
    ("AffineModule", jab.AffineModule(nf=NC), lambda: ab.AffineModule(NC), "map"),
    ("RRDBAffine", jab.RRDBAffine(nc=NC, gc=GC), lambda: ab.RRDBAffine(NC, GC), "map"),
    ("SEANModule", jab.SEANModule(nf=NC), lambda: ab.SEANModule(NC), "map"),
    ("RRDBSEAN", jab.RRDBSEAN(nc=NC, gc=GC), lambda: ab.RRDBSEAN(NC, GC), "map"),
    ("RRDBAda", jab.RRDBAda(nc=32, gc=16), lambda: ab.RRDBAda(32, 16), "map"),
    ("AdaptiveModule", jab.AdaptiveModule(nf=NC, ada_nb=1), lambda: ab.AdaptiveModule(NC, 1),
     "mask"),
    ("RRDBCatInput", jab.RRDBCatInput(nc=NC, gc=GC), lambda: ab.RRDBCatInput(NC, GC, 3), "cond"),
    ("RRDBWithFeatureOut", jab.RRDBWithFeatureOut(nc=NC, gc=GC, tap_ch=8),
     lambda: ab.RRDBWithFeatureOut(NC, GC, 8), "stream"),
    ("CALayer", jab.CALayer(channel=32, reduction=16), lambda: ab.CALayer(32, 16), None),
    ("RCAB", jab.RCAB(nf=32, reduction=16), lambda: ab.RCAB(32, 16), None),
    ("CARRDB", jab.CARRDB(nc=32, gc=16, reduction=16), lambda: ab.CARRDB(32, 16, 16), None),
]


def _inputs(rng, nc, second):
    x = rng.random((2, H, W, nc), dtype=np.float32)
    extra = {"map": (2, H, W, 1), "cond": (2, H, W, 3), "stream": (2, H, W, 4)}
    if second is None:
        return (x,)
    if second == "mask":
        return x, np.array([1.0, 0.0], np.float32)
    return x, rng.random(extra[second], dtype=np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2) if a.ndim == 4 else a))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("kind,jmod,make,second", CASES, ids=[c[0] for c in CASES])
def test_block_matches_flax(rng, kind, jmod, make, second):
    tmod = make()
    nc = getattr(jmod, "nc", None) or getattr(jmod, "nf", None) or jmod.channel
    args = _inputs(rng, nc, second)
    variables = jax.tree.map(np.asarray, jmod.init(jax.random.key(5), *map(jnp.asarray, args)))
    # the constant-initialised scalars away from their init, so the carry-over is checked
    params = variables["params"]
    for name in ("gamma1", "bias1", "alpha_gamma", "alpha_beta", "lda"):
        for node in _nodes_with(params, name):
            node[name] = rng.normal(0.5, 0.2, node[name].shape).astype(np.float32)
    want = jmod.apply(variables, *map(jnp.asarray, args))
    tmod.load_state_dict(ck.adaptive_block_state_dict_from_jax(kind, variables, ada_nb=1),
                         strict=True)
    with torch.no_grad():
        got = tmod(*map(_nchw, args))
    for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
        w = np.asarray(w)
        assert g.shape == _nchw(w).shape
        np.testing.assert_allclose(_nhwc(g), w, atol=ATOL, rtol=0)
    n_flax = sum(np.asarray(v).size for v in jax.tree.leaves(params))
    assert sum(p.numel() for p in tmod.parameters()) == n_flax


def _nodes_with(tree, name):
    if isinstance(tree, dict):
        if name in tree:
            yield tree
        for v in tree.values():
            yield from _nodes_with(v, name)


def test_sean_keeps_its_dormant_beta_stack():
    """The reference's unused beta stack of the repeated map is held as
    parameters, as in the flax module (adaptive_blocks.py:83-92), and takes
    no part in the forward."""
    m = ab.SEANModule(NC)
    dormant = sum(p.numel() for p in m.rep_beta_dormant.parameters())
    assert dormant == 2 * (9 * NC * NC + NC)
    x, ddm = torch.rand(1, NC, 6, 5), torch.rand(1, 1, 6, 5)
    with torch.no_grad():
        before = m(x, ddm)
        for p in m.rep_beta_dormant.parameters():
            p.add_(1.0)
        torch.testing.assert_close(m(x, ddm), before, rtol=0, atol=0)
