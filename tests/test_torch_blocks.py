"""The port's nn blocks against the flax modules of dasr_tpu, f32 on the CPU,
on the same parameters (flax init, carried across as reference-named
state dicts) and the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.nn import blocks as jblocks
from dasr_tpu.nn.layers import conv_block as jconv_block
from dasr_tpu_torch.nn import blocks
from dasr_tpu_torch.nn.layers import conv_block
from dasr_tpu_torch.ops.rdb import TOLERANCES

ATOL, _ = TOLERANCES["jax_blocks"]
WIDTHS = [(16, 8), (64, 32)]


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1))))


def _rdb_sd(p, prefix=""):
    sd = {}
    for k in range(5):
        sd[f"{prefix}conv{k + 1}.0.weight"] = _oihw(p[f"conv{k}_kernel"])
        sd[f"{prefix}conv{k + 1}.0.bias"] = torch.tensor(np.asarray(p[f"conv{k}_bias"]))
    return sd


def _conv_sd(p, index):
    return {
        f"{index}.weight": _oihw(p["Conv_0"]["kernel"]),
        f"{index}.bias": torch.tensor(np.asarray(p["Conv_0"]["bias"])),
    }


def _compare(jmod, make_sd, tmod, x_nhwc):
    variables = jmod.init(jax.random.key(1), jnp.asarray(x_nhwc))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x_nhwc)))
    tmod.load_state_dict(make_sd(variables["params"]), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("nc,gc", WIDTHS)
def test_rdb5c_matches_flax(rng, nc, gc):
    x = rng.random((2, 12, 10, nc), dtype=np.float32)
    _compare(jblocks.RDB5C(nc=nc, gc=gc), _rdb_sd, blocks.RDB5C(nc, gc), x)


def test_rdb5c_norm_chain_matches_flax(rng):
    """With a norm layer both sides run the literal dense chain."""
    x = rng.random((1, 10, 12, 16), dtype=np.float32)
    _compare(jblocks.RDB5C(nc=16, gc=8, norm_type="instance"), _rdb_sd,
             blocks.RDB5C(16, 8, norm_type="instance"), x)


@pytest.mark.parametrize("nc,gc", WIDTHS)
def test_rrdb_matches_flax(rng, nc, gc):
    def sd(p):
        out = {}
        for j in range(3):
            out.update(_rdb_sd(p[f"RDB5C_{j}"], prefix=f"RDB{j + 1}."))
        return out

    x = rng.random((1, 9, 11, nc), dtype=np.float32)
    _compare(jblocks.RRDB(nc=nc, gc=gc), sd, blocks.RRDB(nc, gc), x)


@pytest.mark.parametrize("nc,gc", WIDTHS)
def test_upconv_matches_flax(rng, nc, gc):
    x = rng.random((1, 7, 9, nc), dtype=np.float32)
    _compare(jblocks.upconv(gc, 2, act_type="leakyrelu"),
             lambda p: _conv_sd(p["conv_block_0"], 1),
             blocks.upconv(nc, gc, 2, act_type="leakyrelu"), x)


@pytest.mark.parametrize("act", ["leakyrelu", "relu", "prelu", None])
def test_conv_block_matches_flax(rng, act):
    x = rng.random((2, 8, 6, 16), dtype=np.float32)

    def sd(p):
        out = _conv_sd(p, 0)
        if act == "prelu":
            out["1.weight"] = torch.tensor(np.asarray(p["PReLU_0"]["slope"]).reshape(1))
        return out

    _compare(jconv_block(8, 3, act_type=act), sd, conv_block(16, 8, 3, act_type=act), x)


def test_pixelshuffle_block_matches_flax(rng):
    x = rng.random((1, 5, 6, 16), dtype=np.float32)
    _compare(jblocks.pixelshuffle_block(8, 2, act_type="relu"),
             lambda p: _conv_sd(p["conv_block_0"], 0),
             blocks.pixelshuffle_block(16, 8, 2, act_type="relu"), x)


def test_rdb5c_caches_kernel_weights_per_parameter_version():
    """The cache serves no_grad calls; under grad mode the weights are
    fresh differentiable casts of the parameters."""
    m = blocks.RDB5C(32, 32)
    with torch.no_grad():
        first = m.kernel_weights(torch.float32)
        assert m.kernel_weights(torch.float32) is first
        m.conv1[0].weight.add_(1.0)
        second = m.kernel_weights(torch.float32)
        assert second is not first
        torch.testing.assert_close(second[0][0], m.conv1[0].weight.permute(2, 3, 1, 0))
        assert m.kernel_weights(torch.bfloat16)[0][0].dtype == torch.bfloat16
    ks, bs = m.kernel_weights(torch.float32)
    assert ks[0].requires_grad and bs[0] is m.conv1[0].bias
    assert m.kernel_weights(torch.float32)[0][0] is not ks[0]
