"""Every class of the port's nn/misc_nets.py against dasr_tpu's flax module,
at the smallest input it takes, carried over by the type-paired
``state_dict_from_jax``, within 1e-5 (f32, CPU); ``make_layer`` and
``flow_warp`` too. Where the port follows the reference and JAX does not
(ROADMAP C.5: ``MINCNet``'s last ReLU and ceil pooling, ``ResnetGenerator``'s
transposed-conv taps), the flax comparison holds the parts both agree on,
and a torch oracle written from the reference's form holds the rest."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

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


def _jax_same_ups(net):
    """``net`` (a port ResnetGenerator) with its ups taking JAX's
    ConvTranspose 'SAME' taps: the full transposed conv cropped to 2n."""
    for m in net.modules():
        if isinstance(m, tm.ConvTranspose2d):
            def same(x, m=m):
                y = F.conv_transpose2d(x, m.weight, m.bias, stride=2)
                return y[..., : 2 * x.shape[-2], : 2 * x.shape[-1]]

            m.forward = same
    return net


# name: (flax module, port module, input (B, H, W, C)[, the port's output
# mapped to the part both agree on])
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
    # at 16x16 floor and ceil pools agree; JAX keeps conv53's ReLU
    "MINCNet": (jm.MINCNet, tm.MINCNet, (1, 16, 16, 3), F.relu),
    "ResNet101Features": (jm.ResNet101Features, tm.ResNet101Features, (1, 16, 16, 3)),
    # everything but the ups' taps
    "ResnetGenerator": (lambda: jm.ResnetGenerator(ngf=4, n_blocks=2),
                        lambda: _jax_same_ups(tm.ResnetGenerator(ngf=4, n_blocks=2)),
                        (2, 12, 16, 3)),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_misc_net_matches_flax(rng, name):
    make_j, make_t, shape, *agree = NETS[name]
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
        out = tnet.eval()(_nchw(x))
        got = _nhwc(agree[0](out) if agree else out)
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


def _flax_into(tnet, make_j, x):
    """``tnet`` with a flax init of ``make_j()`` carried over; JAX's output."""
    jnet = make_j()
    variables = _np(jnet.init(jax.random.key(5), jnp.asarray(x)))
    tnet.load_state_dict(ck.state_dict_from_jax(tnet, variables), strict=True)
    return np.asarray(jnet.apply(variables, jnp.asarray(x)))


def test_minc_net_is_the_references_not_jaxs(rng):
    """Deviation from dasr_tpu (ROADMAP C.5): the reference's MINCNet
    (architecture.py:1116-1175) pools with ``ceil_mode=True`` and leaves
    ``conv53`` without a ReLU; JAX's pools with floor and keeps the ReLU. At
    18x18 the taps are 18, 9, 5, 3, 2 (JAX's 18, 9, 4, 2, 1). The port
    equals a torch oracle written from the reference's form."""
    x = rng.random((1, 18, 18, 3), dtype=np.float32)
    net = tm.MINCNet().eval()
    want_jax = _flax_into(net, jm.MINCNet, x)
    pool = nn.MaxPool2d(2, stride=2, padding=0, ceil_mode=True)
    convs = [getattr(net, f"conv{s}{j}") for s, n in ((1, 2), (2, 2), (3, 3), (4, 3), (5, 3))
             for j in range(1, n + 1)]
    oracle = []
    for conv in convs:
        ref = nn.Conv2d(conv.in_channels, conv.out_channels, 3, 1, 1)
        ref.load_state_dict(conv.state_dict())
        oracle.append(ref)
    with torch.no_grad():
        out = _nchw(x)
        for i, ref in enumerate(oracle):
            if i in (2, 4, 7, 10):  # after conv12, conv22, conv33, conv43
                out = pool(out)
            out = ref(out)
            if i < len(oracle) - 1:
                out = F.relu(out)
        got = net(_nchw(x))
    assert got.shape == out.shape == (1, 512, 2, 2) and want_jax.shape == (1, 1, 1, 512)
    np.testing.assert_allclose(got.numpy(), out.numpy(), atol=ATOL, rtol=0)
    assert (got < 0).any()  # no ReLU after conv53


def test_resnet_generator_upsamples_as_the_reference_not_as_jax(rng):
    """Deviation from dasr_tpu (ROADMAP C.5): the reference's CycleGAN
    generator (architecture.py:301-388) upsamples with
    ``nn.ConvTranspose2d(k 3, stride 2, padding=1, output_padding=1)``;
    JAX's 'SAME' transposed conv takes the taps one pixel off. The port
    equals a torch oracle with the reference's layers and its weights, and
    JAX's output differs."""
    x = rng.random((2, 12, 16, 3), dtype=np.float32)
    net = tm.ResnetGenerator(ngf=4, n_blocks=2).eval()
    want_jax = _flax_into(net, lambda: jm.ResnetGenerator(ngf=4, n_blocks=2), x)
    layers = []
    for m in net.model:
        if isinstance(m, tm.ConvTranspose2d):
            ref = nn.ConvTranspose2d(m.in_channels, m.out_channels, 3, stride=2, padding=1,
                                     output_padding=1)
            ref.load_state_dict(m.state_dict())
            m = ref
        layers.append(m)
    with torch.no_grad():
        got = net(_nchw(x))
        want = nn.Sequential(*layers)(_nchw(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    assert got.shape == (2, 3, 12, 16)
    assert np.abs(_nhwc(got) - want_jax).max() > 100 * ATOL
