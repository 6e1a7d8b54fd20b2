"""The networks of the paired-data trainers against dasr_tpu's flax modules,
f32 on the CPU, from one flax init carried across
(``train/checkpoints.py:state_dict_from_jax``), at 1e-5 with equal
parameter counts: SRResNet (with and without BatchNorm), the four
DeResnetSRN names of define_G, DiscriminatorVGG, every
``make_vgg_discriminator`` name and every define_D name in training mode
(outputs, then the BatchNorm running statistics), the spectral-norm D with
``update_stats`` on and off (outputs, then ``u`` and ``sigma``). Also the
one deviation of the nets (ROADMAP C.2): in NAC mode the port's
ResNetBlock keeps the second activation, as the reference and
``dasr_tpu``'s own ResNetBlock do, where ``dasr_tpu``'s SRResNet drops it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.models import registry as jreg
from dasr_tpu.nn import blocks as jblocks
from dasr_tpu.nn import discriminators as jd
from dasr_tpu.nn import generators as jg
from dasr_tpu_torch.models import registry
from dasr_tpu_torch.nn import blocks, discriminators, generators
from dasr_tpu_torch.nn.layers import BatchNorm2d, stats_updates
from dasr_tpu_torch.nn.sft import ACDVGGBN96
from dasr_tpu_torch.ops.rdb import TOLERANCES
from dasr_tpu_torch.train import checkpoints as ck

ATOL, _ = TOLERANCES["jax_blocks"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small ops: torch's intra-op threads only contend with the other
    test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _out(t):
    t = t.detach().float()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


def _check(jnet, tnet, x, train=False, atol=ATOL, **kw):
    """Init jnet, carry it into tnet, hold the outputs at ``atol`` and the
    parameter counts equal; in training mode (``train``) also the BatchNorm
    running statistics after the forward. Returns (flax variables, flax
    variables after)."""
    variables = jax.tree.map(np.asarray, jnet.init(jax.random.key(4), jnp.asarray(x), **kw))
    tnet.load_state_dict(ck.state_dict_from_jax(tnet, variables), strict=True)
    after = variables
    if train and "batch_stats" in variables:
        want, mut = jnet.apply(variables, jnp.asarray(x), mutable=["batch_stats"], **kw)
        after = dict(variables, batch_stats=jax.tree.map(np.asarray, mut["batch_stats"]))
    else:
        want = jnet.apply(variables, jnp.asarray(x), **kw)
    tnet.train(train)
    with torch.no_grad():
        got = _out(tnet(_nchw(x)))
    assert got.shape == np.shape(want)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)
    n_flax = sum(v.size for v in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in tnet.parameters()) == n_flax
    if train:
        bns = [m for m in tnet.modules() if isinstance(m, BatchNorm2d)]
        want_sd = ck.state_dict_from_jax(tnet, after)
        for name, m in tnet.named_modules():
            if m in bns:
                for buf in ("running_mean", "running_var"):
                    np.testing.assert_allclose(getattr(m, buf).numpy(),
                                               want_sd[f"{name}.{buf}"].numpy(),
                                               atol=ATOL, rtol=0, err_msg=f"{name}.{buf}")
    return variables, after


@pytest.mark.parametrize("norm_type", [None, "batch"])
def test_srresnet_matches_jax(rng, norm_type):
    """CNA, as every shipped config, with relu and the pixelshuffle
    upsampler, as the reference builds it; the pixelshuffle convs' channels
    are permuted into nn.PixelShuffle's order on the way in (ROADMAP C.1)."""
    kw = dict(nf=8, nb=2, norm_type=norm_type, mode="CNA")
    _check(jg.SRResNet(**kw), generators.SRResNet(**kw), rng.random((2, 8, 8, 3), np.float32),
           train=norm_type is not None)


def test_resnet_block_keeps_its_nac_activation_as_the_reference(rng):
    """ROADMAP C.2: dasr_tpu's SRResNet drops the second conv block's
    activation in NAC mode (dasr_tpu/nn/generators.py:340-347); the
    reference's ResNetBlock (block.py:221-251) and dasr_tpu's own
    ResNetBlock keep it. The port's ResNetBlock equals dasr_tpu's
    ResNetBlock, so its NAC SRResNet differs from dasr_tpu's."""
    x = rng.random((2, 8, 8, 8), np.float32) - 0.5
    _check(jblocks.ResNetBlock(nf=8, norm_type="batch", act_type="relu", mode="NAC"),
           blocks.ResNetBlock(8, "batch", "relu", "NAC"), x, train=True)
    kw = dict(nf=8, nb=2, norm_type=None, mode="NAC")
    jnet, tnet = jg.SRResNet(**kw), generators.SRResNet(**kw)
    x = rng.random((1, 8, 8, 3), np.float32)
    variables = jax.tree.map(np.asarray, jnet.init(jax.random.key(4), jnp.asarray(x)))
    tnet.load_state_dict(ck.state_dict_from_jax(tnet, variables), strict=True)
    with torch.no_grad():
        got = _out(tnet(_nchw(x)))
    assert np.abs(got - np.asarray(jnet.apply(variables, jnp.asarray(x)))).max() > 1e-3


@pytest.mark.parametrize("which", ["De_Resnet", "De_RRDB", "De_Resnet_bilinear", "De_Resnet2xd"])
def test_define_g_de_resnet_family_matches_jax(rng, which):
    """define_G's De_Resnet family: the config's act_type for De_Resnet
    (PReLU here, in NAC mode), 'relu' for the other three (networks.py:106-127)."""
    opt = {"scale": 4, "bf16": False,
           "network_G": {"which_model_G": which, "nf": 8, "nb": 2, "norm_type": None,
                         "mode": "NAC", "act_type": "prelu"}}
    tnet = registry.define_G(opt)
    assert isinstance(tnet, generators.DeResnetSRN)
    _check(jreg.define_G(opt), tnet, rng.random((2, 16, 16, 3), np.float32))


def test_discriminator_vgg_matches_jax(rng):
    _check(jd.DiscriminatorVGG(input_size=32, nf=8), discriminators.DiscriminatorVGG(32, nf=8),
           rng.random((2, 32, 32, 3), np.float32), train=True)


# define_D names: (the input size they take, the network_D options). Both
# sides take a BatchNorm's variance as flax does, E[x^2] - E[x]^2 in f32,
# whose rounding (in another summation order on each side) grows with
# E[x]^2 / var; through the eleven BatchNorms of the 96 patch variant the
# features (no head averages them) measured 1.55e-5 apart, so that variant
# is held at 2e-5, the others at 1e-5.
PATCH_ATOL = 2e-5
D_NAMES = {
    "discriminator_vgg_128": (128, {"nf": 4}),
    "discriminator_vgg_96": (96, {"nf": 4}),
    "discriminator_vgg_192": (192, {"nf": 4}),
    "discriminator_vgg_192_wavelet": (192, {"nf": 4}),
    "discriminator_vgg_48": (48, {"nf": 8}),
    "discriminator_vgg_96_patch": (96, {"nf": 4}),
    "discriminator_vgg_patch": (96, {"nf": 4, "mode": "NAC"}),
    "discriminator_patch": (32, {"nf": 8, "n_layers": 2}),
    "DSGAN": (24, {}),
}


@pytest.mark.parametrize("which", sorted(D_NAMES))
def test_define_d_matches_jax(rng, which):
    """Every VGG name (define_D's make_vgg_discriminator zoo and
    discriminator_vgg_128), the patch D and the DSGAN D, in training mode:
    outputs and BatchNorm running statistics."""
    size, net = D_NAMES[which]
    opt = {"bf16": False, "network_D": {"which_model_D": which, **net}}
    tnet = registry.define_D(opt)
    if which in discriminators._VGG_VARIANTS:
        assert isinstance(tnet, discriminators.DiscriminatorVGGStack)
        mk = discriminators.make_vgg_discriminator(which, nf=net["nf"],
                                                   mode=net.get("mode", "CNA"))
        assert [tuple(p.shape) for p in mk.parameters()] == [
            tuple(p.shape) for p in tnet.parameters()]
    x = rng.random((2, size, size, 3), np.float32)
    jnet = jreg.define_D(opt)
    if which in ("discriminator_patch", "DSGAN"):
        # InstanceNorm / the FSD body: held on their own, not by _check
        variables = jax.tree.map(np.asarray, jnet.init(jax.random.key(4), jnp.asarray(x)))
        if which == "DSGAN":
            want, _ = jnet.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        else:
            want = jnet.apply(variables, jnp.asarray(x))
        tnet.load_state_dict(ck.state_dict_from_jax(tnet, variables), strict=True)
        with torch.no_grad():
            got = _out(tnet.train()(_nchw(x)))
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
        return
    _check(jnet, tnet, x, train=True, atol=PATCH_ATOL if which.endswith("96_patch") else ATOL)


def test_dis_acd_is_refused():
    """define_D builds 'dis_acd' (``ACDVGGBN96``, held against flax in
    tests/test_torch_sft.py); the SRGAN trainer refuses its two heads by
    name, as dasr_tpu's SRGAN never builds it (``srgan_trainer.py:64-66``)."""
    assert isinstance(registry.define_D({"network_D": {"which_model_D": "dis_acd"}}),
                      ACDVGGBN96)
    opt = {"model": "srgan", "is_train": True, "network_G": {"which_model_G": "RRDB_net",
                                                             "nf": 8, "nb": 1, "gc": 4},
           "network_D": {"which_model_D": "dis_acd"}}
    with pytest.raises(NotImplementedError, match=r"\[dis_acd\]: ACDVGGBN96 gives two heads"):
        registry.create_model(opt)
    assert isinstance(registry.define_pairD(
        {"network_D": {"which_model_D": "dis_acd", "which_model_pairD": "discriminator_vgg_48"}}),
        discriminators.DiscriminatorVGGStack)


@pytest.mark.parametrize("update_stats", [False, True])
def test_spectral_norm_d_matches_jax(rng, update_stats):
    """DiscriminatorVGG128SN (define_D's discriminator_vgg_128_SN): the
    output with one power iteration from the stored ``u``, and ``u`` and
    ``sigma`` after, stored only with ``update_stats``."""
    x = rng.random((1, 128, 128, 3), np.float32)
    jnet, tnet = jd.DiscriminatorVGG128SN(), registry.define_D(
        {"network_D": {"which_model_D": "discriminator_vgg_128_SN"}})
    variables = jax.tree.map(np.asarray, jnet.init(jax.random.key(4), jnp.asarray(x)))
    tnet.load_state_dict(ck.state_dict_from_jax(tnet, variables), strict=True)
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    want, mut = jnet.apply(variables, jnp.asarray(x), update_stats=update_stats,
                           mutable=["batch_stats"])
    with torch.no_grad():
        got = _out(tnet(_nchw(x), update_stats=update_stats))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    after = ck.state_dict_from_jax(tnet, dict(variables, batch_stats=jax.tree.map(
        np.asarray, mut["batch_stats"])))
    sd = tnet.state_dict()
    moved = 0
    for k in sd:
        if k.endswith((".u", ".sigma")):
            np.testing.assert_allclose(sd[k].numpy(), after[k].numpy(), atol=ATOL, rtol=1e-5,
                                       err_msg=k)
            moved += not torch.equal(sd[k], before[k])
    # a 1-wide u stays at +-1, so not every layer's state moves
    assert (moved > 12) if update_stats else moved == 0
    # the layer's own setting holds when the call names none
    with stats_updates(tnet, False), torch.no_grad():
        tnet(_nchw(x))
    assert all(torch.equal(tnet.state_dict()[k], sd[k]) for k in sd)
