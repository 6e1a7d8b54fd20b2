"""The port's LPIPS breadth against the JAX package's, f32 on the CPU, from
the same seeded reference-format files (torchvision backbones, reference
heads) read by each package's ``load_lpips_params``: 'alex', 'vgg' and
'squeeze', in 'net-lin' and 'net' modes, versions 0.1 and 0.0, plain and
spatial, at 64x64 (batch 2), within 1e-5 abs + 1e-4 rel; the JAX variables
carried by ``state_dict_from_jax``; ``l2_distance``, ``dssim_distance`` and
``create_dist_model`` in every mode. One deviation, at 100x100: squeeze
(ROADMAP C.2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_lpips_breadth import _torch_squeeze_feats
from torch_lpips_weights import CHNS, backbone_sd, lin_sd, write

from dasr_tpu.losses import lpips as jlpips
from dasr_tpu_torch.losses import lpips
from dasr_tpu_torch.nn.vgg import SqueezeNetFeatures, load_torchvision_features
from dasr_tpu_torch.train.checkpoints import state_dict_from_jax

ATOL, RTOL = 1e-5, 1e-4  # a dozen convs deep, two conv implementations at f32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("lpips_weights")
    return {net: write(root, net) for net in CHNS}


def _pair(seed, hw=64, b=2):
    rng = np.random.default_rng(seed)
    return [(rng.random((b, hw, hw, 3), dtype=np.float32) * 2 - 1) for _ in range(2)]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _jax_variables(net, version, use_lins, files, hw=64):
    """JAX's variables of the files; every leaf comes from them, so the
    template is the init's structure, not its values."""
    model = jlpips.LPIPS(net=net, use_lins=use_lins, version=version)
    z = jnp.zeros((1, hw, hw, 3))
    bpath, lpath = files[net]
    base = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                        jax.eval_shape(model.init, jax.random.key(0), z, z))
    return jlpips.load_lpips_params(net, lin_path=lpath if use_lins else None,
                                    backbone_path=bpath, base_params=base)


@pytest.mark.parametrize("spatial", [False, True], ids=["plain", "spatial"])
@pytest.mark.parametrize("version", ["0.1", "0.0"])
@pytest.mark.parametrize("mode", ["net-lin", "net"])
@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_lpips_matches_jax(files, net, mode, version, spatial):
    a, b = _pair(0)
    use_lins = mode == "net-lin"
    variables = _jax_variables(net, version, use_lins, files)
    jm = jlpips.LPIPS(net=net, use_lins=use_lins, spatial=spatial, version=version)
    want = np.asarray(jm.apply(variables, jnp.asarray(a), jnp.asarray(b)))
    fn = lpips.create_dist_model(mode, net, version, lin_path=files[net][1],
                                 backbone_path=files[net][0], spatial=spatial)
    got = fn(_nchw(a), _nchw(b)).numpy()
    if spatial:
        assert got.shape == (2, 1, 64, 64) and want.shape == (2, 64, 64, 1)
        want = want.transpose(0, 3, 1, 2)
    else:
        assert got.shape == want.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_jax_variables_carry_over(files, net):
    """``state_dict_from_jax`` pairs the JAX tree with the port's LPIPS: the
    same weights as the port's own loader reads from the files."""
    variables = jax.tree.map(np.asarray, _jax_variables(net, "0.1", True, files))
    port = lpips.LPIPS(net=net)
    port.load_state_dict(state_dict_from_jax(port, variables), strict=True)
    loaded = lpips.load_lpips_params(lpips.LPIPS(net=net), lin_path=files[net][1],
                                     backbone_path=files[net][0])
    for k, v in loaded.state_dict().items():
        np.testing.assert_array_equal(port.state_dict()[k].numpy(), v.numpy(), err_msg=k)
    net_mode = lpips.LPIPS(net=net, use_lins=False)
    sd = state_dict_from_jax(net_mode, variables)
    assert not any(k.startswith("lin") for k in sd)
    net_mode.load_state_dict(sd, strict=True)


def test_squeeze_pools_as_torchvision_not_as_jax(files):
    """Deviation from dasr_tpu (ROADMAP C.2): JAX's ``SqueezeNetFeatures``
    pools with flax's VALID/floor ``max_pool`` (dasr_tpu/nn/vgg.py:136,
    140, 144); torchvision's squeezenet1_1, on which the published squeeze
    heads were trained, pools with ``ceil_mode=True``. At 64x64 the two
    agree (test_lpips_matches_jax); at 100x100 JAX's taps 3-7 are 11x11 and
    5x5, torchvision's 12x12 and 6x6. The port follows torchvision: it
    equals the torchvision-layout oracle of tests/test_lpips_breadth.py,
    and JAX's distance differs."""
    bsd, lsd = backbone_sd("squeeze"), lin_sd("squeeze")
    a, b = _pair(1, hw=100, b=1)
    net = SqueezeNetFeatures()
    load_torchvision_features(net, bsd)
    with torch.no_grad():
        shapes = [tuple(t.shape[-2:]) for t in net(_nchw(a))]
    assert shapes == [(49, 49), (24, 24), (12, 12), (6, 6), (6, 6), (6, 6), (6, 6)]

    fn = lpips.create_dist_model("net-lin", "squeeze", lin_path=files["squeeze"][1],
                                 backbone_path=files["squeeze"][0])
    got = float(fn(_nchw(a), _nchw(b)))
    shift = torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1)
    scale = torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1)
    fa, fb = (_torch_squeeze_feats(bsd, (_nchw(v) - shift) / scale) for v in (a, b))
    want = 0.0
    for k in range(7):
        na = fa[k] / (fa[k].pow(2).sum(1, keepdim=True).sqrt() + 1e-10)
        nb = fb[k] / (fb[k].pow(2).sum(1, keepdim=True).sqrt() + 1e-10)
        want += float(F.conv2d((na - nb) ** 2, lsd[f"lin{k}.model.1.weight"]).mean())
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)

    variables = _jax_variables("squeeze", "0.1", True, files, hw=100)
    jm = jlpips.LPIPS(net="squeeze")
    _, state = jm.apply(variables, jnp.asarray(a), jnp.asarray(b), capture_intermediates=True,
                        mutable=["intermediates"])
    jax_taps = state["intermediates"]["backbone"]["__call__"][0]
    assert [tuple(t.shape[1:3]) for t in jax_taps] == [
        (49, 49), (24, 24), (11, 11), (5, 5), (5, 5), (5, 5), (5, 5)]
    jax_d = float(np.asarray(jm.apply(variables, jnp.asarray(a), jnp.asarray(b))).sum())
    assert abs(jax_d - got) > 10 * (ATOL + RTOL * abs(got)), (jax_d, got)


def test_l2_and_dssim_match_jax():
    a, b = _pair(2, hw=32)
    np.testing.assert_allclose(lpips.l2_distance(_nchw(a), _nchw(b)).numpy(),
                               np.asarray(jlpips.l2_distance(a, b)), rtol=1e-6, atol=0)
    np.testing.assert_allclose(lpips.dssim_distance(_nchw(a), _nchw(b)),
                               jlpips.dssim_distance(a, b), rtol=1e-12, atol=0)
    np.testing.assert_allclose(lpips.dssim_distance(_nchw(a), _nchw(a)), 0.0, atol=1e-7)


@pytest.mark.parametrize("model", ["l2", "L2", "ssim", "DSSIM"])
def test_create_dist_model_host_modes_match_jax(model):
    a, b = _pair(3, hw=32)
    got = lpips.create_dist_model(model)(_nchw(a), _nchw(b))
    got = got.numpy() if torch.is_tensor(got) else got
    want = np.asarray(jlpips.create_dist_model(model)(a, b))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_create_dist_model_refuses_unknown_modes():
    with pytest.raises(NotImplementedError, match="not recognized"):
        lpips.create_dist_model("net-lin", net="resnet")
    with pytest.raises(NotImplementedError, match="not recognized"):
        lpips.create_dist_model("perceptual")
