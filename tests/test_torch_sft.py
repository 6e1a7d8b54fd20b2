"""The port's SFT-GAN networks and CLI against dasr_tpu's, on the CPU.

SFTNet loads a reference-format state dict by the reference's names and
matches JAX's SFTNet on the same dict through ``import_sftnet_params``
(which permutes the HR branch for JAX's depth-to-space) within 1e-5; the
type-paired carry-over takes a flax SFTNet across; the port's
``sftgan_test`` writes the PNGs JAX's writes from the same ``.pth`` and
segmentation maps, within one grey level; ``ACDVGGBN96`` ('dis_acd')
matches flax in training mode, both heads and the BatchNorm running
statistics, within 1e-5. The reference-format weights are drawn with
variance 1 / fan_in, so the activations stay of order one and an absolute
1e-5 is meaningful."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.cli import sftgan_test as jax_sftgan_test
from dasr_tpu.data.io import read_img, save_img
from dasr_tpu.nn.sft import ACDVGGBN96 as JACD
from dasr_tpu.nn.sft import SFTNet as JSFTNet
from dasr_tpu.train.checkpoints import import_sftnet_params
from dasr_tpu_torch.cli import sftgan_test
from dasr_tpu_torch.models import registry
from dasr_tpu_torch.nn.sft import ACDVGGBN96, SFTNet
from dasr_tpu_torch.train import checkpoints as ck

NB = 2
ATOL = 1e-5


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def reference_sd(rng, n_blocks=NB):
    """A reference-format SFT_Net state dict (sft_arch.py:40-75 names)."""
    sd = {}

    def conv(name, cin, cout, k):
        std = 1.0 / np.sqrt(cin * k * k)
        sd[name + ".weight"] = torch.tensor(rng.normal(0, std, (cout, cin, k, k)),
                                            dtype=torch.float32)
        sd[name + ".bias"] = torch.tensor(rng.normal(0, 0.01, (cout,)), dtype=torch.float32)

    def sft_layer(prefix):
        for kind in ("scale", "shift"):
            conv(f"{prefix}.SFT_{kind}_conv0", 32, 32, 1)
            conv(f"{prefix}.SFT_{kind}_conv1", 32, 64, 1)

    conv("conv0", 3, 64, 3)
    for i in range(n_blocks):
        sft_layer(f"sft_branch.{i}.sft0")
        conv(f"sft_branch.{i}.conv0", 64, 64, 3)
        sft_layer(f"sft_branch.{i}.sft1")
        conv(f"sft_branch.{i}.conv1", 64, 64, 3)
    sft_layer(f"sft_branch.{n_blocks}")
    conv(f"sft_branch.{n_blocks + 1}", 64, 64, 3)
    conv("HR_branch.0", 64, 256, 3)
    conv("HR_branch.3", 64, 256, 3)
    conv("HR_branch.6", 64, 64, 3)
    conv("HR_branch.8", 64, 3, 3)
    conv("CondNet.0", 8, 128, 4)
    for j in (2, 4, 6):
        conv(f"CondNet.{j}", 128, 128, 1)
    conv("CondNet.8", 128, 32, 1)
    return sd


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _inputs(rng):
    return (rng.random((1, 10, 12, 3), dtype=np.float32),
            rng.random((1, 40, 48, 8), dtype=np.float32))


def test_sftnet_loads_a_reference_pth_and_matches_jax(rng, tmp_path):
    sd = reference_sd(rng)
    torch.save(sd, tmp_path / "sft.pth")
    net = SFTNet(n_blocks=NB)
    ck.load_pth(net, str(tmp_path / "sft.pth"))
    assert set(net.state_dict()) == set(sd)
    img, seg = _inputs(rng)
    variables = import_sftnet_params({k: v.numpy() for k, v in sd.items()}, n_blocks=NB)
    want = np.asarray(JSFTNet(n_blocks=NB).apply(variables, img, seg))
    with torch.no_grad():
        got = net(_nchw(img), _nchw(seg)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 40, 48, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_sftnet_carries_over_from_flax(rng):
    img, seg = _inputs(rng)
    jnet = JSFTNet(n_blocks=NB)
    variables = jax.tree.map(np.asarray, jnet.init(jax.random.key(1), img, seg))
    net = registry.define_G({"bf16": False, "network_G": {"which_model_G": "sft_arch"}})
    assert isinstance(net, SFTNet) and len(net.sft_branch) == 16 + 2
    net = SFTNet(n_blocks=NB)
    net.load_state_dict(ck.state_dict_from_jax(net, variables), strict=True)
    with torch.no_grad():
        got = net(_nchw(img), _nchw(seg)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.apply(variables, img, seg)), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("seg_format", ["pth", "npy_hwc"])
def test_sftgan_test_cli_matches_jax(rng, tmp_path, seg_format):
    sd = reference_sd(rng)
    model = str(tmp_path / "sft.pth")
    torch.save(sd, model)
    img_dir, seg_dir = tmp_path / "imgs", tmp_path / "segs"
    os.makedirs(img_dir)
    os.makedirs(seg_dir)
    for name, (h, w) in (("a", (40, 44)), ("b", (35, 48))):
        save_img(rng.random((h, w, 3), dtype=np.float32), str(img_dir / f"{name}.png"))
        hc, wc = h - h % 8, w - w % 8  # modcrop 8; the maps live at HR size
        seg = rng.random((8, hc, wc), dtype=np.float32)
        if seg_format == "pth":
            torch.save(torch.from_numpy(seg), seg_dir / f"{name}_bic.pth")
        else:
            np.save(seg_dir / f"{name}_bic.npy", seg.transpose(1, 2, 0))
    common = ["--model", model, "--img_dir", str(img_dir), "--seg_dir", str(seg_dir),
              "--n_blocks", str(NB)]
    jax_sftgan_test.main(common + ["--out", str(tmp_path / "jax")])
    written = sftgan_test.main(common + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert sorted(os.path.basename(p) for p in written) == ["a_rlt.png", "b_rlt.png"]
    for name, shape in (("a", (40, 40, 3)), ("b", (32, 48, 3))):
        got = read_img(str(tmp_path / "port" / f"{name}_rlt.png"))
        want = read_img(str(tmp_path / "jax" / f"{name}_rlt.png"))
        assert got.shape == want.shape == shape
        assert np.abs(got - want).max() <= 1 / 255 + 1e-6


def test_sftgan_test_refuses_an_orbax_directory(tmp_path):
    with pytest.raises(NotImplementedError, match="JAX-only"):
        sftgan_test.main(["--model", str(tmp_path), "--img_dir", str(tmp_path), "--seg_dir",
                          str(tmp_path), "--out", str(tmp_path / "o"), "--device", "cpu"])


def test_acd_discriminator_matches_flax_with_batch_statistics(rng):
    """Training mode: the GAN and class heads, and the seven BatchNorms'
    running statistics after the forward; then eval mode on them."""
    x = rng.random((2, 96, 96, 3), dtype=np.float32)
    jnet = JACD()
    variables = jax.tree.map(np.asarray, jnet.init(jax.random.key(2), jnp.asarray(x)))
    (jgan, jcls), upd = jnet.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    net = registry.define_D({"bf16": False, "network_D": {"which_model_D": "dis_acd"}})
    assert isinstance(net, ACDVGGBN96)
    net.load_state_dict(ck.state_dict_from_jax(net, variables), strict=True)
    assert sum(p.numel() for p in net.parameters()) == sum(
        v.size for v in jax.tree.leaves(variables["params"]))
    with torch.no_grad():
        gan, cls = net.train()(_nchw(x))
    np.testing.assert_allclose(gan.numpy(), np.asarray(jgan), atol=ATOL, rtol=0)
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), atol=ATOL, rtol=0)
    moved = dict(variables, batch_stats=jax.tree.map(np.asarray, upd["batch_stats"]))
    want_sd = ck.state_dict_from_jax(net, moved)
    for k, v in net.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=ATOL, rtol=0,
                                       err_msg=k)
    evaluated = JACD(use_running_average=True).apply(moved, jnp.asarray(x))
    with torch.no_grad():
        gan, cls = net.eval()(_nchw(x))
    np.testing.assert_allclose(gan.numpy(), np.asarray(evaluated[0]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(cls.numpy(), np.asarray(evaluated[1]), atol=ATOL, rtol=0)
