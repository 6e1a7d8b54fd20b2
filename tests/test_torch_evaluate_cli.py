"""The port's evaluate CLI (CPU) against the JAX package's on one directory
pair of mixed sizes (one pair of unequal sizes, cropped to the common
one): the host f64 path within 1e-6, ``--device_metrics`` within 1e-4,
``--device_metrics --pad_bucket`` over the mixed sizes within 1e-4 (and
within 1e-5 of the unbucketed device path), ``--border_crop`` and
``--limit``; LPIPS on the JAX package's weights, carried across. One
deviation: the device PSNR_col is exact in the port and held against JAX's
host value. The identity pair gives psnr and psnr_col inf and ssim 1 on
every path."""

import numpy as np
import pytest
import torch

from dasr_tpu.cli import evaluate as jax_evaluate
from dasr_tpu.models.registry import _default_lpips_variables
from dasr_tpu_torch.cli import evaluate
from dasr_tpu_torch.data.io import save_img
from dasr_tpu_torch.losses import lpips as lpips_mod
from dasr_tpu_torch.train.checkpoints import state_dict_from_jax

SIZES = ((40, 56), (47, 33), (64, 40))
KEYS = ("psnr", "psnr_col", "ssim", "lpips")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Noisy copies of seeded images; the second pair's ground truth is 3
    rows and 2 columns larger than its result."""
    root = tmp_path_factory.mktemp("evaluate")
    rng = np.random.default_rng(4)
    d_a, d_b = root / "a", root / "b"
    d_a.mkdir(), d_b.mkdir()
    for i, (h, w) in enumerate(SIZES):
        x = rng.random((h + 3, w + 2, 3)).astype(np.float32)
        noisy = np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1)
        save_img(x if i == 1 else x[:h, :w], str(d_a / f"{i}.png"))
        save_img(noisy[:h, :w], str(d_b / f"{i}.png"))
    return str(d_a), str(d_b)


@pytest.fixture
def jax_lpips_weights(monkeypatch):
    """The port's LPIPS with the JAX package's default weights."""
    sd = state_dict_from_jax(lpips_mod.LPIPS(), _default_lpips_variables())

    def default_lpips(net="alex", **_):
        model = lpips_mod.LPIPS(net=net)
        model.load_state_dict(sd)
        return model.requires_grad_(False)

    monkeypatch.setattr(lpips_mod, "default_lpips", default_lpips)


def _lines(out):
    return [line.split(":")[0] for line in out.splitlines() if line.endswith(tuple("0123456789"))
            and ".png" in line]


@pytest.mark.parametrize("flags,atol", [
    ([], 1e-6),
    (["--device_metrics"], 1e-4),
    (["--device_metrics", "--pad_bucket", "32"], 1e-4),
    (["--border_crop", "3", "--no_lpips"], 1e-6),
    (["--limit", "2", "--no_lpips"], 1e-6),
], ids=["host", "device", "bucket", "border_crop", "limit"])
def test_port_matches_the_jax_cli(dirs, jax_lpips_weights, capsys, flags, atol):
    d_a, d_b = dirs
    args = ["--dir_a", d_a, "--dir_b", d_b, *flags]
    want = jax_evaluate.main(args)
    jax_out = capsys.readouterr().out
    got = evaluate.main([*args, "--device", "cpu"])
    out = capsys.readouterr().out
    assert list(got) == list(want) == [k for k in KEYS if k != "lpips" or "--no_lpips" not in flags]
    if "--device_metrics" in flags:
        # the port's device PSNR_col is the exact one (integer sums): it is
        # held against JAX's host f64 value; JAX's device value, the
        # difference of two f32 means, is ~5e-4 dB off it here
        want["psnr_col"] = jax_evaluate.main(["--dir_a", d_a, "--dir_b", d_b, "--no_lpips"])[
            "psnr_col"]
        capsys.readouterr()
    for k, v in want.items():
        assert abs(got[k] - v) <= atol, (k, got[k], v)
    n = 2 if "--limit" in flags else 3
    assert _lines(out) == _lines(jax_out) == [f"{i}.png" for i in range(n)]
    assert "== mean ==" in out


def test_bucketed_device_metrics_equal_unbucketed(dirs, capsys):
    d_a, d_b = dirs
    args = ["--dir_a", d_a, "--dir_b", d_b, "--device", "cpu", "--device_metrics"]
    plain = evaluate.main(args)
    bucketed = evaluate.main([*args, "--pad_bucket", "64"])
    for k, v in plain.items():
        assert abs(bucketed[k] - v) <= 1e-5, (k, bucketed[k], v)


@pytest.mark.parametrize("flags", [[], ["--device_metrics"], ["--device_metrics",
                                                                 "--pad_bucket", "32"]])
def test_identity(dirs, flags):
    d_a, _ = dirs
    avg = evaluate.main(["--dir_a", d_a, "--dir_b", d_a, "--no_lpips", "--device", "cpu",
                         *flags])
    assert avg["psnr"] == avg["psnr_col"] == float("inf")
    assert avg["ssim"] == pytest.approx(1.0, abs=1e-6)


def test_cuda_without_a_card_raises(dirs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d_a, d_b = dirs
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate.main(["--dir_a", d_a, "--dir_b", d_b, "--no_lpips"])
