"""The port's device metrics on the CPU: ``psnr_device``, ``ssim_device``
and their masked forms against the JAX package's on the same arrays (1e-4
dB, 1e-5 SSIM); the masked forms on zero-padded images against the plain
ones on the true crop (f32 rounding); the SRN protocol on the device
(``sr_metrics_device``, bucketed or not, with LPIPS) against the host f64
``sr_metrics`` at the JAX package's own limits, 1e-3 dB and 1e-4 SSIM
(dasr_tpu/cli/auto_reproduce.py:164-170, tests/test_metrics.py:75-121)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.ops import metrics as jm
from dasr_tpu_torch.cli.srn_test import make_lpips
from dasr_tpu_torch.eval import evaluate as ev
from dasr_tpu_torch.ops import metrics as m


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small ops: torch's intra-op threads only contend with the other
    test workers for the cores (as in tests/test_torch_dsn_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(rng, shape, noise=12.0):
    a = rng.integers(0, 256, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, shape), 0, 255).round().astype(np.float32)
    return a, b


@pytest.mark.parametrize("channels", [3, 1])
def test_device_metrics_match_jax(rng, channels):
    a, b = _pair(rng, (2, 37, 45, channels))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(m.psnr_device(ta, tb, 255.0).numpy(),
                               np.asarray(jm.psnr_device(ja, jb, 255.0)), atol=1e-4, rtol=0)
    np.testing.assert_allclose(m.ssim_device(ta, tb).numpy(), np.asarray(jm.ssim_device(ja, jb)),
                               atol=1e-5, rtol=0)
    h, w = 30, 41
    np.testing.assert_allclose(m.psnr_device_masked(ta, tb, h, w, 255.0).numpy(),
                               np.asarray(jm.psnr_device_masked(ja, jb, h, w, 255.0)),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(m.ssim_device_masked(ta, tb, h, w).numpy(),
                               np.asarray(jm.ssim_device_masked(ja, jb, h, w)), atol=1e-5, rtol=0)
    # PSNR_col from integer sums: the f64 value of the true crop
    diff = (a[:, :h, :w].astype(np.float64) - b[:, :h, :w]).mean(axis=(1, 2)) / 255.0
    np.testing.assert_allclose(m.psnr_col_device(ta, tb, h, w).numpy(),
                               -10 * np.log10((diff ** 2).mean(axis=-1)), rtol=1e-6)


def test_masked_metrics_equal_the_plain_ones_on_the_true_crop(rng):
    """Zero padding beyond (h, w) changes nothing: no SSIM map position that
    is kept reads a padded pixel."""
    a, b = _pair(rng, (1, 29, 34, 3))
    pa, pb = (np.zeros((1, 64, 64, 3), np.float32) for _ in range(2))
    pa[:, :29, :34], pb[:, :29, :34] = a, b
    # padding with anything else must not matter either
    pa[:, 29:], pb[:, :, 34:] = 255.0, 17.0
    ta, tb, tpa, tpb = (torch.from_numpy(v) for v in (a, b, pa, pb))
    torch.testing.assert_close(m.psnr_device_masked(tpa, tpb, 29, 34, 255.0),
                               m.psnr_device(ta, tb, 255.0), rtol=1e-6, atol=0)
    torch.testing.assert_close(m.ssim_device_masked(tpa, tpb, 29, 34), m.ssim_device(ta, tb),
                               rtol=1e-6, atol=0)
    assert torch.equal(m.psnr_col_device(tpa, tpb, 29, 34), m.psnr_col_device(ta, tb, 29, 34))


@pytest.fixture(scope="module")
def lpips_fn():
    return make_lpips(torch.device("cpu"))


@pytest.mark.parametrize("hw", [(68, 84), (130, 61)])
def test_srn_protocol_on_the_device_matches_the_host(hw, lpips_fn):
    """RGB and Y, border-cropped, from an f32 SR image and a uint8 HR image,
    plain and padded to a bucket of 64, against the host f64 protocol."""
    rng = np.random.default_rng(hw[0])
    gt = rng.integers(0, 256, (*hw, 3)).astype(np.uint8)
    sr = np.clip(gt / 255.0 + rng.normal(0, 0.04, gt.shape), -0.1, 1.1).astype(np.float32)
    want = ev.sr_metrics(ev.to_uint8(sr), gt, 4, lpips_fn)
    dev = ev.metrics_dict(ev.sr_metrics_device(torch.from_numpy(sr), torch.from_numpy(gt), 4,
                                               lpips_fn.raw).tolist(), lpips=True)
    sr8 = ev.to_uint8_device(torch.from_numpy(sr))
    assert torch.equal(sr8, torch.from_numpy(ev.to_uint8(sr)))
    bucketed = ev.metrics_dict(ev.sr_metrics_device_bucketed(sr8, torch.from_numpy(gt), 4,
                                                             64).tolist())
    for got in (dev, bucketed):
        for k in ("psnr", "psnr_y"):
            assert abs(got[k] - want[k]) < 1e-3, (k, got[k], want[k])
        for k in ("ssim", "ssim_y"):
            assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])
    assert abs(dev["lpips"] - want["lpips"]) < 1e-5
    for k in ev.METRIC_KEYS:  # the bucket is exact: only f32 rounding apart
        assert bucketed[k] == pytest.approx(dev[k], rel=1e-5), k


def test_sr_metrics_on_gates_like_the_jax_clis(lpips_fn):
    """Device metrics unless the chop or pad_bucket forward is on without a
    bucket; every choice gives the host protocol's numbers."""
    rng = np.random.default_rng(1)
    gt = rng.integers(0, 256, (40, 48, 3)).astype(np.uint8)
    sr = np.clip(gt / 255.0 + rng.normal(0, 0.03, gt.shape), 0, 1).astype(np.float32)
    want = ev.sr_metrics(ev.to_uint8(sr), gt, 4, lpips_fn)
    for opt, dm, bucket in (({}, False, 0), ({}, True, 0), ({"chop": True}, True, 0),
                            ({"pad_bucket": 8}, True, 32), ({}, True, 32)):
        got = ev.sr_metrics_on({"scale": 4, **opt}, lpips_fn, dm, bucket)(
            torch.from_numpy(sr), gt.astype(np.float32) / 255.0)(sr)
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) < (1e-3 if "psnr" in k else 1e-4), (opt, dm, k)
