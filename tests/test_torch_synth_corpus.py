"""The port's ``tools/make_synth_corpus`` against the repository's
``tools/make_synth_corpus.py`` (imported by path: it needs no jax) on
seeded inputs: ``synth_image``, ``_box_mean``, ``texture_mask``,
``degrade`` in its three modes and ``_bicubic_down`` bit-equal (both use
PIL's JPEG and bicubic), and ``main`` on a 2 + 2 + 1 corpus writing the same
files, byte for byte, and the same ``paths.yml``."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from dasr_tpu_torch.tools import make_synth_corpus as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "tools", "make_synth_corpus.py")


def _jax_tool():
    spec = importlib.util.spec_from_file_location("repo_tools_make_synth_corpus", JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _jax_tool()


@pytest.mark.parametrize("seed,h,w", [(0, 64, 96), (7, 37, 53), (500_003, 128, 80)])
def test_synth_image_is_bit_equal(seed, h, w):
    got = port.synth_image(np.random.default_rng(seed), h, w)
    want = ref.synth_image(np.random.default_rng(seed), h, w)
    assert got.dtype == want.dtype == np.float32 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("r", [1, 3])
def test_box_mean_is_bit_equal(r):
    x = np.random.default_rng(r).random((23, 31), dtype=np.float32)
    np.testing.assert_array_equal(port._box_mean(x, r), ref._box_mean(x, r))


def test_texture_mask_is_bit_equal():
    img = ref.synth_image(np.random.default_rng(3), 48, 72)
    got, want = port.texture_mask(img), ref.texture_mask(img)
    np.testing.assert_array_equal(got, want)
    assert 0 < (got > 0.5).mean() < 1  # the corpus has textured and flat regions


@pytest.mark.parametrize("mode", ["global", "half", "textured"])
def test_degrade_is_bit_equal(mode):
    lr = ref.synth_image(np.random.default_rng(11), 40, 56)
    rng_p, rng_r = np.random.default_rng(12), np.random.default_rng(12)
    got = port.degrade(lr, rng_p, noise_mode=mode)
    want = ref.degrade(lr, rng_r, noise_mode=mode)
    np.testing.assert_array_equal(got, want)
    # both drew the same noise: the generators are left in one state
    assert rng_p.random() == rng_r.random()


@pytest.mark.parametrize("scale", [2, 4])
def test_bicubic_down_is_bit_equal(scale):
    img = ref.synth_image(np.random.default_rng(5), 66, 90)
    got = port._bicubic_down(img, scale)
    np.testing.assert_array_equal(got, ref._bicubic_down(img, scale))
    assert got.shape == (66 // scale, 90 // scale, 3)


def test_main_writes_the_same_corpus(tmp_path):
    flags = ["--n_target", "2", "--n_source", "2", "--n_valid", "1", "--hr_h", "64",
             "--hr_w", "96", "--valid_h", "48", "--valid_w", "64", "--seed", "3",
             "--noise_mode", "textured", "--workers", "2"]
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    port.main(["--out", ours] + flags)
    # the repository's tool forks its pool: run it in a process of its own
    proc = subprocess.run([sys.executable, JAX_TOOL, "--out", theirs] + flags,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    counts = {"target": 2, "source": 2, "valid_hr": 1, "valid_lr": 1}
    for d, n in counts.items():
        names = sorted(os.listdir(os.path.join(ours, d)))
        assert names == sorted(os.listdir(os.path.join(theirs, d))) and len(names) == n
        for name in names:
            with open(os.path.join(ours, d, name), "rb") as a, \
                    open(os.path.join(theirs, d, name), "rb") as b:
                assert a.read() == b.read(), f"{d}/{name}"
    with open(os.path.join(ours, "paths.yml")) as a, open(os.path.join(theirs, "paths.yml")) as b:
        assert a.read() == b.read().replace(theirs, ours)
