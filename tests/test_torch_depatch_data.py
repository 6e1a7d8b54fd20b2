"""The port's two wavelet dataset modes against dasr_tpu's (CPU).

'LRHR_wavelet_unpair' (``MixUnpairedDataset``) is a copy of JAX's host
code: on the same ``np.random.Generator`` its items are JAX's, bit for bit,
for a pseudo-pair index (the ``fake`` prefix, with its DDM) and a real one.

'LRHR_Trans_Wavelet_GAN' (``TransWaveletDataset``) is repaired: JAX's
cannot be built from the keys of its own shipped DePatch config (it reads
``dataroot_fake_LR``, a KeyError: ROADMAP C.2, fault 1), and given those
keys it still reads no reference from the shipped ``dataroot_Trans_refer``
(fault 2), gives no ``LR`` (fault 3) and crops ``ref`` at HR size (fault
4). The port's items carry ``HR``, ``LR`` and ``ref`` at HR, LR and LR
size; with ``dataroot_LR`` null, ``LR`` is the MATLAB bicubic of the
``HR`` crop (JAX's ``imresize_np``, within 1e-6)."""

import json
import os

import numpy as np
import pytest

from dasr_tpu.data import datasets as jds
from dasr_tpu.data.io import save_img
from dasr_tpu.ops.resize import imresize_np
from dasr_tpu_torch.core.config import _strip_json_comments
from dasr_tpu_torch.data import datasets as tds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HR, SCALE = 64, 4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavelet_corpus")
    rng = np.random.default_rng(3)
    dirs = {d: root / d for d in ("hr", "lr", "w", "ref", "paired_lr")}
    for d in dirs.values():
        os.makedirs(d)
    for i in range(4):
        hr = rng.random((80, 72, 3), dtype=np.float32)
        save_img(hr, str(dirs["hr"] / f"{i:03d}.png"))
        save_img(hr.reshape(20, 4, 18, 4, 3).mean((1, 3)), str(dirs["paired_lr"] / f"{i:03d}.png"))
        np.save(dirs["w"] / f"{i:03d}.npy", rng.random((1, 1, 20, 18), dtype=np.float32))
        save_img(rng.random((80, 72, 3), dtype=np.float32), str(dirs["ref"] / f"r{i}.png"))
    # two pseudo pairs (name-prefixed 'fake') and two real LRs, sorted together
    for i, name in enumerate(("fake_000", "fake_001", "real_002", "real_003")):
        save_img(rng.random((20, 18, 3), dtype=np.float32), str(dirs["lr"] / f"{name}.png"))
    return {k: str(v) for k, v in dirs.items()}


def _mix_opt(corpus):
    return {"mode": "LRHR_wavelet_unpair", "scale": SCALE, "HR_size": HR, "prefix": "fake",
            "dataroot_HR": corpus["hr"], "dataroot_LR": corpus["lr"],
            "dataroot_weights": corpus["w"]}


@pytest.mark.parametrize("index", [1, 3], ids=["fake", "real"])
def test_mix_unpaired_items_equal_jax(corpus, index):
    opt = _mix_opt(corpus)
    got = tds.create_dataset(opt).__getitem__(index, np.random.default_rng(11))
    want = jds.create_dataset(opt).__getitem__(index, np.random.default_rng(11))
    assert set(got) == set(want)
    assert got["is_fake"] == want["is_fake"] == np.float32(index == 1)
    for k in ("LR", "HR", "weights"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["LR"].shape == (HR // SCALE, HR // SCALE, 3) and got["HR"].shape == (HR, HR, 3)


def _shipped_train_opt():
    path = os.path.join(REPO, "dasr_tpu", "configs", "train", "train_De_patch_wavelet_GAN.json")
    with open(path) as f:
        return json.loads(_strip_json_comments(f.read()))["datasets"]["train"]


def test_jax_trans_mode_fails_on_its_shipped_keys(corpus):
    """Faults 1 to 4: the shipped keys raise KeyError; with the DASR mode's
    keys added, the shipped reference key is not read (no ``ref``) and no
    ``LR`` is given; under JAX's key ``ref`` is an HR-size crop."""
    opt = dict(_shipped_train_opt(), scale=SCALE, HR_size=HR, dataroot_HR=corpus["hr"],
               dataroot_Trans_refer=corpus["ref"])
    with pytest.raises(KeyError, match="dataroot_fake_LR"):
        jds.create_dataset(opt)
    item = jds.create_dataset(dict(opt, dataroot_fake_LR=corpus["lr"],
                                   dataroot_real_LR=corpus["lr"]))[0]
    assert "ref" not in item and "LR" not in item
    item = jds.create_dataset(dict(opt, dataroot_fake_LR=corpus["lr"],
                                   dataroot_real_LR=corpus["lr"], dataroot_ref=corpus["ref"]))[0]
    assert item["ref"].shape == (HR, HR, 3)


@pytest.mark.parametrize("with_lr", [False, True], ids=["bicubic", "lr_dir"])
def test_trans_wavelet_items(corpus, with_lr):
    opt = dict(_shipped_train_opt(), scale=SCALE, HR_size=HR, dataroot_HR=corpus["hr"],
               dataroot_Trans_refer=corpus["ref"])
    if with_lr:  # LR images at the HR images' size / 4
        opt["dataroot_LR"] = corpus["paired_lr"]
    ds = tds.create_dataset(opt)
    assert isinstance(ds, tds.TransWaveletDataset) and len(ds) == 4
    for i in range(len(ds)):
        item = ds.__getitem__(i, np.random.default_rng(i))
        assert item["HR"].shape == (HR, HR, 3)
        assert item["LR"].shape == item["ref"].shape == (HR // SCALE, HR // SCALE, 3)
        assert item["ref_path"].startswith(corpus["ref"])
        if not with_lr:
            np.testing.assert_allclose(item["LR"], imresize_np(item["HR"], 1 / SCALE),
                                       atol=1e-6, rtol=0)
    # JAX's key for the references is read too
    opt.pop("dataroot_Trans_refer")
    assert tds.create_dataset(dict(opt, dataroot_ref=corpus["ref"]))[0]["ref"].shape[0] == 16
    with pytest.raises(ValueError, match="dataroot_Trans_refer"):
        tds.create_dataset(opt)

