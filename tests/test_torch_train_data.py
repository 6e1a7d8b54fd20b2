"""The port's DASR data path against the JAX package's: the same seed gives
the same batches, bit for bit (shuffle, crops, augments, pairing, DDM
alignment), and the DDM loader reads the DSN layout."""

import numpy as np
import pytest
import torch

from dasr_tpu.data.datasets import DASRUnpairedDataset as JDataset
from dasr_tpu.data.datasets import DASRUnpairedEqDataset as JEqDataset
from dasr_tpu.data.pipeline import Loader as JLoader
from dasr_tpu_torch.data.datasets import create_dataset
from dasr_tpu_torch.data.io import load_ddm
from dasr_tpu_torch.data.pipeline import Loader
from test_torch_srn_train_cli import write_corpus


def _opt(dirs, mode="LRHR_wavelet_unpair_fake_weights_EQ", **extra):
    return {"phase": "train", "mode": mode, "scale": 4, "HR_size": 32,
            "dataroot_HR": dirs["hr"], "dataroot_fake_LR": dirs["fake"],
            "dataroot_real_LR": dirs["real"], "dataroot_fake_weights": dirs["ddm"], **extra}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("dasr_data")), n=5, hr=48)


@pytest.mark.parametrize("epoch", [0, 3])
def test_loader_gives_the_jax_packages_batches(dirs, epoch):
    ours = Loader(create_dataset(_opt(dirs)), batch_size=2, num_workers=2, seed=7)
    theirs = JLoader(JDataset(_opt(dirs)), batch_size=2, num_workers=2, seed=7)
    ours.set_epoch(epoch)
    theirs.set_epoch(epoch)
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == len(ours) == 2  # drop_last
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k
    assert got[0]["fake_w"].shape == (2, 8, 8, 1) and got[0]["HR"].shape == (2, 32, 32, 3)


def test_eq_mode_adds_the_real_ddms(dirs):
    opt = _opt(dirs, mode="LRHR_wavelet_unpair_fake_real_w_EQ", dataroot_real_weights=dirs["ddm"])
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    got = create_dataset(opt).__getitem__(2, rng=rng_a)
    want = JEqDataset(opt).__getitem__(2, rng=rng_b)
    assert np.array_equal(got["real_w"], want["real_w"])
    assert np.array_equal(got["LR_real"], want["LR_real"])


def test_pinned_batches_hold_the_same_values(dirs):
    plain = next(iter(Loader(create_dataset(_opt(dirs)), batch_size=2, num_workers=1, seed=3)))
    loader = Loader(create_dataset(_opt(dirs)), batch_size=2, num_workers=1, seed=3,
                    pin_memory=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # pinning needs CUDA
            next(iter(loader))
        return
    pinned = next(iter(loader))
    assert pinned["HR"].is_pinned() and np.array_equal(pinned["HR"].numpy(), plain["HR"])


def test_load_ddm_reads_the_dsn_layout(tmp_path):
    ddm = np.random.default_rng(0).random((1, 1, 6, 9)).astype(np.float32)
    np.save(tmp_path / "d.npy", ddm)
    got = load_ddm(str(tmp_path / "d.npy"))
    assert got.shape == (6, 9, 1) and np.array_equal(got[..., 0], ddm[0, 0])
