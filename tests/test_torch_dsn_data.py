"""The port's DSN data path and host helpers against the JAX package's: the
same seed gives the same DSN batches, bit for bit (shuffle, crops,
augments, pairing, the bicubic target, the uint8 wire form), the same
validation items, and the same paths.yml registry; selecting the card turns
TF32 off."""

import os

import numpy as np
import pytest
import torch
import yaml

from dasr_tpu.core.config import dataset_paths as jdataset_paths
from dasr_tpu.data.datasets import DSNTrainDataset as JTrain
from dasr_tpu.data.datasets import DSNValDataset as JVal
from dasr_tpu.data.pipeline import Loader as JLoader
from dasr_tpu_torch.core import device as devmod
from dasr_tpu_torch.core.config import dataset_paths, load_paths_yml
from dasr_tpu_torch.data.datasets import DSNTrainDataset, DSNValDataset
from dasr_tpu_torch.data.pipeline import Loader
from torch_dsn_corpus import write_dsn_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return write_dsn_corpus(str(tmp_path_factory.mktemp("dsn_data")))


@pytest.mark.parametrize("epoch", [1, 4])
@pytest.mark.parametrize("wire", ["f32_host_bicubic", "uint8_device_bicubic", "augment"])
def test_loader_gives_the_jax_packages_dsn_batches(dirs, epoch, wire):
    kw = dict(crop_size=66, upscale_factor=4, transfer_uint8=wire.startswith("uint8"),
              device_bicubic=wire.startswith("uint8"), flips=wire == "augment",
              rotations=wire == "augment")
    ours = Loader(DSNTrainDataset(dirs["source"], dirs["target"], **kw), batch_size=2,
                  num_workers=2, seed=3)
    theirs = JLoader(JTrain(dirs["source"], dirs["target"], **kw), batch_size=2, num_workers=2,
                     seed=3)
    ours.set_epoch(epoch)
    theirs.set_epoch(epoch)
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert set(a) == set(b) == ({"input", "disc"} if kw["device_bicubic"]
                                    else {"input", "disc", "bicubic"})
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert got[0]["input"].shape == (2, 64, 64, 3) and got[0]["disc"].shape == (2, 16, 16, 3)
    assert got[0]["input"].dtype == (np.uint8 if kw["transfer_uint8"] else np.float32)


def test_val_items_match_the_jax_package(dirs):
    ours = DSNValDataset(dirs["valid_hr"], dirs["valid_lr"], crop_size=64)
    theirs = JVal(dirs["valid_hr"], dirs["valid_lr"], crop_size=64)
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b)
        for k in b:
            assert np.array_equal(a[k], b[k]), k
    assert ours[0]["input"].shape == (64, 64, 3) and ours[0]["bicubic"].shape == (16, 16, 3)


def test_paths_yml_matches_the_jax_package():
    path = os.path.join(REPO, "paths.yml")
    with open(path) as f:
        assert load_paths_yml(path) == yaml.safe_load(f)
    for dataset, artifact in (("aim2019", "tdsr"), ("realsr", "tdrealsr_x2")):
        assert dataset_paths(path, dataset, artifact) == jdataset_paths(path, dataset, artifact)
    with pytest.raises(KeyError, match=r"\[aim2019\]\[nope\]"):
        dataset_paths(path, "aim2019", "nope")


def test_f32_numerics_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    devmod.f32_numerics()
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    # and resolve_device calls it whenever it returns a CUDA device
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert devmod.resolve_device("cuda") == torch.device("cuda", 0)
    assert torch.backends.cudnn.allow_tf32 is False
