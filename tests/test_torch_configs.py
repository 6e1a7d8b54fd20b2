"""Every shipped config through the port (ROADMAP A.14): each file of
dasr_tpu/configs/{train,test}/ and dasr_tpu_torch/configs/ parses with
``parse_srn_options`` and builds its model with ``create_model``, at nf 8
and nb 1 (cut here, not in the file); 'DSGAN' (test_DeGradtion_patchSave.json)
is refused, as dasr_tpu's ``create_model`` refuses it (``dsn_test`` runs
that network). Also ``ycbcr2rgb`` against the JAX package's."""

import glob
import os
import re

import numpy as np
import pytest

from dasr_tpu.models.registry import create_model as jcreate_model
from dasr_tpu.ops.metrics import ycbcr2rgb as jycbcr2rgb
from dasr_tpu_torch.core.config import parse_srn_options
from dasr_tpu_torch.models.registry import create_model
from dasr_tpu_torch.ops.metrics import ycbcr2rgb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(
    glob.glob(os.path.join(REPO, "dasr_tpu", "configs", "train", "*.json"))
    + glob.glob(os.path.join(REPO, "dasr_tpu", "configs", "test", "*.json"))
    + glob.glob(os.path.join(REPO, "dasr_tpu_torch", "configs", "*.json")))
REFUSED = {"test_DeGradtion_patchSave.json": "Model [DSGAN] not recognized"}


def _id(path):
    return os.path.relpath(path, REPO)


def test_every_config_directory_is_listed():
    names = {os.path.basename(p) for p in CONFIGS}
    assert {"train_DASR.json", "test_DASR_Adaptive.json", "train_DASR_auto_reproduce.json",
            "test_DeGradtion_patchSave.json"} <= names
    assert len(CONFIGS) == 27


@pytest.mark.parametrize("path", CONFIGS, ids=_id)
def test_shipped_config_parses_and_builds(path, tmp_path):
    is_train = os.path.basename(path).startswith("train")
    opt = parse_srn_options(path, is_train=is_train)
    opt["path"]["root"] = str(tmp_path)
    assert opt["is_train"] == is_train and opt["model"]
    net = opt["network_G"]
    net.update(nf=8, nb=1, gc=4)
    if net.get("ada_nb"):
        net["ada_nb"] = 1
    refused = REFUSED.get(os.path.basename(path))
    if refused:
        for create in (create_model, jcreate_model):
            with pytest.raises(NotImplementedError, match=re.escape(refused)):
                create(opt)
        return
    model = create_model(opt)
    assert (model.trainer is not None) == is_train
    assert sum(p.numel() for p in model.g.parameters()) > 0


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_ycbcr2rgb_matches_jax(dtype):
    rng = np.random.default_rng(0)
    img = (rng.integers(16, 236, (9, 7, 3)).astype(np.uint8) if dtype == np.uint8
           else rng.uniform(16 / 255, 235 / 255, (9, 7, 3)).astype(np.float32))
    got, want = ycbcr2rgb(img), jycbcr2rgb(img)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
