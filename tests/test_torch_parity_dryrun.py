"""The port's ``tools/parity_dryrun`` against the repository's
``tools/parity_dryrun.py`` (imported by path; its functions import torch
only): the stand-in checkpoint, the functional forward and the recursive
``forward_chop`` bit-equal at nb 1, nf 8, gc 4, f32; ``main`` at nb 1 on
the CPU, with every max |delta| of the port's SRModel against the
functional forward and the chop replica within 1e-5. Without a card the
tool raises unless given ``--device cpu``."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from dasr_tpu_torch.data.io import save_img
from dasr_tpu_torch.tools import parity_dryrun as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "repo_tools_parity_dryrun", os.path.join(REPO, "tools", "parity_dryrun.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)
NB, NF, GC = 1, 8, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    root = tmp_path_factory.mktemp("standin")
    ours, theirs = str(root / "port.pth"), str(root / "jax.pth")
    port.make_standin_pth(ours, nb=NB, nf=NF, gc=GC, seed=3)
    ref.make_standin_pth(theirs, nb=NB, nf=NF, gc=GC, seed=3)
    return (torch.load(ours, weights_only=True), torch.load(theirs, weights_only=True))


def test_standin_checkpoint_is_the_same(standin):
    ours, theirs = standin
    assert list(ours) == list(theirs)
    for k in theirs:
        assert torch.equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("hw", [(12, 10), (37, 52)])
def test_functional_forward_is_bit_equal(standin, hw):
    sd = standin[0]
    x = torch.from_numpy(np.random.default_rng(1).random((1, 3, *hw), dtype=np.float32))
    with torch.no_grad():
        got = port.torch_rrdb_forward(sd, x, nb=NB, nf=NF, gc=GC)
        want = ref.torch_rrdb_forward(sd, x, nb=NB, nf=NF, gc=GC)
    assert got.shape == (1, 3, 4 * hw[0], 4 * hw[1]) and torch.equal(got, want)


# (h, w, min_size): too small to quadrant, one level, and a level of recursion
@pytest.mark.parametrize("h,w,min_size", [(30, 44, 160000), (61, 75, 160000), (97, 90, 1500)])
def test_forward_chop_is_bit_equal(standin, h, w, min_size):
    sd = standin[0]
    x = torch.from_numpy(np.random.default_rng(2).random((2, 3, h, w), dtype=np.float32))

    def model(v):
        return port.torch_rrdb_forward(sd, v, nb=NB, nf=NF, gc=GC)

    calls = []

    def counted(v):
        calls.append(v.shape)
        return model(v)

    with torch.no_grad():
        got = port.torch_forward_chop(x, 4, counted, min_size=min_size)
        want = ref.torch_forward_chop(x, 4, model, min_size=min_size)
    assert torch.equal(got, want)
    assert len(calls) == {30: 1, 61: 1, 97: 4}[h]


def test_main_holds_srmodel_against_the_functional_forward(tmp_path):
    lr_dir = tmp_path / "lr"
    rng = np.random.default_rng(4)
    # one image below the chop's 2 x shave and one it quadrants
    for i, (h, w) in enumerate(((24, 20), (52, 60))):
        save_img(rng.random((h, w, 3), dtype=np.float32), str(lr_dir / f"im{i}.png"))
    work = str(tmp_path / "work")
    report = port.main(["--lr_dir", str(lr_dir), "--work", work, "--n", "2", "--nb", str(NB),
                        "--device", "cpu"])
    assert os.path.exists(os.path.join(work, "standin_G.pth"))
    with open(os.path.join(work, "parity_dryrun.json")) as f:
        assert json.load(f) == report
    assert [r["lr_shape"] for r in report] == [[24, 20, 3], [52, 60, 3]]
    for row in report:
        assert row["out_absmax"] > 0
        for pair in ("ours_plain_vs_torch_full", "ours_chop_vs_torch_chop"):
            assert row[pair]["max_abs"] <= 1e-5, (row["image"], pair, row[pair])


def test_raises_without_a_card_unless_given_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        port.main(["--lr_dir", str(tmp_path), "--work", str(tmp_path / "w")])
