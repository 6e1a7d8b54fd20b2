"""The comparison has to fail what it is there to catch. On the CPU at tiny
sizes, under the real cells' limits: the control (the reference computed
in float8 in the program's place) and each fault a cell can have, planted
under the timed path with the rest of the run as it is. On the card
(marked ``cuda``), the control at the cell's own size."""

import json
from pathlib import Path

import pytest
import torch

from port_bench import controls, run
from port_bench.tests import tiny

torch.set_num_threads(2)
WORKLOADS = Path(run.__file__).resolve().parent / "workloads"


def _limits(cell):
    return json.loads((WORKLOADS / f"{cell}.json").read_text())["limits"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    limits = dict(_limits("srn_train"), **_limits("srn_serve"))
    return tiny.make_root(tmp_path_factory.mktemp("bench"), limits)


@pytest.mark.parametrize("cell,arm", [
    ("tiny_srn_train", "control"), ("tiny_srn_train", "unchanged"),
    ("tiny_srn_train", "half_batch"), ("tiny_srn_train", "reused_draws"),
    ("tiny_dsn_train", "control"),
    ("tiny_dsn_train", "unchanged"), ("tiny_srn_serve", "control"),
    ("tiny_srn_serve", "altered")])
def test_control_and_faults_come_out_not_correct(root, cell, arm):
    out = controls.reading(root, cell, 7, 0.3, torch.device("cpu"), arm)
    assert out["correct"] is False, out


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dasr_tpu_torch.core.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["srn_serve", "srn_train"])
def test_control_at_the_cells_size_is_not_correct(card, cell):
    out = controls.reading(run.ROOT, cell, 2024, 1.0, card, "control")
    assert out["correct"] is False, out
