"""The per-layer metric read from the program's own counters,
``tile_overcompute``, on the CPU: a traced tiny serving run reads 1.0 (its
images lie under the chop gate, so each is forwarded whole), and where the
program has no such counters, as a parent commit without
``dasr_tpu_torch/utils/trace.py`` has not, the reader returns nothing and
does not raise."""

import sys
import types

import pytest
import torch

from port_bench import harness
from port_bench.tests import tiny

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def test_a_traced_serving_run_reads_its_overcompute(root):
    out = tiny.run_tiny(root, "tiny_srn_serve", trace=1)
    assert out["rc"] == 0
    assert out["result"]["metrics"]["tile_overcompute"] == {"value": 1.0, "unit": "px/px"}


def test_without_the_programs_counters_nothing_is_read(root, monkeypatch):
    import dasr_tpu_torch.utils as utils

    reader = harness.Bench(root).reader("tile_overcompute")
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "dasr_tpu_torch.utils.trace", None)
    assert reader.read(types.SimpleNamespace()) is None
