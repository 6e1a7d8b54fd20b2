"""``port_bench/program_trace.py`` on the CPU: the readings of each tiny
cell's windows (the five phases of a train step, the host's work a step,
the serving facade's upload and forward issue, the LR pixels forwarded
over those served), and the naming of idle gaps by the harness span and
the innermost program span that holds their start, on a synthetic trace."""

import contextlib
import io
import json

import pytest
import torch

from dasr_tpu_torch.utils.trace import Span
from port_bench import program_trace, trace
from port_bench.tests import tiny

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _program_line(root, cell):
    err, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        rc = program_trace.main(["--workload", cell, "--seed", "5", "--seconds", "0.5",
                                 "--trace", "1"], root=root, device="cpu")
    assert rc == 0
    (line,) = [x for x in err.getvalue().splitlines() if x.startswith("program ")]
    return json.loads(line[len("program "):])


@pytest.mark.parametrize("cell", ["tiny_srn_train", "tiny_dsn_train", "tiny_srn_serve"])
def test_readings_of_a_tiny_run(root, cell):
    got = _program_line(root, cell)
    for window in ("measured", "traced"):
        r = got[window]
        if "train" in cell:
            assert all(r[m] > 0 for m in program_trace.PHASES), r
            # on the CPU the eager loop runs: the SRN facade's index upload
            # is the only host span (the DSN harness copies its own index)
            assert (r["host_work_ms_per_step"] > 0) == (cell == "tiny_srn_train")
        else:
            assert r["serve_upload_ms"] > 0 and r["serve_forward_issue_ms"] > 0
            assert r["tile_overcompute"] == 1.0  # the tiny images lie under the chop gate
    names = set(got["gap_s_by_name"])
    if "serve" in cell:
        assert any(n.startswith("issue/serve.") for n in names), names


def test_gaps_are_named_by_the_program_span_that_holds_their_start():
    events = [(0.0, 0.2, "k"), (0.25, 0.5, "k"), (0.7, 0.9, "k")]
    reduced = trace.Reduced(1.0, 0.65, events, [(0.1, 0.8, "issue")])
    t0 = 10**18
    spans = [Span("graph.draw", t0 + 150_000_000, t0 + 220_000_000, None, 3),
             Span("graph.stage", t0 + 180_000_000, t0 + 210_000_000, "graph.draw", 3)]
    got = program_trace.named_gaps(reduced, spans, t0)
    assert [(n, round(a, 6), round(d, 6)) for n, a, d in got] == [
        ("issue/graph.stage", 0.2, 0.05), ("issue", 0.5, 0.2), ("harness", 0.9, 0.1)]
