"""The idle and percentile arithmetic on made-up spans and records: busy
time as the union of device events, gaps named by the host span, the p95
over every image of the window (no medians of chunks), a step time over
the whole window."""

import statistics
import types

import pytest

from port_bench import harness, trace, trainloop
from port_bench.traffic import closed_loop_serve


def test_union_and_gaps():
    assert trace.union([(5, 7), (0, 2), (1, 3), (6, 9)]) == [(0, 3), (5, 9)]
    assert trace.union_length([(0, 2), (1, 3), (5, 9)]) == 7
    assert trace.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
    host = [(0.0, 10.0, "issue"), (3.0, 4.0, "readback")]
    assert trace.name_at(3.5, host) == "readback"
    assert trace.name_at(1.0, host) == "issue"
    assert trace.name_at(11.0, host) == "harness"


def test_reduce_events_idle_and_names():
    ns = 1_000_000_000
    raw = [(0, 10 * ns, "bench.window", False, True),
           (0, 6 * ns, "bench.issue", False, True),
           (6 * ns, 10 * ns, "bench.readback", False, True),
           (1 * ns, 3 * ns, "rdb_level_wgmma", True, False),
           (2 * ns, 4 * ns, "rdb_level_wgmma", True, False),  # overlaps: counted once
           (7 * ns, 8 * ns, "Memcpy DtoH", True, False),
           (7 * ns, 9 * ns, "bench.readback", True, True),  # the annotation mirrored
           (9 * ns, 12 * ns, "conv", True, False)]  # clipped to the window
    r = trace.reduce_events(raw)
    assert r.window_s == pytest.approx(10) and r.busy_s == pytest.approx(3 + 1 + 1)
    assert r.union_of("rdb_level") == pytest.approx(3)
    assert [(n, pytest.approx(t)) for n, t in r.idle_gaps()] == \
        [("issue", 1.0), ("issue", 3.0), ("readback", 1.0)]
    b = r.breakdown()
    assert b["device_ops"][0] == ["rdb_level_wgmma", pytest.approx(4.0)]
    assert b["idle_gaps"][0] == ["issue", pytest.approx(3.0)]
    idle = 100 * (1 - r.busy_s / r.window_s)
    assert idle == pytest.approx(50.0)
    assert trace.reduce_events([(0, 1, "x", True, False)]) is None


def test_p95_is_over_every_image_of_the_window():
    lat = [0.010] * 90 + [0.050] * 5 + [0.500] * 5
    run = types.SimpleNamespace(record={"latency_s": lat, "lr_pixels": [100] * 100,
                                        "window_s": 2.0})
    out = closed_loop_serve.end_to_end(run)
    assert out["serve_p95_ms"] == pytest.approx(
        1e3 * statistics.quantiles(lat, n=100, method="inclusive")[94])
    # a median of chunk p95s would hide the stall the tail holds
    chunks = [statistics.quantiles(lat[i:i + 10], n=100, method="inclusive")[94]
              for i in range(0, 100, 10)]
    assert out["serve_p95_ms"] > 1e3 * statistics.median(chunks)
    assert out["serve_mpix_per_s"] == pytest.approx(16 * 100 * 100 / 2.0 / 1e6)


def test_step_time_is_the_window_over_its_steps():
    run = types.SimpleNamespace(record={"window_s": 3.0, "steps": 40})
    assert trainloop.end_to_end(run)["train_step_ms"] == pytest.approx(75.0)


def test_spans_and_seeds():
    s = harness.Spans()
    with s("issue"):
        pass
    with s("issue"):
        pass
    assert [n for n, _, _ in s.items] == ["issue", "issue"] and s.total("issue") >= 0
    big = 2 ** 31 + 12345
    assert harness.derive_seed(big, "G") != harness.derive_seed(big, "D")
    assert harness.derive_seed(big, "G") == harness.derive_seed(big, "G") < 2 ** 63
