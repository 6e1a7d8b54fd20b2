"""The harness on the CPU at tiny sizes: a cell, a configuration and a
metric dropped in as new files are found without edits; the last line's
schema; the guards; the exits without a card or without the program."""

import ast
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from port_bench import run
from port_bench.tests import tiny

torch.set_num_threads(2)
PKG = Path(run.__file__).resolve().parent


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def test_a_dropped_in_config_cell_and_metric_are_found(root, tmp_path):
    import shutil

    new = tmp_path / "co"
    shutil.copytree(root, new)
    cfg = json.loads((new / "port_bench/configs/tiny_srn.json").read_text())
    cfg["name"] = "tiny_srn_b"
    cfg["opt"]["network_G"]["nb"] = 2
    (new / "port_bench/configs/tiny_srn_b.json").write_text(json.dumps(cfg))
    wl = json.loads((new / "port_bench/workloads/tiny_srn_serve.json").read_text())
    (new / "port_bench/workloads/tiny_srn_serve_b.json").write_text(json.dumps(wl))
    (new / "port_bench/metrics/images_per_s.py").write_text(
        "def read(run):\n    return len(run.record['lr_pixels']) / run.record['window_s']\n")
    spec = json.loads((new / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny_srn_serve_b", "config": "tiny_srn_b",
                              "traffic": "tiny_lr_b", "chips": 1, "why": "drop-in"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "tiny_srn_serve" in m["workloads"]:
            m["workloads"].append("tiny_srn_serve_b")
    spec["per_layer"].append({"name": "images_per_s", "unit": "1/s", "better": "higher",
                              "source": "host_clock", "layer": "facade", "moves":
                              "serve_mpix_per_s", "workloads": ["tiny_srn_serve_b"]})
    (new / "BENCHMARK.json").write_text(json.dumps(spec))
    out = tiny.run_tiny(new, "tiny_srn_serve_b", trace=1)
    assert out["rc"] == 0
    assert out["result"]["metrics"]["images_per_s"]["value"] > 0
    out = tiny.run_tiny(new, "tiny_srn_serve_b", trace=0)
    assert set(out["result"]["metrics"]) == {"serve_mpix_per_s", "serve_p95_ms", "setup_s"}


@pytest.mark.parametrize("cell", ["tiny_srn_serve", "tiny_srn_train", "tiny_dsn_train"])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_schema(root, cell, trace):
    out = tiny.run_tiny(root, cell, trace=trace)
    assert out["rc"] == 0
    r = out["result"]
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    spec = json.loads((root / "BENCHMARK.json").read_text())
    group = "per_layer" if trace else "end_to_end"
    listed = {m["name"]: m["unit"] for m in spec[group] if cell in m.get("workloads", [cell])}
    assert set(r["metrics"]) <= set(listed) and r["metrics"]
    for name, m in r["metrics"].items():
        assert m["unit"] == listed[name] and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in r["breakdown"].values())
    else:
        assert "setup_s" in r["metrics"] and "breakdown" not in r
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}


def test_guard_names_jax_and_the_jax_package_but_not_the_port(monkeypatch):
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "dasr_tpu_torch_extra", types.ModuleType("x"))
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "dasr_tpu.ops", types.ModuleType("dasr_tpu.ops"))
    assert run.loaded_forbidden() == ["dasr_tpu", "jax"]


def test_a_reference_that_imports_the_program_is_caught(root, tmp_path):
    import shutil

    new = tmp_path / "co"
    shutil.copytree(root, new)
    assert run.reference_imports_program(new) == []
    (new / "port_bench/reference/bad.py").write_text(
        "from dasr_tpu_torch.ops import rdb\n")
    assert run.reference_imports_program(new) == ["bad.py"]


def test_no_module_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in run.FORBIDDEN for n in names), path


def test_no_card_exits_2_with_no_result(root, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here")
    rc = run.main(["--workload", "tiny_srn_serve", "--seed", "1", "--seconds", "1"], root=root)
    assert rc == 2 and capsys.readouterr().out == ""


def test_only_the_benchmark_files_exit_nonzero(tmp_path):
    import shutil

    shutil.copytree(PKG, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(PKG.parent / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "srn_serve",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_traced_run_reads_the_host_clock_from_the_measured_window(root):
    """Host-clock metrics come from the untraced window of ``--seconds``;
    the device trace from the second, traced window of the cell's own
    length."""
    from port_bench import harness

    run_ = harness.Run(harness.Bench(root), "tiny_srn_train", 5, 0.5, True, torch.device("cpu"))
    out = run.execute(run_, 0.0)
    params = run_.params
    assert run_.record["window_s"] >= 0.5
    assert run_.trace_record["steps"] == params["trace_windows"] * params["steps_per_call"]
    issue = [t1 - t0 for n, t0, t1 in run_.spans.items if n == "issue"]
    assert out["metrics"]["host_issue_ms_per_step"]["value"] == pytest.approx(
        1e3 * sum(issue) / run_.record["steps"])
    assert out["metrics"]["kernels_per_step"]["value"] == pytest.approx(
        len(run_.trace.events) / run_.trace_record["steps"])
    assert set(run_.host) >= {"train_step_ms", "host_issue_ms_per_step", "train_mfu_pct",
                              "window_quarters"}
