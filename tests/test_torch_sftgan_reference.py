"""The port's SFTGAN serving ('sftgan', 'sft_arch') against the benchmark's
plain reference (``port_bench/reference/sftgan.py``) on the CPU, f32, on
weights and maps drawn as the benchmark draws them: ``SFTNet`` at its
published 16 blocks against ``sftnet``; model 'sftgan''s ``test_async``
on a uint8 LR image and its maps against ``sft_image``; its refusals; the
condition's counter and the three device phases; then a tiny
``sftgan_serve`` cell through ``port_bench.run`` on the CPU.

The reference imports nothing of the program; this test imports both."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench import harness
from port_bench.reference import sftgan
from port_bench.traffic import sft_closed_loop_serve

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
NB, H, W, SEED = 16, 24, 32, 7
# both sides are the same f32 convs on the CPU in another order of adds;
# over outputs of order 0.3 through 40 layers they part by a few ulps of
# the largest activation (1e-6 read), so 1e-5 of the output's largest value
FWD_TOL = 1e-5
MAPS = {"seg_classes": 8, "seg_logit_scale": 24.0}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return harness.draw_params(sftgan.sftnet_spec(NB), SEED, "G", CPU)


@pytest.fixture(scope="module")
def inputs():
    lr = harness.images_u8((1, H, W, 3), SEED, "lr0", CPU)[0]
    return lr, sft_closed_loop_serve.seg_maps(H, W, MAPS, SEED, "seg0", CPU)


def _close(got, want, tol=FWD_TOL):
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


def _model(weights, **opt):
    from dasr_tpu_torch.models.registry import create_model

    model = create_model(dict({"model": "sftgan", "scale": 4, "bf16": False,
                               "network_G": {"which_model_G": "sft_arch"}}, **opt), CPU)
    harness.load_params(model.g, weights, "G")
    return model


def test_sftnet_matches_the_reference(weights, inputs):
    from dasr_tpu_torch.nn.sft import SFTNet

    lr, seg = inputs
    net = SFTNet(n_blocks=NB)
    harness.load_params(net, weights, "G")
    x = lr.permute(2, 0, 1)[None].float() / 255.0
    with torch.no_grad():
        got = net.eval()(x, seg[None])
        want = sftgan.sftnet(weights, x, seg[None])
    assert got.shape == (1, 3, 4 * H, 4 * W)
    _close(got, want)


@pytest.mark.parametrize("layout", ["chw", "hwc"])
def test_served_image_matches_the_reference(weights, inputs, layout):
    """A uint8 HWC LR image and its maps, CHW or HWC, through the facade."""
    lr, seg = inputs
    model = _model(weights)
    maps = seg.numpy() if layout == "chw" else seg.permute(1, 2, 0).numpy()
    got = model.test_async(lr.numpy(), maps)
    assert got.shape == (4 * H, 4 * W, 3) and got.dtype == torch.float32
    _close(got, sftgan.sft_image(weights, lr, seg))


def test_refusals_name_what_they_refuse(weights, inputs):
    from dasr_tpu_torch.models.registry import create_model

    opt = {"model": "sftgan", "network_G": {"which_model_G": "sft_arch"}}
    for key in ("is_train", "chop", "pad_bucket"):
        with pytest.raises(ValueError, match=key):
            create_model(dict(opt, **{key: True}), CPU)
    lr, seg = inputs
    model = _model(weights)
    with pytest.raises(ValueError, match=r"segmentation maps of shape \(8, 96, 124\)"):
        model.test_async(lr.numpy(), seg[:, :, :-4].numpy())
    with pytest.raises(ValueError, match="segmentation maps"):
        model.test_async(lr.numpy())
    # only 'sftgan' takes 'sft_arch', and only 'sftgan' takes a condition
    with pytest.raises(NotImplementedError, match="sftgan_test"):
        create_model({"model": "sr", "network_G": {"which_model_G": "sft_arch"}}, CPU)


def test_condition_counted_and_phases_marked_only_while_tracing(weights, inputs, monkeypatch):
    """``serve.cond_bytes``: 8 f32 maps at x4, 512 bytes an LR pixel; the
    upload a span nested in ``serve.upload``; SFTNet's three phases marked
    with tracing on, and no mark with it off."""
    from dasr_tpu_torch.utils import trace

    lr, seg = inputs
    model = _model(weights)
    mark, marks = trace._mark, []
    monkeypatch.setattr(trace, "_mark", lambda i: (marks.append(i), mark(i)))
    before = trace.counters()
    model.test_async(lr.numpy(), seg.numpy())
    after = trace.counters()
    assert after["serve.cond_bytes"] - before.get("serve.cond_bytes", 0) == 512 * H * W
    assert after["serve.image_lr_px"] - before["serve.image_lr_px"] == H * W
    assert marks == []
    trace.enable()
    try:
        model.test_async(lr.numpy(), seg.numpy())
        spans = trace.drain()
    finally:
        trace.disable()
    assert marks == [0, 1, 2, 3]
    assert set(trace.phase_ms()) == {"cond", "sft_branch", "hr_branch"}
    assert [s.parent for s in spans if s.name == "serve.cond_upload"] == ["serve.upload"]


def test_tiny_sftgan_cell_runs_on_the_cpu(tmp_path):
    """A tiny ``sftgan_serve`` cell (2 blocks, LR 16x24 and 24x16) in a
    root this test builds, run by ``port_bench.run.main(device='cpu')`` in
    a process of its own (this one has loaded JAX, which the run refuses),
    untraced and traced: ``correct``, the cell's end-to-end metrics, and
    with ``--trace 1`` its per-layer ones."""
    from port_bench.tests import tiny

    root = tiny.make_root(tmp_path / "bench")
    cfg = json.loads((REPO / "port_bench/configs/sftgan.json").read_text())
    cfg["name"] = "tiny_sftgan"
    cfg["opt"]["network_G"]["nb"] = 2
    (root / "port_bench/configs/tiny_sftgan.json").write_text(json.dumps(cfg))
    wl = json.loads((REPO / "port_bench/workloads/sftgan_serve.json").read_text())
    wl["params"].update(shapes=[[16, 24, 2], [24, 16, 1]], check_images=2, trace_seconds=0.5)
    (root / "port_bench/workloads/tiny_sftgan_serve.json").write_text(json.dumps(wl))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny_sftgan_serve", "config": "tiny_sftgan",
                              "traffic": "tiny_lr_seg", "chips": 1, "why": "CPU test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "sftgan_serve" in m.get("workloads", []):
            m["workloads"].append("tiny_sftgan_serve")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import sys; from pathlib import Path; from port_bench import run; "
            f"sys.exit(run.main(sys.argv[1:], root=Path({str(root)!r}), device='cpu'))")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for trace in (0, 1):
        p = subprocess.run([sys.executable, "-c", code, "--workload", "tiny_sftgan_serve",
                            "--seed", "3100000000011", "--seconds", "0.5", "--trace",
                            str(trace)], cwd=REPO, env=env, capture_output=True, text=True,
                           timeout=300)
        assert p.returncode == 0, p.stderr[-3000:]
        r = json.loads(p.stdout.strip().splitlines()[-1])
        assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
        assert set(r["checks"]) == {"sr_rms_vs_bf16", "sr_max_vs_bf16"}
        if trace:
            m = r["metrics"]
            assert {"sft_branch_ms", "cond_bytes_per_lr_px", "sft_serve_mfu_pct",
                    "serve_host_issue_ms"} <= set(m)
            assert m["cond_bytes_per_lr_px"]["value"] == 512.0
            assert m["sft_branch_ms"]["value"] > 0 and m["sft_serve_mfu_pct"]["value"] > 0
        else:
            assert set(r["metrics"]) == {"serve_mpix_per_s", "serve_p95_ms", "setup_s"}
