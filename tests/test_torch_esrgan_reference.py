"""The port's ESRGAN ('srragan') against the benchmark's plain reference
(``port_bench/reference/esrgan.py``) on the CPU, f32, at small widths, on
weights drawn as the benchmark draws them: ``VGG19Feature54`` against
``vgg19_54``; ``define_D``'s ``discriminator_vgg_48`` (nf 16, the stage
code of vgg_192) against ``vgg_d``, its outputs and its BatchNorms'
running statistics; three steps of the banked window, looped, against
``srragan_steps``; the looped window against three calls of
``SRGANModel.train_step`` on the same draws, bit for bit; then a tiny
``srragan_train`` cell through ``port_bench.run`` on the CPU.

The reference imports nothing of the program; this test imports both."""

import json
import os
import statistics
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import harness, trainloop
from port_bench.reference import esrgan, nets, sampling

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
NF, NB, GC, D_NF = 16, 1, 8, 16
B, HR_SIZE, SCALE, SEED = 2, 48, 4, 11
D_48 = "discriminator_vgg_48"
# the forward limit of tests/test_torch_adaptive_reference.py: both sides
# are f32 convs on the CPU and differ only in the order of the adds
FWD_TOL = 1e-5
# BatchNorm's statistics: the port takes the variance as E[x^2] - E[x]^2
# (flax's), the reference in two passes; in f32 over unit-scale maps the two
# part by a few ulps of the mean square, 1e-5 of the variance at most here
STATS_TOL = 1e-5
# the loss, first-gradient and change limits of the Adaptive reference test
# (tests/test_torch_adaptive_reference.py), for the same reasons: two f32
# computations of one step part by the order of their adds, and an Adam
# element whose gradient is rounding noise moves up to lr a step either way
LOSS_RTOL, LOSS_ATOL = 2e-3, 2e-5
GRAD_RTOL = 1e-3
CHANGE_RTOL = 2e-3
# D's running statistics after three steps, as a relative gap of each
# BatchNorm's (mean, variance): after the first step D's batch statistics
# are those of weights in which an Adam element whose gradient is rounding
# noise has moved up to lr (1e-4) a step either way, so the gap reads a few
# lr (1.0e-4 here), far above the batch statistics' own rounding (STATS_TOL)
BN_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(a, b, tol=FWD_TOL):
    a, b = a.detach().float(), b.detach().float()
    assert (a - b).abs().max().item() <= tol * max(1.0, b.abs().max().item())


def _opt() -> dict:
    """The shipped config at small widths, the 48 D, f32."""
    opt = json.loads((REPO / "port_bench/configs/esrgan_srragan.json").read_text())["opt"]
    opt["network_G"].update(nf=NF, nb=NB, gc=GC)
    opt["network_D"].update(which_model_D=D_48, nf=D_NF)
    opt["datasets"]["train"].update(batch_size=B, HR_size=HR_SIZE)
    opt["train"]["manual_seed"] = SEED
    opt.update(bf16=False, is_train=True)
    return opt


def _weights(opt, seed=3):
    specs = {"G": nets.rrdbnet_spec(NF, NB, GC), "D": esrgan.vgg_d_spec(D_48, 3, D_NF),
             "VGG": esrgan.vgg19_54_spec()}
    return {n: harness.draw_params(s, seed, n, CPU) for n, s in specs.items()}


def _model(opt, w):
    from dasr_tpu_torch.models.registry import create_model

    model = create_model(opt, CPU).init(0)
    tr = model.trainer
    harness.load_params(tr.state.g.net, w["G"], "G")
    harness.load_params(tr.state.d_target.net, w["D"], "D")
    harness.load_params(tr.vgg, w["VGG"], "VGG")
    return model


def _banks():
    """Four pairs: LRs of 16 x 20, HRs of 64 x 80, as numpy banks."""
    from dasr_tpu_torch.data.device_bank import ImageBank

    out = {}
    for name, (h, w) in (("lr", (16, 20)), ("hr", (64, 80))):
        data = harness.images_u8((4, h, w, 3), 5, name, CPU).numpy()
        out[name] = ImageBank(data, np.array([[h, w]] * 4, np.int32))
    return out


def test_vgg19_54_matches_the_reference():
    from dasr_tpu_torch.nn.vgg import VGG19Feature54

    w = _weights(_opt())["VGG"]
    vgg = VGG19Feature54()
    harness.load_params(vgg, w, "VGG")
    assert set(vgg.state_dict()) == set(w)  # the buffers are not state
    x = torch.rand(2, 3, 32, 32)
    with torch.no_grad():
        _close(vgg(x), esrgan.vgg19_54(w, x))


def test_vgg_48_discriminator_and_its_statistics_match_the_reference():
    """Two training-mode forwards that move the statistics and one that does
    not: the logits, then each BatchNorm's running mean and variance and
    the forwards counted."""
    from dasr_tpu_torch.models.registry import define_D
    from dasr_tpu_torch.nn.layers import stats_updates

    opt = _opt()
    w = _weights(opt)["D"]
    d = define_D(opt).train()
    harness.load_params(d, w, "D")
    stats = esrgan.vgg_d_stats(D_48, D_NF, CPU)
    xs = [torch.rand(4, 3, 48, 48) for _ in range(3)]
    with torch.no_grad():
        for x, update in zip(xs, (True, False, True)):
            with stats_updates(d, update):
                got = d(x)
            _close(got, esrgan.vgg_d(w, x, D_48, D_NF, stats=stats if update else None))
    bufs = dict(d.named_buffers())
    for name, ref in stats.items():
        if name == "updates":
            assert int(bufs["features.3.num_batches_tracked"]) == int(ref) == 2
        else:
            _close(bufs[name], ref, STATS_TOL)


def _gaps(prog, ref, keys):
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}


def test_three_banked_steps_match_the_reference():
    """Two calls of the banked window, looped on the CPU (one step, then
    two), against three reference steps on batches drawn from the same
    generators: each call's last losses, the first gradients, the change,
    and D's running statistics with the forwards that moved them (two a
    step)."""
    from dasr_tpu_torch.data.device_bank import upload
    from port_bench.traffic import srragan_banked_window as kind

    opt = _opt()
    w = _weights(opt)
    model = _model(opt, w)
    banks = _banks()
    model.setup_device_bank(banks["lr"], banks["hr"], HR_SIZE)
    st = model.trainer.state
    run = types.SimpleNamespace(params={"checked_calls": [1, 2]})
    rows = iter([np.array([0, 2]), np.array([3, 1]), np.array([2, 2])])
    prog = trainloop.checked_calls(run, model.train_banked_window_async, model.metrics_to_host,
                                   rows, {"G": st.g, "D": st.d_target}, {"G": 0.9, "D": 0.9},
                                   {"G": w["G"], "D": w["D"]})
    gens = sampling.call_generators(SEED, prog["calls"], CPU)
    dev = {k: tuple(upload(b, CPU)) for k, b in banks.items()}
    ref = esrgan.srragan_steps(
        w, lambda i: esrgan.paired_batch(dev, torch.as_tensor(prog["rows"][i]), next(gens),
                                         HR_SIZE, SCALE, True, True), 3, opt)

    for got, i in zip(prog["losses"], prog["loss_steps"]):
        for k, v in ref["losses"][i].items():
            assert abs(got[k] - v) <= LOSS_ATOL + LOSS_RTOL * abs(v), (i, k, got[k], v)
    for n, g in ref["grad"].items():
        gaps = _gaps(prog["grad"][n], g, list(g))
        worst = max(gaps, key=gaps.get)
        assert gaps[worst] <= GRAD_RTOL, (n, worst, gaps[worst])
        med = statistics.median(g.values())
        keep = [k for k, v in g.items() if v >= 1e-3 * med]
        assert statistics.median(_gaps(prog["change"][n], ref["change"][n], keep).values()) \
            <= CHANGE_RTOL
    assert int(ref["bn"]["updates"]) == 6
    assert kind.bn_stats_gap(kind.bn_stats(st.d_target.net), ref["bn"]) <= BN_RTOL


def test_looped_window_equals_train_step_calls():
    """One three-step window and three ``train_step`` calls on host batches
    of the window's own draws, from one state: the same bits in the last
    metrics, the parameters, Adam's moments and D's running statistics,
    and two D forwards a step that moved them."""
    from dasr_tpu_torch.data import device_bank as bank
    from dasr_tpu_torch.utils import trace

    opt = _opt()
    w = _weights(opt)
    banks = _banks()
    windowed, stepped = _model(opt, w), _model(opt, w)
    windowed.setup_device_bank(banks["lr"], banks["hr"], HR_SIZE)
    rows = np.array([[0, 2], [3, 1], [2, 2]])
    before = trace.counters().get("bn.stat_updates", 0)
    got = windowed.metrics_to_host(windowed.train_banked_window_async(rows, 0))
    assert trace.counters()["bn.stat_updates"] - before == 2 * 3
    gen = bank.window_generator(SEED, 0, CPU)
    dev = bank.PairedBanks(*(bank.upload(banks[k], CPU) for k in ("lr", "hr")))
    for row in rows:
        batch = bank.gather_paired(dev, torch.as_tensor(row), bank.draw_paired(gen, B),
                                   HR_SIZE, SCALE)
        want = stepped.train_step(batch)
    assert got == want
    a, b = windowed.trainer.state, stepped.trainer.state
    assert a.step == b.step == 3
    for name in ("g", "d_target"):
        na, nb = getattr(a, name), getattr(b, name)
        for (k, x), (_, y) in zip(na.net.state_dict().items(), nb.net.state_dict().items()):
            assert torch.equal(x, y), (name, k)
        for p, q in zip(na.params(), nb.params()):
            for what in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(na.opt.state[p][what], nb.opt.state[q][what])


def test_tiny_srragan_cell_runs_on_the_cpu(tmp_path):
    """A tiny ``srragan_train`` cell beside ``port_bench/tests/tiny.py``'s,
    run by ``port_bench.run.main(device='cpu')`` in a process of its own
    (this one has loaded JAX, which the run refuses), untraced and traced:
    ``correct``, the cell's end-to-end metrics, and with ``--trace 1`` the
    per-layer ones, ``feature_ms_per_step`` among them."""
    from port_bench.tests import tiny

    root = tiny.make_root(tmp_path / "bench")
    cfg = json.loads((REPO / "port_bench/configs/esrgan_srragan.json").read_text())
    cfg["name"] = "tiny_esrgan"
    cfg["opt"]["network_G"].update(nf=32, nb=1, gc=32)
    cfg["opt"]["network_D"].update(which_model_D=D_48, nf=8)
    cfg["opt"]["datasets"]["train"].update(batch_size=2, HR_size=48)
    (root / "port_bench/configs/tiny_esrgan.json").write_text(json.dumps(cfg))
    wl = json.loads((REPO / "port_bench/workloads/srragan_train.json").read_text())
    wl["params"].update(steps_per_call=2, checked_calls=[1, 2], trace_windows=1,
                        banks={"lr": [6, 16, 16, 3], "hr": [6, 64, 64, 3]})
    wl["limits"] = {k: 1e9 for k in wl["limits"]}
    (root / "port_bench/workloads/tiny_srragan_train.json").write_text(json.dumps(wl))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny_srragan_train", "config": "tiny_esrgan",
                              "traffic": "tiny_pair_bank", "chips": 1, "why": "CPU test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "srragan_train" in m.get("workloads", []):
            m["workloads"].append("tiny_srragan_train")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import sys; from pathlib import Path; from port_bench import run; "
            f"sys.exit(run.main(sys.argv[1:], root=Path({str(root)!r}), device='cpu'))")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    for trace in (0, 1):
        p = subprocess.run([sys.executable, "-c", code, "--workload", "tiny_srragan_train",
                            "--seed", "3100000000011", "--seconds", "0.5", "--trace",
                            str(trace)], cwd=REPO, env=env, capture_output=True, text=True,
                           timeout=300)
        assert p.returncode == 0, p.stderr[-3000:]
        r = json.loads(p.stdout.strip().splitlines()[-1])
        assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
        assert set(r["checks"]) == {"grad_gap", "grad_gap_d_median", "change_gap_median",
                                    "bn_stats_gap"}
        if trace:
            assert {"feature_ms_per_step", "kernels_per_step", "train_mfu_pct",
                    "device_idle_pct.train", "host_issue_ms_per_step"} <= set(r["metrics"])
            assert r["metrics"]["feature_ms_per_step"]["value"] > 0
        else:
            assert set(r["metrics"]) == {"train_step_ms", "setup_s"}
