"""The port's DASR Adaptive model against the benchmark's plain reference
(``port_bench/reference/adaptive.py``) on the CPU, f32, at small widths, on
weights drawn as the benchmark draws them: the generator
(``RRDBNetResidualConv``) against ``rrdbnet_residual_conv``, the shipped
config's patch D (``define_patchD``: FSD, gau, kernel 5, InstanceNorm)
against ``fsd_gau``, and three steps of ``DASRAdaptiveTrainer`` against
``adaptive_steps``, with the patch D's Adam step off and on; then a tiny
``adaptive_train`` cell through ``port_bench.run`` on the CPU.

The reference imports nothing of the program; this test imports both."""

import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import harness, trainloop
from port_bench.reference import adaptive, nets

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
NF, NB, GC, NB_ADA, D_NF = 16, 1, 8, 1, 16
B, LR_SIZE, SCALE = 2, 16, 4
# the forward limit of port_bench's reference tests, held tighter: both
# sides are f32 convs on the CPU and differ only in the order of the adds
FWD_TOL = 1e-5
# the loss limits of the DASR three-step trajectory (tests/torch_srn_step_case.py:
# RTOL, ATOL): two f32 computations of one step part by the order of their adds
LOSS_RTOL, LOSS_ATOL = 2e-3, 2e-5
# the first gradients as each Adam got them, held in norm as the Adaptive
# trajectory holds G's first moments (tests/torch_adaptive_step_case.py:
# MOMENT_RTOL), each leaf's gap against the larger of its norm and the
# median leaf's, as port_bench/compare.py measures a leaf's gap
GRAD_RTOL = 1e-3
# the change over three steps, each leaf's gap in norm against the larger of
# its norm and the median leaf's: an Adam element whose gradient is rounding
# noise moves up to lr a step either way (the trajectories' PARAM_ATOL strays,
# 2 x 3 x lr at most), so the change is held by its median leaf, as
# port_bench/compare.py holds it, at the trajectories' RTOL; leaves whose
# first gradient is under a thousandth of the median leaf's (the patch D's
# biases before its InstanceNorms, which the norm cancels) are left out
CHANGE_RTOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(a, b, tol=FWD_TOL):
    a, b = a.detach().float(), b.detach().float()
    assert (a - b).abs().max().item() <= tol * max(1.0, b.abs().max().item())


def _opt(use_patchd_opt: bool) -> dict:
    """The shipped config at small widths, f32."""
    opt = json.loads((REPO / "port_bench/configs/dasr_adaptive.json").read_text())["opt"]
    opt["network_G"].update(nf=NF, nb=NB, gc=GC, ada_nb=NB_ADA)
    opt["network_D"].update(nf=D_NF)
    opt["train"]["use_patchD_opt"] = use_patchd_opt
    opt["datasets"]["train"].update(batch_size=B, HR_size=LR_SIZE * SCALE)
    opt.update(bf16=False, is_train=True)
    return opt


def _weights(opt, seed=3):
    ng, nd = opt["network_G"], opt["network_D"]
    specs = {"G": adaptive.rrdbnet_residual_conv_spec(NF, NB, GC, NB_ADA),
             "D": nets.nlayer_spec(nd["in_nc"], nd["nf"], nd["n_layers"]),
             "PatchD": nets.fsd_spec(), "LPIPS": nets.lpips_spec()}
    assert ng["nb"] == NB
    return {n: harness.draw_params(s, seed, n, CPU) for n, s in specs.items()}


def test_generator_and_patch_d_match_the_port():
    from dasr_tpu_torch.models.registry import define_G, define_patchD

    opt = _opt(False)
    w = _weights(opt)
    g, pd = define_G(opt), define_patchD(opt)
    assert pd.filter_type == "gau" and pd.kernel_size == 5
    harness.load_params(g, w["G"], "G")
    harness.load_params(pd, w["PatchD"], "PatchD")
    x = torch.rand(2, 3, 12, 10)
    with torch.no_grad():
        ddm = pd(x)
        _close(adaptive.fsd_gau(w["PatchD"], x), ddm)
        _close(adaptive.rrdbnet_residual_conv(w["G"], x, ddm, nb=NB, nb_ada=NB_ADA), g(x, ddm))


def _batch(rng):
    lr = LR_SIZE
    return {k: torch.from_numpy(rng.random((B, 3, s, s)).astype(np.float32))
            for k, s in (("LR_fake", lr), ("LR_real", lr), ("HR", lr * SCALE),
                         ("HR_unpair", lr * SCALE))}


def _gaps(prog, ref, keys):
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}


@pytest.mark.parametrize("use_patchd_opt", [False, True])
def test_three_steps_match_the_reference(use_patchd_opt):
    from dasr_tpu_torch.models.registry import create_model

    opt = _opt(use_patchd_opt)
    w = _weights(opt)
    model = create_model(opt, CPU).init(0)
    tr = model.trainer
    st = tr.state
    held = {"G": st.g, "D": st.d_target, **({"PatchD": st.patchd} if use_patchd_opt else {})}
    for name, net in (("G", st.g.net), ("D", st.d_target.net), ("PatchD", st.patchd.net),
                      ("LPIPS", tr.lpips)):
        harness.load_params(net, w[name], name)
    rng = np.random.default_rng(7)
    batches = [_batch(rng) for _ in range(3)]
    losses, first = [], None
    for b in batches:
        m = tr.train_step(b)
        losses.append({k: float(v) for k, v in m.items()})
        if first is None:
            first = {n: trainloop.first_grad_norms(ns, opt["train"]["beta1_G" if n == "G"
                                                                    else "beta1_D"])
                     for n, ns in held.items()}
    change = {n: trainloop.change_norms(ns.net, w[n]) for n, ns in held.items()}
    ref = adaptive.adaptive_steps(w, lambda i: batches[i], 3, opt)

    assert set(ref["grad"]) == set(held)
    for i, (got, want) in enumerate(zip(losses, ref["losses"])):
        assert ("loss/patch_D_gan_loss" in want) == use_patchd_opt
        for k, v in want.items():
            assert abs(got[k] - v) <= LOSS_ATOL + LOSS_RTOL * abs(v), (i, k, got[k], v)
    for n, g in ref["grad"].items():
        gaps = _gaps(first[n], g, list(g))
        worst = max(gaps, key=gaps.get)
        assert gaps[worst] <= GRAD_RTOL, (n, worst, gaps[worst])
        med = statistics.median(g.values())
        keep = [k for k, v in g.items() if v >= 1e-3 * med]
        assert statistics.median(_gaps(change[n], ref["change"][n], keep).values()) <= CHANGE_RTOL


def test_tiny_adaptive_cell_runs_on_the_cpu(tmp_path):
    """A tiny ``adaptive_train`` cell beside ``port_bench/tests/tiny.py``'s,
    run by ``port_bench.run.main(device='cpu')`` in a process of its own
    (this one has loaded JAX, which the run refuses), untraced and traced:
    ``correct``, the cell's end-to-end metrics, and with ``--trace 1`` the
    per-layer ones, ``ddm_ms_per_step`` among them."""
    from port_bench.tests import tiny

    root = tiny.make_root(tmp_path / "bench")
    cfg = json.loads((REPO / "port_bench/configs/dasr_adaptive.json").read_text())
    cfg["name"] = "tiny_adaptive"
    cfg["opt"]["network_G"].update(nf=32, nb=1, gc=32, ada_nb=1)
    cfg["opt"]["network_D"].update(nf=8)
    cfg["opt"]["datasets"]["train"].update(batch_size=2, HR_size=32)
    (root / "port_bench/configs/tiny_adaptive.json").write_text(json.dumps(cfg))
    wl = json.loads((REPO / "port_bench/workloads/adaptive_train.json").read_text())
    wl["params"].update(steps_per_call=2, checked_calls=[1, 2], trace_windows=1,
                        banks={"fake": [6, 16, 16, 3], "hr": [6, 64, 64, 3],
                               "real": [6, 16, 16, 3]})
    wl["limits"] = {k: 1e9 for k in wl["limits"]}
    (root / "port_bench/workloads/tiny_adaptive_train.json").write_text(json.dumps(wl))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny_adaptive_train", "config": "tiny_adaptive",
                              "traffic": "tiny_unpair_bank", "chips": 1, "why": "CPU test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "adaptive_train" in m.get("workloads", []):
            m["workloads"].append("tiny_adaptive_train")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import sys; from pathlib import Path; from port_bench import run; "
            f"sys.exit(run.main(sys.argv[1:], root=Path({str(root)!r}), device='cpu'))")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    for trace in (0, 1):
        p = subprocess.run([sys.executable, "-c", code, "--workload", "tiny_adaptive_train",
                            "--seed", "3100000000007", "--seconds", "0.5", "--trace",
                            str(trace)], cwd=REPO, env=env, capture_output=True, text=True,
                           timeout=300)
        assert p.returncode == 0, p.stderr[-3000:]
        r = json.loads(p.stdout.strip().splitlines()[-1])
        assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
        assert set(r["checks"]) == {"grad_gap", "grad_gap_d_median", "change_gap_median"}
        if trace:
            assert {"ddm_ms_per_step", "kernels_per_step", "train_mfu_pct",
                    "device_idle_pct.train", "host_issue_ms_per_step"} <= set(r["metrics"])
            assert r["metrics"]["ddm_ms_per_step"]["value"] > 0
        else:
            assert set(r["metrics"]) == {"train_step_ms", "setup_s"}
