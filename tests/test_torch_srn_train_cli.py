"""The port's srn_train CLI on a tiny synthetic DASR corpus (CPU): it trains,
logs finite losses to metrics.jsonl, validates with LPIPS, saves the train
state and the reference-format checkpoints. The fast path: K-step windows
on the device bank and on the host loader log at the host loader's
cadence; uint8 windows train exactly as f32 single steps; the device
validation metrics agree with the host f64 protocol recomputed from the
saved PNGs; ``--profile`` writes a trace; a run resumed from its
``{iter}.pt`` ends where the straight run ends; the bank gate falls back to
the host loader, with two repairs against ``dasr_tpu`` (ADVICE.md:4, fake
LR / HR / DDM counts must match; ADVICE.md:6, the corpus must hold a
batch); a run resumed from its reference-format ``{iter}.state`` continues
to ``niter`` as a resume from its ``{iter}.pt`` does."""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from dasr_tpu_torch.cli import srn_train
from dasr_tpu_torch.data.io import save_img

LOSSES = {"loss/l_g_pix", "loss/l_g_LL_pix", "loss/l_g_fea", "loss/l_g_gan_target_Hf",
          "loss/l_d_target_total", "loss/l_g_total"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small ops: torch's intra-op threads only contend with the other
    test workers for the cores (as in tests/test_torch_dsn_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_corpus(root, n=4, hr=64, seed=3):
    """HR images, fake LRs at HR/4, real LRs, DDM .npy maps in [0, 1] of the
    DSN layout (1, 1, h, w), and two validation pairs."""
    rng = np.random.default_rng(seed)
    dirs = {d: os.path.join(root, d) for d in ("hr", "fake", "real", "ddm", "val_hr", "val_lr")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i in range(n):
        save_img(rng.random((hr, hr, 3)), os.path.join(dirs["hr"], f"{i:03d}.png"))
        save_img(rng.random((hr // 4, hr // 4, 3)), os.path.join(dirs["fake"], f"{i:03d}.png"))
        save_img(rng.random((hr // 4 + 4, hr // 4 + 4, 3)),
                 os.path.join(dirs["real"], f"{i:03d}.png"))
        np.save(os.path.join(dirs["ddm"], f"{i:03d}.npy"),
                rng.random((1, 1, hr // 4, hr // 4)).astype(np.float32))
    for i in range(2):
        lr = rng.random((12, 12, 3))
        save_img(lr, os.path.join(dirs["val_lr"], f"v{i}.png"))
        save_img(np.kron(lr, np.ones((4, 4, 1))), os.path.join(dirs["val_hr"], f"v{i}.png"))
    return dirs


def train_config(root, dirs, niter=4, **extra):
    cfg = {
        "name": "tiny_dasr", "model": "DASR", "scale": 4, "val_lpips": True, "bf16": False,
        "multiweights": True, **extra,
        "datasets": {
            "train": {"name": "synth", "mode": "LRHR_wavelet_unpair_fake_weights_EQ",
                      "dataroot_HR": dirs["hr"], "dataroot_fake_LR": dirs["fake"],
                      "dataroot_real_LR": dirs["real"], "dataroot_fake_weights": dirs["ddm"],
                      "n_workers": 2, "batch_size": 2, "HR_size": 64},
            "val": {"name": "val", "mode": "LRHR", "dataroot_HR": dirs["val_hr"],
                    "dataroot_LR": dirs["val_lr"]},
        },
        "path": {"root": str(root)},
        "network_G": {"which_model_G": "RRDB_net", "nf": 16, "nb": 1, "gc": 8},
        "network_D": {"which_model_D": "discriminator_patch", "nf": 16, "in_nc": 9, "n_layers": 2},
        "train": {"niter": niter, "val_freq": 4, "manual_seed": 0, "lr_steps": [2]},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 4, "save_ref_formats": True},
    }
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("srn_train")
    dirs = write_corpus(str(root))
    steps, last = srn_train.main(["-opt", train_config(str(root), dirs), "--device", "cpu"])
    return root, steps, last


def test_trains_and_logs_finite_losses(run):
    root, steps, last = run
    assert steps == 4 and LOSSES <= set(last)
    with open(root / "tiny_dasr" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if "loss/l_g_total" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all(np.isfinite(r[k]) for r in train for k in LOSSES)
    val = [r for r in recs if "val/psnr" in r]
    assert len(val) == 1 and val[0]["step"] == 4
    assert all(np.isfinite(val[0][f"val/{k}"]) for k in ("psnr", "ssim", "lpips"))
    assert len(os.listdir(root / "tiny_dasr" / "val_images" / "4")) == 2


def test_saves_train_state_and_reference_formats(run):
    root, _, _ = run
    state = torch.load(root / "tiny_dasr" / "training_state" / "4.pt", weights_only=True)
    assert state["step"] == 4 and {"G", "D_target"} <= set(state)
    assert state["G"]["sched"]["last_epoch"] == 4
    # the milestone at 2: updates 2 and 3 ran at half the LR, and the next will
    assert state["G"]["opt"]["param_groups"][0]["lr"] == pytest.approx(0.5e-4)
    models = sorted(os.listdir(root / "tiny_dasr" / "models"))
    assert models == ["4.state", "4_D_target.pth", "4_G.pth"]
    g = torch.load(root / "tiny_dasr" / "models" / "4_G.pth", weights_only=True)
    assert "model.1.sub.0.RDB1.conv1.0.weight" in g
    torch.testing.assert_close(g["model.0.weight"], state["G"]["net"]["model.0.weight"])


def _fast_config(root, dirs, name, niter=8, **extra):
    """train_config with windows in mind: prints, validates and saves at
    multiples of 4."""
    path = train_config(root, dirs, niter=niter, **extra)
    cfg = json.load(open(path))
    cfg["name"] = name
    cfg["train"]["val_freq"] = 8
    cfg["logger"].update(print_freq=4, save_ref_formats=False)
    path = os.path.join(root, f"{name}.json")
    json.dump(cfg, open(path, "w"))
    return path


def _run(path, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        steps, last = srn_train.main(["-opt", path, "--device", "cpu", *args])
    return steps, last, out.getvalue()


@pytest.fixture(scope="module")
def fast(tmp_path_factory):
    """Three 8-step runs of one config: the host loader a step at a time
    with host metrics; 4-step uint8 windows on the host loader with device
    val metrics; 4-step windows on the device bank with device val metrics
    padded to a bucket of 32."""
    root = str(tmp_path_factory.mktemp("srn_fast"))
    dirs = write_corpus(root)
    runs = {
        "host": _run(_fast_config(root, dirs, "host")),
        "windows": _run(_fast_config(root, dirs, "windows", val_device_metrics=True),
                        "--steps_per_call", "4", "--transfer_uint8"),
        "bank": _run(_fast_config(root, dirs, "bank", val_device_metrics=True,
                                  val_metrics_pad_bucket=32),
                     "--device_bank", "--steps_per_call", "4", "--transfer_uint8"),
    }
    return root, dirs, runs


def _records(root, name):
    with open(os.path.join(root, name, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _g_params(root, name, step):
    return torch.load(os.path.join(root, name, "training_state", f"{step}.pt"),
                      weights_only=True)["G"]["net"]


def test_windows_log_at_the_host_loader_cadence(fast):
    root, _, runs = fast
    assert "device bank: " in runs["bank"][2] and "GiB resident" in runs["bank"][2]
    assert "device bank" not in runs["windows"][2]
    for name, (steps, last, _) in runs.items():
        train = [r for r in _records(root, name) if "loss/l_g_total" in r]
        assert steps == 8 and [r["step"] for r in train] == [4, 8], name
        assert all(np.isfinite(r[k]) for r in train for k in LOSSES), name
        assert LOSSES <= set(last)


def test_uint8_windows_train_as_f32_single_steps(fast):
    """The same batches in the same order: 4-step windows of uint8 batches
    cast on the device give the single-step f32 run's weights."""
    root, _, _ = fast
    for step in (4, 8):
        want, got = _g_params(root, "host", step), _g_params(root, "windows", step)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["windows", "bank"])
def test_device_val_metrics_match_the_host_protocol(fast, name):
    """The logged device metrics (bank: padded to a bucket of 32) against the
    host f64 protocol on the saved SR PNGs, 1e-3 dB and 1e-4 SSIM; LPIPS
    1e-4."""
    from dasr_tpu_torch.cli.srn_test import make_lpips
    from dasr_tpu_torch.data.io import read_img
    from dasr_tpu_torch.eval.evaluate import average, sr_metrics, to_uint8

    root, dirs, _ = fast
    val = [r for r in _records(root, name) if "val/psnr" in r]
    assert len(val) == 1 and val[0]["step"] == 8
    lpips = make_lpips(torch.device("cpu"))
    host = []
    for i in range(2):
        sr = read_img(os.path.join(root, name, "val_images", "8", f"v{i}_8.png"))
        hr = read_img(os.path.join(dirs["val_hr"], f"v{i}.png"))
        host.append(sr_metrics(to_uint8(sr), to_uint8(hr), 4, lpips))
    want = average(host)
    for k, v in want.items():
        limit = 1e-3 if k.startswith("psnr") else 1e-4
        assert abs(val[0][f"val/{k}"] - v) < limit, (k, val[0][f"val/{k}"], v)


def test_resumed_banked_run_ends_where_the_straight_run_ends(fast, caplog):
    """Resume from the bank run's 4.pt: the run continues inside the epoch,
    draws the windows it would have drawn, and its 8.pt equals the bank
    run's."""
    root, dirs, _ = fast
    path = _fast_config(root, dirs, "resumed", val_device_metrics=True,
                        val_metrics_pad_bucket=32)
    cfg = json.load(open(path))
    cfg["path"]["resume_state"] = os.path.join(root, "bank", "training_state", "4.pt")
    json.dump(cfg, open(path, "w"))
    with caplog.at_level("INFO", logger="base"):
        steps, _, _ = _run(path, "--device_bank", "--steps_per_call", "4", "--transfer_uint8")
    assert steps == 8 and "Resuming training from iteration: 4." in caplog.text
    assert [r["step"] for r in _records(root, "resumed") if "loss/l_g_total" in r] == [8]
    want, got = _g_params(root, "bank", 8), _g_params(root, "resumed", 8)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_profile_writes_a_trace(tmp_path, caplog):
    """A torch.profiler trace of steps 10-20 (windows of 4: from the window
    that reaches step 10 to the one that reaches step 20), and beside it
    the port's spans of those windows on the trace's clock (each window's
    index upload, ``window.upload``, with the window's first step); the run
    logs the port's counters."""
    dirs = write_corpus(str(tmp_path), n=2)
    path = _fast_config(str(tmp_path), dirs, "prof", niter=20)
    trace = str(tmp_path / "trace")
    with caplog.at_level("INFO", logger="base"):
        steps, _, _ = _run(path, "--device_bank", "--steps_per_call", "4", "--profile", trace)
    assert steps == 20 and f"wrote the profiler trace to {trace}" in caplog.text
    assert "counters: {" in caplog.text
    with open(os.path.join(trace, "trace.json")) as f:
        prof = json.load(f)
    with open(os.path.join(trace, "spans.json")) as f:
        spans = json.load(f)
    assert spans["baseTimeNanoseconds"] == prof.get("baseTimeNanoseconds", 0)
    uploads = [e for e in spans["traceEvents"] if e["name"] == "window.upload"]
    assert [e["args"]["id"] for e in uploads] == [8, 12, 16]
    timed = [e for e in prof["traceEvents"] if e.get("ph") == "X"]
    t0, t1 = min(e["ts"] for e in timed), max(e["ts"] + e["dur"] for e in timed)
    assert all(t0 <= e["ts"] <= e["ts"] + e["dur"] <= t1 for e in uploads)


def _gate_case(root, case):
    """(opt, train dataset opt) of the tiny corpus, changed as ``case`` says."""
    dirs = write_corpus(root, n=3)
    cfg = json.load(open(train_config(root, dirs)))
    ds = cfg["datasets"]["train"]
    if case == "small_images":
        ds["HR_size"] = 128
    elif case == "not_dasr":
        cfg["model"] = "sr"
    elif case == "adaptive":
        cfg["model"] = "DASR_Adaptive_Model"
    elif case == "update_inter":
        cfg["train"]["D_update_inter"] = 2
    elif case == "mode":
        ds["mode"] = "LRHR_wavelet_unpair_fake_real_w_EQ"
    elif case == "count_mismatch":
        shutil.copy(os.path.join(dirs["hr"], "000.png"), os.path.join(dirs["hr"], "003.png"))
    elif case == "fewer_than_a_batch":
        ds["batch_size"] = 4
    return cfg, ds


@pytest.mark.parametrize("case,reason", [
    ("budget", "GiB > budget"), ("small_images", "smaller than the crop"),
    ("not_dasr", "model [sr] has no banked path"), ("adaptive", "dataset mode [LRHR_wavelet_unpair_fake_weights_EQ] unsupported for model "
                  "[DASR_Adaptive_Model]"),
    ("update_inter", "G/D_update_inter != 1"), ("mode", "dataset mode"),
    ("count_mismatch", "3 fake LRs, 4 HRs and 3 DDMs are not paired"),
    ("fewer_than_a_batch", "3 train images hold no batch of 4"),
])
def test_bank_gate_falls_back_to_the_host_loader(tmp_path, capsys, case, reason):
    cfg, ds = _gate_case(str(tmp_path), case)
    budget = 1e-9 if case == "budget" else 1.0
    assert srn_train._bank_gate(cfg, ds, budget) is None
    out = capsys.readouterr().out
    assert reason in out and out.strip().endswith("using the host loader")
    if case == "budget":  # and the run trains on the host loader
        path = _fast_config(str(tmp_path), write_corpus(str(tmp_path), n=2), "fallback",
                            niter=4)
        steps, _, out = _run(path, "--device_bank", "--device_bank_gb", "1e-9",
                             "--steps_per_call", "2")
        assert steps == 4 and "using the host loader" in out and "GiB resident" not in out


def test_bank_gate_accepts_the_tiny_corpus(tmp_path):
    cfg, ds = _gate_case(str(tmp_path), "none")
    dirs = srn_train._bank_gate(cfg, ds, 1.0)
    assert dirs == tuple(ds[k] for k in ("dataroot_fake_LR", "dataroot_HR", "dataroot_real_LR",
                                         "dataroot_fake_weights"))


def test_resume_from_a_reference_state_continues_to_niter(run, caplog):
    """Resume from the run's reference-format ``4.state`` (with its
    ``4_G.pth`` / ``4_D_target.pth`` beside it, where ``check_resume`` looks)
    to step 8: finite losses at steps 5-8, and the same weights as a resume
    from the run's own ``4.pt``, which carries the same params, moments and
    count. The config names no ``gan_H_target``: ``check_resume`` reads the
    trainer's default and loads the D_target (JAX's would leave it at its
    fresh init, and the two resumes would end apart)."""
    root, _, _ = run
    for name in ("from_state", "from_pt"):
        shutil.copytree(root / "tiny_dasr" / "models", root / name / "models")
    ends = {}
    for name, resume in (("from_state", root / "from_state" / "models" / "4.state"),
                         ("from_pt", root / "tiny_dasr" / "training_state" / "4.pt")):
        cfg = json.load(open(root / "train.json"))
        cfg["name"] = name
        cfg["path"]["resume_state"] = str(resume)
        cfg["train"].update(niter=8, val_freq=8)
        cfg["logger"].update(save_checkpoint_freq=8, save_ref_formats=False)
        path = root / f"{name}.json"
        json.dump(cfg, open(path, "w"))
        caplog.clear()
        with caplog.at_level("INFO", logger="base"):
            steps, last = srn_train.main(["-opt", str(path), "--device", "cpu"])
        assert steps == 8 and "Resuming training from iteration: 4." in caplog.text, name
        train = [r for r in _records(str(root), name) if "loss/l_g_total" in r]
        assert [r["step"] for r in train] == [5, 6, 7, 8], name
        assert all(np.isfinite(r[k]) for r in train for k in LOSSES), name
        ends[name] = torch.load(root / name / "training_state" / "8.pt", weights_only=True)
    for label in ("G", "D_target"):
        for k, v in ends["from_pt"][label]["net"].items():
            assert torch.equal(ends["from_state"][label]["net"][k], v), (label, k)
    assert ends["from_state"]["G"]["sched"]["last_epoch"] == 8


def test_cuda_without_a_card_raises(tmp_path):
    """--device cuda (the default) never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    dirs = write_corpus(str(tmp_path), n=2)
    with pytest.raises(RuntimeError, match="cuda"):
        srn_train.main(["-opt", train_config(str(tmp_path), dirs)])
