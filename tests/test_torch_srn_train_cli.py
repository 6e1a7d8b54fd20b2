"""The port's srn_train CLI on a tiny synthetic DASR corpus (CPU): it trains,
logs finite losses to metrics.jsonl, validates with LPIPS, saves the train
state and the reference-format checkpoints; the options that are not
ported yet are refused."""

import json
import os

import numpy as np
import pytest
import torch

from dasr_tpu_torch.cli import srn_train
from dasr_tpu_torch.data.io import save_img

LOSSES = {"loss/l_g_pix", "loss/l_g_LL_pix", "loss/l_g_fea", "loss/l_g_gan_target_Hf",
          "loss/l_d_target_total", "loss/l_g_total"}


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


@pytest.mark.parametrize("args,opt_extra", [
    (["--device_bank"], {}), (["--steps_per_call", "2"], {}), (["--transfer_uint8"], {}),
    (["--profile", "trace"], {}), ([], {"val_device_metrics": True}),
])
def test_unported_options_are_refused(tmp_path, args, opt_extra):
    dirs = write_corpus(str(tmp_path), n=2)
    path = train_config(str(tmp_path), dirs, **opt_extra)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        srn_train.main(["-opt", path, "--device", "cpu", *args])


def test_resume_state_is_refused(tmp_path):
    dirs = write_corpus(str(tmp_path), n=2)
    path = train_config(str(tmp_path), dirs)
    cfg = json.load(open(path))
    cfg["path"]["resume_state"] = str(tmp_path / "10.state")
    json.dump(cfg, open(path, "w"))
    with pytest.raises(NotImplementedError, match="ROADMAP A.5"):
        srn_train.main(["-opt", path, "--device", "cpu"])


def test_cuda_without_a_card_raises(tmp_path):
    """--device cuda (the default) never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    dirs = write_corpus(str(tmp_path), n=2)
    with pytest.raises(RuntimeError, match="cuda"):
        srn_train.main(["-opt", train_config(str(tmp_path), dirs)])
