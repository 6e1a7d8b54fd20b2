"""The port stands alone: importing every module of dasr_tpu_torch, serving a
tiny corpus through its srn_test CLI, training two steps through its
srn_train CLI, two DASR Adaptive steps on the device bank through it, two
'srragan' steps and one 'De_Resnet' step through it, one
'De_patch_wavelet_GAN' step, one SFTNet forward and one image served by
model 'sftgan', running the three
stages through its auto_reproduce CLI
(dsn_train, dsn_create_dataset, srn_train), and its evaluate, dsn_test,
auto_test and add_corruptions CLIs on those runs' outputs load neither jax
nor dasr_tpu; nor do compute_dists (squeeze), lpips_train (train and
eval), parity, test_dataloader and misc_tools (color2gray) on CPU inputs,
nor a one-rank gloo world (core/dist.py) with spatially_sharded_apply
(ops/spatial_shard.py) over it; nor do the experiment tools
(dasr_tpu_torch/tools: make_synth_corpus and parity_dryrun run, ddm_ablation
imported) with jax, dasr_tpu and the repository's tools/ blocked.
chip_smoke.py refuses to run without a card and outside the repository.

Subprocesses, because this test process already imported JAX (conftest)."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import json, os, pkgutil, sys, tempfile
import importlib
import numpy as np, torch
import dasr_tpu_torch
for mod in pkgutil.walk_packages(dasr_tpu_torch.__path__, "dasr_tpu_torch."):
    importlib.import_module(mod.name)
from dasr_tpu_torch.cli import srn_test
from dasr_tpu_torch.data.io import save_img
from dasr_tpu_torch.nn.generators import RRDBNet
root = tempfile.mkdtemp()
for d in ("hr", "lr"):
    os.makedirs(os.path.join(root, d))
lr = np.random.default_rng(0).random((12, 10, 3)).astype(np.float32)
save_img(lr, os.path.join(root, "lr", "a.png"))
save_img(np.kron(lr, np.ones((4, 4, 1))), os.path.join(root, "hr", "a.png"))
net = RRDBNet(nf=16, nb=1, gc=8).init_weights(torch.Generator().manual_seed(0))
torch.save(net.state_dict(), os.path.join(root, "g.pth"))
cfg = {"name": "t", "model": "sr", "scale": 4, "val_lpips": False,
       "datasets": {"test_1": {"name": "s", "mode": "LRHR", "dataroot_HR": os.path.join(root, "hr"),
                               "dataroot_LR": os.path.join(root, "lr")}},
       "path": {"root": root, "pretrain_model_G": os.path.join(root, "g.pth")},
       "network_G": {"which_model_G": "RRDB_net", "nf": 16, "nb": 1, "gc": 8}}
with open(os.path.join(root, "c.json"), "w") as f:
    json.dump(cfg, f)
avg = srn_test.main(["-opt", os.path.join(root, "c.json"), "--device", "cpu"])
assert np.isfinite(avg["s"]["psnr"])
sys.path.insert(0, "tests")
from test_torch_srn_train_cli import train_config, write_corpus
from dasr_tpu_torch.cli import srn_train
troot = os.path.join(root, "train")
steps, last = srn_train.main(["-opt", train_config(troot, write_corpus(troot, n=2), niter=2),
                              "--device", "cpu"])
assert steps == 2 and np.isfinite(last["loss/l_g_total"])
aroot = os.path.join(root, "adaptive")
acfg_path = train_config(aroot, write_corpus(aroot, n=2), niter=2)
acfg = json.load(open(acfg_path))
acfg.update(model="DASR_Adaptive_Model", name="tiny_adaptive")
acfg["datasets"]["train"]["mode"] = "LRHR_unpair"
acfg["network_G"].update(which_model_G="RRDB_Residual_conv", ada_nb=1)
acfg["logger"]["save_ref_formats"] = False
json.dump(acfg, open(acfg_path, "w"))
steps, last = srn_train.main(["-opt", acfg_path, "--device", "cpu", "--device_bank"])
assert steps == 2 and np.isfinite(last["loss/l_g_total"])
pdirs = write_corpus(os.path.join(root, "paired"), n=2)
for model, niter, net_g, hr_size in (
        ("srragan", 2, {"which_model_G": "RRDB_net", "nf": 8, "nb": 1, "gc": 4}, 48),
        ("De_Resnet", 1, {"which_model_G": "De_Resnet", "nf": 8, "nb": 1, "norm_type": None,
                          "mode": "CNA"}, 32)):
    pcfg = {"name": f"tiny_{model}", "model": model, "scale": 4, "bf16": False,
            "datasets": {"train": {"name": "p", "mode": "LRHR", "dataroot_HR": pdirs["hr"],
                                   "dataroot_LR": pdirs["fake"], "n_workers": 1,
                                   "batch_size": 2, "HR_size": hr_size}},
            "path": {"root": os.path.join(root, "paired")}, "network_G": net_g,
            "network_D": {"which_model_D": "discriminator_vgg_48", "nf": 8},
            "train": {"niter": niter, "manual_seed": 0},
            "logger": {"print_freq": 1, "save_checkpoint_freq": niter}}
    ppath = os.path.join(root, f"{model}.json")
    json.dump(pcfg, open(ppath, "w"))
    steps, last = srn_train.main(["-opt", ppath, "--device", "cpu"])
    assert steps == niter and all(np.isfinite(v) for v in last.values()), (model, last)
from torch_dsn_corpus import auto_reproduce_args
from dasr_tpu_torch.cli import auto_reproduce
argv, dirs = auto_reproduce_args(os.path.join(root, "ar"))
times = auto_reproduce.main(argv)
assert list(times) == ["dsn_train", "dsn_create_dataset", "srn_train"]
from dasr_tpu_torch.cli import add_corruptions, auto_test, dsn_test, evaluate
avg = evaluate.main(["--dir_a", os.path.join(root, "results", "t", "s"), "--dir_b",
                     os.path.join(root, "hr"), "--device", "cpu", "--device_metrics"])
assert np.isfinite(avg["psnr"]) and np.isfinite(avg["lpips"])
ckpt = os.path.join(root, "ar", "work", "DSN_experiments", "0603_DSN_aim2019", "checkpoints")
out = dsn_test.main(["--checkpoint", ckpt, "--input_dir", dirs["target"], "--output_dir",
                     os.path.join(root, "dsn_test"), "--num_res_blocks", "2", "--filter",
                     "avg_pool", "--save_realness", "--device", "cpu"])
assert len(os.listdir(out)) == 8
sweep = auto_test.main(["-opt", os.path.join(root, "c.json"), "--models_dir",
                        os.path.join(troot, "tiny_dasr", "models"), "--device", "cpu"])
assert list(sweep) == ["2"] and np.isfinite(sweep["2"]["s"]["psnr"])
add_corruptions.main(["--input_dir", os.path.join(root, "hr"), "--output_dir",
                      os.path.join(root, "noisy")])
assert os.listdir(os.path.join(root, "noisy")) == ["a.png"]
from dasr_tpu_torch.models.registry import create_model
from dasr_tpu_torch.nn.sft import SFTNet
dcfg = json.load(open(os.path.join("dasr_tpu_torch", "configs", "train_De_patch_wavelet_GAN.json")))
dcfg.update(bf16=False, is_train=True, network_G={"which_model_G": "De_Resnet", "nf": 8, "nb": 1,
                                                  "norm_type": None, "mode": "CNA"})
rng = np.random.default_rng(0)
m = create_model(dcfg).init().train_step(
    {"HR": rng.random((1, 128, 128, 3), dtype=np.float32),
     "LR": rng.random((1, 32, 32, 3), dtype=np.float32),
     "ref": rng.random((1, 32, 32, 3), dtype=np.float32)})
assert len(m) == 7 and all(np.isfinite(v) for v in m.values()), m
sft = SFTNet(n_blocks=1).init_weights(torch.Generator().manual_seed(0))
with torch.no_grad():
    assert sft(torch.rand(1, 3, 8, 8), torch.rand(1, 8, 32, 32)).shape == (1, 3, 32, 32)
sftgan = create_model({"model": "sftgan", "network_G": {"which_model_G": "sft_arch", "nb": 1}})
assert sftgan.init().test_async(np.zeros((8, 6, 3), np.uint8),
                                np.full((8, 32, 24), 0.125, np.float32)).shape == (32, 24, 3)
from PIL import Image
from dasr_tpu_torch.cli import compute_dists, lpips_train, parity, test_dataloader
from dasr_tpu_torch.scripts import misc_tools
afc = os.path.join(root, "2afc")
for i in range(2):
    for d in ("ref", "p0", "p1", "judge"):
        os.makedirs(os.path.join(afc, d), exist_ok=True)
        if d != "judge":
            Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
                os.path.join(afc, d, f"{i}.png"))
    np.save(os.path.join(afc, "judge", f"{i}.npy"), np.array([0.25], np.float32))
d = compute_dists.main(["pair", "-p0", os.path.join(afc, "ref", "0.png"), "-p1",
                        os.path.join(afc, "p0", "0.png"), "--net", "squeeze", "--device", "cpu"])
assert np.isfinite(d)
tr = lpips_train.main(["train", "--datasets", afc, "--nepoch", "1", "--nepoch_decay", "0",
                       "--batch_size", "2", "--save_dir", os.path.join(root, "lpips"),
                       "--device", "cpu"])
assert os.path.exists(os.path.join(root, "lpips", "latest_net_.pth"))
ev = lpips_train.main(["eval", "--datasets", afc, "--lin_path",
                       os.path.join(root, "lpips", "latest_net_.pth"), "--device", "cpu"])
assert 0 <= ev[afc] <= 1
avg = parity.main(["--hr_dir", os.path.join(root, "hr"), "--lr_dir", os.path.join(root, "lr"),
                   "--nb", "1", "--nf", "16", "--gc", "8", "--g_pth", os.path.join(root, "g.pth"),
                   "--device", "cpu"])
assert np.isfinite(avg["psnr"]) and np.isfinite(avg["lpips"])
test_dataloader.main(["-opt", acfg_path, "--out", os.path.join(root, "vis"), "--n", "1"])
assert "00_HR.png" in os.listdir(os.path.join(root, "vis"))
misc_tools.main(["color2gray", "--input_dir", os.path.join(root, "hr"), "--out",
                 os.path.join(root, "gray")])
assert os.listdir(os.path.join(root, "gray")) == ["a.png"]
import socket
from dasr_tpu_torch.core import dist
from dasr_tpu_torch.ops.spatial_shard import spatially_sharded_apply
with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0", WORLD_SIZE="1",
                  LOCAL_RANK="0")
world = dist.init_world("cpu")
assert world.group is not None and world.mesh_line() == "[mesh] data=1 spatial=1"
x = torch.rand(1, 3, 44, 20)
with torch.no_grad():
    assert torch.allclose(spatially_sharded_apply(x, net, 4, 20, world), net(x), atol=1e-5)
# the experiment tools with jax, the JAX package and the repository's tools/
# blocked: importing any of them now raises
for name in ("jax", "jaxlib", "flax", "dasr_tpu", "make_synth_corpus", "ddm_ablation",
             "parity_dryrun"):
    sys.modules.setdefault(name, None)
from dasr_tpu_torch.tools import ddm_ablation, make_synth_corpus, parity_dryrun
for tool in (make_synth_corpus, ddm_ablation, parity_dryrun):
    importlib.reload(tool)
corpus = os.path.join(root, "corpus")
make_synth_corpus.main(["--out", corpus, "--noise_mode", "textured", "--n_target", "1",
                        "--n_source", "1", "--n_valid", "1", "--hr_h", "48", "--hr_w", "64",
                        "--valid_h", "48", "--valid_w", "64", "--workers", "1"])
rep = parity_dryrun.main(["--lr_dir", os.path.join(corpus, "valid_lr"), "--work",
                          os.path.join(root, "parity"), "--n", "1", "--nb", "1", "--device", "cpu"])
assert rep[0]["ours_plain_vs_torch_full"]["max_abs"] <= 1e-5
bad = sorted(m for m, v in sys.modules.items()
             if v is not None and m.split(".")[0] in ("jax", "jaxlib", "flax", "dasr_tpu"))
print("LEAKED", bad)
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # many small ops: one intra-op thread is faster on a host the other
    # test workers already load
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_and_serves_without_jax():
    proc = _run(["-c", _SCRIPT], REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout, proc.stdout[-2000:]


def test_chip_smoke_fails_without_a_card():
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
