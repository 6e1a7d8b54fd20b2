"""The port stands alone: importing every module of dasr_tpu_torch, and
serving a tiny corpus through its CLI, loads neither jax nor dasr_tpu.
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
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "dasr_tpu"))
print("LEAKED", bad)
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
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
