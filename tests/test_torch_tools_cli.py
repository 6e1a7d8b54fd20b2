"""The port's small CLIs and launchers (CPU): add_corruptions writes the
JAX package's files byte for byte in all three modes; auto_test sweeps two
``{iter}_G.pth`` files saved by the port's ``save_reference_formats``, its
averages equal to srn_test's on each file, and names and skips an orbax step
directory; each port launcher's commands parse with the port CLIs'
argparsers and carry the JAX launcher's flags one for one."""

import json
import os
import shlex

import numpy as np
import pytest
import torch

from dasr_tpu.cli import add_corruptions as jax_add_corruptions
from dasr_tpu_torch.cli import (add_corruptions, auto_test, dsn_create_dataset, dsn_train,
                                srn_test)
from dasr_tpu_torch.core.config import dict_to_nonedict
from dasr_tpu_torch.data.io import save_img
from dasr_tpu_torch.models.registry import DASRModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = {"which_model_G": "RRDB_net", "nf": 16, "nb": 1, "gc": 8}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["noise", "blur", "jpeg"])
def test_add_corruptions_writes_the_jax_files(tmp_path, mode):
    rng = np.random.default_rng(2)
    src = tmp_path / "in"
    src.mkdir()
    for i, (h, w) in enumerate([(32, 40), (27, 19)]):
        save_img(rng.random((h, w, 3)).astype(np.float32), str(src / f"c{i}.png"))
    jout, out = tmp_path / "jax", tmp_path / "port"
    args = ["--input_dir", str(src), "--corruption", mode, "--seed", "5"]
    jax_add_corruptions.main([*args, "--output_dir", str(jout)])
    add_corruptions.main([*args, "--output_dir", str(out)])
    names = sorted(os.listdir(jout))
    assert names == sorted(os.listdir(out)) == ["c0.png", "c1.png"]
    for name in names:
        assert (out / name).read_bytes() == (jout / name).read_bytes(), name
        assert (out / name).read_bytes() != (src / name).read_bytes(), name


def _train_opt(seed):
    return dict_to_nonedict({
        "model": "DASR", "is_train": True, "scale": 4, "bf16": False, "network_G": NET,
        "network_D": {"which_model_D": "discriminator_patch", "nf": 16, "in_nc": 9,
                      "n_layers": 2},
        "train": {"manual_seed": seed, "feature_weight": 0.0}})


def test_auto_test_sweeps_the_saved_generators(tmp_path, capsys):
    models = tmp_path / "models"
    for it, seed in ((2, 0), (4, 1)):
        DASRModel(_train_opt(seed), torch.device("cpu")).init().save_reference_formats(
            str(models), it)
    (models / "6").mkdir()  # an orbax step directory
    rng = np.random.default_rng(8)
    for d in ("hr", "lr"):
        (tmp_path / d).mkdir()
    for i, (h, w) in enumerate([(12, 10), (9, 14)]):
        lr = rng.random((h, w, 3)).astype(np.float32)
        save_img(lr, str(tmp_path / "lr" / f"x{i}.png"))
        save_img(np.kron(lr, np.ones((4, 4, 1))), str(tmp_path / "hr" / f"x{i}.png"))
    cfg = {"name": "sweep", "model": "DASR", "scale": 4, "bf16": False, "val_lpips": False,
           "network_G": NET, "path": {"root": str(tmp_path / "out")},
           "datasets": {"test_1": {"name": "t", "mode": "LRHR",
                                   "dataroot_HR": str(tmp_path / "hr"),
                                   "dataroot_LR": str(tmp_path / "lr")}}}
    tpl = tmp_path / "test.json"
    tpl.write_text(json.dumps(cfg))
    got = auto_test.main(["-opt", str(tpl), "--models_dir", str(models), "--device", "cpu"])
    assert "checkpoint 6: no 6_G.pth" in capsys.readouterr().out
    assert list(got) == ["2", "4"]
    for it in ("2", "4"):
        single = dict(cfg, name=f"single_{it}",
                      path={"root": str(tmp_path / "out"),
                            "pretrain_model_G": str(models / f"{it}_G.pth")})
        path = tmp_path / f"single_{it}.json"
        path.write_text(json.dumps(single))
        want = srn_test.main(["-opt", str(path), "--device", "cpu"])
        assert got[it] == want, it
        assert (tmp_path / "out" / "results" / f"sweep_{it}" / "t" / "x1.png").exists()
    assert got["2"]["t"]["psnr"] != got["4"]["t"]["psnr"]


def _commands(path):
    """(module, argv) of each ``python -m`` line of a launcher script."""
    text = open(path).read().replace("\\\n", " ")
    return [(words[2], words[3:]) for words in (shlex.split(line) for line in text.splitlines())
            if words[:2] == ["python", "-m"]]


@pytest.mark.parametrize("dataset", ["aim2019", "realsr"])
def test_port_launchers_carry_the_jax_flags(dataset):
    name = f"auto_reproduce_launcher_{dataset}.sh"
    port = _commands(os.path.join(REPO, "dasr_tpu_torch", "launchers", name))
    jax = _commands(os.path.join(REPO, "launchers", name))
    parsers = {"dsn_train": dsn_train.build_argparser(),
               "dsn_create_dataset": dsn_create_dataset.build_argparser()}
    assert [m for m, _ in port] == [m.replace("dasr_tpu.", "dasr_tpu_torch.", 1)
                                    for m, _ in jax] == [
        "dasr_tpu_torch.cli.dsn_train", "dasr_tpu_torch.cli.dsn_create_dataset"]
    for (module, argv), (_, jargv) in zip(port, jax):
        assert argv == jargv, module
        opt = parsers[module.rsplit(".", 1)[1]].parse_args(argv)
        assert opt.device == "cuda" and opt.generator == "DeResnet", module
