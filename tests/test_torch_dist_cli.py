"""The port's CLIs over two ranks of a gloo world on the CPU, each against
the same CLI in one process (``tests/torch_dist_case.py``; one run goes
through ``python -m torch.distributed.run`` itself):

* ``srn_test --mesh 2``, chopped and ``--spatial_shard``: the same PNGs and
  metrics as one process's chopped and plain forwards;
* ``dsn_create_dataset --mesh 2``: the same pseudo-LRs and DDMs as
  ``--mesh 1`` (JAX's mesh tiles: 256 px above 256x256, three tiles here);
* ``srn_train`` and ``dsn_train``: the ``[mesh] data=2 spatial=1`` line,
  rank 0 alone logs and writes, the losses of one process on the global
  batch, and (srn_train) a run resumed from its ``2.pt`` ends where the
  straight run ends;
* the refusals: a batch two does not divide, and the models JAX does not
  shard ('sr', 'De_Resnet', 'De_patch_wavelet_GAN');
* ``auto_reproduce`` over two ranks: two ``[mesh]`` lines, rank 0's."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_case as case
from dasr_tpu_torch.cli import dsn_create_dataset, dsn_train, srn_test, srn_train
from dasr_tpu_torch.data.io import read_img_u8, save_img
from dasr_tpu_torch.nn.discriminators import FSDiscriminator
from dasr_tpu_torch.nn.generators import DeResnet, RRDBNet
from dasr_tpu_torch.nn.layers import init_lecun_
from dasr_tpu_torch.train.checkpoints import save_dsn_tar
from test_torch_srn_train_cli import train_config, write_corpus
from torch_dsn_corpus import auto_reproduce_args, write_dsn_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = {"which_model_G": "RRDB_net", "nf": 16, "nb": 1, "gc": 8, "norm_type": None}
RTOL, ATOL, SCORE_ATOL = 2e-3, 2e-5, 1e-4  # the three-step limits (tests/torch_srn_step_case.py)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def serve(tmp_path_factory):
    """LR images of 40x300 (three 128-px chop tiles; 20 rows a rank) and
    44x132 (two), their x4 HRs, and a seeded RRDBNet .pth."""
    root = tmp_path_factory.mktemp("dist_serve")
    rng = np.random.default_rng(3)
    for d in ("hr", "lr"):
        os.makedirs(root / d)
    for i, (h, w) in enumerate([(40, 300), (44, 132)]):
        lr = rng.random((h, w, 3), dtype=np.float32)
        save_img(lr, str(root / "lr" / f"img_{i}.png"))
        save_img(np.kron(lr, np.ones((4, 4, 1), np.float32)), str(root / "hr" / f"img_{i}.png"))
    net = RRDBNet(nf=16, nb=1, gc=8).init_weights(torch.Generator().manual_seed(0))
    torch.save(net.state_dict(), root / "g.pth")
    return root


def _serve_config(root, name, chop):
    cfg = {"name": name, "model": "sr", "scale": 4, "chop": chop, "val_lpips": False,
           "bf16": False, "network_G": NET,
           "datasets": {"test_1": {"name": "synth", "mode": "LRHR",
                                   "dataroot_HR": str(root / "hr"),
                                   "dataroot_LR": str(root / "lr")}},
           "path": {"root": str(root / name), "pretrain_model_G": str(root / "g.pth")}}
    path = str(root / f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _pngs(root, name):
    d = os.path.join(root, name, "results", name, "synth")
    return {f: read_img_u8(os.path.join(d, f)).astype(int) for f in sorted(os.listdir(d))}


def _same_serving(root, got, want, got_avg, want_avg):
    a, b = _pngs(root, got), _pngs(root, want)
    assert set(a) == set(b) == {"img_0.png", "img_1.png"}
    for f in a:
        assert a[f].shape == b[f].shape and np.abs(a[f] - b[f]).max() <= 1, f
    for k, v in want_avg.items():
        assert abs(got_avg[k] - v) < (1e-2 if k.startswith("psnr") else 1e-4), (k, got_avg, v)


def test_srn_test_mesh_two_chopped_equals_one_process(serve):
    want = srn_test.main(["-opt", _serve_config(serve, "one_chop", True), "--device", "cpu"])
    got = case.run_ranks(case.run_cli, 2, "dasr_tpu_torch.cli.srn_test",
                         ["-opt", _serve_config(serve, "two_chop", True), "--device", "cpu",
                          "--mesh", "2"])
    assert got[1]["ret"] == {} and "PSNR" not in got[1]["out"]  # rank 0 alone reports
    assert "Average PSNR/SSIM" in got[0]["out"]
    _same_serving(serve, "two_chop", "one_chop", got[0]["ret"]["synth"], want["synth"])


def test_srn_test_mesh_two_spatial_shard_under_torchrun(serve):
    """Through the launcher itself: each image's rows split over two ranks,
    against one process's plain forward."""
    want = srn_test.main(["-opt", _serve_config(serve, "one_plain", False), "--device", "cpu"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_port", str(case.free_port()), "-m", "dasr_tpu_torch.cli.srn_test",
         "-opt", _serve_config(serve, "two_shard", False), "--device", "cpu", "--mesh", "2",
         "--spatial_shard"], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    avg = [ln for ln in proc.stdout.splitlines() if ln.strip().startswith("PSNR:")]
    assert len(avg) == 1, proc.stdout[-2000:]  # one report: rank 0's
    psnr = float(avg[0].split("PSNR:")[1].split("dB")[0])
    _same_serving(serve, "two_shard", "one_plain", {"psnr": psnr},
                  {"psnr": want["synth"]["psnr"]})


def test_dsn_create_dataset_mesh_two_equals_mesh_one(tmp_path):
    dirs = write_dsn_corpus(str(tmp_path / "corpus"), n_source=2, n_target=2, source=(24, 30),
                            target=(200, 600), n_val=0, grow=False)
    save_img(np.random.default_rng(1).random((100, 100, 3), dtype=np.float32),
             os.path.join(dirs["target"], "t2.png"))
    gen = torch.Generator().manual_seed(2)
    g = DeResnet(2, 4).init_weights(gen)
    d = init_lecun_(FSDiscriminator(d_arch="FSD", filter_type="avg_pool"), gen)
    tar = save_dsn_tar(str(tmp_path / "dsn.tar"), g, d)
    common = ["--checkpoint", tar, "--num_res_blocks", "2", "--filter", "avg_pool",
              "--source_dir", dirs["source"], "--target_dir", dirs["target"], "--name", "lrs",
              "--including_source_ddm", "--device", "cpu"]
    one = dsn_create_dataset.main(common + ["--results_root", str(tmp_path / "one"),
                                            "--mesh", "1"])
    (two, _) = (r["ret"] for r in case.run_ranks(
        case.run_cli, 2, "dasr_tpu_torch.cli.dsn_create_dataset",
        common + ["--results_root", str(tmp_path / "two"), "--mesh", "2"]))
    for sub, n in (("imgs_from_target", 3), ("ddm_target", 3), ("ddm_source", 2)):
        files = sorted(os.listdir(os.path.join(one, sub)))
        assert files == sorted(os.listdir(os.path.join(two, sub))) and len(files) == n, sub
        for f in files:
            a, b = (os.path.join(p, sub, f) for p in (two, one))
            if f.endswith(".png"):
                assert np.array_equal(read_img_u8(a), read_img_u8(b)), f
            else:
                np.testing.assert_allclose(np.load(a), np.load(b), atol=1e-5, rtol=0,
                                           err_msg=f"{sub}/{f}")


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _same_losses(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k, v in w.items():
            if k.startswith("loss/"):
                np.testing.assert_allclose(g[k], v, rtol=RTOL, atol=ATOL, err_msg=k)
            elif "score" in k.lower():
                np.testing.assert_allclose(g[k], v, rtol=0, atol=SCORE_ATOL, err_msg=k)


def test_srn_train_over_two_ranks(tmp_path):
    dirs = write_corpus(str(tmp_path / "corpus"))
    configs = {}
    for name in ("one", "two", "resumed"):
        root = tmp_path / name
        os.makedirs(root)
        configs[name] = train_config(str(root), dirs, niter=4, name=f"dasr_{name}")
        cfg = json.load(open(configs[name]))
        cfg["logger"]["save_checkpoint_freq"] = 2
        if name == "resumed":
            cfg["path"]["resume_state"] = str(tmp_path / "two" / "dasr_two" / "training_state"
                                              / "2.pt")
        json.dump(cfg, open(configs[name], "w"))
    srn_train.main(["-opt", configs["one"], "--device", "cpu"])
    mod = "dasr_tpu_torch.cli.srn_train"
    runs = case.run_ranks(case.run_clis, 2, [(mod, ["-opt", configs["two"], "--device", "cpu"]),
                                             (mod, ["-opt", configs["resumed"], "--device",
                                                    "cpu"])])
    (two, resumed), (two_1, _) = runs
    assert "[mesh] data=2 spatial=1" in two["out"].splitlines()
    assert two_1["out"] == ""  # rank 1 neither prints nor logs
    assert two["ret"][0] == resumed["ret"][0] == 4
    assert "Resuming training from iteration: 2." in resumed["out"]
    logs = {n: tmp_path / n / f"dasr_{n}" for n in ("one", "two", "resumed")}
    got = [r for r in _records(logs["two"] / "metrics.jsonl") if "loss/l_g_total" in r]
    want = [r for r in _records(logs["one"] / "metrics.jsonl") if "loss/l_g_total" in r]
    _same_losses(got, want)
    assert sorted(os.listdir(logs["two"] / "training_state")) == ["2.pt", "4.pt"]
    straight = torch.load(logs["two"] / "training_state" / "4.pt", weights_only=True)
    again = torch.load(logs["resumed"] / "training_state" / "4.pt", weights_only=True)
    for side in ("G", "D_target"):
        for k, v in straight[side]["net"].items():
            np.testing.assert_allclose(again[side]["net"][k].numpy(), v.numpy(), atol=1e-6,
                                       rtol=0, err_msg=f"{side} {k}")


def _dsn_args(dirs, root, name, *extra):
    return ["--device", "cpu", "--source_dir", dirs["source"], "--target_dir", dirs["target"],
            "--valid_hr_dir", dirs["valid_hr"], "--valid_lr_dir", dirs["valid_lr"],
            "--num_res_blocks", "1", "--crop_size", "64", "--crop_size_val", "64",
            "--batch_size", "2", "--num_workers", "2", "--no_per_loss", "--ragan",
            "--filter", "avg_pool", "--num_epochs", "1", "--num_decay_epochs", "1",
            "--val_interval", "1", "--val_img_interval", "1", "--save_model_interval", "1",
            "--experiments_root", root, "--save_path", name, *extra]


def test_dsn_train_over_two_ranks(tmp_path):
    dirs = write_dsn_corpus(str(tmp_path / "corpus"), n_target=2, target=(80, 72))
    root = str(tmp_path / "exp")
    assert dsn_train.main(_dsn_args(dirs, root, "one")) == 2
    mod = "dasr_tpu_torch.cli.dsn_train"
    (two, two_1) = case.run_ranks(case.run_cli, 2, mod, _dsn_args(dirs, root, "two"))
    assert two["ret"] == two_1["ret"] == 2
    assert "[mesh] data=2 spatial=1" in two["out"].splitlines()
    assert two_1["out"] == ""
    _same_losses(_records(os.path.join(root, "two", "metrics.jsonl")),
                 _records(os.path.join(root, "one", "metrics.jsonl")))
    assert sorted(os.listdir(os.path.join(root, "two", "checkpoints"))) == [
        "2.pt", "last_iteration.tar"]


UNSHARDED = ["sr", "De_Resnet", "De_patch_wavelet_GAN"]


@pytest.fixture(scope="module")
def unsharded_errors():
    """Each model's create_model error on both ranks, from one spawn."""
    opts = [{"model": model, "scale": 4, "is_train": True, "bf16": False,
             "network_G": {"which_model_G": "De_Resnet" if model != "sr" else "RRDB_net",
                           "nf": 8, "nb": 1, "gc": 4, "norm_type": None, "mode": "CNA"}}
            for model in UNSHARDED]
    ranks = case.run_ranks(case.create_model_errors, 2, opts)
    return {model: [rank[i] for rank in ranks] for i, model in enumerate(UNSHARDED)}


@pytest.mark.parametrize("model", UNSHARDED)
def test_models_jax_does_not_shard_are_refused(unsharded_errors, model):
    msgs = unsharded_errors[model]
    assert all(m and "trains on one rank" in m for m in msgs), msgs


def test_a_batch_two_ranks_do_not_divide_is_refused(tmp_path):
    dirs = write_corpus(str(tmp_path / "corpus"))
    cfg = json.load(open(train_config(str(tmp_path), dirs, niter=1)))
    cfg["datasets"]["train"]["batch_size"] = 3
    path = str(tmp_path / "odd.json")
    json.dump(cfg, open(path, "w"))
    ddirs = write_dsn_corpus(str(tmp_path / "dsn"), n_target=2, target=(80, 72))
    args = _dsn_args(ddirs, str(tmp_path / "exp"), "odd")
    args[args.index("--batch_size") + 1] = "3"
    results = case.run_ranks(case.run_clis, 2, [
        ("dasr_tpu_torch.cli.srn_train", ["-opt", path, "--device", "cpu"], True),
        ("dasr_tpu_torch.cli.dsn_train", args, True)])
    for rank in results:
        for r in rank:
            assert r.get("error") == "ValueError" and "does not split over 2 ranks" in r["msg"]


def test_auto_reproduce_over_two_ranks(tmp_path):
    argv, _ = auto_reproduce_args(str(tmp_path))
    (rank0, rank1) = case.run_ranks(case.run_cli, 2, "dasr_tpu_torch.cli.auto_reproduce", argv)
    assert list(rank0["ret"]) == ["dsn_train", "dsn_create_dataset", "srn_train"]
    lines = [ln for ln in rank0["out"].splitlines() if ln.startswith("[mesh] ")]
    assert lines == ["[mesh] data=2 spatial=1"] * 2  # stages 1 and 3
    assert "[mesh]" not in rank1["out"]
