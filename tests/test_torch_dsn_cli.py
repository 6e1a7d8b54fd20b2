"""The port's DSN-stage CLIs on the CPU: dsn_create_dataset against the JAX
package's on one ``.tar`` written by JAX's ``save_dsn_tar``; the tiled
generator forward against JAX's ``tiled_apply`` and the whole-image forward;
dsn_train resumed after one epoch against two epochs straight, on the host
loader and on the device bank with 2-step windows; 2-step host windows
against single steps; the bank gate's fallbacks (with the repair that a
corpus must hold one batch); the auto_reproduce orchestrator on a tiny
corpus with the JAX package's fast path; and the refusals."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.cli import dsn_create_dataset as jcreate
from dasr_tpu.nn.discriminators import FSDiscriminator as JFSD
from dasr_tpu.nn.generators import DeResnet as JDeResnet
from dasr_tpu.ops.tiled import tiled_apply as jtiled_apply
from dasr_tpu.train import checkpoints as jck
from dasr_tpu_torch.cli import auto_reproduce, dsn_create_dataset, dsn_train
from dasr_tpu_torch.data.io import read_img_u8
from dasr_tpu_torch.nn.generators import DeResnet
from dasr_tpu_torch.train import checkpoints as ck
from torch_dsn_corpus import auto_reproduce_args, write_dsn_corpus

NB = 2


@pytest.fixture
def one_thread():
    """The CLI runs issue many small ops; torch's intra-op thread pool makes
    them several times slower when the test workers already fill every
    core (58 s against 9 s for the resume test on a loaded 8-core host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _jax_nets(x_hr, x_lr):
    jg = JDeResnet(n_res_blocks=NB, scale=4)
    jd = JFSD(d_arch="FSD", filter_type="avg_pool", norm_layer="Instance")
    return (jg, jax.tree.map(np.asarray, jg.init(jax.random.key(7), x_hr)),
            jd, jax.tree.map(np.asarray, jd.init(jax.random.key(8), x_lr)))


def test_create_dataset_matches_the_jax_cli_on_a_jax_tar(tmp_path):
    dirs = write_dsn_corpus(str(tmp_path / "corpus"), n_source=2, n_target=2,
                            source=(24, 30), target=(61, 50), n_val=0)
    _, gv, _, dv = _jax_nets(jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 16, 16, 3)))
    tar = jck.save_dsn_tar(str(tmp_path / "last_iteration.tar"), gv, dv, epoch=3,
                           iteration=77, n_res_blocks=NB)
    common = ["--checkpoint", tar, "--num_res_blocks", str(NB), "--filter", "avg_pool",
              "--source_dir", dirs["source"], "--target_dir", dirs["target"], "--name", "lrs",
              "--including_source_ddm"]
    jcreate.main(common + ["--results_root", str(tmp_path / "jax")])
    out = dsn_create_dataset.main(common + ["--results_root", str(tmp_path / "port"),
                                            "--device", "cpu"])
    jout = str(tmp_path / "jax" / "lrs")
    assert os.path.exists(os.path.join(out, "lrs.tar"))
    names = sorted(os.listdir(os.path.join(jout, "imgs_from_target")))
    assert names == sorted(os.listdir(os.path.join(out, "imgs_from_target"))) == ["t0.png", "t1.png"]
    for i, name in enumerate(names):
        a = read_img_u8(os.path.join(out, "imgs_from_target", name)).astype(int)
        b = read_img_u8(os.path.join(jout, "imgs_from_target", name)).astype(int)
        assert a.shape == b.shape == (-(-(61 + i) // 4), -(-(50 + 2 * i) // 4), 3)
        assert np.abs(a - b).max() <= 1, name
    for sub, n in (("ddm_target", 2), ("ddm_source", 2)):
        files = sorted(os.listdir(os.path.join(jout, sub)))
        assert files == sorted(os.listdir(os.path.join(out, sub))) and len(files) == n
        for f in files:
            a, b = np.load(os.path.join(out, sub, f)), np.load(os.path.join(jout, sub, f))
            assert a.shape == b.shape and a.shape[:2] == (1, 1)
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=f"{sub}/{f}")
            assert 0 <= a.min() and a.max() <= 1


def test_tiled_generator_forward_matches_jax_and_the_whole_image(rng):
    """The CLI's tiled helper with a small tile (the CLI tiles above
    ``TILE_ABOVE`` pixels; a DeResnet forward that large takes tens of
    seconds on a CPU): against JAX's tiled_apply everywhere, against the
    whole-image forward away from the border, where reflect and zero
    padding differ."""
    assert (dsn_create_dataset.TILE, dsn_create_dataset.TILE_ABOVE) == (512, 1024 * 1024)
    x = rng.random((1, 150, 203, 3), dtype=np.float32)
    jg, gv, _, _ = _jax_nets(jnp.asarray(x), jnp.zeros((1, 16, 16, 3)))
    want = np.asarray(jtiled_apply(jnp.asarray(x), lambda t: jg.apply(gv, t), scale=0.25,
                                   tile=64, halo=64))
    g = DeResnet(NB, 4)
    g.load_state_dict(ck.deresnet_state_dict_from_jax(gv, NB, 4))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = dsn_create_dataset.generate_lr(g, xt, 4, tile=64, above=0)
        whole = dsn_create_dataset.generate_lr(g, xt, 4)
    got, whole = (t.permute(0, 2, 3, 1).numpy() for t in (got, whole))
    assert got.shape == want.shape == whole.shape == (1, 38, 51, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    band = 4  # LR pixels: G's receptive field reaches ~12 HR pixels
    np.testing.assert_allclose(got[:, band:-band, band:-band], whole[:, band:-band, band:-band],
                               atol=1e-5, rtol=0)


def _train_args(dirs, root, save_path, epochs, *extra):
    return ["--device", "cpu", "--source_dir", dirs["source"], "--target_dir", dirs["target"],
            "--valid_hr_dir", dirs["valid_hr"], "--valid_lr_dir", dirs["valid_lr"],
            "--num_res_blocks", str(NB), "--crop_size", "64", "--crop_size_val", "64",
            "--batch_size", "2", "--num_workers", "2", "--no_per_loss", "--wgan",
            "--filter", "avg_pool", "--num_epochs", str(epochs), "--num_decay_epochs", "1",
            "--val_interval", "1", "--val_img_interval", "1", "--save_model_interval", "1",
            "--experiments_root", root, "--save_path", save_path, *extra]


def test_dsn_train_resumed_equals_straight(tmp_path, one_thread):
    """One epoch, then a resume from its checkpoint to two, ends where two
    epochs straight end. This deviates from dasr_tpu on purpose (ROADMAP
    C.2): JAX's dsn_train sets ``iteration = 0`` after a resume
    (dasr_tpu/cli/dsn_train.py:407) and would save the resumed run's last
    checkpoint as 2.pt; the port continues from the saved step."""
    dirs = write_dsn_corpus(str(tmp_path / "corpus"), n_target=2, target=(80, 72))
    root = str(tmp_path / "exp")
    assert dsn_train.main(_train_args(dirs, root, "straight", 2)) == 4  # 2 steps an epoch
    assert dsn_train.main(_train_args(dirs, root, "resumed", 1)) == 2
    ckpt = os.path.join(root, "resumed", "checkpoints")
    assert dsn_train.main(_train_args(dirs, root, "resumed", 2, "--checkpoint", ckpt)) == 4

    def final(name):
        return torch.load(os.path.join(root, name, "checkpoints", "4.pt"), weights_only=True)

    a, b = final("straight"), final("resumed")
    assert a["step"] == b["step"] == 4
    for label in ("G", "D_target"):
        for k, v in a[label]["net"].items():
            np.testing.assert_allclose(b[label]["net"][k].numpy(), v.numpy(), atol=1e-6,
                                       rtol=0, err_msg=f"{label} {k}")
    run = os.path.join(root, "straight")
    recs = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    losses = [r for r in recs if "loss/d_tex_loss" in r]
    names = {"g_overall_loss", "color_loss", "g_tex_loss", "perceptual_loss", "d_tex_loss",
             "rgb_loss", "mean_loss"}
    assert losses[-1]["step"] == 4 and {f"loss/{k}" for k in names} | {
        "disc_score/real", "disc_score/fake"} <= set(losses[-1])
    assert all(np.isfinite(v) for r in losses for v in r.values())
    assert [r["step"] for r in recs if "val/psnr_vs_bicubic" in r] == [2, 4]
    assert sorted(os.listdir(os.path.join(run, "val_images", "2"))) == sorted(
        f"{i}_{k}.png" for i in range(2) for k in ("fake", "fake_hf", "bicubic"))
    tar = ck.load_dsn_tar(os.path.join(run, "checkpoints", "last_iteration.tar"))
    assert (tar["iteration"], tar["fs_type"], tar["D_type"]) == (4, "avg_pool", "FSD")
    assert set(tar["model_g_state_dict"]) == set(a["G"]["net"])
    assert set(tar["models_d_state_dict"]) == set(a["D_target"]["net"])


def test_dsn_windows_and_bank_resume(tmp_path, capsys, one_thread):
    """2-step windows on the host loader train as single steps; on the bank,
    one epoch and a resume end where two epochs straight end. The resume
    continues from the saved step, a deliberate deviation from dasr_tpu
    (ROADMAP C.2): JAX's dsn_train restarts at ``iteration = 0``
    (dasr_tpu/cli/dsn_train.py:407), so its banked windows would reseed
    from 0 and replay the first epoch's draws."""
    dirs = write_dsn_corpus(str(tmp_path / "corpus"), n_target=2, target=(80, 72))
    root = str(tmp_path / "exp")
    k2 = ("--steps_per_call", "2")
    bank = ("--device_bank",) + k2
    assert dsn_train.main(_train_args(dirs, root, "single", 2)) == 4
    assert dsn_train.main(_train_args(dirs, root, "windows", 2, *k2)) == 4
    assert "device bank" not in capsys.readouterr().out
    assert dsn_train.main(_train_args(dirs, root, "bank", 2, *bank)) == 4
    assert "device bank: " in capsys.readouterr().out
    assert dsn_train.main(_train_args(dirs, root, "resumed", 1, *bank)) == 2
    ckpt = os.path.join(root, "resumed", "checkpoints")
    assert dsn_train.main(_train_args(dirs, root, "resumed", 2, *bank, "--checkpoint", ckpt)) == 4

    def final(name):
        return torch.load(os.path.join(root, name, "checkpoints", "4.pt"), weights_only=True)

    for a, b, atol in (("single", "windows", 1e-6), ("bank", "resumed", 0.0)):
        sa, sb = final(a), final(b)
        assert sa["step"] == sb["step"] == 4
        for label in ("G", "D_target"):
            for k, v in sa[label]["net"].items():
                np.testing.assert_allclose(sb[label]["net"][k].numpy(), v.numpy(), atol=atol,
                                           rtol=0, err_msg=f"{a}/{b} {label} {k}")
    recs = [json.loads(line) for line in open(os.path.join(root, "bank", "metrics.jsonl"))]
    losses = [r for r in recs if "loss/d_tex_loss" in r]
    assert [r["step"] for r in losses] == [4]
    assert all(np.isfinite(v) for r in losses for v in r.values())


@pytest.mark.parametrize("case,reason", [
    ("budget", "GiB > budget"), ("small", "smaller than the 192px crop"),
    ("batch", "fewer source images than one batch of 8")])
def test_dsn_bank_gate_falls_back_to_the_host_loader(tmp_path, capsys, case, reason):
    dirs = write_dsn_corpus(str(tmp_path / "corpus"), n_val=0)
    args = {"budget": ["--device_bank_gb", "1e-9"], "small": ["--crop_size", "192"],
            "batch": ["--batch_size", "8"]}[case]
    opt = dsn_train.build_argparser().parse_args(["--device_bank", "--crop_size", "64", *args])
    assert not dsn_train.bank_gate(opt, dirs["source"], dirs["target"])
    assert reason in capsys.readouterr().out
    opt = dsn_train.build_argparser().parse_args(["--device_bank", "--crop_size", "64",
                                                  "--batch_size", "2"])
    assert dsn_train.bank_gate(opt, dirs["source"], dirs["target"])


@pytest.mark.parametrize("call,item", [
    (lambda: dsn_create_dataset.main(["--mesh", "2", "--checkpoint", "x", "--device", "cpu",
                                      "--source_dir", "s", "--target_dir", "t"]),
     "--mesh 2 needs a world of 2 rank"),
], ids=["dsn_create_dataset-mesh"])
def test_unported_options_are_refused(call, item):
    """--mesh N runs over a launcher's world of N ranks
    (tests/test_torch_dist_cli.py); in a process without one it is refused,
    with the torchrun command that gives the world."""
    with pytest.raises(ValueError, match=f"{item}.*torch.distributed.run"):
        call()


def test_dsn_train_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    dirs = write_dsn_corpus(str(tmp_path / "corpus"), n_val=0)
    with pytest.raises(RuntimeError, match="cuda"):
        dsn_train.main(["--source_dir", dirs["source"], "--target_dir", dirs["target"],
                        "--experiments_root", str(tmp_path / "exp")])


def test_auto_reproduce_runs_the_three_stages(tmp_path, capsys, one_thread):
    argv, dirs = auto_reproduce_args(str(tmp_path))
    times = auto_reproduce.main(argv)
    work = tmp_path / "work"
    out = capsys.readouterr().out
    assert "not yet ported" not in out and out.count("device bank: ") == 2
    assert list(times) == ["dsn_train", "dsn_create_dataset", "srn_train"]
    assert all(f"stage '{s}' wall-clock" in out for s in times)

    lrs = work / "DSN_results" / "0603_DSN_LRs_aim2019"
    assert sorted(os.listdir(lrs / "imgs_from_target")) == [f"t{i}.png" for i in range(4)]
    ddm = np.load(lrs / "ddm_target" / "t0.npy")
    assert ddm.shape == (1, 1, 36, 36) and np.isfinite(ddm).all()
    dsn_exp = work / "DSN_experiments" / "0603_DSN_aim2019"
    assert (dsn_exp / "checkpoints" / "last_iteration.tar").exists()
    args = json.load(open(dsn_exp / "commandline_args.txt"))
    assert args["transfer_uint8"] and args["device_bicubic"] and args["device_bank"]
    assert args["device"] == "cpu"
    last = [json.loads(line) for line in open(dsn_exp / "metrics.jsonl")][-1]
    assert all(np.isfinite(v) for k, v in last.items() if k != "time")
    derived = json.load(open(work / "train_DASR_auto_reproduce_aim2019.json"))
    assert derived["datasets"]["train"]["dataroot_fake_LR"] == str(lrs / "imgs_from_target")
    assert derived["datasets"]["train"]["dataroot_HR"] == str(dirs["target"])
    assert derived["train"]["niter"] == 2 and derived["val_device_metrics"] is True
    assert derived["val_metrics_pad_bucket"] == 128
    srn_exp = work / "SRN_experiments" / "0603_DASR_SRN_auto_reproduce_aim2019"
    assert os.listdir(srn_exp / "training_state")
    loss_lines = [r for r in map(json.loads, open(srn_exp / "metrics.jsonl"))
                  if "loss/l_g_pix" in r]
    assert loss_lines and all(np.isfinite(v) for r in loss_lines for k, v in r.items()
                              if k != "time")
