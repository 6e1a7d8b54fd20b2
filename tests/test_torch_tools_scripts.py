"""The port's parity and test_dataloader CLIs, ``utils/batch_ops`` and
``scripts/`` (CPU) against the JAX package's on the same inputs: parity's
report within 0.01 dB and 1e-4 SSIM (and LPIPS 1e-4) of JAX's on the same
stand-in reference-format weights, plain and chopped; test_dataloader's
files and shapes; b_split / b_merge / b_select; every misc_tools tool,
extract_subimgs_single, net_interp and transfer_params with the same files
or values. Without a card ``parity --device cuda`` raises."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_checkpoint_import import _make_rrdb_sd
from test_torch_srn_train_cli import train_config, write_corpus
from torch_lpips_weights import write

from dasr_tpu.cli import parity as jax_parity
from dasr_tpu.cli import test_dataloader as jax_test_dataloader
from dasr_tpu.nn.generators import RRDBNet as JRRDBNet
from dasr_tpu.scripts import extract_subimgs_single as jax_extract
from dasr_tpu.scripts import misc_tools as jax_misc
from dasr_tpu.scripts import net_interp as jax_net_interp
from dasr_tpu.scripts import transfer_params as jax_transfer
from dasr_tpu.train import checkpoints as jck
from dasr_tpu.utils import batch_ops as jbatch_ops
from dasr_tpu_torch.cli import parity, test_dataloader
from dasr_tpu_torch.data.io import read_img, save_img
from dasr_tpu_torch.nn.generators import RRDBNet, SRResNet
from dasr_tpu_torch.scripts import extract_subimgs_single, misc_tools, net_interp, transfer_params
from dasr_tpu_torch.utils import batch_ops


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_files(a, b):
    """The two directories hold the same file names and the same images."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if os.path.isdir(pa):
            _same_files(pa, pb)
        else:
            np.testing.assert_array_equal(read_img(pa), read_img(pb), err_msg=name)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(8)
    for d in ("hr", "lr", "sr", "big"):
        os.makedirs(root / d)
    for i in range(2):
        hr = rng.random((48, 48, 3), dtype=np.float32)
        save_img(hr, str(root / "hr" / f"{i}.png"))
        save_img(rng.random((12, 12, 3), dtype=np.float32), str(root / "lr" / f"{i}.png"))
        save_img(np.clip(hr + 0.05 * rng.standard_normal(hr.shape), 0, 1),
                 str(root / "sr" / f"{i}.png"))
        save_img(rng.random((70, 90, 3), dtype=np.float32), str(root / "big" / f"b{i}.png"))
    return root


@pytest.mark.parametrize("chop", [False, True], ids=["plain", "chop"])
def test_parity_matches_jax(images, tmp_path, capsys, chop):
    nb, nf, gc = 1, 16, 8
    g_path = str(tmp_path / "g.pth")
    torch.save(_make_rrdb_sd(nb, nf, gc), g_path)
    bpath, lpath = write(tmp_path, "alex")
    args = ["--g_pth", g_path, "--lpips_backbone", bpath, "--lpips_lin", lpath,
            "--hr_dir", str(images / "hr"), "--lr_dir", str(images / "lr"),
            "--nb", str(nb), "--nf", str(nf), "--gc", str(gc)] + (["--chop"] if chop else [])
    want = jax_parity.main(args + ["--out", str(tmp_path / "jax.md")])
    jax_out = capsys.readouterr().out
    got = parity.main(args + ["--out", str(tmp_path / "port.md"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert list(got) == list(want) == ["psnr", "ssim", "psnr_y", "ssim_y", "lpips"]
    for k, tol in (("psnr", 0.01), ("psnr_y", 0.01), ("ssim", 1e-4), ("ssim_y", 1e-4),
                   ("lpips", 1e-4)):
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
    last = json.loads(out.strip().splitlines()[-1])
    assert last["n"] == json.loads(jax_out.strip().splitlines()[-1])["n"] == 2
    assert last["weights_supplied"] is True
    report = open(tmp_path / "port.md").read().splitlines()
    assert [ln.split("|")[1] for ln in report if ln.startswith("| ")] == [
        ln.split("|")[1] for ln in open(tmp_path / "jax.md").read().splitlines()
        if ln.startswith("| ")]


def test_parity_banners_without_weights(images, capsys):
    parity.main(["--hr_dir", str(images / "hr"), "--lr_dir", str(images / "lr"), "--nb", "1",
                 "--nf", "8", "--gc", "4", "--max_images", "1", "--device", "cpu"])
    captured = capsys.readouterr()
    assert "GENERATOR WEIGHTS NOT SUPPLIED" in captured.err
    assert "LPIPS BACKBONE NOT SUPPLIED" in captured.err
    assert "RANDOM-INIT" in captured.out
    assert json.loads(captured.out.strip().splitlines()[-1])["weights_supplied"] is False


def test_parity_cuda_without_a_card_raises(images):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        parity.main(["--hr_dir", str(images / "hr"), "--lr_dir", str(images / "lr")])


@pytest.mark.parametrize("mode", ["LRHR", "DASR"])
def test_test_dataloader_matches_jax(tmp_path, capsys, mode):
    """The DASR mode's items carry a weight map, written as a heatmap."""
    dirs = write_corpus(str(tmp_path), n=2)
    cfg_path = train_config(str(tmp_path), dirs)
    if mode == "LRHR":
        cfg = json.load(open(cfg_path))
        cfg["datasets"]["train"] = {"name": "p", "mode": "LRHR", "dataroot_HR": dirs["hr"],
                                    "dataroot_LR": dirs["fake"], "HR_size": 32}
        json.dump(cfg, open(cfg_path, "w"))
    jax_test_dataloader.main(["-opt", cfg_path, "--out", str(tmp_path / "jax"), "--n", "2"])
    jax_out = capsys.readouterr().out
    test_dataloader.main(["-opt", cfg_path, "--out", str(tmp_path / "port"), "--n", "2"])
    out = capsys.readouterr().out
    _same_files(tmp_path / "port", tmp_path / "jax")
    assert [ln for ln in out.splitlines() if ln.startswith("item")] == [
        ln for ln in jax_out.splitlines() if ln.startswith("item")]
    if mode == "DASR":
        assert "00_fake_w.png" in os.listdir(tmp_path / "port")


def test_batch_ops_match_jax():
    rng = np.random.default_rng(9)
    batch = rng.random((5, 4, 4, 3), dtype=np.float32)
    mask = np.array([0, 1, 1, 0, 1])
    fake, real = batch_ops.b_split(batch, mask)
    for got, want in zip((fake, real), jbatch_ops.b_split(batch, mask)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(batch_ops.b_merge(real, fake, mask),
                                  jbatch_ops.b_merge(real, fake, mask))
    np.testing.assert_array_equal(batch_ops.b_merge(real, fake, mask), batch)
    other = rng.random((5, 4, 4, 3), dtype=np.float32)
    got = batch_ops.b_select(torch.from_numpy(batch), torch.from_numpy(other),
                             torch.from_numpy(mask))
    want = np.asarray(jbatch_ops.b_select(jnp.asarray(batch), jnp.asarray(other),
                                          jnp.asarray(mask)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[1], batch[1])
    np.testing.assert_array_equal(got.numpy()[0], other[0])


def _both(tmp_path, argv_of):
    """Run JAX's and the port's misc_tools with ``argv_of(out_dir)``."""
    jax_misc.main(argv_of(str(tmp_path / "jax")))
    return misc_tools.main(argv_of(str(tmp_path / "port")))


@pytest.mark.parametrize("tool", ["back_projection", "color2gray", "generate_mod_lr_bic",
                                  "extract_enlarge_patches"])
def test_misc_tools_write_the_files_jax_writes(images, tmp_path, tool):
    argv = {
        "back_projection": lambda o: ["back_projection", "--sr_dir", str(images / "sr"),
                                      "--lr_dir", str(images / "lr"), "--out", o,
                                      "--iters", "3"],
        "color2gray": lambda o: ["color2gray", "--input_dir", str(images / "big"), "--out", o],
        "generate_mod_lr_bic": lambda o: ["generate_mod_lr_bic", "--input_dir",
                                          str(images / "big"), "--out", o],
        "extract_enlarge_patches": lambda o: [
            "extract_enlarge_patches", "--input_dir", str(images / "big"), "--out", o,
            "--h_start", "10", "--h_len", "16", "--w_start", "20", "--w_len", "24",
            "--ratio", "2", "--color", "matlab_blue"],
    }[tool]
    _both(tmp_path, argv)
    _same_files(tmp_path / "port", tmp_path / "jax")


def test_misc_tools_rename_make_video_and_lmdb(images, tmp_path):
    import shutil

    import cv2

    for side in ("jax", "port"):
        shutil.copytree(images / "big", tmp_path / side)
    jax_misc.main(["rename", "--input_dir", str(tmp_path / "jax"), "--pattern", "f{i:03d}"])
    misc_tools.main(["rename", "--input_dir", str(tmp_path / "port"), "--pattern", "f{i:03d}"])
    _same_files(tmp_path / "port", tmp_path / "jax")
    assert sorted(os.listdir(tmp_path / "port")) == ["f000.png", "f001.png"]

    for side, mod in (("jax", jax_misc), ("port", misc_tools)):
        mod.main(["make_video", "--input_dir", str(images / "big"),
                  "--out", str(tmp_path / f"{side}.mp4")])
    frames = []
    for side in ("jax", "port"):
        cap = cv2.VideoCapture(str(tmp_path / f"{side}.mp4"))
        frames.append([cap.read()[1] for _ in range(int(cap.get(cv2.CAP_PROP_FRAME_COUNT)))])
        cap.release()
    assert len(frames[0]) == len(frames[1]) == 2
    for a, b in zip(*frames):
        np.testing.assert_array_equal(a, b)

    try:
        import lmdb  # noqa: F401
    except ImportError:  # gated as in the JAX package: both refuse the same way
        with pytest.raises(SystemExit, match="lmdb"):
            jax_misc.main(["create_lmdb", "--input_dir", str(images / "big"),
                           "--out", str(tmp_path / "jax.lmdb")])
        with pytest.raises(SystemExit, match="lmdb"):
            misc_tools.main(["create_lmdb", "--input_dir", str(images / "big"),
                             "--out", str(tmp_path / "port.lmdb")])
    else:
        misc_tools.main(["create_lmdb", "--input_dir", str(images / "big"),
                         "--out", str(tmp_path / "port.lmdb")])
        assert os.path.isdir(tmp_path / "port.lmdb")


@pytest.mark.parametrize("net", ["FSD", "nld_s2", "DSGAN", "DeResnet"])
def test_misc_tools_rf_table_matches_jax(capsys, net):
    argv = ["rf_table", "--net", net, "--imsize", "64", "--n_res_blocks", "2"]
    jax_misc.main(argv)
    want = capsys.readouterr().out
    misc_tools.main(argv)
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("which,extra", [("RRDB_net", ["--nb", "2", "--nf", "16", "--gc", "8"]),
                                         ("sr_resnet", ["--nb", "2", "--nf", "16"]),
                                         ("De_Resnet", ["--nb", "2", "--nf", "16"])])
def test_misc_tools_param_count_matches_jax(capsys, which, extra):
    argv = ["param_count", "--which_model_G", which] + extra
    jax_misc.main(argv)
    want = capsys.readouterr().out
    total = misc_tools.main(argv)
    assert capsys.readouterr().out == want
    assert f"{total:,}" in want


def test_param_count_takes_a_jax_command_line(capsys):
    """JAX's parser takes ``--imsize`` (dasr_tpu/scripts/misc_tools.py:259)
    and the count ignores it; the port parses and ignores it too."""
    argv = ["param_count", "--which_model_G", "RRDB_net", "--nb", "1", "--nf", "8", "--gc", "4",
            "--imsize", "48"]
    jax_misc.main(argv)
    want = capsys.readouterr().out
    total = misc_tools.main(argv)
    assert capsys.readouterr().out == want and f"{total:,}" in want
    assert total == misc_tools.main(argv[:-2])


def test_extract_subimgs_single_matches_jax(images, tmp_path):
    argv = ["--input_dir", str(images / "big"), "--crop_sz", "32", "--step", "24",
            "--thres_sz", "8", "--n_threads", "2"]
    jax_extract.main(argv + ["--save_dir", str(tmp_path / "jax")])
    extract_subimgs_single.main(argv + ["--save_dir", str(tmp_path / "port")])
    _same_files(tmp_path / "port", tmp_path / "jax")


def test_net_interp_writes_the_file_jax_writes(tmp_path):
    nb = 1
    paths = {}
    for name, seed_offset in (("psnr", 0), ("gan", 100)):
        sd = {k: v + 0.01 * seed_offset for k, v in _make_rrdb_sd(nb, 16, 8).items()}
        paths[name] = str(tmp_path / f"{name}_G.pth")
        torch.save(sd, paths[name])
    argv = ["--net_psnr", paths["psnr"], "--net_gan", paths["gan"], "--alpha", "0.3"]
    jax_net_interp.main(argv + ["--nb", str(nb), "--out", str(tmp_path / "jax.pth")])
    net_interp.main(argv + ["--out", str(tmp_path / "port.pth")])
    got, want = (torch.load(tmp_path / f"{s}.pth", weights_only=True) for s in ("port", "jax"))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    # the port's {iter}.pt gives its G; an orbax directory is refused
    torch.save({"step": 2, "G": {"net": torch.load(paths["gan"], weights_only=True)}},
               tmp_path / "2.pt")
    net_interp.main(["--net_psnr", paths["psnr"], "--net_gan", str(tmp_path / "2.pt"),
                     "--alpha", "0.3", "--out", str(tmp_path / "pt.pth")])
    for k, v in torch.load(tmp_path / "pt.pth", weights_only=True).items():
        np.testing.assert_array_equal(v.numpy(), got[k].numpy(), err_msg=k)
    with pytest.raises(NotImplementedError, match="dasr_tpu.scripts.net_interp"):
        net_interp.main(["--net_psnr", str(tmp_path), "--net_gan", paths["gan"],
                         "--out", str(tmp_path / "x.pth")])


def _x2_key_map(nb):
    """JAX's RRDBNet key map for an x2 net: one upconv, the HR convs after it."""
    head = jck.rrdbnet_key_map(nb)[:-4]
    return head + [("model.3", ("upconv_0", "conv_block_0", "Conv_0"), "conv"),
                   ("model.5", ("conv_block_2", "Conv_0"), "conv"),
                   ("model.7", ("conv_block_3", "Conv_0"), "conv")]


def test_transfer_matches_jax():
    """x2 -> x4: JAX copies by module path; the port by key and shape, the
    tail's convs matched by role, the same tensors."""
    nb, z = 1, jnp.zeros((1, 8, 8, 3))
    src = JRRDBNet(nf=8, nb=nb, gc=4, upscale=2).init(jax.random.key(0), z)
    dst = JRRDBNet(nf=8, nb=nb, gc=4, upscale=4).init(jax.random.key(1), z)
    merged, copied = jax_transfer.transfer(src, dst)
    to_np = lambda sd: {k: v.numpy() for k, v in sd.items()}  # noqa: E731
    src_sd = to_np(jck.export_params_to_state_dict(src, _x2_key_map(nb)))
    dst_sd = to_np(jck.export_params_to_state_dict(dst, jck.rrdbnet_key_map(nb)))
    want = to_np(jck.export_params_to_state_dict(merged, jck.rrdbnet_key_map(nb)))
    got, got_copied = transfer_params.transfer_rrdb(src_sd, dst_sd)
    assert got_copied == copied == len(want) - 2  # all but the second upconv
    assert list(got) == list(dst_sd)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["model.6.weight"], dst_sd["model.6.weight"])


def test_transfer_params_cli(tmp_path):
    x2 = RRDBNet(nf=8, nb=1, gc=4, upscale=2).init_weights(torch.Generator().manual_seed(3))
    torch.save(x2.state_dict(), tmp_path / "x2_G.pth")
    merged, copied = transfer_params.main(["--src", str(tmp_path / "x2_G.pth"), "--out",
                                           str(tmp_path / "x4_G.pth"), "--dst_nf", "8",
                                           "--dst_nb", "1", "--dst_gc", "4", "--seed", "5"])
    x4 = RRDBNet(nf=8, nb=1, gc=4, upscale=4)
    x4.load_state_dict(torch.load(tmp_path / "x4_G.pth", weights_only=True), strict=True)
    fresh = RRDBNet(nf=8, nb=1, gc=4, upscale=4).init_weights(torch.Generator().manual_seed(5))
    src, out = x2.state_dict(), x4.state_dict()
    for k_out, k_src in (("model.0.weight", "model.0.weight"), ("model.3.bias", "model.3.bias"),
                         ("model.8.weight", "model.5.weight"), ("model.10.bias", "model.7.bias")):
        assert torch.equal(out[k_out], src[k_src]), k_out
    assert torch.equal(out["model.6.weight"], fresh.state_dict()["model.6.weight"])
    assert copied == len(out) - 2


def test_sft_surgery_writes_the_file_jax_writes(tmp_path):
    src = SRResNet(nb=2, upscale=4, norm_type=None, mode="CNA").state_dict()
    torch.save(src, tmp_path / "srresnet.pth")
    argv = ["--sft", "--src", str(tmp_path / "srresnet.pth"), "--sft_nb", "2", "--seed", "3"]
    jax_transfer.main(argv + ["--out", str(tmp_path / "jax.pth")])
    transfer_params.main(argv + ["--out", str(tmp_path / "port.pth")])
    got, want = (torch.load(tmp_path / f"{s}.pth", weights_only=True) for s in ("port", "jax"))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(got["HR_branch.0.weight"].numpy(), src["model.2.weight"].numpy())
