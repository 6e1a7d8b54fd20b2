"""'De_patch_wavelet_GAN' through the port's CLIs (CPU), on a tiny synthetic
corpus, from the port's copy of the shipped
``train_De_patch_wavelet_GAN.json`` at small width.

srn_train trains it on the 'LRHR_Trans_Wavelet_GAN' mode (HR 128, the
host bicubic LR, real-LR references), logs finite losses, validates G(HR)
against the LR image, and a run resumed from its ``2.pt`` ends where the
straight run ends (G, D and both Adams). srn_test with ``save_RealorFake``
writes ``<base>_ddm.npy``, (1, 1, h / 2, w / 2), equal within 1e-5 to
dasr_tpu's ``DePatchModel.realness_map`` on the same weights.

dasr_tpu's faults on this path, named here (ROADMAP C.2): its
``DePatchTrainer`` reads ``batch["LR"]``, which its own Trans mode does not
give (fault 3), and its ``DePatchModel`` has no ``resume`` and serves G,
an HR -> LR net, on the LR image in its srn_test (fault 5)."""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from dasr_tpu.data import datasets as jds
from dasr_tpu.data.io import read_img, save_img
from dasr_tpu.models import registry as jreg
from dasr_tpu_torch.cli import srn_test, srn_train
from dasr_tpu_torch.core.config import parse_srn_options
from dasr_tpu_torch.models.registry import DePatchModel, create_model
from dasr_tpu_torch.train import checkpoints as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "dasr_tpu_torch", "configs")
NET_G = {"which_model_G": "De_Resnet", "nf": 8, "nb": 1, "norm_type": None, "mode": "CNA"}
HR = 128  # LR 32: alex LPIPS needs 32 px
LOSSES = {"loss/l_g_pix", "loss/l_g_fea", "loss/l_g_gan", "loss/l_g_total", "loss/l_d_total"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four 144x136 HR images, four 40x36 real-LR references, and a
    validation / test set of two 128x128 HR images with their box-filtered
    32x32 LRs."""
    root = tmp_path_factory.mktemp("depatch")
    rng = np.random.default_rng(9)
    for d in ("hr", "ref", "val_hr", "val_lr"):
        os.makedirs(root / d)
    for i in range(4):
        save_img(rng.random((144, 136, 3), dtype=np.float32), str(root / "hr" / f"{i:03d}.png"))
        save_img(rng.random((40, 36, 3), dtype=np.float32), str(root / "ref" / f"r{i}.png"))
    for i in range(2):
        hr = rng.random((HR, HR, 3), dtype=np.float32)
        save_img(hr, str(root / "val_hr" / f"v{i}.png"))
        save_img(hr.reshape(32, 4, 32, 4, 3).mean((1, 3)), str(root / "val_lr" / f"v{i}.png"))
    return root


def _train_config(root, name, niter=4, resume=None):
    with open(os.path.join(CONFIGS, "train_De_patch_wavelet_GAN.json")) as f:
        cfg = json.load(f)
    cfg.update(name=name, bf16=False, use_tb_logger=False, val_lpips=False)
    cfg["datasets"]["train"].update(dataroot_HR=str(root / "hr"), dataroot_LR=None,
                                    dataroot_Trans_refer=str(root / "ref"), n_workers=1,
                                    batch_size=2, HR_size=HR)
    cfg["datasets"]["val"].update(dataroot_HR=str(root / "val_hr"),
                                  dataroot_LR=str(root / "val_lr"))
    cfg["path"] = {"root": str(root), "resume_state": resume}
    cfg["network_G"] = NET_G
    cfg["train"].update(niter=niter, val_freq=4, lr_steps=[3])
    cfg["logger"] = {"print_freq": 1, "save_checkpoint_freq": 2}
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _run(path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        steps, last = srn_train.main(["-opt", path, "--device", "cpu"])
    return steps, last, out.getvalue()


def test_trains_validates_and_resumes(corpus, caplog):
    steps, last, out = _run(_train_config(corpus, "straight"))
    assert steps == 4 and LOSSES <= set(last)
    # the shipped keys dasr_tpu's model does not read, named once
    assert ("De_patch_wavelet_GAN: not read, as in dasr_tpu: network_D" in out
            and "train.ragan" in out and "train.feature_criterion" in out)
    with open(corpus / "straight" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if any(k.startswith("loss/") for k in r)]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all(np.isfinite(v) for r in train for k, v in r.items() if k.startswith("loss/"))
    val = [r for r in recs if "val/psnr" in r]
    assert len(val) == 1 and np.isfinite(val[0]["val/psnr"])
    # validation holds G(HR) against the LR image: its PNGs are LR-sized
    for name in os.listdir(corpus / "straight" / "val_images" / "4"):
        assert read_img(str(corpus / "straight" / "val_images" / "4" / name)).shape == (32, 32, 3)

    with caplog.at_level("INFO", logger="base"):
        steps, _, _ = _run(_train_config(
            corpus, "resumed", resume=str(corpus / "straight" / "training_state" / "2.pt")))
    assert steps == 4 and "Resuming training from iteration: 2." in caplog.text
    want = torch.load(corpus / "straight" / "training_state" / "4.pt", weights_only=True)
    got = torch.load(corpus / "resumed" / "training_state" / "4.pt", weights_only=True)
    assert set(got) == set(want) == {"step", "G", "D_target"}
    for label in ("G", "D_target"):
        for k, v in want[label]["net"].items():
            assert torch.equal(got[label]["net"][k], v), (label, k)
        for idx, st in want[label]["opt"]["state"].items():
            for name in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(got[label]["opt"]["state"][idx][name], st[name])


def test_jax_trainer_cannot_take_its_own_trans_batch(corpus):
    """Fault 3: dasr_tpu's Trans mode gives no ``LR`` (with the DASR mode's
    keys it reads at all), and its trainer reads one."""
    jopt = parse_srn_options(_train_config(corpus, "jax_fault3"), is_train=True)
    jopt = json.loads(json.dumps(jopt))
    jopt["bf16"] = False
    train = dict(jopt["datasets"]["train"], dataroot_fake_LR=str(corpus / "val_lr"),
                 dataroot_real_LR=str(corpus / "ref"), dataroot_HR=str(corpus / "val_hr"))
    item = jds.create_dataset(train)[0]
    assert "LR" not in item
    model = jreg.DePatchModel(jopt).init(jax.random.key(0))
    batch = {k: v[None] for k, v in item.items() if isinstance(v, np.ndarray)}
    with pytest.raises(KeyError, match="LR"):
        model.train_step(batch)


def test_srn_test_dumps_the_realness_maps_of_jax(corpus, tmp_path):
    """The port's srn_test on a ``{iter}.pt`` of JAX's initial weights,
    carried over, writes the maps JAX's ``DePatchModel.realness_map`` gives
    on those weights. Fault 5: JAX's model has no ``resume``, and its test
    takes the LR image (the image its srn_test hands it) to an LR / 4 one."""
    with open(os.path.join(CONFIGS, "test_De_patch_wavelet_GAN.json")) as f:
        cfg = json.load(f)
    cfg.update(bf16=False, val_lpips=False, network_G=NET_G)
    cfg["datasets"]["test_1"].update(dataroot_HR=str(corpus / "val_hr"),
                                     dataroot_LR=str(corpus / "val_lr"))
    cfg["path"] = {"root": str(tmp_path)}
    jmodel = jreg.DePatchModel(json.loads(json.dumps(cfg))).init(jax.random.key(0))
    assert not hasattr(jmodel, "resume")
    assert jmodel.test(np.zeros((32, 32, 3), np.float32)).shape == (8, 8, 3)

    opt = parse_srn_options(_write(tmp_path / "train.json", dict(cfg, is_train=True)),
                            is_train=True)
    model = create_model(opt)
    assert isinstance(model, DePatchModel)
    st = model.init().trainer.state
    np_tree = lambda t: jax.tree.map(np.asarray, jax.device_get(t))  # noqa: E731
    for ns, params in ((st.g, jmodel.state.g.params), (st.d_target, jmodel.state.d_target.params)):
        ns.net.load_state_dict(ck.state_dict_from_jax(ns.net, np_tree(params)), strict=True)
    pt = model.save(str(tmp_path / "ckpt"), 1)

    cfg["path"]["pretrain_model_G"] = pt
    averages = srn_test.main(["-opt", _write(tmp_path / "test.json", cfg), "--device", "cpu"])
    assert np.isfinite(averages["val_RealSR"]["psnr"])
    out = tmp_path / "results" / cfg["name"] / "val_RealSR"
    for i in range(2):
        got = np.load(out / f"v{i}_ddm.npy")
        lr = read_img(str(corpus / "val_lr" / f"v{i}.png"))
        want = jmodel.realness_map(lr)
        assert got.shape == (1, 1, 16, 16) and got.dtype == np.float32
        np.testing.assert_allclose(got[0, 0], want, atol=1e-5, rtol=0)
        assert read_img(str(out / f"v{i}.png")).shape == (32, 32, 3)


def _write(path, cfg):
    path.write_text(json.dumps(cfg))
    return str(path)
