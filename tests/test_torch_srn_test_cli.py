"""The port's srn_test CLI (CPU) reproduces dasr_tpu's srn_test on the same
reference-named .pth and the same synthetic LRHR corpus, with and without
chop; ``--device_metrics`` (with and without ``--metrics_pad_bucket``)
agrees with the host report at 1e-3 dB and 1e-4 SSIM and falls back to the
host metrics where the JAX CLI does; the flags that are not ported yet are
refused."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.cli import srn_test as jax_srn_test
from dasr_tpu.data.io import save_img
from dasr_tpu.nn.generators import RRDBNet as JRRDBNet
from dasr_tpu.train.checkpoints import export_params_to_state_dict, rrdbnet_key_map
from dasr_tpu_torch.cli import srn_test
from dasr_tpu_torch.ops.rdb import TOLERANCES

NET = {"which_model_G": "RRDB_net", "nf": 16, "nb": 2, "gc": 8, "norm_type": None}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small ops: torch's intra-op threads only contend with the other
    test workers for the cores (as in tests/test_torch_dsn_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("srn_corpus")
    rng = np.random.default_rng(7)
    for d in ("hr", "lr"):
        os.makedirs(root / d)
    for i, (h, w) in enumerate([(20, 24), (17, 23), (24, 24)]):
        lr = rng.random((h, w, 3)).astype(np.float32)
        hr = np.clip(np.kron(lr, np.ones((4, 4, 1))) + rng.normal(0, 0.05, (4 * h, 4 * w, 3)), 0, 1)
        save_img(lr, str(root / "lr" / f"img_{i}.png"))
        save_img(hr, str(root / "hr" / f"img_{i}.png"))
    variables = JRRDBNet(nf=16, nb=2, gc=8).init(jax.random.key(11), jnp.zeros((1, 16, 16, 3)))
    torch.save(export_params_to_state_dict(variables, rrdbnet_key_map(2)), root / "tiny_G.pth")
    return root


def _config(root, name, chop, model="sr", **extra):
    cfg = {
        "name": name, "model": model, "scale": 4, "chop": chop, "val_lpips": False,
        "bf16": False, **extra,
        "datasets": {"test_1": {"name": "synth", "mode": "LRHR",
                                "dataroot_HR": str(root / "hr"), "dataroot_LR": str(root / "lr")}},
        "path": {"root": str(root / name), "pretrain_model_G": str(root / "tiny_G.pth")},
        "network_G": NET,
    }
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("chop,extra", [
    (False, {}),
    (True, {}),  # tiled_apply
    (True, {"chop_parity": True}),  # forward_chop
    (False, {"pad_bucket": 16}),
])
def test_port_reproduces_jax_srn_test(corpus, chop, extra):
    tag = f"{int(chop)}{''.join(extra)}"
    want = jax_srn_test.main(["-opt", _config(corpus, f"jax_{tag}", chop, **extra)])
    got = srn_test.main(
        ["-opt", _config(corpus, f"port_{tag}", chop, **extra), "--device", "cpu"])
    assert set(got) == set(want) == {"synth"}
    psnr_tol, _ = TOLERANCES["psnr_db"]
    ssim_tol, _ = TOLERANCES["ssim"]
    for k in ("psnr", "psnr_y"):
        assert abs(got["synth"][k] - want["synth"][k]) <= psnr_tol, k
    for k in ("ssim", "ssim_y"):
        assert abs(got["synth"][k] - want["synth"][k]) <= ssim_tol, k
    dirs = [corpus / name / "results" / name / "synth" for name in (f"jax_{tag}", f"port_{tag}")]
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1])) == [
        "img_0.png", "img_1.png", "img_2.png"]


@pytest.mark.parametrize("chop,bucket,on_device", [
    (False, 0, True), (False, 128, True), (True, 128, True), (True, 0, False)])
def test_device_metrics_agree_with_the_host_report(corpus, monkeypatch, chop, bucket, on_device):
    """LPIPS on, against the host run of the same config; the chop forward
    without a bucket keeps the host metrics, as in the JAX CLI."""
    from dasr_tpu_torch.eval import evaluate

    def config(name):
        path = _config(corpus, name, chop)
        cfg = json.loads(open(path).read())
        cfg["val_lpips"] = True
        open(path, "w").write(json.dumps(cfg))
        return path

    tag = f"{int(chop)}_{bucket}"
    want = srn_test.main(["-opt", config(f"host_{tag}"), "--device", "cpu"])["synth"]
    calls = []
    host = evaluate.sr_metrics
    monkeypatch.setattr(evaluate, "sr_metrics", lambda *a: calls.append(1) or host(*a))
    got = srn_test.main(["-opt", config(f"dev_{tag}"), "--device", "cpu", "--device_metrics",
                         "--metrics_pad_bucket", str(bucket)])["synth"]
    assert len(calls) == (0 if on_device else 3)
    assert set(got) == set(want) == {"psnr", "ssim", "psnr_y", "ssim_y", "lpips"}
    for k, v in want.items():
        assert abs(got[k] - v) < (1e-3 if k.startswith("psnr") else 1e-4), (k, got[k], v)


@pytest.mark.parametrize("flag", [["--mesh", "2"], ["--spatial_shard"]])
def test_unported_flags_are_refused(corpus, flag):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        srn_test.main(["-opt", _config(corpus, "refused", False), "--device", "cpu", *flag])


def test_val_lpips_is_refused(corpus):
    """val_lpips is no longer refused: srn_test reports LPIPS (alex, the
    seeded default weights) beside PSNR/SSIM, and its value is the port's
    LPIPS on the same uint8 images."""
    from dasr_tpu_torch.cli.srn_test import make_lpips
    from dasr_tpu_torch.data.io import read_img
    from dasr_tpu_torch.eval.evaluate import im2tensor_range, to_uint8

    path = _config(corpus, "lpips", False)
    cfg = json.loads(open(path).read())
    cfg["val_lpips"] = True
    open(path, "w").write(json.dumps(cfg))
    got = srn_test.main(["-opt", path, "--device", "cpu"])["synth"]
    assert set(got) == {"psnr", "ssim", "psnr_y", "ssim_y", "lpips"}
    fn = make_lpips(torch.device("cpu"))
    out = corpus / "lpips" / "results" / "lpips" / "synth"
    want = np.mean([
        fn(im2tensor_range(to_uint8(read_img(str(out / f"img_{i}.png"))))[None],
           im2tensor_range(to_uint8(read_img(str(corpus / "hr" / f"img_{i}.png"))))[None])
        for i in range(3)
    ])
    assert np.isfinite(got["lpips"]) and abs(got["lpips"] - want) < 1e-6


def test_dasr_model_serves_and_other_models_are_refused(corpus):
    from dasr_tpu_torch.core.config import parse_srn_options
    from dasr_tpu_torch.models.registry import DASRModel, create_model

    opt = parse_srn_options(_config(corpus, "dasr", False, model="DASR_FS_ESRGAN_patchGAN"),
                            is_train=False)
    model = create_model(opt)
    assert isinstance(model, DASRModel) and model.chop_threshold == 320000
    sr = model.init().load().test(np.zeros((6, 5, 3), np.float32))
    assert sr.shape == (24, 20, 3) and np.isfinite(sr).all()
    with pytest.raises(RuntimeError, match="is_train"):
        model.train_step({})
    for name in ("srgan", "De_Resnet", "DASR_Adaptive_Model"):
        opt["model"] = name
        with pytest.raises(NotImplementedError, match="ROADMAP A.9"):
            create_model(opt)
    opt["model"], opt["is_train"] = "sr", True
    with pytest.raises(NotImplementedError, match="ROADMAP A.9"):
        create_model(opt)
    # the DASR trainer is ported (ROADMAP A.4): training builds its discriminator
    opt["model"] = "DASR"
    assert create_model(opt).trainer is not None
