"""The port's srn_test CLI (CPU) reproduces dasr_tpu's srn_test on the same
reference-named .pth and the same synthetic LRHR corpus, with and without
chop; ``--device_metrics`` (with and without ``--metrics_pad_bucket``)
agrees with the host report at 1e-3 dB and 1e-4 SSIM and falls back to the
host metrics where the JAX CLI does; ``--mesh`` without a world of its size
is refused."""

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


@pytest.mark.parametrize("flag", [["--mesh", "2"], ["--mesh", "2", "--spatial_shard"]])
def test_unported_flags_are_refused(corpus, flag):
    """--mesh N serves over a launcher's world of N ranks
    (tests/test_torch_dist_cli.py); in a process without one it is refused,
    with the torchrun command that gives the world."""
    with pytest.raises(ValueError, match="--mesh 2 needs a world of 2 rank.*torch.distributed.run"):
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
    from dasr_tpu_torch.models.registry import (
        DASRAdaptiveModel,
        DASRModel,
        DegradationModel,
        DePatchModel,
        SRGANModel,
        SRModel,
        create_model,
    )

    opt = parse_srn_options(_config(corpus, "dasr", False, model="DASR_FS_ESRGAN_patchGAN"),
                            is_train=False)
    model = create_model(opt)
    assert isinstance(model, DASRModel) and model.chop_threshold == 320000
    sr = model.init().load().test(np.zeros((6, 5, 3), np.float32))
    assert sr.shape == (24, 20, 3) and np.isfinite(sr).all()
    with pytest.raises(RuntimeError, match="is_train"):
        model.train_step({})
    # the paired-data trainers are ported (ROADMAP A.9, items 1-3): 'srgan'
    # serves the RRDB_net, 'De_Resnet' its De_Resnet family, and 'sr' trains
    opt["model"] = "srgan"
    assert isinstance(create_model(opt), SRGANModel)
    opt["model"] = "De_Resnet"
    with pytest.raises(NotImplementedError, match=r"does not take generator \[RRDB_net\]"):
        create_model(opt)  # an RRDB_net is not a degradation net
    net_g = opt["network_G"]
    opt["network_G"] = {"which_model_G": "De_Resnet", "nf": 8, "nb": 1, "norm_type": None}
    assert isinstance(create_model(opt), DegradationModel)
    # the last trainer of the registry is ported (ROADMAP A.9): the DePatch
    # wavelet GAN serves the De_Resnet family too; the Adaptive model does not
    opt["model"] = "De_patch_wavelet_GAN"
    assert isinstance(create_model(opt), DePatchModel)
    opt["model"] = "DASR_Adaptive_Model"
    with pytest.raises(NotImplementedError, match="does not take generator"):
        create_model(opt)
    # the DASR Adaptive model is ported (ROADMAP A.9's first item) with the
    # generators it feeds a domain-distance map; no other model feeds one
    opt["network_G"] = dict(net_g, which_model_G="RRDB_Residual_conv", ada_nb=1)
    opt["model"] = "DASR_Adaptive_Model"
    assert isinstance(create_model(opt), DASRAdaptiveModel)
    for name, which in (("DASR", "RRDB_Residual_conv"), ("sr", "RRDB_Residual_conv_concat"),
                        ("srragan", "RRDB_Residual_conv"), ("DASR", "RRDB_SEAN"),
                        ("DASR_Adaptive_Model", "RRDB_SEAN")):
        opt["model"], opt["network_G"]["which_model_G"] = name, which
        with pytest.raises(NotImplementedError, match=f"does not take generator \\[{which}\\]"):
            create_model(opt)
    # define_G builds 'DSGAN' and 'sft_arch', which no model feeds: each
    # refusal names the CLI that runs the generator
    from dasr_tpu_torch.models.registry import define_G
    from dasr_tpu_torch.nn.generators import DSGANGenerator
    from dasr_tpu_torch.nn.sft import SFTNet

    assert isinstance(define_G({"network_G": {"which_model_G": "DSGAN"}}), DSGANGenerator)
    assert isinstance(define_G({"network_G": {"which_model_G": "sft_arch"}}), SFTNet)
    for name in ("sr", "srgan", "DASR", "DASR_Adaptive_Model", "De_Resnet",
                 "De_patch_wavelet_GAN"):
        for which, runner in (("DSGAN", "dsn_test"), ("sft_arch", "sftgan_test")):
            opt["model"], opt["network_G"] = name, {"which_model_G": which}
            with pytest.raises(NotImplementedError, match=runner):
                create_model(opt)
    opt["network_G"] = net_g
    opt["model"], opt["is_train"] = "sr", True
    assert isinstance(create_model(opt), SRModel) and create_model(opt).trainer is not None
    # define_D builds 'dis_acd'; the SRGAN step cannot train its two heads
    opt["network_D"] = {"which_model_D": "dis_acd"}
    opt["model"] = "srragan"
    with pytest.raises(NotImplementedError, match=r"\[dis_acd\].*two heads"):
        create_model(opt)
    # the DASR trainer is ported (ROADMAP A.4): training builds its discriminator
    opt["model"] = "DASR"
    opt["network_D"] = {}
    assert create_model(opt).trainer is not None
