"""The paired-data models through the port's CLIs (CPU), on a tiny synthetic
LRHR corpus: srn_train trains 'sr' (RRDB_net and sr_resnet), 'srgan',
'srragan' and 'De_Resnet' on the host loader, with ``dataroot_LR`` given
and null (the host bicubic), logs finite losses and a validation, and a
run resumed from its ``{iter}.pt`` ends where the straight run ends;
``--steps_per_call`` and ``--device_bank`` fall back with the JAX CLI's
lines, a ``.state`` resume and ``save_ref_formats`` are refused; srn_test
serves 'sr' and 'srgan' within 0.01 dB / 1e-4 SSIM of dasr_tpu's CLI on
the same reference-named .pth. Deviations from dasr_tpu named here
(ROADMAP C.2): 'sr' loads a reference sr_resnet .pth, which dasr_tpu
imports as an RRDB and cannot; 'De_Resnet' loads ``pretrain_model_G``,
which dasr_tpu ignores, and validates G(HR) against the LR image, where
dasr_tpu's CLI feeds G the LR image and fails on the shapes; a BatchNorm G
serves and validates on its running statistics, where dasr_tpu's cannot
apply at all."""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.cli import srn_test as jax_srn_test
from dasr_tpu.data.io import read_img
from dasr_tpu.data.io import save_img
from dasr_tpu.nn.generators import RRDBNet as JRRDBNet
from dasr_tpu.train.checkpoints import export_params_to_state_dict, rrdbnet_key_map
from dasr_tpu_torch.cli import srn_test, srn_train
from dasr_tpu_torch.nn.generators import DeResnetSRN, SRResNet
from dasr_tpu_torch.ops.rdb import TOLERANCES

RRDB = {"which_model_G": "RRDB_net", "nf": 8, "nb": 1, "gc": 4}
SRRESNET = {"which_model_G": "sr_resnet", "nf": 8, "nb": 2, "norm_type": None, "mode": "CNA"}
DE_RESNET = {"which_model_G": "De_Resnet", "nf": 8, "nb": 2, "norm_type": None, "mode": "CNA"}
MODELS = {  # name: (model, network_G, HR_size, train options, logged losses)
    "sr": ("sr", RRDB, 32, {}, {"loss/l_pix"}),
    "sr_resnet": ("sr", SRRESNET, 32, {}, {"loss/l_pix"}),
    "srgan": ("srgan", RRDB, 48, {"D_update_ratio": 2, "D_init_iters": 1},
              {"loss/l_g_pix", "loss/l_g_fea", "loss/l_g_gan", "loss/l_g_total",
               "loss/l_d_total"}),
    "srragan": ("srragan", RRDB, 48, {"gan_type": "wgan-gp"},
                {"loss/l_g_pix", "loss/l_g_fea", "loss/l_g_gan", "loss/l_g_total",
                 "loss/l_d_total"}),
    "De_Resnet": ("De_Resnet", DE_RESNET, 32, {}, {"loss/l_pix"}),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four 64x64 HR images with their 16x16 box-filtered LRs, two
    validation pairs (12x12 LR), a 128x128 pair for 'De_Resnet' (its LR-size
    output keeps 24x24 past the 4-px border, enough for SSIM's 11x11
    window) and a tiny RRDB's reference-named .pth."""
    root = tmp_path_factory.mktemp("paired")
    rng = np.random.default_rng(5)
    for d in ("hr", "lr", "val_hr", "val_lr", "de_hr", "de_lr"):
        os.makedirs(root / d)
    for i in range(4):
        hr = rng.random((64, 64, 3)).astype(np.float32)
        save_img(hr, str(root / "hr" / f"{i:03d}.png"))
        save_img(hr.reshape(16, 4, 16, 4, 3).mean((1, 3)), str(root / "lr" / f"{i:03d}.png"))
    hr = rng.random((128, 128, 3)).astype(np.float32)
    save_img(hr, str(root / "de_hr" / "d0.png"))
    save_img(hr.reshape(32, 4, 32, 4, 3).mean((1, 3)), str(root / "de_lr" / "d0.png"))
    for i in range(2):
        lr = rng.random((12, 12, 3)).astype(np.float32)
        save_img(lr, str(root / "val_lr" / f"v{i}.png"))
        save_img(np.kron(lr, np.ones((4, 4, 1))), str(root / "val_hr" / f"v{i}.png"))
    variables = JRRDBNet(nf=8, nb=1, gc=4).init(jax.random.key(3), jnp.zeros((1, 8, 8, 3)))
    torch.save(export_params_to_state_dict(variables, rrdbnet_key_map(1)), root / "rrdb_G.pth")
    return root


def _train_config(root, name, key, with_lr, niter=4, **extra):
    model, net_g, hr_size, train, _ = MODELS[key]
    cfg = {
        "name": name, "model": model, "scale": 4, "bf16": False, "val_lpips": False, **extra,
        "datasets": {
            "train": {"name": "synth", "mode": "LRHR", "dataroot_HR": str(root / "hr"),
                      "dataroot_LR": str(root / "lr") if with_lr else None, "n_workers": 1,
                      "batch_size": 2, "HR_size": hr_size},
            "val": {"name": "val", "mode": "LRHR", "dataroot_HR": str(root / "val_hr"),
                    "dataroot_LR": str(root / "val_lr")}},
        "path": {"root": str(root)},
        "network_G": net_g,
        "network_D": {"which_model_D": "discriminator_vgg_48", "nf": 8},
        "train": {"niter": niter, "val_freq": 4, "manual_seed": 0, "lr_steps": [3], **train},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 2},
    }
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _run(path, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        steps, last = srn_train.main(["-opt", path, "--device", "cpu", *args])
    return steps, last, out.getvalue()


def _records(root, name):
    with open(root / name / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("with_lr", [True, False], ids=["dataroot_LR", "bicubic"])
@pytest.mark.parametrize("key", list(MODELS))
def test_trains_validates_and_resumes(corpus, caplog, key, with_lr):
    """Four steps with a validation and saves at 2 and 4 (the LR milestone
    at 3), then a run resumed from 2.pt: its 4.pt equals the straight
    run's, every network's weights and buffers (BatchNorm statistics) and
    Adam state."""
    tag = f"{key}_{int(with_lr)}"
    steps, last, _ = _run(_train_config(corpus, tag, key, with_lr))
    assert steps == 4 and MODELS[key][4] <= set(last)
    recs = _records(corpus, tag)
    train = [r for r in recs if any(k.startswith("loss/") for k in r)]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all(np.isfinite(v) for r in train for k, v in r.items() if k.startswith("loss/"))
    val = [r for r in recs if "val/psnr" in r]
    assert len(val) == 1 and np.isfinite(val[0]["val/psnr"])

    path = _train_config(corpus, f"{tag}_resumed", key, with_lr)
    cfg = json.loads(open(path).read())
    cfg["path"]["resume_state"] = str(corpus / tag / "training_state" / "2.pt")
    open(path, "w").write(json.dumps(cfg))
    with caplog.at_level("INFO", logger="base"):
        steps, _, _ = _run(path)
    assert steps == 4 and "Resuming training from iteration: 2." in caplog.text
    want = torch.load(corpus / tag / "training_state" / "4.pt", weights_only=True)
    got = torch.load(corpus / f"{tag}_resumed" / "training_state" / "4.pt", weights_only=True)
    assert set(got) == set(want) == ({"step", "G", "D_target"} if "gan" in key
                                     else {"step", "G"})
    for label in set(want) - {"step"}:
        for k, v in want[label]["net"].items():
            assert torch.equal(got[label]["net"][k], v), (label, k)
        for idx, st in want[label]["opt"]["state"].items():
            for name in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(got[label]["opt"]["state"][idx][name], st[name])


@pytest.mark.parametrize("key", ["sr", "srgan", "srragan", "De_Resnet"])
def test_fallbacks_and_refusals(corpus, caplog, key):
    """One step a call: ``--steps_per_call 2`` and ``--device_bank`` fall back
    with the JAX CLI's lines; a reference ``.state`` resume and
    ``save_ref_formats`` are refused (dasr_tpu has none)."""
    path = _train_config(corpus, f"fallback_{key}", key, True, niter=2)
    with caplog.at_level("INFO", logger="base"):
        steps, _, out = _run(path, "--steps_per_call", "2", "--device_bank")
    assert steps == 2
    assert (f"--device_bank: model [{MODELS[key][0]}] has no banked path; using the host "
            "loader") in out
    assert ("steps_per_call > 1 requires a multi-step-capable model with G/D_update_inter == 1; "
            "falling back to per-step dispatch") in caplog.text
    cfg = json.loads(open(path).read())
    for edit, match in ((lambda c: c["path"].update(resume_state="models/4.state"),
                         "reference .state"),
                        (lambda c: c["logger"].update(save_ref_formats=True),
                         "save_ref_formats")):
        c = json.loads(json.dumps(cfg))
        edit(c)
        open(path, "w").write(json.dumps(c))
        with pytest.raises(NotImplementedError, match=f"{match}.*no reference format"):
            _run(path)


def test_batchnorm_g_validates_on_its_running_statistics(corpus):
    """A BatchNorm sr_resnet validates in eval mode, as the reference's
    ``test`` runs ``netG.eval()``: a run that validates at 2 and 4 saves the
    same 4.pt, G's running statistics included, as one that never
    validates, and G trains on in training mode. dasr_tpu's flax G neither
    trains nor serves with BatchNorm: its apply leaves ``batch_stats``
    immutable and raises (ROADMAP C.2)."""
    from dasr_tpu.nn.generators import SRResNet as JSRResNet

    states = {}
    for val_freq in (2, 100):
        tag = f"bn_sr_resnet_{val_freq}"
        path = _train_config(corpus, tag, "sr_resnet", True)
        cfg = json.loads(open(path).read())
        cfg["network_G"] = dict(SRRESNET, norm_type="batch")
        cfg["train"]["val_freq"] = val_freq
        open(path, "w").write(json.dumps(cfg))
        _run(path)
        states[val_freq] = torch.load(corpus / tag / "training_state" / "4.pt",
                                      weights_only=True)["G"]["net"]
    assert sum("val/psnr" in r for r in _records(corpus, "bn_sr_resnet_2")) == 2
    assert any(k.endswith("running_var") for k in states[100])
    for k, v in states[100].items():
        assert torch.equal(states[2][k], v), k

    jnet = JSRResNet(nf=8, nb=2, norm_type="batch", mode="CNA")
    x = jnp.zeros((1, 8, 8, 3))
    with pytest.raises(Exception, match="batch_stats"):
        jnet.apply(jnet.init(jax.random.key(0), x), x)


@pytest.mark.parametrize("key", ["chop", "pad_bucket"])
def test_de_resnet_refuses_the_sr_forwards(corpus, key):
    """'De_Resnet' degrades the whole image it is given: the x4 SR models'
    chop and pad_bucket forwards are refused, not ignored."""
    from dasr_tpu_torch.core.config import parse_srn_options
    from dasr_tpu_torch.models.registry import create_model

    extra = {"pad_bucket": 16} if key == "pad_bucket" else {}
    path = _test_config(corpus, f"deres_{key}", "De_Resnet", corpus / "none.pth",
                        key == "chop", net_g=DE_RESNET, pairs="de", **extra)
    with pytest.raises(ValueError, match=f"'{key}' is for the x4 SR models"):
        create_model(parse_srn_options(path, is_train=False))


def _test_config(root, name, model, pth, chop, net_g=RRDB, pairs="val", **extra):
    cfg = {"name": name, "model": model, "scale": 4, "chop": chop, "val_lpips": False,
           "bf16": False, **extra,
           "datasets": {"test_1": {"name": "synth", "mode": "LRHR",
                                   "dataroot_HR": str(root / f"{pairs}_hr"),
                                   "dataroot_LR": str(root / f"{pairs}_lr")}},
           "path": {"root": str(root / name), "pretrain_model_G": str(pth)},
           "network_G": net_g}
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("model,chop", [("sr", False), ("srgan", True)])
def test_srn_test_reproduces_jax(corpus, model, chop):
    tag = f"{model}_{int(chop)}"
    want = jax_srn_test.main(["-opt", _test_config(corpus, f"jax_{tag}", model,
                                                   corpus / "rrdb_G.pth", chop)])["synth"]
    got = srn_test.main(["-opt", _test_config(corpus, f"port_{tag}", model,
                                              corpus / "rrdb_G.pth", chop),
                         "--device", "cpu"])["synth"]
    psnr_tol, _ = TOLERANCES["psnr_db"]
    ssim_tol, _ = TOLERANCES["ssim"]
    for k in ("psnr", "psnr_y"):
        assert abs(got[k] - want[k]) <= psnr_tol, k
    for k in ("ssim", "ssim_y"):
        assert abs(got[k] - want[k]) <= ssim_tol, k


def test_sr_serves_a_reference_sr_resnet_pth(corpus):
    """ROADMAP C.2: an sr_resnet .pth by its reference names
    (``model.1.sub.{i}.res.{0,2}``, the pixelshuffle convs at ``model.2`` /
    ``model.5``) serves through the port's srn_test; dasr_tpu's SRModel
    imports every .pth as an RRDB and fails on it."""
    net = SRResNet(nf=8, nb=2, norm_type=None, mode="CNA")
    net.init_weights(torch.Generator().manual_seed(1))
    sd = net.state_dict()
    assert {"model.1.sub.0.res.0.weight", "model.1.sub.0.res.2.weight", "model.2.weight",
            "model.5.weight", "model.10.weight"} <= set(sd)
    pth = corpus / "srresnet_G.pth"
    torch.save(sd, pth)
    got = srn_test.main(["-opt", _test_config(corpus, "port_srresnet", "sr", pth, False,
                                              net_g=SRRESNET), "--device", "cpu"])["synth"]
    assert np.isfinite(got["psnr"])
    with pytest.raises(KeyError):
        jax_srn_test.main(["-opt", _test_config(corpus, "jax_srresnet", "sr", pth, False,
                                                net_g=SRRESNET)])


def test_de_resnet_loads_its_pretrained_g_and_validates_hr_to_lr(corpus):
    """ROADMAP C.2: the port's 'De_Resnet' loads ``pretrain_model_G`` (a
    .pth of its generator; dasr_tpu's ``DegradationModel.load`` returns
    without reading it), serves G(HR) against the LR image in srn_test, and
    validates so in srn_train; dasr_tpu's ``_validate`` feeds G the LR
    image, and the metrics fail on the shapes."""
    from dasr_tpu.cli.srn_train import _validate as jax_validate
    from dasr_tpu.core.config import parse_srn_options as jax_parse
    from dasr_tpu.data.datasets import create_dataset as jax_create_dataset
    from dasr_tpu.models.registry import create_model as jax_create_model
    from dasr_tpu_torch.core.config import parse_srn_options
    from dasr_tpu_torch.models.registry import create_model

    net = DeResnetSRN(nf=8, nb=2, norm_type=None, act_type=None, mode="CNA")
    net.init_weights(torch.Generator().manual_seed(2))
    pth = corpus / "deres_G.pth"
    torch.save(net.state_dict(), pth)
    path = _test_config(corpus, "port_deres", "De_Resnet", pth, False, net_g=DE_RESNET,
                        pairs="de")
    model = create_model(parse_srn_options(path, is_train=False)).init(seed=7).load()
    for k, v in net.state_dict().items():
        assert torch.equal(model.g.state_dict()[k], v), k
    got = srn_test.main(["-opt", path, "--device", "cpu"])["synth"]
    assert all(np.isfinite(v) for v in got.values())
    lr = model.test(read_img(str(corpus / "de_hr" / "d0.png")))
    assert lr.shape == (32, 32, 3)
    out = corpus / "port_deres" / "results" / "port_deres" / "synth"
    assert sorted(os.listdir(out)) == ["d0.png"]

    jopt = jax_parse(path, is_train=False)
    jm = jax_create_model(jopt).init(lr_size=32).load()
    val_set = jax_create_dataset(jopt["datasets"]["test_1"])
    jopt["path"]["val_images"] = str(corpus / "jax_deres_val")
    with pytest.raises(ValueError):
        jax_validate(jm, val_set, jopt, 1, None, None, None)
