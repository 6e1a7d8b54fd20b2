"""The DASR Adaptive model through the port's CLIs on the CPU: srn_train on a
tiny 'LRHR_unpair' corpus (RRDB_Residual_conv nf 16 nb 1, the patch D from
a DSN .tar and trained) on the host loader and with --device_bank
--steps_per_call 2, validating and saving, a resume from its {iter}.pt
ending where the straight run ends; the patch D of a .tar written by JAX's
save_dsn_tar against JAX's import; srn_test plain and chopped against
dasr_tpu's srn_test on the same carried weights (0.01 dB, 1e-4 SSIM); the
two config-key deviations from dasr_tpu (ROADMAP C.2); the reference
formats refused, as dasr_tpu has none for this model."""

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
from dasr_tpu.data.io import save_img
from dasr_tpu.models import registry as jreg
from dasr_tpu.nn.discriminators import FSDiscriminator as JFSD
from dasr_tpu.nn.generators import DeResnet as JDeResnet
from dasr_tpu.train import checkpoints as jck
from dasr_tpu_torch.cli import srn_test, srn_train
from dasr_tpu_torch.core.config import parse_srn_options
from dasr_tpu_torch.models import registry
from dasr_tpu_torch.ops.rdb import TOLERANCES
from dasr_tpu_torch.train import checkpoints as ck
from test_torch_srn_train_cli import write_corpus

LOSSES = {"loss/patch_D_gan_loss", "loss/l_g_pix", "loss/l_g_LL_pix", "loss/l_g_fea",
          "loss/l_g_gan_target_Hf", "loss/l_d_target_total", "loss/l_g_total"}
NET_G = {"which_model_G": "RRDB_Residual_conv", "nf": 16, "nb": 1, "gc": 8, "ada_nb": 1}
PATCH_D = {"which_patchD": "FSD", "FS_type": "avg_pool", "norm_layer": "Instance",
           "kernel_size": 5}


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
    """The train corpus, an LRHR serve set (two small images and one that
    the lowered chop gate tiles), and a DSN .tar from JAX's save_dsn_tar."""
    root = tmp_path_factory.mktemp("adaptive")
    dirs = write_corpus(str(root))
    rng = np.random.default_rng(9)
    for d in ("serve_lr", "serve_hr"):
        os.makedirs(root / d)
    for i, (h, w) in enumerate([(20, 24), (17, 23), (140, 136)]):
        lr = rng.random((h, w, 3)).astype(np.float32)
        hr = np.clip(np.kron(lr, np.ones((4, 4, 1))) + rng.normal(0, 0.05, (4 * h, 4 * w, 3)), 0, 1)
        save_img(lr, str(root / "serve_lr" / f"img_{i}.png"))
        save_img(hr, str(root / "serve_hr" / f"img_{i}.png"))
    z = jnp.zeros((1, 16, 16, 3))
    d_vars = JFSD(d_arch="FSD", filter_type="avg_pool", kernel_size=5,
                  norm_layer="Instance").init(jax.random.key(21), z)
    g_vars = JDeResnet(n_res_blocks=1).init(jax.random.key(22), z)
    dirs["tar"] = jck.save_dsn_tar(str(root / "last_iteration.tar"), g_vars, d_vars,
                                   n_res_blocks=1)
    dirs["root"] = str(root)
    return dirs


def train_config(dirs, name, niter=4, **path):
    cfg = {
        "name": name, "model": "DASR_Adaptive_Model", "scale": 4, "val_lpips": True,
        "bf16": False, "use_domain_distance_map": True,
        "datasets": {
            "train": {"name": "synth", "mode": "LRHR_unpair", "dataroot_HR": dirs["hr"],
                      "dataroot_fake_LR": dirs["fake"], "dataroot_real_LR": dirs["real"],
                      "n_workers": 2, "batch_size": 2, "HR_size": 64},
            "val": {"name": "val", "mode": "LRHR", "dataroot_HR": dirs["val_hr"],
                    "dataroot_LR": dirs["val_lr"]},
        },
        "path": {"root": dirs["root"], "Patch_Discriminator": dirs["tar"], **path},
        "network_G": NET_G,
        "network_D": {"which_model_D": "discriminator_patch", "nf": 16, "in_nc": 9,
                      "n_layers": 2},
        "network_patchD": PATCH_D,
        "train": {"niter": niter, "val_freq": 4, "manual_seed": 0, "lr_steps": [3],
                  "use_patchD_opt": True},
        "logger": {"print_freq": 1, "save_checkpoint_freq": 2},
    }
    path = os.path.join(dirs["root"], f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _records(dirs, name):
    with open(os.path.join(dirs["root"], name, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _run(path, *flags):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        steps, last = srn_train.main(["-opt", path, "--device", "cpu", *flags])
    return steps, last, out.getvalue()


@pytest.fixture(scope="module")
def run(corpus):
    return _run(train_config(corpus, "ada"))


def test_trains_validates_and_saves(corpus, run):
    steps, last, out = run
    assert steps == 4 and LOSSES <= set(last)
    assert f"patch D: loaded from {corpus['tar']}" in out
    recs = _records(corpus, "ada")
    train = [r for r in recs if "loss/l_g_total" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all(np.isfinite(r[k]) for r in train for k in LOSSES)
    val = [r for r in recs if "val/psnr" in r]
    assert len(val) == 1 and all(np.isfinite(val[0][f"val/{k}"]) for k in ("psnr", "lpips"))
    state = torch.load(os.path.join(corpus["root"], "ada", "training_state", "4.pt"),
                       weights_only=True)
    assert state["step"] == 4 and set(state) == {"step", "G", "D_target", "patchD"}
    # the patch D took four Adam steps at a constant LR
    assert state["patchD"]["opt"]["param_groups"][0]["lr"] == pytest.approx(1e-4)
    assert state["G"]["opt"]["param_groups"][0]["lr"] == pytest.approx(0.5e-4)


def test_banked_windows_train_on_the_device_bank(corpus):
    steps, last, out = _run(train_config(corpus, "ada_bank"), "--device_bank",
                            "--steps_per_call", "2")
    assert "device bank: " in out and "using the host loader" not in out
    assert steps == 4 and LOSSES <= set(last)
    train = [r for r in _records(corpus, "ada_bank") if "loss/l_g_total" in r]
    assert [r["step"] for r in train] == [2, 4]
    assert all(np.isfinite(r[k]) for r in train for k in LOSSES)
    opt = parse_srn_options(train_config(corpus, "gate"), is_train=True)
    assert srn_train._bank_gate(opt, opt["datasets"]["train"], 1.0) == (
        corpus["fake"], corpus["hr"], corpus["real"], None)


def test_resume_from_its_pt_ends_where_the_straight_run_ends(corpus, run, caplog):
    """From the straight run's 2.pt to step 4: every network (the patch D
    too), its Adam and its schedule carry over, and the run continues
    inside the epoch."""
    pt = os.path.join(corpus["root"], "ada", "training_state", "2.pt")
    with caplog.at_level("INFO", logger="base"):
        steps, _, _ = _run(train_config(corpus, "ada_resumed", resume_state=pt))
    assert steps == 4 and "Resuming training from iteration: 2." in caplog.text
    ends = [torch.load(os.path.join(corpus["root"], name, "training_state", "4.pt"),
                       weights_only=True) for name in ("ada", "ada_resumed")]
    for label in ("G", "D_target", "patchD"):
        for k, v in ends[0][label]["net"].items():
            assert torch.equal(ends[1][label]["net"][k], v), (label, k)


def _fsd_input(rng):
    return rng.random((2, 20, 18, 3), dtype=np.float32)


def test_patchd_from_a_jax_tar_matches_jax(corpus, rng, tmp_path):
    """JAX's save_dsn_tar -> the port's load_patchd_tar, against JAX's own
    import of that .tar; and the port's .tar loads back as it was."""
    x = _fsd_input(rng)
    variables = jck.import_fsd_discriminator_params(
        jck.load_dsn_tar(corpus["tar"])["models_d_state_dict"])
    jd = JFSD(d_arch="FSD", filter_type="avg_pool", kernel_size=5, norm_layer="Instance")
    want = np.asarray(jd.apply(variables, jnp.asarray(x)))
    opt = {"network_patchD": PATCH_D, "bf16": False}
    d = ck.load_patchd_tar(registry.define_patchD(opt), corpus["tar"]).eval()
    with torch.no_grad():
        got = d(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=TOLERANCES["jax_network"][0], rtol=0)
    again = ck.save_dsn_tar(str(tmp_path / "port.tar"), torch.nn.Linear(1, 1), d)
    d2 = ck.load_patchd_tar(registry.define_patchD(opt), again)
    for k, v in d.state_dict().items():
        assert torch.equal(d2.state_dict()[k], v), k


def serve_config(corpus, name, patchd_key, chop=False, g_path=None):
    cfg = {"name": name, "model": "DASR_Adaptive_Model", "scale": 4, "chop": chop,
           "val_lpips": False, "bf16": False,
           "datasets": {"test_1": {"name": "synth", "mode": "LRHR",
                                   "dataroot_HR": os.path.join(corpus["root"], "serve_hr"),
                                   "dataroot_LR": os.path.join(corpus["root"], "serve_lr")}},
           "path": {"root": os.path.join(corpus["root"], name), patchd_key: corpus["tar"],
                    **({"pretrain_model_G": g_path} if g_path else {})},
           "network_G": NET_G, "network_patchD": PATCH_D}
    path = os.path.join(corpus["root"], f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.mark.parametrize("chop", [False, True])
def test_srn_test_matches_jax(corpus, monkeypatch, chop):
    """dasr_tpu's srn_test serves the G of its init (key 0) and the patch D
    of the .tar named by its key; the port's, the same G carried across as a
    .pth and the same .tar named by the shipped key. With ``chop`` the gate
    is lowered on both sides so that the 140x136 image is tiled
    (tiled_apply, 128-px tiles) and the small ones are not."""
    if chop:
        monkeypatch.setattr(jreg.DASRAdaptiveModel, "chop_threshold", 10000)
        monkeypatch.setattr(registry.DASRAdaptiveModel, "chop_threshold", 10000)
    tag = int(chop)
    jpath = serve_config(corpus, f"jax_{tag}", "pretrain_model_patchD", chop)
    jopt = json.load(open(jpath))
    jopt["is_train"] = False
    jmodel = jreg.create_model(jopt).init()
    g_pth = os.path.join(corpus["root"], "ada_G.pth")
    torch.save(ck.conditioned_g_state_dict_from_jax(
        jax.tree.map(np.asarray, jmodel.state.base.g.params), 1, 1, "RRDBResidualConv"), g_pth)
    want = jax_srn_test.main(["-opt", jpath])
    got = srn_test.main(["-opt", serve_config(corpus, f"port_{tag}", "Patch_Discriminator", chop,
                                              g_pth), "--device", "cpu"])
    assert set(got) == set(want) == {"synth"}
    psnr_tol, _ = TOLERANCES["psnr_db"]
    ssim_tol, _ = TOLERANCES["ssim"]
    for k in ("psnr", "psnr_y"):
        assert abs(got["synth"][k] - want["synth"][k]) <= psnr_tol, k
    for k in ("ssim", "ssim_y"):
        assert abs(got["synth"][k] - want["synth"][k]) <= ssim_tol, k


def test_patchd_tar_is_read_from_the_shipped_key(corpus, rng):
    """ROADMAP C.2, a deviation from dasr_tpu: the shipped configs name the
    patch D's .tar ``path.Patch_Discriminator``, which dasr_tpu ignores (it
    reads ``path.pretrain_model_patchD``, registry.py:845), serving and
    training from a random patch D. The port reads the shipped key, then
    JAX's."""
    x = _fsd_input(rng)
    want = np.asarray(JFSD(d_arch="FSD", filter_type="avg_pool", kernel_size=5,
                           norm_layer="Instance").apply(
        jck.import_fsd_discriminator_params(jck.load_dsn_tar(corpus["tar"])["models_d_state_dict"]),
        jnp.asarray(x)))
    for key in ("Patch_Discriminator", "pretrain_model_patchD"):
        opt = json.load(open(serve_config(corpus, "key", key)))
        opt["is_train"] = False
        model = registry.create_model(opt).init().load()
        with torch.no_grad():
            got = model.patchd(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=TOLERANCES["jax_network"][0], rtol=0)
        jmodel = jreg.create_model(opt).init()
        jgot = np.asarray(jmodel.trainer.patchd_model.apply(jmodel.state.patchd.params,
                                                            jnp.asarray(x)))
        assert np.allclose(jgot, want, atol=1e-4) == (key == "pretrain_model_patchD"), key


@pytest.mark.parametrize("opt,want_jax,want_port", [
    ({"use_domain_distance_map": False}, True, False),
    ({"adaptive_weights": False}, False, False),
    ({"use_domain_distance_map": True, "adaptive_weights": False}, False, True),
    ({}, True, True),
])
def test_ddm_switch_is_read_from_the_shipped_key(opt, want_jax, want_port):
    """ROADMAP C.2, a deviation from dasr_tpu: the shipped configs switch the
    DDM with ``use_domain_distance_map``, which dasr_tpu ignores (it reads
    ``adaptive_weights``, registry.py:836). The port reads the shipped key
    first, then JAX's, and defaults to on."""
    full = {"model": "DASR_Adaptive_Model", "scale": 4, "network_G": NET_G, **opt}
    assert jreg.DASRAdaptiveModel(full).trainer.cfg.use_domain_distance_map is want_jax
    assert registry.adaptive_config(full).use_domain_distance_map is want_port


def test_patchd_filter_default_is_define_patchds():
    """ROADMAP C.2, a deviation from dasr_tpu: its Adaptive model defaults
    ``network_patchD.FS_type`` to avg_pool (registry.py:838), where its
    ``define_patchD``, the factory the reference's Adaptive model calls,
    defaults to gau. The port's Adaptive model builds its patch D with
    ``define_patchD``."""
    full = {"model": "DASR_Adaptive_Model", "scale": 4, "network_G": NET_G, "bf16": False,
            "network_patchD": {"which_patchD": "FSD"}}
    assert jreg.DASRAdaptiveModel(full).trainer.cfg.patchd_fs_type == "avg_pool"
    assert jreg.define_patchD(full).filter_type == "gau"
    patchd = registry.create_model(full, torch.device("cpu")).patchd
    assert (patchd.filter_type, patchd.kernel_size) == ("gau", 5)


def test_without_a_tar_the_patchd_is_a_fresh_init(corpus, capsys):
    opt = json.load(open(serve_config(corpus, "no_tar", "unused_key")))
    opt["is_train"] = False
    model = registry.create_model(opt).init()
    before = {k: v.clone() for k, v in model.patchd.state_dict().items()}
    model.load()
    out = capsys.readouterr().out
    assert out.count("patch D: no DSN .tar") == 1
    for k, v in model.patchd.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("case", ["state", "ref_formats"])
def test_reference_formats_are_refused(corpus, case):
    """dasr_tpu's CLI resumes a reference .state only for a model with
    resume_reference_state and writes reference formats only for one with
    save_reference_formats; its Adaptive model has neither."""
    path = train_config(corpus, f"refused_{case}")
    cfg = json.load(open(path))
    if case == "state":
        cfg["path"]["resume_state"] = os.path.join(corpus["root"], "4.state")
    else:
        cfg["logger"]["save_ref_formats"] = True
    json.dump(cfg, open(path, "w"))
    with pytest.raises(NotImplementedError, match="no reference format"):
        srn_train.main(["-opt", path, "--device", "cpu"])
