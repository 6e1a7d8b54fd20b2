"""The reference ``{iter}.state`` resume, both ways between the port and
the JAX package (CPU, f32, nf 16 nb 1 gc 8, no LPIPS), in the pattern of
tests/test_reference_resume.py, with ``D_update_inter`` 2 so that G's and
D's update counts differ from each other and from the iteration:

* JAX trains three steps and writes ``3.state`` and the ``3_*.pth`` files
  (``save_reference_formats``); a fresh port model resumes from them
  through ``check_resume`` and ``load``: params and Adam moments equal
  JAX's, each network's Adam count and LR schedule at its own update count
  (G 3, D 2), the step at 3; then two more steps from both on the same
  batches (D updates in the second): params within 2e-5;
* the port writes ``5.state``; JAX's ``DASRModel.load`` resumes it into a
  re-initialised model: params equal, JAX's counts G 5, D 3; two more steps
  from both: params within 2e-5.

Also: a reference-style pickle (int ``step``, MultiStepLR state with a
``Counter``, ``param_groups`` of other hyperparameters) keeps the config's
lr and betas; ``check_resume`` rewires only ``.state`` paths, deviating
from the JAX function on purpose (ROADMAP C.2), and reads an absent
``gan_H_target`` as the trainer's default."""

import collections
import copy
import os

import jax
import numpy as np
import pytest
import torch

from dasr_tpu.core.config import check_resume as jax_check_resume
from dasr_tpu.core.config import dict_to_nonedict as jax_nonedict
from dasr_tpu.models.registry import DASRModel as JDASRModel
from dasr_tpu.train import checkpoints as jck
from dasr_tpu_torch.core.config import check_resume, dict_to_nonedict
from dasr_tpu_torch.models.registry import DASRModel
from dasr_tpu_torch.train import checkpoints as ck

PARAM_ATOL = 2e-5
NB, D_LAYERS = 1, 2
CONFIG = {
    "model": "DASR", "scale": 4, "multiweights": True, "bf16": False,
    "network_G": {"which_model_G": "RRDB_net", "nf": 16, "nb": NB, "gc": 8, "norm_type": None},
    "network_D": {"which_model_D": "discriminator_patch", "nf": 16, "in_nc": 9,
                  "n_layers": D_LAYERS},
    # G's fourth update (count 3) is the first past the milestone; D reaches
    # count 3 only in the JAX model's second stretch
    "train": {"lr_G": 1e-4, "lr_D": 1e-4, "lr_steps": [3], "fs": "wavelet",
              "gan_H_target": 0.005, "gan_H_source": 0.005, "feature_weight": 0.0,
              "manual_seed": 0, "D_update_inter": 2},
}
NETS = (("g", "G"), ("d_target", "D_target"), ("d_source", "D_source"))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(rng, b=2, lr=8):
    hr = lr * 4
    return {"LR_fake": rng.random((b, lr, lr, 3)).astype(np.float32),
            "LR_real": rng.random((b, lr, lr, 3)).astype(np.float32),
            "HR": rng.random((b, hr, hr, 3)).astype(np.float32),
            "HR_unpair": rng.random((b, hr, hr, 3)).astype(np.float32),
            "fake_w": rng.random((b, lr // 2, lr // 2, 1)).astype(np.float32)}


def _key_map(attr):
    return jck.rrdbnet_key_map(NB) if attr == "g" else jck.nlayer_d_key_map(D_LAYERS)


def _jax_net(m, attr):
    """A JAX network's params and Adam state as the reference's torch dicts."""
    net = getattr(m.state, attr)
    return (jck.export_params_to_state_dict(net.params, _key_map(attr)),
            jck.export_adam_state(net.opt_state, _key_map(attr), net.params)["state"])


def _port_opt(models, resume_state):
    opt = dict_to_nonedict({**copy.deepcopy(CONFIG), "is_train": True,
                            "path": {"models": models, "resume_state": resume_state}})
    return check_resume(opt)


def _compare(port, jmodel, what, atol):
    """Fails where a port network's params differ from the JAX model's past
    ``atol``; returns the largest difference."""
    worst = 0.0
    st = port.trainer.state
    for attr, label in NETS:
        want, _ = _jax_net(jmodel, attr)
        got = getattr(st, attr).net.state_dict()
        assert set(got) == set(want), (what, label)
        for k, v in want.items():
            err = (got[k] - v).abs().max().item()
            worst = max(worst, err)
            assert err <= atol, (what, label, k, err)
    return worst


@pytest.fixture(scope="module")
def both_ways(tmp_path_factory):
    """JAX -> port -> JAX, recording each check's inputs."""
    root = tmp_path_factory.mktemp("reference_resume")
    rng = np.random.default_rng(0)
    rec = {}
    jm = JDASRModel(jax_nonedict({**copy.deepcopy(CONFIG), "path": {}})).init(
        jax.random.key(0), lr_size=8)
    for _ in range(3):
        jm.train_step(_batch(rng))
    jdir = str(root / "jax_models")
    jm.save_reference_formats(jdir, 3)
    rec["jax_files"] = sorted(os.listdir(jdir))

    pm = DASRModel(_port_opt(jdir, os.path.join(jdir, "3.state")), torch.device("cpu"))
    pm.init(seed=99).load()
    rec["after_port_load"] = {attr: _jax_net(jm, attr) for attr, _ in NETS}
    rec["port_loaded"] = {}
    for attr, _ in NETS:
        ns = getattr(pm.trainer.state, attr)
        rec["port_loaded"][attr] = (
            {k: v.clone() for k, v in ns.net.state_dict().items()},
            [{k: ns.opt.state[p][k].clone() for k in ("exp_avg", "exp_avg_sq")}
             for p in ns.params()])
    rec["port_counts"] = {attr: (ns.sched.last_epoch, [float(s["step"]) for s in
                                                        ns.opt.state.values()],
                                 ns.opt.param_groups[0]["lr"])
                          for attr, ns in ((a, getattr(pm.trainer.state, a)) for a, _ in NETS)}
    rec["port_step"] = pm.trainer.state.step
    for _ in range(2):  # steps 3 (G only) and 4 (G and D)
        b = _batch(rng)
        jm.train_step(dict(b))
        pm.train_step(dict(b))
    rec["port_after_jax_resume"] = _compare(pm, jm, "port resumed from JAX", float("inf"))
    rec["models"] = (pm, jm)

    pdir = str(root / "port_models")
    pm.save_reference_formats(pdir, 5)
    jm.init(jax.random.key(7), lr_size=8)
    jm.opt = jax_check_resume(jax_nonedict({**copy.deepcopy(CONFIG), "path": {
        "models": pdir, "resume_state": os.path.join(pdir, "5.state")}}))
    jm.load()
    rec["jax_step"] = int(jm.state.step)
    rec["jax_counts"] = {attr: int(_jax_net(jm, attr)[1][0]["step"]) for attr, _ in NETS}
    rec["jax_loaded_err"] = _compare(pm, jm, "JAX loaded the port's state", float("inf"))
    for _ in range(2):  # steps 5 (G only) and 6 (G and D)
        b = _batch(rng)
        jm.train_step(dict(b))
        pm.train_step(dict(b))
    rec["jax_after_port_resume"] = _compare(pm, jm, "JAX resumed from the port", float("inf"))
    return rec


def test_jax_state_resumes_in_the_port(both_ways):
    assert both_ways["jax_files"] == ["3.state", "3_D_source.pth", "3_D_target.pth", "3_G.pth"]
    assert both_ways["port_step"] == 3
    for attr, label in NETS:
        params, moments = both_ways["after_port_load"][attr]
        got, got_moments = both_ways["port_loaded"][attr]
        for k, v in params.items():
            assert torch.equal(got[k], v), (label, k)
        assert len(got_moments) == len(moments), label
        for i, m in enumerate(got_moments):
            for k, v in m.items():
                assert torch.equal(v, moments[i][k]), (label, i, k)


def test_per_network_counts_come_from_the_adam_state(both_ways):
    """D updates at steps 0 and 2 only: its count is 2, not the iteration 3.
    G's count 3 is past the milestone, so its LR is halved; D's is not."""
    counts = both_ways["port_counts"]
    for attr, count, lr in (("g", 3, 0.5e-4), ("d_target", 2, 1e-4), ("d_source", 2, 1e-4)):
        last_epoch, steps, group_lr = counts[attr]
        assert last_epoch == count and set(steps) == {float(count)}, attr
        assert group_lr == pytest.approx(lr), attr
    assert both_ways["jax_counts"] == {"g": 5, "d_target": 3, "d_source": 3}
    assert both_ways["jax_step"] == 5


def test_port_continues_as_jax_from_a_jax_state(both_ways):
    assert both_ways["port_after_jax_resume"] <= PARAM_ATOL


def test_port_state_resumes_in_jax(both_ways):
    assert both_ways["jax_loaded_err"] <= 1e-7


def test_jax_continues_as_the_port_from_a_port_state(both_ways):
    assert both_ways["jax_after_port_resume"] <= PARAM_ATOL


def test_imported_moments_equal_the_saved_ones(tmp_path):
    """``import_adam_state`` by parameter index: every moment equals the
    state dict's, every step is the largest count; a shape that does not
    match its parameter raises."""
    opt = dict_to_nonedict({**copy.deepcopy(CONFIG), "is_train": True, "path": {}})
    src = DASRModel(opt, torch.device("cpu")).init(seed=1)
    rng = np.random.default_rng(3)
    for _ in range(2):
        src.train_step(_batch(rng))
    dst = DASRModel(opt, torch.device("cpu")).init(seed=2)
    for attr, label in NETS:
        sd = getattr(src.trainer.state, attr).opt.state_dict()
        ns = getattr(dst.trainer.state, attr)
        assert ck.import_adam_state(ns, sd) == (2 if attr == "g" else 1), label
        for i, p in enumerate(ns.params()):
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(ns.opt.state[p][k], sd["state"][i][k]), (label, i, k)
    bad = copy.deepcopy(src.trainer.state.g.opt.state_dict())
    bad["state"][0]["exp_avg"] = bad["state"][0]["exp_avg"][:1]
    with pytest.raises(ValueError, match="shape"):
        ck.import_adam_state(dst.trainer.state.g, bad)


def test_reference_pickle_keeps_the_config_hyperparameters(tmp_path):
    """A reference-style ``.state``: int ``step``s, MultiStepLR state with a
    ``Counter`` of milestones, and ``param_groups`` with lr 1e-4 and the
    default betas. The config's lr (2e-4, 3e-4) and beta1 (0.5) stay; the
    count (2) sets the schedule; the run takes a step."""
    base = {**copy.deepcopy(CONFIG), "is_train": True, "path": {}}
    base["train"].update(gan_H_source=0.0, D_update_inter=1, lr_steps=[5])
    src = DASRModel(dict_to_nonedict(base), torch.device("cpu")).init(seed=1)
    rng = np.random.default_rng(5)
    for _ in range(2):
        src.train_step(_batch(rng))
    models = str(tmp_path / "models")
    ck.save_reference_formats(models, src.trainer.state, 2)
    path = os.path.join(models, "2.state")
    saved = torch.load(path, weights_only=False)
    for osd in saved["optimizers"]:
        for st in osd["state"].values():
            st["step"] = int(st["step"])
        osd["param_groups"][0].update(lr=1e-4, betas=(0.9, 0.999))
    sched = torch.optim.lr_scheduler.MultiStepLR(
        torch.optim.Adam([torch.zeros(1, requires_grad=True)]), [5], 0.5)
    saved["schedulers"] = [sched.state_dict()] * 2
    assert isinstance(saved["schedulers"][0]["milestones"], collections.Counter)
    saved["epoch"] = 1
    torch.save(saved, path)

    cfg = copy.deepcopy(base)
    cfg["train"].update(lr_G=2e-4, lr_D=3e-4, beta1_G=0.5, beta1_D=0.5)
    cfg["path"] = {"models": models, "resume_state": path}
    dst = DASRModel(check_resume(dict_to_nonedict(cfg)), torch.device("cpu")).init(seed=2).load()
    st = dst.trainer.state
    assert st.step == 2
    for ns, lr in ((st.g, 2e-4), (st.d_target, 3e-4)):
        group = ns.opt.param_groups[0]
        assert group["lr"] == pytest.approx(lr) and group["betas"] == (0.5, 0.999)
        assert ns.sched.last_epoch == 2
        for p in ns.params():
            step = ns.opt.state[p]["step"]
            assert torch.is_tensor(step) and step.dtype == torch.float32 and float(step) == 2
    metrics = dst.train_step(_batch(rng))
    assert all(np.isfinite(v) for v in metrics.values())
    assert all(float(s["step"]) == 3 for s in st.g.opt.state.values())


@pytest.mark.parametrize("resume", ["7.state", "training_state/7.pt", "training_state"])
@pytest.mark.parametrize("train", [{"gan_H_target": 0.005, "gan_H_source": 0.005}, {}],
                         ids=["both_d", "absent_keys"])
def test_check_resume_rewires_only_state_paths(resume, train):
    """``.state``: the pretrain paths at ``{models}/{iter}_*.pth``, as JAX's
    function sets them where the config names ``gan_H_target``; an absent
    ``gan_H_target`` reads as the trainer's default 0.005 (JAX reads 0 and
    would leave the D_target a resume finds at its fresh init). Any other
    resume path: unchanged, where JAX's function points
    ``pretrain_model_G`` at ``{models}/0_G.pth`` (ROADMAP C.2)."""
    def opt(make):
        return make({"train": dict(train), "path": {"models": "/exp/models",
                                                    "resume_state": f"/exp/{resume}"}})

    got, want = check_resume(opt(dict_to_nonedict))["path"], jax_check_resume(
        opt(jax_nonedict))["path"]
    keys = {f"pretrain_model_{k}" for k in ("G", "D_target", "D_source")}
    got = {k: v for k, v in got.items() if k in keys}
    want = {k: v for k, v in want.items() if k in keys}
    if not resume.endswith(".state"):
        assert got == {} and want["pretrain_model_G"] == "/exp/models/0_G.pth"
        return
    expected = {"pretrain_model_G": "/exp/models/7_G.pth",
                "pretrain_model_D_target": "/exp/models/7_D_target.pth"}
    if train:
        expected["pretrain_model_D_source"] = "/exp/models/7_D_source.pth"
        assert got == want == expected
    else:
        assert got == expected and want == {"pretrain_model_G": "/exp/models/7_G.pth"}
