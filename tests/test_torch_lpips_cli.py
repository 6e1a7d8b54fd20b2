"""The port's LPIPS CLIs (CPU) against the JAX package's on the same inputs:
``lpips_train train`` for two epochs (one at the base LR, one decayed)
writes a ``latest_net_.pth`` within 2e-5 of JAX's, and each package loads
the other's; ``lpips_train eval`` for 2afc and jnd in every model mode;
``compute_dists`` ``pair``, ``dirs`` with ``-o`` and ``--html`` and
``self``, distances within 1e-5 abs + 1e-4 rel and the same lines. The
seeded reference-format weights of tests/torch_lpips_weights.py stand in
for the published ones, and the ranking net starts from JAX's init in both
(the port's draws its own otherwise). Without a card ``--device cuda``
raises."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lpips_train import write_2afc, write_jnd
from torch_lpips_weights import write

from dasr_tpu.cli import compute_dists as jax_compute_dists
from dasr_tpu.cli import lpips_train as jax_lpips_train
from dasr_tpu.losses import lpips as jlpips
from dasr_tpu.losses import lpips_train as jlt
from dasr_tpu_torch.cli import compute_dists, lpips_train
from dasr_tpu_torch.data.io import save_img
from dasr_tpu_torch.losses.lpips import LPIPS, load_lpips_params
from dasr_tpu_torch.train.checkpoints import state_dict_from_jax

ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("lpips_cli")
    rng = np.random.default_rng(6)
    weights = {net: write(root, net) for net in ("alex", "squeeze")}
    # 64x64: squeeze pools as JAX's there, not at every size (ROADMAP C.2)
    dirs = {"2afc": write_2afc(str(root / "2afc"), 8, rng, hw=(64, 64)),
            "jnd": write_jnd(str(root / "jnd"), 6, rng, hw=(64, 64))}
    for d in ("d0", "d1"):
        os.makedirs(root / d)
    for i in range(3):
        a = rng.random((64, 64, 3), dtype=np.float32)
        save_img(a, str(root / "d0" / f"{i}.png"))
        save_img(np.clip(a + 0.1 * (i + 1) * rng.standard_normal(a.shape), 0, 1),
                 str(root / "d1" / f"{i}.png"))
    return root, weights, dirs


@pytest.fixture
def jax_rank_init(monkeypatch):
    """The port's ranking net starts where JAX's CLI starts its own
    (``TwoAFCTrainer.init`` with key 1)."""
    d = jnp.ones((1, 1, 1, 1))
    variables = jax.tree.map(np.asarray, jlt.Dist2LogitLayer().init(jax.random.key(1), d, d))

    def init_weights(self, generator=None):
        self.load_state_dict(state_dict_from_jax(self, variables))
        return self

    monkeypatch.setattr(lpips_train.Dist2LogitLayer, "init_weights", init_weights)


def test_train_writes_the_heads_jax_writes(corpus, tmp_path, jax_rank_init, capsys):
    root, weights, dirs = corpus
    bpath, lpath = weights["alex"]
    args = ["train", "--datasets", dirs["2afc"], "--nepoch", "1", "--nepoch_decay", "1",
            "--batch_size", "4", "--print_freq", "1", "--lin_path", lpath, "--backbone", bpath,
            "--val_datasets", dirs["2afc"]]
    jax_lpips_train.main(args + ["--save_dir", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    trainer = lpips_train.main(args + ["--save_dir", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert trainer.opt.state[trainer.lins[0]]["step"] == 4  # 8 triplets, batch 4, 2 epochs

    def lines(text, key):
        return [ln for ln in text.splitlines() if ln.startswith(key)]

    for key in ("epoch", "End of epoch", "  Dataset", "Loading"):
        assert len(lines(out, key)) == len(lines(jax_out, key)) > 0, key
    for ours, theirs in zip(lines(out, "epoch"), lines(jax_out, "epoch")):
        loss = [float(ln.split("loss ")[1].split()[0]) for ln in (ours, theirs)]
        assert abs(loss[0] - loss[1]) <= 1e-4, (ours, theirs)  # 4 decimals printed

    files = {k: str(tmp_path / k / "latest_net_.pth") for k in ("jax", "port")}
    sds = {k: torch.load(p, weights_only=True) for k, p in files.items()}
    assert list(sds["port"]) == list(sds["jax"]) == [f"lin{k}.model.1.weight" for k in range(5)]
    for k, v in sds["jax"].items():
        assert sds["port"][k].shape == v.shape and sds["port"][k].dtype == v.dtype
        np.testing.assert_allclose(sds["port"][k].numpy(), v.numpy(), atol=2e-5, rtol=0,
                                   err_msg=k)
    # each package reads the other's file
    z = jnp.zeros((1, 64, 64, 3))
    jvars = jlpips.load_lpips_params("alex", lin_path=files["port"],
                                     base_params=jlpips.LPIPS().init(jax.random.key(0), z, z))
    port = load_lpips_params(LPIPS(), lin_path=files["jax"])
    for k in range(5):
        np.testing.assert_array_equal(np.asarray(jvars["params"][f"lin{k}"])[:, 0],
                                      sds["port"][f"lin{k}.model.1.weight"].numpy().reshape(-1))
        np.testing.assert_array_equal(getattr(port, f"lin{k}").detach().numpy(),
                                      sds["jax"][f"lin{k}.model.1.weight"].numpy().reshape(-1))


@pytest.mark.parametrize("mode,model,net", [
    ("2afc", "net-lin", "alex"), ("jnd", "net-lin", "alex"), ("2afc", "net", "squeeze"),
    ("jnd", "l2", "alex"), ("2afc", "DSSIM", "alex")])
def test_eval_matches_jax(corpus, tmp_path, mode, model, net):
    root, weights, dirs = corpus
    args = ["eval", "--datasets", dirs[mode], "--dataset_mode", mode, "--model", model,
            "--net", net, "--backbone", weights[net][0], "--batch_size", "4"]
    want = jax_lpips_train.main(args + ["--out", str(tmp_path / "jax.json")])
    got = lpips_train.main(args + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    assert got.keys() == want.keys() == {dirs[mode]}
    assert got[dirs[mode]] == pytest.approx(want[dirs[mode]], abs=1e-12)
    assert open(tmp_path / "port.json").read() == open(tmp_path / "jax.json").read()


def test_eval_scores_the_heads_it_is_given(corpus):
    root, weights, dirs = corpus
    args = ["eval", "--datasets", dirs["2afc"], "--backbone", weights["alex"][0],
            "--device", "cpu"]
    a = lpips_train.main(args)[dirs["2afc"]]
    b = lpips_train.main(args + ["--lin_path", weights["alex"][1]])[dirs["2afc"]]
    assert 0 <= a <= 1 and 0 <= b <= 1


def _values(text):
    return [float(ln.rsplit(": ", 1)[1]) for ln in text.splitlines() if ": " in ln
            and ln.rsplit(": ", 1)[1].replace(".", "").isdigit()]


@pytest.mark.parametrize("model,net", [("net-lin", "alex"), ("net", "squeeze"), ("l2", "alex"),
                                       ("ssim", "alex")])
def test_compute_dists_matches_jax(corpus, tmp_path, capsys, model, net):
    root, weights, _ = corpus
    common = ["--model", model, "--net", net, "--backbone", weights[net][0]]
    d0, d1 = str(root / "d0"), str(root / "d1")
    (tmp_path / "jax").mkdir()
    for sub in (["pair", "-p0", os.path.join(d0, "0.png"), "-p1", os.path.join(d1, "0.png")],
                ["dirs", "-d0", d0, "-d1", d1],
                ["self", "-d", d1]):
        tag = sub[0]
        extra = {"dirs": ["-o", str(tmp_path / f"{tag}.txt"), "--html", str(tmp_path / "html")]}
        want = jax_compute_dists.main(sub + common + [
            a.replace(str(tmp_path), str(tmp_path / "jax")) for a in extra.get(tag, [])])
        jax_out = capsys.readouterr().out
        got = compute_dists.main(sub + common + extra.get(tag, []) + ["--device", "cpu"])
        out = capsys.readouterr().out
        if want is not None:
            assert got == pytest.approx(want, abs=ATOL, rel=RTOL), tag
        assert [ln.split(":")[0] for ln in out.splitlines()] == [
            ln.split(":")[0].replace(str(tmp_path / "jax"), str(tmp_path))
            for ln in jax_out.splitlines()], tag
        np.testing.assert_allclose(_values(out), _values(jax_out), atol=1.5e-4, rtol=0,
                                   err_msg=tag)  # printed to 4 and 6 decimals
    written = open(tmp_path / "dirs.txt").read().splitlines()
    assert [ln.split(":")[0] for ln in written] == ["0.png", "1.png", "2.png"]
    index = open(tmp_path / "html" / "index.html").read()
    assert "<table>" in index and all(f"{i}.png" in index for i in range(3))
    assert sorted(os.listdir(tmp_path / "html" / "images")) == sorted(
        os.listdir(tmp_path / "jax" / "html" / "images"))


def test_cuda_without_a_card_raises(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, weights, dirs = corpus
    with pytest.raises(RuntimeError, match="cuda"):
        compute_dists.main(["self", "-d", str(root / "d0")])
    with pytest.raises(RuntimeError, match="cuda"):
        lpips_train.main(["eval", "--datasets", dirs["2afc"]])
