"""The port's 2AFC training pieces and BAPPS scoring against the JAX
package's, f32 on the CPU: ``Dist2LogitLayer`` and ``bce_ranking_loss``;
three ``TwoAFCTrainer`` steps (alex, batch 4, 64 px) from one carried init,
losses, accs, the clamped heads and the ranking net within 2e-5; an LR
callable stepped as optax's schedule; ``TwoAFCDataset``, ``JNDDataset``,
``score_2afc``, ``score_jnd`` and ``voc_ap`` equal to JAX's on a seeded
BAPPS-layout corpus."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_lpips_weights import write

from dasr_tpu.data import bapps as jbapps
from dasr_tpu.losses import lpips as jlpips
from dasr_tpu.losses import lpips_train as jlt
from dasr_tpu_torch.data import bapps
from dasr_tpu_torch.losses.lpips import LPIPS, load_lpips_params
from dasr_tpu_torch.losses.lpips_train import Dist2LogitLayer, TwoAFCTrainer, bce_ranking_loss
from dasr_tpu_torch.train.checkpoints import state_dict_from_jax

B, PATCH = 4, 64
TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def write_2afc(root, n, rng, hw=(40, 48)):
    """A BAPPS-layout 2AFC root: ref/ p0/ p1/ PNGs of ``hw`` and judge/*.npy."""
    for d in ("ref", "p0", "p1", "judge"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(n):
        ref = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
        for d, noise in (("ref", 0), ("p0", 20), ("p1", 60)):
            img = np.clip(ref + rng.integers(-noise, noise + 1, ref.shape), 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(os.path.join(root, d, f"{i:03d}.png"))
        np.save(os.path.join(root, "judge", f"{i:03d}.npy"),
                np.array([rng.random()], np.float32))
    return root


def write_jnd(root, n, rng, hw=(40, 48)):
    """A BAPPS-layout JND root: p0/ p1/ PNGs and same/*.npy."""
    for d in ("p0", "p1", "same"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(n):
        p0 = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
        noise = int(rng.integers(0, 60))
        p1 = np.clip(p0 + rng.integers(-noise, noise + 1, p0.shape), 0, 255).astype(np.uint8)
        Image.fromarray(p0).save(os.path.join(root, "p0", f"{i:03d}.png"))
        Image.fromarray(p1).save(os.path.join(root, "p1", f"{i:03d}.png"))
        np.save(os.path.join(root, "same", f"{i:03d}.npy"),
                np.array([rng.random()], np.float32))
    return root


def test_dist2logit_and_bce_match_jax():
    rng = np.random.default_rng(0)
    d0, d1 = (rng.random((3, 1, 1, 1), dtype=np.float32) for _ in range(2))
    jr = jlt.Dist2LogitLayer()
    variables = _np(jr.init(jax.random.key(1), jnp.asarray(d0), jnp.asarray(d1)))
    rank = Dist2LogitLayer()
    rank.load_state_dict(state_dict_from_jax(rank, variables), strict=True)
    with torch.no_grad():
        got = rank(torch.from_numpy(d0), torch.from_numpy(d1))
    want = np.asarray(jr.apply(variables, jnp.asarray(d0), jnp.asarray(d1)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    judge = rng.random((3, 1, 1, 1), dtype=np.float32) * 2 - 1
    for logit in (np.array(want), np.array([[[[0.0]]], [[[1.0]]], [[[0.5]]]], np.float32)):
        np.testing.assert_allclose(
            float(bce_ranking_loss(torch.from_numpy(logit), torch.from_numpy(judge))),
            float(jlt.bce_ranking_loss(jnp.asarray(logit), jnp.asarray(judge))), rtol=1e-6)


def test_three_steps_match_jax(tmp_path):
    bpath, lpath = write(tmp_path, "alex")
    z = jnp.zeros((1, PATCH, PATCH, 3))
    jtr = jlt.TwoAFCTrainer(net="alex", lr=1e-4, beta1=0.5)
    lvars = jlpips.load_lpips_params(
        "alex", lin_path=lpath, backbone_path=bpath,
        base_params=jlpips.LPIPS(net="alex").init(jax.random.key(0), z, z))
    trainable, backbone, opt_state = jtr.init(jax.random.key(1), lvars)

    lpips = load_lpips_params(LPIPS(net="alex"), lin_path=lpath, backbone_path=bpath)
    rank = Dist2LogitLayer()
    rank.load_state_dict(state_dict_from_jax(rank, _np({"params": trainable["rank"]})))
    tr = TwoAFCTrainer(lpips, rank, lr=1e-4, beta1=0.5)

    rng = np.random.default_rng(3)
    for i in range(3):
        batch = {k: (rng.random((B, PATCH, PATCH, 3), dtype=np.float32) * 2 - 1)
                 for k in ("ref", "p0", "p1")}
        batch["judge"] = rng.random((B, 1, 1, 1), dtype=np.float32)
        trainable, opt_state, want = jtr.step(trainable, opt_state, backbone, batch)
        got = tr.step({k: _nchw(v) if k != "judge" else torch.from_numpy(v)
                       for k, v in batch.items()})
        for k in ("loss", "acc"):
            np.testing.assert_allclose(float(got[k]), float(want[k]), atol=TOL, rtol=0,
                                       err_msg=f"step {i}: {k}")
    for k in range(5):
        w = getattr(lpips, f"lin{k}").detach().numpy()
        assert (w >= 0).all()
        np.testing.assert_allclose(w, np.asarray(trainable["lins"][f"lin{k}"])[:, 0],
                                   atol=TOL, rtol=0, err_msg=f"lin{k}")
    want_rank = state_dict_from_jax(rank, _np({"params": trainable["rank"]}))
    for k, v in rank.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_rank[k].numpy(), atol=TOL, rtol=0, err_msg=k)


def test_callable_lr_is_taken_at_the_update_count():
    """A callable LR gives update n (0-based) lr(n), as optax's schedule:
    the first update takes lr(0)."""
    lpips = LPIPS(net="alex").init_weights(torch.Generator().manual_seed(0))
    tr = TwoAFCTrainer(lpips, Dist2LogitLayer().init_weights(), lr=lambda n: 1e-4 / (n + 1))
    rng = np.random.default_rng(4)
    for n in range(3):
        assert tr.opt.param_groups[0]["lr"] == pytest.approx(1e-4 / (n + 1), rel=1e-12)
        batch = {k: torch.from_numpy(rng.random((1, 3, 32, 32), dtype=np.float32))
                 for k in ("ref", "p0", "p1")}
        tr.step({**batch, "judge": torch.full((1, 1, 1, 1), 0.5)})


def test_bapps_datasets_and_scores_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    afc = write_2afc(str(tmp_path / "2afc"), 7, rng)
    jnd = write_jnd(str(tmp_path / "jnd"), 9, rng)
    for ours, theirs in ((bapps.TwoAFCDataset(afc, 32), jbapps.TwoAFCDataset(afc, 32)),
                         (bapps.JNDDataset(jnd, 32), jbapps.JNDDataset(jnd, 32))):
        assert len(ours) == len(theirs)
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert ours[0]["p0"].shape == (32, 38, 3)  # the short side to load_size

    def l2(a, b):
        return np.mean((a - b) ** 2, axis=(1, 2, 3))

    got, got_v = bapps.score_2afc(l2, bapps.TwoAFCDataset(afc, 32), batch_size=3)
    want, want_v = jbapps.score_2afc(l2, jbapps.TwoAFCDataset(afc, 32), batch_size=3)
    assert got == want
    for k in want_v:
        np.testing.assert_array_equal(got_v[k], want_v[k])
    got, _ = bapps.score_jnd(l2, bapps.JNDDataset(jnd, 32), batch_size=4)
    want, _ = jbapps.score_jnd(l2, jbapps.JNDDataset(jnd, 32), batch_size=4)
    assert got == want
    rec, prec = np.sort(rng.random(12)), rng.random(12)
    assert bapps.voc_ap(rec, prec) == jbapps.voc_ap(rec, prec)
    # ties score 0.5
    assert bapps.score_2afc(lambda a, b: np.zeros(len(a)), bapps.TwoAFCDataset(afc, 32))[0] == 0.5
