"""The port's dsn_test CLI (CPU) against the JAX package's on one ``.tar``
written by JAX's ``save_dsn_tar``, with and without ``--save_realness``:
the same output names, equal PNGs, DDMs of shape (1, 1, h, w) within 1e-5. The port's own checkpoint directory (its latest
``{iter}.pt``) gives the ``.tar``'s outputs exactly; a directory without one
(an orbax directory) is refused."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.cli import dsn_test as jax_dsn_test
from dasr_tpu.nn.discriminators import FSDiscriminator as JFSD
from dasr_tpu.nn.generators import DeResnet as JDeResnet
from dasr_tpu.train import checkpoints as jck
from dasr_tpu_torch.cli import dsn_test
from dasr_tpu_torch.data.io import read_img_u8
from dasr_tpu_torch.nn.discriminators import FSDiscriminator
from dasr_tpu_torch.train import checkpoints as ck
from torch_dsn_corpus import write_dsn_corpus

NB = 2
DDM_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Three seeded targets of growing, ragged sizes, a JAX-written ``.tar``
    and the port's checkpoint directory with the same nets."""
    root = tmp_path_factory.mktemp("dsn_test")
    dirs = write_dsn_corpus(str(root / "corpus"), n_source=0, n_target=3, target=(61, 50),
                            n_val=0)
    g, d = JDeResnet(n_res_blocks=NB, scale=4), JFSD(d_arch="FSD", filter_type="avg_pool")
    gv = jax.tree.map(np.asarray, g.init(jax.random.key(3), jnp.zeros((1, 64, 64, 3))))
    dv = jax.tree.map(np.asarray, d.init(jax.random.key(4), jnp.zeros((1, 16, 16, 3))))
    tar = jck.save_dsn_tar(str(root / "last_iteration.tar"), gv, dv, n_res_blocks=NB)
    ckpt_dir = root / "checkpoints"
    ckpt_dir.mkdir()
    torch.save({"step": 3, "G": {"net": ck.deresnet_state_dict_from_jax(gv, NB, 4)},
                "D_target": {"net": ck.state_dict_from_jax(
                    FSDiscriminator(d_arch="FSD", filter_type="avg_pool"), dv)}},
               ckpt_dir / "3.pt")
    return root, dirs["target"], tar, str(ckpt_dir)


def _args(target, checkpoint, out, realness):
    return ["--checkpoint", checkpoint, "--input_dir", target, "--output_dir", out,
            "--num_res_blocks", str(NB), "--filter", "avg_pool",
            *(["--save_realness"] if realness else [])]


@pytest.mark.parametrize("realness", [False, True], ids=["images", "save_realness"])
def test_port_matches_the_jax_cli(case, realness):
    root, target, tar, _ = case
    tag = "ddm" if realness else "img"
    jout, out = str(root / f"jax_{tag}"), str(root / f"port_{tag}")
    jax_dsn_test.main(_args(target, tar, jout, realness))
    assert dsn_test.main([*_args(target, tar, out, realness), "--device", "cpu"]) == out
    names = sorted(os.listdir(jout))
    want = [f"t{i}.png" for i in range(3)] + ([f"t{i}_ddm.npy" for i in range(3)]
                                              if realness else [])
    assert names == sorted(os.listdir(out)) == sorted(want)
    for i in range(3):
        a = read_img_u8(os.path.join(out, f"t{i}.png")).astype(int)
        b = read_img_u8(os.path.join(jout, f"t{i}.png")).astype(int)
        lr = (-(-(61 + i) // 4), -(-(50 + 2 * i) // 4), 3)
        assert a.shape == b.shape == lr
        assert np.array_equal(a, b), (i, int((a != b).sum()))
        if realness:
            da, db = (np.load(os.path.join(o, f"t{i}_ddm.npy")) for o in (out, jout))
            assert da.shape == db.shape == (1, 1, *lr[:2])
            np.testing.assert_allclose(da, db, atol=DDM_ATOL, rtol=0)
            assert 0 <= da.min() and da.max() <= 1


def test_checkpoint_directory_equals_the_tar(case):
    root, target, tar, ckpt_dir = case
    outs = [str(root / name) for name in ("from_tar", "from_dir")]
    for ckpt, out in zip((tar, ckpt_dir), outs):
        dsn_test.main([*_args(target, ckpt, out, True), "--device", "cpu"])
    assert sorted(os.listdir(outs[0])) == sorted(os.listdir(outs[1]))
    for name in os.listdir(outs[0]):
        a, b = (os.path.join(o, name) for o in outs)
        if name.endswith(".npy"):
            assert np.array_equal(np.load(a), np.load(b)), name
        else:
            assert np.array_equal(read_img_u8(a), read_img_u8(b)), name


def test_directory_without_a_train_state_is_refused(case, tmp_path):
    _, target, _, _ = case
    orbax = tmp_path / "orbax"
    (orbax / "3").mkdir(parents=True)
    with pytest.raises(SystemExit, match="JAX-only"):
        dsn_test.main([*_args(target, str(orbax), str(tmp_path / "out"), False),
                       "--device", "cpu"])
