"""The port's device banks (dasr_tpu_torch/data/device_bank.py) on the CPU:
bank building against the JAX package's ``build_bank`` / ``build_ddm_bank``
(exact); the gathers fed JAX's own draws against ``sample_dsn_batch`` and
``sample_dasr_batch`` (exact: uint8 crops, f32 / 255, DDM crops); the fast
gathers against their plain per-item versions (exact); the sampling law
(offsets uniform over the valid range, picks uniform, the eight dihedral
variants); the epoch order against the JAX CLI's expression and the host
Loader's; the uint8 DASR batch against the f32 one.

Departs from ``dasr_tpu`` on purpose: the host cache of ``build_bank`` keys
on each file's path, mtime and size (ADVICE.md:3; the JAX package keys on
the paths only and serves a stale bank after a file is rewritten)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.data import device_bank as jbank
from dasr_tpu_torch.data import device_bank as bank
from dasr_tpu_torch.data.datasets import DASRUnpairedDataset
from dasr_tpu_torch.data.io import save_img
from dasr_tpu_torch.data.pipeline import Loader

SCALE, HR_SIZE, LR = 4, 32, 8


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
    """Images of different sizes (the banks pad them): 3 fake LRs, their 3
    HRs at x4, 2 real LRs, 3 DDM maps at half the fake size."""
    root = tmp_path_factory.mktemp("bank")
    rng = np.random.default_rng(11)
    dirs = {k: root / k for k in ("fake", "hr", "real", "ddm")}
    for d in dirs.values():
        d.mkdir()
    for i, (h, w) in enumerate(((10, 12), (9, 14), (12, 9))):
        save_img(rng.random((h, w, 3), dtype=np.float32), str(dirs["fake"] / f"{i}.png"))
        save_img(rng.random((4 * h, 4 * w, 3), dtype=np.float32), str(dirs["hr"] / f"{i}.png"))
        np.save(dirs["ddm"] / f"{i}.npy", rng.random((1, 1, h // 2, w // 2), dtype=np.float32))
    for i, (h, w) in enumerate(((11, 8), (8, 13))):
        save_img(rng.random((h, w, 3), dtype=np.float32), str(dirs["real"] / f"{i}.png"))
    return {k: str(v) for k, v in dirs.items()}


def _ddm_files(corpus):
    return sorted(os.path.join(corpus["ddm"], f) for f in os.listdir(corpus["ddm"]))


@pytest.fixture(scope="module")
def host_banks(corpus):
    fake = bank.build_bank(corpus["fake"], min_size=LR)
    return bank.SrnBanks(fake, bank.build_bank(corpus["hr"], min_size=HR_SIZE),
                         bank.build_bank(corpus["real"], min_size=LR),
                         bank.build_ddm_bank(_ddm_files(corpus), fake.sizes))


@pytest.fixture(scope="module")
def banks(host_banks):
    return bank.SrnBanks(*(bank.upload(b, "cpu") for b in host_banks))


def test_build_bank_matches_jax(corpus, host_banks):
    for name, got in zip(("fake", "hr", "real"), host_banks[:3]):
        want = jbank.build_bank(corpus[name])
        assert got.data.dtype == np.uint8 and got.sizes.dtype == np.int32
        np.testing.assert_array_equal(got.data, want.data, err_msg=name)
        np.testing.assert_array_equal(got.sizes, want.sizes, err_msg=name)
        assert bank.bank_nbytes(corpus[name]) == jbank.bank_nbytes(corpus[name]) == got.data.nbytes
        assert bank.bank_min_hw(corpus[name]) == jbank.bank_min_hw(corpus[name])
    # padding is zero, the content is the decoded image
    assert host_banks.fake.data[0, 10:].sum() == 0 and host_banks.fake.data[0, :10, :12].any()
    want = jbank.build_ddm_bank(_ddm_files(corpus), host_banks.fake.sizes)
    np.testing.assert_array_equal(host_banks.ddm.data, want.data)
    np.testing.assert_array_equal(host_banks.ddm.sizes, want.sizes)
    assert host_banks.ddm.data.shape == (3, 12, 14, 1)


def test_build_bank_min_size_guard(corpus):
    for build in (bank.build_bank, jbank.build_bank):
        with pytest.raises(ValueError, match="smaller than the 10px crop"):
            build(corpus["fake"], min_size=10)


def test_build_bank_cache_keys_on_mtime_and_size(tmp_path, monkeypatch):
    """A cached bank is served while its files are unchanged and rebuilt
    once one is rewritten at the same path (ADVICE.md:3)."""
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        save_img(rng.random((8, 8, 3), dtype=np.float32), str(d / f"{i}.png"))
    monkeypatch.setenv("DASR_BANK_HOST_CACHE", str(tmp_path / "cache"))
    first = bank.build_bank(str(d))
    again = bank.build_bank(str(d))
    assert isinstance(again.data, np.memmap)
    np.testing.assert_array_equal(again.data, first.data)
    save_img(np.zeros((8, 8, 3), np.float32), str(d / "1.png"))
    os.utime(d / "1.png", ns=(1, 1))
    fresh = bank.build_bank(str(d))
    assert not isinstance(fresh.data, np.memmap) and fresh.data[1].sum() == 0
    np.testing.assert_array_equal(fresh.data[0], first.data[0])


def _jax_bank(b):
    return jbank.ImageBank(jnp.asarray(b.data), jnp.asarray(b.sizes))


def _jax_dasr_draws(key, b, n_real, n_hr):
    """The draws of ``sample_dasr_batch`` (dasr_tpu/data/device_bank.py:
    271-312), split out of its key as it splits them."""
    parts = {k: [] for k in bank.DasrDraws._fields}
    for k in jax.random.split(key, b):
        ks = jax.random.split(k, 6)
        parts["fake_u"].append(jax.random.uniform(ks[0], (2,)))
        parts["real_pick"].append(jax.random.randint(ks[1], (), 0, n_real, dtype=jnp.int32))
        parts["real_u"].append(jax.random.uniform(ks[2], (2,)))
        parts["hr_pick"].append(jax.random.randint(ks[3], (), 0, n_hr, dtype=jnp.int32))
        parts["unpair_u"].append(jax.random.uniform(ks[4], (2,)))
        parts["aug"].append(jax.random.uniform(ks[5], (3,)) < 0.5)
    return bank.DasrDraws(**{k: torch.from_numpy(np.stack([np.asarray(v) for v in vs]))
                             for k, vs in parts.items()})


def _jax_dsn_draws(key, b, n_clean):
    """The draws of ``sample_dsn_batch`` (:201-212) and its two
    ``sample_crops`` (:162-179)."""
    k_pick, k_clean, k_noisy = jax.random.split(key, 3)
    pick = jax.random.randint(k_pick, (b,), 0, n_clean, dtype=jnp.int32)

    def crops(k):
        us, augs = [], []
        for kk in jax.random.split(k, b):
            k_off, k_aug = jax.random.split(kk)
            us.append(np.asarray(jax.random.uniform(k_off, (2,))))
            augs.append(np.asarray(jax.random.uniform(k_aug, (3,)) < 0.5))
        return torch.from_numpy(np.stack(us)), torch.from_numpy(np.stack(augs))

    (cu, ca), (nu, na) = crops(k_clean), crops(k_noisy)
    return bank.DsnDraws(torch.from_numpy(np.array(pick)), cu, nu, ca, na)


def _all_set_key(b, draws_of, aug_fields):
    """The first key whose draws set every augment bit of the batch."""
    for s in range(500):
        d = draws_of(jax.random.key(s))
        if all(bool(getattr(d, f).all()) for f in aug_fields):
            return jax.random.key(s)
    raise AssertionError("no key sets every augment bit")


FLAGS = [(True, True), (True, False), (False, True), (False, False), "all_bits"]


@pytest.mark.parametrize("flags", FLAGS, ids=["flip_rot", "flip", "rot", "none", "all_bits"])
def test_gather_dasr_on_jax_draws_equals_jax(host_banks, banks, flags):
    # every bit set: 3 of them an item, so a short batch keeps the key search short
    idx = np.array([0, 2] if flags == "all_bits" else [0, 2, 1, 2], np.int32)
    n_real, n_hr = host_banks.real.data.shape[0], host_banks.hr.data.shape[0]
    if flags == "all_bits":
        key = _all_set_key(len(idx), lambda k: _jax_dasr_draws(k, len(idx), n_real, n_hr),
                           ("aug",))
        use_flip = use_rot = True
    else:
        key, (use_flip, use_rot) = jax.random.key(3), flags
    want = jbank.sample_dasr_batch(*(_jax_bank(b) for b in host_banks), jnp.asarray(idx), key,
                                   HR_SIZE, SCALE, use_flip, use_rot)
    draws = _jax_dasr_draws(key, len(idx), n_real, n_hr)
    got = bank.gather_dasr(banks, torch.from_numpy(idx), draws, HR_SIZE, SCALE, use_flip,
                           use_rot)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("flags", FLAGS, ids=["flip_rot", "flip", "rot", "none", "all_bits"])
def test_gather_dsn_on_jax_draws_equals_jax(host_banks, banks, flags):
    """The HR bank as the clean one, the fake LRs as the noisy one."""
    clean, noisy = host_banks.hr, host_banks.fake
    idx = np.array([2] if flags == "all_bits" else [2, 0, 1], np.int32)
    crop = 30  # cut to 28, a multiple of the scale, as the sampler does
    if flags == "all_bits":
        key = _all_set_key(len(idx), lambda k: _jax_dsn_draws(k, len(idx), 3),
                           ("clean_aug", "noisy_aug"))
        flips = rotations = True
    else:
        key, (flips, rotations) = jax.random.key(5), flags
    want = jbank.sample_dsn_batch(_jax_bank(clean), _jax_bank(noisy), jnp.asarray(idx), key,
                                  crop, SCALE, flips, rotations)
    got = bank.gather_dsn(banks.hr, banks.fake, torch.from_numpy(idx),
                          _jax_dsn_draws(key, len(idx), 3), crop, SCALE, flips, rotations)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.uint8 and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("flags", [(True, True), (True, False), (False, True), "all_bits"],
                         ids=["flip_rot", "flip", "rot", "all_bits"])
def test_fast_gather_equals_plain(banks, flags):
    gen = torch.Generator().manual_seed(0)
    use_flip, use_rot = (True, True) if flags == "all_bits" else flags
    for _ in range(3):
        idx = torch.randint(0, 3, (6,), generator=gen)
        d = bank.draw_dasr(gen, 6, 2, 3)
        dn = bank.draw_dsn(gen, 6, 3)
        if flags == "all_bits":
            d = d._replace(aug=torch.ones_like(d.aug))
            dn = dn._replace(clean_aug=torch.ones_like(dn.clean_aug),
                             noisy_aug=torch.ones_like(dn.noisy_aug))
        got, want = (f(banks, idx, d, HR_SIZE, SCALE, use_flip, use_rot)
                     for f in (bank.gather_dasr, bank.gather_dasr_plain))
        for k in want:
            assert torch.equal(got[k], want[k]), k
        got, want = (f(banks.hr, banks.fake, idx, dn, 28, SCALE, use_flip, use_rot)
                     for f in (bank.gather_dsn, bank.gather_dsn_plain))
        for k in want:
            assert torch.equal(got[k], want[k]), k
    # without a DDM bank the weights are ones (the online-weights law)
    nod = banks._replace(ddm=None)
    got = bank.gather_dasr(nod, idx, d, HR_SIZE, SCALE)
    assert torch.equal(got["fake_w"], torch.ones(6, LR, LR, 1))
    assert torch.equal(got["fake_w"], bank.gather_dasr_plain(nod, idx, d, HR_SIZE, SCALE)["fake_w"])


def _posimg(h, w):
    """uint8 image whose channels hold the pixel's row and column."""
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([y, x, np.full_like(y, 7)], -1).astype(np.uint8)


def _one(img):
    return bank.ImageBank(torch.from_numpy(img[None]),
                          torch.tensor([img.shape[:2]], dtype=torch.int32))


def test_crop_offsets_law():
    """(top, left) uniform over [0, size - crop], every value reached (the
    host loader's rng.integers(0, dim - crop + 1); tests/test_device_bank.py
    :81 for JAX)."""
    gen = torch.Generator().manual_seed(1)
    clean, noisy = _one(_posimg(40, 44)), _one(_posimg(12, 13))
    out = bank.gather_dsn(clean, noisy, torch.zeros(4000, dtype=torch.long),
                          bank.draw_dsn(gen, 4000, 1), 32, 4)
    for key, (h, w), crop in (("input", (40, 44), 32), ("disc", (12, 13), 8)):
        tl = out[key][:, 0, 0, :2].long().numpy()
        for col, span in ((0, h - crop + 1), (1, w - crop + 1)):
            counts = np.bincount(tl[:, col], minlength=span)
            assert len(counts) == span and (counts > 0).all(), (key, col)
            assert counts.max() < 1.5 * counts.min(), (key, col, counts)


def test_aligned_offsets_law():
    """The fake-LR window is uniform over the joint valid range of the pair
    (datasets._rand_crop_aligned), its HR window is x4 of it and its DDM
    window the same."""
    gen = torch.Generator().manual_seed(2)
    y, x = np.mgrid[0:36, 0:44]
    hr = np.stack([y // 4, x // 4, np.full_like(y, 7)], -1).astype(np.uint8)
    ddm = (_posimg(12, 11)[..., :1] * 100.0 + _posimg(12, 11)[..., 1:2]).astype(np.float32)
    banks = bank.SrnBanks(_one(_posimg(12, 11)), _one(hr), _one(_posimg(8, 8)), _one(ddm))
    n = 3000
    out = bank.gather_dasr(banks, torch.zeros(n, dtype=torch.long), bank.draw_dasr(gen, n, 1, 1),
                           32, 4, False, False)
    t = np.round(out["LR_fake"][:, 0, 0, 0].numpy() * 255).astype(int)
    lft = np.round(out["LR_fake"][:, 0, 0, 1].numpy() * 255).astype(int)
    # rows: min(12 - 8, (36 - 32) // 4) = 1; columns: min(11 - 8, (44 - 32) // 4) = 3
    assert set(t) == {0, 1} and set(lft) == {0, 1, 2, 3}
    for v in (t, lft):
        counts = np.bincount(v)
        assert counts.max() < 1.3 * counts.min()
    np.testing.assert_array_equal(np.round(out["HR"][:, 0, 0, 0].numpy() * 255), t)
    np.testing.assert_array_equal(np.round(out["HR"][:, 0, 0, 1].numpy() * 255), lft)
    np.testing.assert_array_equal(out["fake_w"][:, 0, 0, 0].numpy(), t * 100 + lft)


def test_picks_law():
    """The real-LR and unpaired-HR picks are uniform over their banks
    whatever the fake index (tests/test_srn_device_bank.py:151 for JAX),
    and the DSN clean pick over the clean bank."""
    gen = torch.Generator().manual_seed(3)
    real = np.stack([np.full((8, 8, 3), i, np.uint8) for i in range(5)])
    hr = np.stack([np.full((32, 32, 3), 10 + i, np.uint8) for i in range(4)])

    def stack(d, hw):
        return bank.ImageBank(torch.from_numpy(d), torch.full((len(d), 2), hw, dtype=torch.int32))

    banks = bank.SrnBanks(stack(np.zeros((4, 8, 8, 3), np.uint8), 8), stack(hr, 32),
                          stack(real, 8), None)
    n = 4000
    out = bank.gather_dasr(banks, torch.arange(n) % 4, bank.draw_dasr(gen, n, 5, 4), 32, 4)
    dsn = bank.gather_dsn(stack(hr, 32), stack(real, 8), torch.zeros(n, dtype=torch.long),
                          bank.draw_dsn(gen, n, 4), 32, 4)
    for x, base, m in ((out["LR_real"] * 255, 0, 5), (out["HR_unpair"] * 255, 10, 4),
                       (dsn["input"], 10, 4)):
        picks = np.round(x[:, 0, 0, 0].float().numpy()).astype(int) - base
        share = np.bincount(picks, minlength=m) / n
        assert len(share) == m and np.abs(share - 1 / m).max() < 0.03, share


def test_augment_law():
    """Each of the eight dihedral variants of an image appears, each bit
    about half the time, one draw for all five tensors of an item."""
    gen = torch.Generator().manual_seed(4)
    img = np.arange(4 * 4 * 3, dtype=np.uint8).reshape(4, 4, 3)
    hr = np.kron(img, np.ones((4, 4, 1), np.uint8))
    banks = bank.SrnBanks(_one(img), _one(hr), _one(img), None)
    d = bank.draw_dasr(gen, 800, 1, 1)
    out = bank.gather_dasr(banks, torch.zeros(800, dtype=torch.long), d, 16, 4)
    variants = {out["LR_fake"][i].numpy().tobytes() for i in range(800)}
    assert len(variants) == 8
    assert np.abs(d.aug.float().mean(0).numpy() - 0.5).max() < 0.06
    # the HR crop is the LR crop's x4 under the same augment
    want_hr = out["LR_fake"].repeat_interleave(4, 1).repeat_interleave(4, 2)
    assert torch.equal(out["HR"], want_hr)
    assert torch.equal(out["LR_real"], out["LR_fake"])


def test_epoch_rows_follow_the_jax_cli_and_the_loader():
    """The JAX CLIs' expression (dasr_tpu/cli/srn_train.py:262-269), and the
    host Loader's order of the same epoch, drop_last."""

    class Items:
        def __len__(self):
            return 11

        def __getitem__(self, i, rng=None):
            return {"i": np.array([i])}

    for seed, epoch in ((0, 0), (3, 5)):
        rows = bank.epoch_rows(seed, epoch, 11, 3)
        perm = np.random.default_rng((seed, epoch)).permutation(11).astype(np.int32)
        want = [perm[s * 3:(s + 1) * 3] for s in range(11 // 3)]
        assert len(rows) == 3 and all(np.array_equal(a, b) for a, b in zip(rows, want))
        loader = Loader(Items(), batch_size=3, num_workers=1, seed=seed)
        loader.set_epoch(epoch)
        assert [list(b["i"][:, 0]) for b in loader] == [list(r) for r in rows]
    assert [list(r) for r in bank.epoch_rows(0, 0, 5, 2, shuffle=False)] == [[0, 1], [2, 3]]


def test_window_generator_replays_a_window():
    a = torch.rand(5, generator=bank.window_generator(3, 40, "cpu"))
    b = torch.rand(5, generator=bank.window_generator(3, 40, "cpu"))
    c = torch.rand(5, generator=bank.window_generator(3, 48, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_uint8_batch_equals_f32_batch(corpus):
    """DASRUnpairedDataset with transfer_uint8, cast as the facade casts it,
    equals the f32 batch exactly (8-bit sources)."""
    opt = {"phase": "train", "scale": SCALE, "HR_size": HR_SIZE, "dataroot_HR": corpus["hr"],
           "dataroot_fake_LR": corpus["fake"], "dataroot_real_LR": corpus["real"],
           "dataroot_fake_weights": corpus["ddm"]}
    f32, u8 = DASRUnpairedDataset(opt), DASRUnpairedDataset({**opt, "transfer_uint8": True})
    for i in range(3):
        a = f32.__getitem__(i, np.random.default_rng(i))
        b = u8.__getitem__(i, np.random.default_rng(i))
        for k in ("LR_fake", "LR_real", "HR", "HR_unpair"):
            assert b[k].dtype == np.uint8 and a[k].dtype == np.float32
            cast = (torch.from_numpy(b[k]).float() / 255.0).numpy()
            np.testing.assert_array_equal(cast, a[k], err_msg=k)
        np.testing.assert_array_equal(b["fake_w"], a["fake_w"])
