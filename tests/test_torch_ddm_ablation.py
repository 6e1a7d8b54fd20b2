"""The port's ``tools/ddm_ablation``: stages 3 and 5 on seeded arrays
against a literal numpy transcription of the repository's
``tools/ddm_ablation.py`` (:80-103, the DDM localization, and :147-153 with
:180-189, the region-split PSNRs) on the JAX package's image IO, metrics
and the repository's ``texture_mask``, within 1e-12; the whole tool once on
the CPU on a tiny textured corpus, with the module's width constants
shrunk: every stage's outputs, both runs' results, and ``--skip_*``
honoured. Without a card the tool raises unless given ``--device cpu``."""

import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

from dasr_tpu.data.io import list_images as jax_list_images
from dasr_tpu.data.io import read_img as jax_read_img
from dasr_tpu.eval.evaluate import to_uint8 as jax_to_uint8
from dasr_tpu.ops.metrics import calculate_psnr as jax_calculate_psnr
from dasr_tpu_torch.data.io import read_img, save_img
from dasr_tpu_torch.tools import ddm_ablation as abl
from dasr_tpu_torch.tools import make_synth_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "repo_tools_make_synth_corpus", os.path.join(REPO, "tools", "make_synth_corpus.py"))
ref_corpus = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_corpus)
texture_mask = ref_corpus.texture_mask
NITER = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stage3_transcribed(img_dir, ddm_dir):
    """tools/ddm_ablation.py:80-103, as written there."""
    corrs, means_t, means_f = [], [], []
    for f in sorted(jax_list_images(img_dir))[:40]:
        base = os.path.splitext(os.path.basename(f))[0]
        fake = jax_read_img(f)
        ddm = np.load(os.path.join(ddm_dir, base + ".npy"))[0, 0]
        m = texture_mask(fake)
        mh, mw = min(ddm.shape[0], m.shape[0]), min(ddm.shape[1], m.shape[1])
        d, m = ddm[:mh, :mw].ravel(), m[:mh, :mw].ravel()
        if d.std() > 1e-6 and m.std() > 1e-6:
            corrs.append(float(np.corrcoef(d, m)[0, 1]))
        means_t.append(float(d[m > 0.5].mean()) if (m > 0.5).any() else np.nan)
        means_f.append(float(d[m < 0.1].mean()) if (m < 0.1).any() else np.nan)
    return {
        "corr_ddm_vs_texture_mean": float(np.mean(corrs)) if corrs else None,
        "ddm_mean_textured": float(np.nanmean(means_t)),
        "ddm_mean_flat": float(np.nanmean(means_f)),
    }


def masked_psnr_transcribed(sr_u8, hr_u8, region):
    """tools/ddm_ablation.py:147-153."""
    d = (sr_u8.astype(np.float64) - hr_u8.astype(np.float64)) ** 2
    sel = d[region]
    if sel.size == 0:
        return float("nan")
    mse = sel.mean()
    return float(10 * np.log10(255.0**2 / mse)) if mse > 0 else float("inf")


def row_transcribed(sr, hr, lr):
    """tools/ddm_ablation.py:180-189 for one val image."""
    m = texture_mask(lr)
    h = min(sr.shape[0], hr.shape[0]); w = min(sr.shape[1], hr.shape[1])
    sr8, hr8 = jax_to_uint8(sr[:h, :w]), jax_to_uint8(hr[:h, :w])
    up = np.kron(m, np.ones((4, 4), np.float32))[:h, :w, None]
    up = np.broadcast_to(up, sr8.shape)
    return {
        "psnr_full": jax_calculate_psnr(sr8.astype(float), hr8.astype(float)),
        "psnr_degraded": masked_psnr_transcribed(sr8, hr8, up > 0.5),
        "psnr_clean": masked_psnr_transcribed(sr8, hr8, up < 0.1),
    }


def _close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if want[k] is None or np.isnan(want[k]):
            assert got[k] is None if want[k] is None else np.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


@pytest.mark.parametrize("case", ["textured", "with_degenerate_images"])
def test_stage3_matches_the_transcription(tmp_path, case):
    rng = np.random.default_rng(1)
    img_dir, ddm_dir = tmp_path / "imgs", tmp_path / "ddms"
    os.makedirs(img_dir), os.makedirs(ddm_dir)
    n = 5 if case == "textured" else 3
    for i in range(n):
        h, w = 40 + 3 * i, 52 + 2 * i
        fake = ref_corpus.synth_image(rng, h, w)
        # a DDM of the image's size give or take a pixel, smaller where textured
        ddm = 0.5 - 0.1 * texture_mask(fake) + rng.normal(0, 0.05, (h, w))
        ddm = ddm[: h - i % 2, : w + 1 - i % 2] if i % 2 else np.pad(ddm, ((0, 1), (0, 1)))
        if case != "textured" and i == 1:
            fake = np.full((h, w, 3), 0.4, np.float32)  # flat: no textured pixel
        if case != "textured" and i == 2:
            ddm = np.full_like(ddm, 0.3)  # constant DDM: no correlation
        save_img(fake, str(img_dir / f"f{i:02d}.png"))
        np.save(ddm_dir / f"f{i:02d}.npy", ddm[None, None].astype(np.float32))
    pairs = [(read_img(str(img_dir / f"f{i:02d}.png")),
              np.load(ddm_dir / f"f{i:02d}.npy")[0, 0]) for i in range(n)]
    got, want = abl.ddm_localization(pairs), stage3_transcribed(str(img_dir), str(ddm_dir))
    _close(got, want)
    assert want["corr_ddm_vs_texture_mean"] < 0


@pytest.mark.parametrize("case", ["ragged", "same_size", "flat_lr"])
def test_stage5_matches_the_transcription(case):
    rng = np.random.default_rng(2)
    lr = ref_corpus.synth_image(rng, 24, 30)
    if case == "flat_lr":
        lr = np.full_like(lr, 0.6)  # no degraded region: its PSNR is nan
    hr = np.clip(np.kron(lr, np.ones((4, 4, 1), np.float32)), 0, 1)
    grow = (3, 5) if case == "ragged" else (0, 0)
    sr = np.clip(np.pad(hr, ((0, grow[0]), (0, grow[1]), (0, 0)), mode="edge")
                 + rng.normal(0, 0.03, (96 + grow[0], 120 + grow[1], 3)).astype(np.float32),
                 -0.1, 1.1)
    _close(abl.region_psnrs(sr, hr, lr), row_transcribed(sr, hr, lr))
    a = rng.integers(0, 256, (8, 9, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (8, 9, 3), dtype=np.uint8)
    for region in (a > 128, np.zeros(a.shape, bool), np.ones(a.shape, bool)):
        got, want = abl.masked_psnr(a, b, region), masked_psnr_transcribed(a, b, region)
        assert got == want or (np.isnan(got) and np.isnan(want))
    assert abl.masked_psnr(a, a, a > 0) == float("inf")


@pytest.fixture(scope="module")
def ablation(tmp_path_factory):
    """The whole tool once on the CPU: a 3 + 4 + 2 textured corpus (targets
    128x160: stage 1's crop of 128 gives LPIPS alex its smallest input),
    DSN one epoch at batch 2, SRN at nf 8 nb 1, batch 2 + 2, HR 32,
    NITER iterations a run."""
    root = tmp_path_factory.mktemp("ablation")
    corpus, work = str(root / "corpus"), str(root / "work")
    make_synth_corpus.main(["--out", corpus, "--noise_mode", "textured", "--n_target", "3",
                            "--n_source", "4", "--n_valid", "2", "--hr_h", "128", "--hr_w",
                            "160", "--valid_h", "64", "--valid_w", "64", "--workers", "2"])
    with open(abl.TEMPLATE) as f:
        cfg = json.load(f)
    cfg["network_G"].update(nf=8, nb=1, gc=4)
    cfg["network_D"]["nf"] = 8
    cfg["datasets"]["train"].update(batch_size=2, HR_size=32, n_workers=1)
    template = str(root / "template.json")
    with open(template, "w") as f:
        json.dump(cfg, f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(abl, "TEMPLATE", template)
        mp.setattr(abl, "DSN_WIDTHS",
                   ["--batch_size", "2", "--num_workers", "1", "--crop_size", "128"])
        results = abl.main(["--corpus", corpus, "--work", work, "--dsn_epochs", "1",
                            "--niter", str(NITER), "--device", "cpu"])
    return corpus, work, results, template


def test_every_stage_writes_its_outputs(ablation):
    corpus, work, results, _ = ablation
    ckpts = os.listdir(os.path.join(work, "DSN_experiments", "dsn_abl", "checkpoints"))
    assert "last_iteration.tar" in ckpts and any(c.endswith(".pt") for c in ckpts)
    res = os.path.join(work, "DSN_results", "abl")
    targets = sorted(os.path.splitext(f)[0] for f in os.listdir(os.path.join(corpus, "target")))
    assert sorted(os.path.splitext(f)[0] for f in os.listdir(
        os.path.join(res, "imgs_from_target"))) == targets
    assert sorted(os.path.splitext(f)[0] for f in os.listdir(
        os.path.join(res, "ddm_target"))) == targets
    _close(results["ddm_stats"], stage3_transcribed(os.path.join(res, "imgs_from_target"),
                                                    os.path.join(res, "ddm_target")))
    for mw in ("on", "off"):
        name = f"abl_mw_{mw}"
        with open(os.path.join(work, f"{name}.json")) as f:
            cfg = json.load(f)
        assert cfg["multiweights"] == (mw == "on") and cfg["val_lpips"]
        assert (cfg["train"]["niter"], cfg["train"]["val_freq"]) == (NITER, NITER // 4)
        assert cfg["datasets"]["train"]["dataroot_fake_weights"] == os.path.join(
            res, "ddm_target")
        run = os.path.join(work, "SRN_experiments", name)
        assert os.path.exists(os.path.join(run, "training_state", f"{NITER}.pt"))
        with open(os.path.join(run, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        # one window of --steps_per_call 8 crosses val_freq: one validation
        assert len([r for r in recs if "val/psnr" in r]) == 1
    with open(os.path.join(work, "ablation_results.json")) as f:
        assert json.load(f) == results


def test_both_runs_have_finite_region_psnrs(ablation):
    results = ablation[2]
    assert set(results) == {"ddm_stats", "runs"}
    assert set(results["runs"]) == {"abl_mw_on", "abl_mw_off"}
    for agg in results["runs"].values():
        assert set(agg) == {"psnr_full", "psnr_degraded", "psnr_clean"}
        assert all(np.isfinite(v) for v in agg.values()), agg


def test_skip_flags_are_honoured(ablation, tmp_path, monkeypatch):
    corpus, work, results, template = ablation
    # stage 4 writes the runs' configs from the template whatever it skips
    monkeypatch.setattr(abl, "TEMPLATE", template)
    for cli in (abl.dsn_train, abl.dsn_create_dataset, abl.srn_train):
        monkeypatch.setattr(cli, "main", lambda argv, cli=cli: pytest.fail(
            f"{cli.__name__} ran under --skip_*"))
    skip = ["--skip_dsn", "--skip_dataset", "--skip_train", "--device", "cpu",
            "--niter", str(NITER), "--corpus", corpus]
    # the trained runs are evaluated again from their saved states
    again = abl.main(skip + ["--work", work])
    assert again == results
    # a work dir with stage 2's outputs only: stage 3 runs, no run is evaluated
    fresh = str(tmp_path / "work")
    shutil.copytree(os.path.join(work, "DSN_results"), os.path.join(fresh, "DSN_results"))
    only = abl.main(skip + ["--work", fresh])
    assert only == {"ddm_stats": results["ddm_stats"], "runs": {}}
    assert os.path.exists(os.path.join(fresh, "abl_mw_on.json"))


def test_raises_without_a_card_unless_given_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        abl.main(["--corpus", str(tmp_path), "--work", str(tmp_path / "w")])
