"""DDM-mechanism ablation through the port's CLIs: two otherwise-identical
DASR runs, ``multiweights`` on and off, on a corpus whose degradation is
confined to locally textured regions (``make_synth_corpus --noise_mode
textured``), so the domain gap can be located by content by the patch D.
The port of the repository's ``tools/ddm_ablation.py``, with its flags,
stages and ``ablation_results.json`` keys.

Stages (each through the port's production code):
  1. ``cli.dsn_train`` (the launcher's hyperparameters, scaled epochs) on
     the corpus;
  2. ``cli.dsn_create_dataset``: pseudo-LRs and their DDMs;
  3. DDM localization: the correlation between each fake LR's DDM and its
     texture mask, and the mean DDM inside and outside the texture (does
     the discriminator see the gap?);
  4. ``cli.srn_train`` twice (multiweights true / false, same seed, data
     and budget), validating PSNR, SSIM and LPIPS;
  5. region-split eval on the val set: PSNR inside the degraded (textured)
     region and inside the clean (flat) region, for both runs, from each
     run's latest ``training_state/{iter}.pt``.

A run with no saved state (``--skip_train`` before it was trained) is left
out of stage 5 with a line. Every stage runs on the card unless ``--device
cpu`` is given; without a card the tool raises.

    python -m dasr_tpu_torch.tools.ddm_ablation --corpus abl_corpus --work abl_work \\
        --dsn_epochs 30 --niter 4000
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from dasr_tpu_torch.cli import dsn_create_dataset, dsn_train, srn_train
from dasr_tpu_torch.core.config import dict_to_nonedict
from dasr_tpu_torch.core.device import resolve_device
from dasr_tpu_torch.data.io import list_images, read_img
from dasr_tpu_torch.eval.evaluate import to_uint8
from dasr_tpu_torch.models.registry import create_model
from dasr_tpu_torch.ops.metrics import calculate_psnr
from dasr_tpu_torch.tools.make_synth_corpus import texture_mask
from dasr_tpu_torch.train.checkpoints import latest_train_state

# stage 1's batch, loader and crop (the aim2019 launcher's); a test shrinks them
DSN_WIDTHS = ["--batch_size", "8", "--num_workers", "8", "--crop_size", "256"]
# stage 4's template: nf 64, nb 23, batch 6 + 6, HR 128; a test points it at a
# narrower copy
TEMPLATE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "train_DASR_auto_reproduce.json")
N_DDM = 40  # the fake LRs whose DDMs stage 3 reads


def ddm_localization(pairs) -> dict:
    """Stage 3 over (fake LR (H, W, 3) in [0, 1], its DDM (h, w)) pairs: the
    mean over images of corr(DDM, texture mask), and the mean DDM where the
    mask is above 0.5 (textured) and below 0.1 (flat)."""
    corrs, means_t, means_f = [], [], []
    for fake, ddm in pairs:
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


def masked_psnr(sr_u8: np.ndarray, hr_u8: np.ndarray, region: np.ndarray) -> float:
    """PSNR of uint8 images over the elements where ``region`` is true."""
    d = (sr_u8.astype(np.float64) - hr_u8.astype(np.float64)) ** 2
    sel = d[region]
    if sel.size == 0:
        return float("nan")
    mse = sel.mean()
    return float(10 * np.log10(255.0**2 / mse)) if mse > 0 else float("inf")


def region_psnrs(sr: np.ndarray, hr: np.ndarray, lr: np.ndarray) -> dict:
    """Stage 5 for one val image: the PSNR of SR against HR over the whole
    image, over LR's texture mask upscaled x4 (> 0.5, degraded) and outside
    it (< 0.1, clean)."""
    m = texture_mask(lr)
    h, w = min(sr.shape[0], hr.shape[0]), min(sr.shape[1], hr.shape[1])
    sr8, hr8 = to_uint8(sr[:h, :w]), to_uint8(hr[:h, :w])
    up = np.kron(m, np.ones((4, 4), np.float32))[:h, :w, None]
    up = np.broadcast_to(up, sr8.shape)
    return {
        "psnr_full": calculate_psnr(sr8.astype(float), hr8.astype(float)),
        "psnr_degraded": masked_psnr(sr8, hr8, up > 0.5),
        "psnr_clean": masked_psnr(sr8, hr8, up < 0.1),
    }


def _timed(stage: str, fn):
    t0 = time.perf_counter()
    out = fn()
    print(f"[ablation] {stage}: {time.perf_counter() - t0:.2f} s", flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--corpus", required=True, help="make_synth_corpus --out dir")
    p.add_argument("--work", required=True)
    p.add_argument("--dsn_epochs", type=int, default=30)
    p.add_argument("--niter", type=int, default=4000)
    p.add_argument("--skip_dsn", action="store_true")
    p.add_argument("--skip_dataset", action="store_true")
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run every stage on the GPU (hand-written kernels) or on the CPU")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    os.makedirs(args.work, exist_ok=True)
    src = os.path.join(args.corpus, "source")
    tgt = os.path.join(args.corpus, "target")
    vhr = os.path.join(args.corpus, "valid_hr")
    vlr = os.path.join(args.corpus, "valid_lr")
    exp = os.path.join(args.work, "DSN_experiments")
    res = os.path.join(args.work, "DSN_results")
    img_dir = os.path.join(res, "abl", "imgs_from_target")
    ddm_dir = os.path.join(res, "abl", "ddm_target")

    # --- stage 1: DSN (launcher hyperparams, scaled epochs) ---
    if not args.skip_dsn:
        _timed("stage 1 (dsn_train)", lambda: dsn_train.main([
            "--source_dir", src, "--target_dir", tgt,
            "--valid_hr_dir", vhr, "--valid_lr_dir", vlr,
            "--generator", "DeResnet", "--discriminator", "FSD",
            "--filter", "avg_pool", "--w_tex", "0.006", *DSN_WIDTHS,
            "--num_epochs", str(args.dsn_epochs),
            "--num_decay_epochs", str(max(1, args.dsn_epochs // 3)),
            "--val_interval", "10", "--save_model_interval", "10",
            "--transfer_uint8", "--device_bicubic",
            "--decode_cache_gb", "8",
            "--experiments_root", exp, "--save_path", "dsn_abl", "--device", args.device,
        ]))

    # --- stage 2: LR + DDM generation ---
    if not args.skip_dataset:
        _timed("stage 2 (dsn_create_dataset)", lambda: dsn_create_dataset.main([
            "--source_dir", src, "--target_dir", tgt,
            "--checkpoint", os.path.join(exp, "dsn_abl", "checkpoints"),
            "--generator", "DeResnet", "--discriminator", "FSD",
            "--filter", "avg_pool", "--name", "abl", "--results_root", res,
            "--transfer_uint8", "--device", args.device,
        ]))

    # --- stage 3: does the DDM localize the gap? ---
    def stage3():
        pairs = []
        for f in sorted(list_images(img_dir))[:N_DDM]:
            base = os.path.splitext(os.path.basename(f))[0]
            pairs.append((read_img(f), np.load(os.path.join(ddm_dir, base + ".npy"))[0, 0]))
        return ddm_localization(pairs)

    ddm_stats = _timed("stage 3 (DDM localization)", stage3)
    print("[ablation] DDM localization:", json.dumps(ddm_stats), flush=True)

    # --- stage 4: two DASR runs, multiweights on/off ---
    with open(TEMPLATE) as fh:
        base_cfg = json.load(fh)
    runs = {}
    for mw in (True, False):
        name = f"abl_mw_{'on' if mw else 'off'}"
        cfg = json.loads(json.dumps(base_cfg))
        cfg["name"] = name
        cfg["multiweights"] = mw
        cfg["val_lpips"] = True
        cfg["datasets"]["train"].update(
            dataroot_HR=tgt, dataroot_fake_LR=img_dir, dataroot_real_LR=src,
            dataroot_fake_weights=ddm_dir,
        )
        cfg["datasets"]["val"].update(dataroot_HR=vhr, dataroot_LR=vlr)
        cfg["path"]["root"] = os.path.join(args.work, "SRN_experiments")
        cfg["train"]["niter"] = args.niter
        cfg["train"]["val_freq"] = max(1, args.niter // 4)
        cfg["logger"]["save_checkpoint_freq"] = args.niter
        cfg["max_val_images"] = 8
        cfg_path = os.path.join(args.work, f"{name}.json")
        with open(cfg_path, "w") as fh:
            json.dump(cfg, fh, indent=1)
        if not args.skip_train:
            _timed(f"stage 4 (srn_train {name})", lambda: srn_train.main(
                ["-opt", cfg_path, "--steps_per_call", "8",
                 "--transfer_uint8", "--decode_cache_gb", "8", "--device", args.device]))
        runs[name] = os.path.join(args.work, "SRN_experiments", name)

    # --- stage 5: region-split eval on the val set ---
    results = {"ddm_stats": ddm_stats, "runs": {}}
    hr_files = sorted(list_images(vhr))
    lr_files = sorted(list_images(vlr))
    t0 = time.perf_counter()
    for name, root in runs.items():
        state = latest_train_state(os.path.join(root, "training_state"))
        if state is None:
            print(f"[ablation] {name}: no training_state/{{iter}}.pt under {root}; "
                  "not evaluated", flush=True)
            continue
        # the run's own config, with G from its latest train state
        with open(os.path.join(args.work, f"{name}.json")) as fh:
            eval_cfg = json.load(fh)
        eval_cfg["chop"] = False
        eval_cfg["path"]["pretrain_model_G"] = state
        eval_cfg["path"]["root"] = root
        model = create_model(dict_to_nonedict(eval_cfg), device).init().load()
        rows = []
        for hf, lf in zip(hr_files, lr_files):
            hr, lr = read_img(hf), read_img(lf)
            rows.append(region_psnrs(model.test(lr), hr, lr))
        agg = {k: float(np.nanmean([r[k] for r in rows])) for k in rows[0]}
        results["runs"][name] = agg
        print(f"[ablation] {name}: {json.dumps(agg)}", flush=True)
    print(f"[ablation] stage 5 (region-split eval): {time.perf_counter() - t0:.2f} s",
          flush=True)

    out = os.path.join(args.work, "ablation_results.json")
    with open(out, "w") as fh:
        json.dump(results, fh, indent=1)
    print(f"[ablation] wrote {out}", flush=True)
    return results


if __name__ == "__main__":
    main()
