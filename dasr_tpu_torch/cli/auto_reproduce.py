"""End-to-end reproduction orchestrator of the port (reference:
codes/Auto_Reproduce.py) — ``python -m dasr_tpu_torch.cli.auto_reproduce
--dataset aim2019 --artifact tdsr [--device cuda]``, with the stages,
launcher argument sets, derived stage-3 JSON and smoke knobs of
``dasr_tpu.cli.auto_reproduce``, run in-process:

  1. DSN GAN training with the launcher hyperparameters
     (codes/DSN/auto_reproduce_launcher_{aim2019,realsr}.sh: aim2019 =
     DeResnet + FSD + avg_pool, w_tex 0.006, batch 8, crop 256; realsr the
     same with w_tex 0.005 and crop 128);
  2. pseudo-LR + DDM generation from stage 1's checkpoint directory;
  3. SRN/DASR training from a config derived like ``create_auto_json``
     (Auto_Reproduce.py:8-27): the template JSON with the HR / fake / real
     / weights paths rewired from paths.yml and the stage-2 outputs.

The stages hand over through files (PNG, NPY, checkpoints), as the
reference's do. The fast path is the JAX package's: DSN ``--transfer_uint8
--device_bicubic --device_bank --decode_cache_gb 24``; SRN
``--steps_per_call 8 --transfer_uint8 --device_bank --decode_cache_gb 24``
with ``val_device_metrics`` and ``val_metrics_pad_bucket: 128`` in the
derived config unless the template sets them.

On N cards, under ``python -m torch.distributed.run --nproc_per_node N -m
dasr_tpu_torch.cli.auto_reproduce ...``, every rank runs the three stages:
stages 1 and 3 train over the ranks (each prints its ``[mesh]`` line on
rank 0), stage 2 runs with ``--mesh N``, and rank 0 alone writes the
derived JSON and the logs.
"""

from __future__ import annotations

import argparse
import json
import os
import time

# launcher hyperparameters per dataset (the reference's .sh files)
LAUNCHER_ARGS = {
    "aim2019": [
        "--dataset", "aim2019", "--artifacts", "tdsr",
        "--generator", "DeResnet", "--discriminator", "FSD",
        "--filter", "avg_pool", "--w_tex", "0.006",
        "--batch_size", "8", "--num_workers", "8", "--crop_size", "256",
    ],
    "realsr": [
        "--dataset", "realsr", "--artifacts", "tdrealsr",
        "--generator", "DeResnet", "--discriminator", "FSD",
        "--filter", "avg_pool", "--w_tex", "0.005",
        "--batch_size", "8", "--num_workers", "8", "--crop_size", "128",
    ],
}

_CREATE_DATASET_NAME = {"aim2019": "aim2019", "realsr": "realsr_tdrealsr"}


def main(argv=None):
    p = argparse.ArgumentParser(description="Auto Reproduce Script")
    p.add_argument("--dataset", required=True, choices=["aim2019", "realsr"])
    p.add_argument("--artifact", required=True, type=str)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run every stage on the GPU or on the CPU (plain PyTorch)")
    p.add_argument("--paths_yml", default=None, type=str)
    p.add_argument("--work_root", default="../../", type=str)
    p.add_argument("--num_epochs", type=int, default=None,
                   help="override DSN epochs (for smoke runs)")
    p.add_argument("--niter", type=int, default=None,
                   help="override SRN iterations (for smoke runs)")
    p.add_argument("--skip_dsn", action="store_true")
    p.add_argument("--skip_dataset", action="store_true")
    p.add_argument("--no_fast_path", action="store_true",
                   help="leave out the fast path (uint8 transfer, in-step bicubic, device "
                        "banks, K-step windows, device val metrics, decode cache) and the "
                        "DSN stage's bf16: run fully plain f32")
    p.add_argument("--srn_template", default=None,
                   help="the stage-3 config template JSON (default: "
                        "dasr_tpu_torch/configs/train_DASR_auto_reproduce.json)")
    p.add_argument("--dsn_extra", default="",
                   help="extra dsn_train args after the launcher set, whitespace-split")
    p.add_argument("--dsn_create_extra", default="",
                   help="extra dsn_create_dataset args (mirror any architecture overrides "
                        "of --dsn_extra, e.g. '--num_res_blocks 2')")
    args = p.parse_args(argv)

    from dasr_tpu_torch.cli import dsn_create_dataset, dsn_train, srn_train
    from dasr_tpu_torch.core import dist
    from dasr_tpu_torch.core.config import dataset_paths
    from dasr_tpu_torch.core.device import resolve_device

    world = dist.init_world(resolve_device(args.device))
    stage_times = {}

    def tick(stage, t0):
        stage_times[stage] = dt = time.time() - t0
        if world.is_main:
            print(f"[auto_reproduce] stage '{stage}' wall-clock: {dt:.1f} s", flush=True)

    paths_yml = args.paths_yml or os.path.join(os.path.dirname(__file__), "..", "..",
                                               "paths.yml")
    exp_root = os.path.join(args.work_root, "DSN_experiments")
    res_root = os.path.join(args.work_root, "DSN_results")
    save_name = f"0603_DSN_{args.dataset}"
    lrs_name = f"0603_DSN_LRs_{args.dataset}"
    device = ["--device", args.device]

    # --- stage 1: DSN training ---
    if not args.skip_dsn:
        t0 = time.time()
        dsn_args = list(LAUNCHER_ARGS[args.dataset]) + device + [
            "--paths_yml", paths_yml, "--experiments_root", exp_root, "--save_path", save_name,
        ]
        if args.num_epochs:
            dsn_args += ["--num_epochs", str(args.num_epochs),
                         "--num_decay_epochs", str(max(1, args.num_epochs // 3))]
        if args.no_fast_path:
            dsn_args += ["--no_bf16"]
        else:
            dsn_args += ["--transfer_uint8", "--device_bicubic", "--device_bank",
                         "--decode_cache_gb", "24"]
        dsn_train.main(dsn_args + args.dsn_extra.split())
        tick("dsn_train", t0)

    # --- stage 2: LR + DDM generation ---
    if not args.skip_dataset:
        t0 = time.time()
        dsn_create_dataset.main(
            ["--dataset", _CREATE_DATASET_NAME[args.dataset],
             "--checkpoint", os.path.join(exp_root, save_name, "checkpoints"),
             "--generator", "DeResnet", "--discriminator", "FSD", "--filter", "avg_pool",
             "--name", lrs_name, "--paths_yml", paths_yml, "--results_root", res_root]
            + (["--mesh", str(world.size)] if world.size > 1 else [])
            + device + args.dsn_create_extra.split())
        tick("dsn_create_dataset", t0)

    # --- stage 3: SRN/DASR training from a derived config ---
    reg = dataset_paths(paths_yml, args.dataset, args.artifact)
    template = args.srn_template or os.path.join(
        os.path.dirname(__file__), "..", "configs", "train_DASR_auto_reproduce.json")
    with open(template) as f:
        config = json.load(f)
    config["name"] = f"0603_DASR_SRN_auto_reproduce_{args.dataset}"
    train = config["datasets"]["train"]
    train["dataroot_HR"] = reg["target"]
    train["dataroot_fake_LR"] = os.path.join(res_root, lrs_name, "imgs_from_target")
    train["dataroot_real_LR"] = reg["source"]
    train["dataroot_fake_weights"] = os.path.join(res_root, lrs_name, "ddm_target")
    config["datasets"]["val"]["dataroot_HR"] = reg["valid_hr"]
    config["datasets"]["val"]["dataroot_LR"] = reg["valid_lr"]
    config["path"]["root"] = os.path.join(args.work_root, "SRN_experiments")
    if args.niter:
        config["train"]["niter"] = args.niter
        config["train"]["val_freq"] = max(1, args.niter // 4)
        config["logger"]["save_checkpoint_freq"] = max(1, args.niter // 2)
    if not args.no_fast_path:
        config.setdefault("val_device_metrics", True)
        config.setdefault("val_metrics_pad_bucket", 128)
    derived = os.path.join(args.work_root, f"train_DASR_auto_reproduce_{args.dataset}.json")
    if world.is_main:
        os.makedirs(os.path.dirname(os.path.abspath(derived)), exist_ok=True)
        with open(derived, "w") as f:
            json.dump(config, f, indent=1)
    world.barrier()
    t0 = time.time()
    srn_args = ["-opt", derived] + device
    if not args.no_fast_path:
        srn_args += ["--steps_per_call", "8", "--transfer_uint8", "--device_bank",
                     "--decode_cache_gb", "24"]
    srn_train.main(srn_args)
    tick("srn_train", t0)
    total = sum(stage_times.values())
    if world.is_main:
        print("[auto_reproduce] TOTAL wall-clock: "
              f"{total:.1f} s ({total / 3600:.2f} h) - "
              + ", ".join(f"{k}={v:.1f}s" for k, v in stage_times.items()), flush=True)
    return stage_times


if __name__ == "__main__":
    main()
