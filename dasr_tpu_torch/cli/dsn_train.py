"""DSN training CLI of the port (stage 1) — ``python -m
dasr_tpu_torch.cli.dsn_train --dataset aim2019 --artifacts tdsr ...
[--device cuda]``, with the flags of ``dasr_tpu.cli.dsn_train`` (mirroring
codes/DSN/train.py:24-73).

Epoch loop on the host loader (threads, pinned memory): crops as uint8
with ``--transfer_uint8`` (cast on the device), the bicubic target in the
step with ``--device_bicubic``, the decoded-image cache with
``--decode_cache_gb``. ``--device_bank`` keeps both corpora on the card
and samples every batch there (uint8 crops, the bicubic in the step),
unless they exceed ``--device_bank_gb``, hold an image smaller than its
crop or fewer noisy images than one batch; each epoch's order is
``np.random.default_rng((seed, epoch)).permutation(n)`` with
``drop_last``. ``--steps_per_call K`` trains windows of K steps (k = 1
windows when ``disc_freq`` or ``gen_freq`` is not 1); windows run across
epoch ends, and a last partial one runs after the last epoch. Metrics are
read from the card only for a window that crosses a 50-iteration
boundary, one window late so the queue stays full, checked finite there
and written to ``metrics.jsonl`` and TensorBoard; the last window's are
written at the end. Every ``val_interval`` epochs the PSNR of
the generator's output against the bicubic over at most 16 validation
images; every ``val_img_interval`` epochs image dumps under
``val_images/``; every ``save_model_interval`` epochs and at the end the
whole train state as ``checkpoints/{iter}.pt``, and at the end the
reference-format ``checkpoints/last_iteration.tar``. ``--checkpoint``
resumes from the port's own saves (a ``{iter}.pt`` or its directory).

On N cards: ``python -m torch.distributed.run --nproc_per_node N -m
dasr_tpu_torch.cli.dsn_train ...`` (``core/dist.py``). Each rank loads (or,
with ``--device_bank``, gathers from its whole copy of the banks) its rows
of each global batch of ``--batch_size``, which N must divide; an N-rank
step equals the 1-rank step on the global batch. Rank 0 prints the
``[mesh] data=N spatial=1`` line, and alone writes the logs, the metrics
and the saves and validates, the others waiting.

``--packed_trunk`` is a TPU rewrite of the same function, accepted and
ignored.
``--lpips_rot_flip`` is parsed and never read, as in the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os

LOG_EVERY = 50  # iterations between metric reads (the reference asserts at log time)


def build_argparser():
    p = argparse.ArgumentParser(description="Train Downscaling Models")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="train on the GPU or on the CPU (plain PyTorch)")
    p.add_argument("--upscale_factor", default=4, type=int, choices=[1, 2, 4])
    p.add_argument("--crop_size", default=256, type=int)
    p.add_argument("--crop_size_val", default=256, type=int)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--num_workers", default=6, type=int)
    p.add_argument("--num_epochs", default=400, type=int)
    p.add_argument("--num_decay_epochs", default=150, type=int)
    p.add_argument("--learning_rate", default=1e-4, type=float)
    p.add_argument("--adam_beta_1", default=0.5, type=float)
    p.add_argument("--val_interval", default=5, type=int)
    p.add_argument("--val_random_crop", action="store_true",
                   help="re-crop val images at a random position each pass, as the "
                        "reference does; the default is a deterministic center crop")
    p.add_argument("--val_img_interval", default=5, type=int)
    p.add_argument("--save_model_interval", default=5, type=int)
    p.add_argument("--artifacts", default="tdsr", type=str)
    p.add_argument("--dataset", default="df2k", type=str)
    p.add_argument("--flips", action="store_true")
    p.add_argument("--rotations", action="store_true")
    p.add_argument("--num_res_blocks", default=8, type=int)
    p.add_argument("--ragan", action="store_true")
    p.add_argument("--wgan", action="store_true")
    p.add_argument("--no_highpass", dest="highpass", action="store_false")
    p.add_argument("--kernel_size", default=5, type=int)
    p.add_argument("--no_per_loss", dest="use_per_loss", action="store_false")
    p.add_argument("--lpips_rot_flip", action="store_true", help="parsed, not used")
    p.add_argument("--per_type", default="LPIPS", type=str)
    p.add_argument("--lpips_backbone", default=None, type=str,
                   help="torchvision alexnet .pth for the LPIPS perceptual loss (also "
                        "DASR_TPU_LPIPS_BACKBONE; a seeded random backbone otherwise)")
    p.add_argument("--disc_freq", default=1, type=int)
    p.add_argument("--gen_freq", default=1, type=int)
    p.add_argument("--w_col", default=1, type=float)
    p.add_argument("--w_tex", default=0.005, type=float)
    p.add_argument("--w_per", default=0.01, type=float)
    p.add_argument("--checkpoint", default=None, type=str,
                   help="resume from the port's train state ({iter}.pt or its directory)")
    p.add_argument("--save_path", default=None, type=str)
    p.add_argument("--generator", default="DeResnet", type=str)
    p.add_argument("--discriminator", default="FSD", type=str)
    p.add_argument("--filter", default="gau", type=str)
    p.add_argument("--cat_or_sum", default="cat", type=str)
    p.add_argument("--norm_layer", default="Instance", type=str)
    p.add_argument("--steps_per_call", default=1, type=int,
                   help="train windows of K steps (disc_freq and gen_freq 1)")
    p.add_argument("--transfer_uint8", action="store_true",
                   help="ship crops to the device as uint8, cast to f32/255 there (exact)")
    p.add_argument("--decode_cache_gb", type=float, default=None,
                   help="in-RAM decoded-image cache budget (GiB); also DASR_DECODE_CACHE_GB")
    p.add_argument("--device_bicubic", action="store_true",
                   help="compute the MATLAB-bicubic LR target in the step, not in the "
                        "loader's workers (the same resampling matrices)")
    p.add_argument("--device_bank", action="store_true",
                   help="keep the decoded corpora on the device and sample each batch there "
                        "(the host loader serves over budget or with small images)")
    p.add_argument("--device_bank_gb", type=float, default=12.0,
                   help="device memory budget of --device_bank (padded bytes)")
    p.add_argument("--packed_trunk", action="store_true",
                   help="a TPU rewrite of DeResnet's trunk: accepted and ignored")
    p.add_argument("--seed", default=0, type=int,
                   help="run seed: the init, the loader's shuffle and crops, the WGAN-GP draws")
    p.add_argument("--no_bf16", dest="bf16", action="store_false",
                   help="run G/D/LPIPS in float32 instead of bfloat16 (params are f32 "
                        "either way)")
    p.add_argument("--no_saving", dest="saving", action="store_false")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--paths_yml", default=None, type=str)
    p.add_argument("--experiments_root", default="../../DSN_experiments", type=str)
    p.add_argument("--source_dir", default=None, type=str)
    p.add_argument("--target_dir", default=None, type=str)
    p.add_argument("--valid_hr_dir", default=None, type=str)
    p.add_argument("--valid_lr_dir", default=None, type=str)
    return p


def to_device(batch, device):
    """Host NHWC arrays (pinned tensors from the Loader) -> NCHW device views."""
    import torch

    return {k: torch.as_tensor(v).to(device, non_blocking=True).permute(0, 3, 1, 2)
            for k, v in batch.items()}


def make_loader(opt, source_dir, target_dir, device):
    """The host loader of ``opt``'s DSN feed (pinned batches for the card):
    the current world's rows of each global batch."""
    from dasr_tpu_torch.core import dist
    from dasr_tpu_torch.data.datasets import DSNTrainDataset
    from dasr_tpu_torch.data.pipeline import Loader

    train_set = DSNTrainDataset(
        source_dir, target_dir, crop_size=opt.crop_size, upscale_factor=opt.upscale_factor,
        flips=opt.flips, rotations=opt.rotations, transfer_uint8=opt.transfer_uint8,
        device_bicubic=opt.device_bicubic)
    return Loader(train_set, batch_size=opt.batch_size, shuffle=True,
                  num_workers=opt.num_workers, drop_last=True, seed=opt.seed,
                  pin_memory=device.type == "cuda", world=dist.current())


def make_trainer(opt, device, steps_per_epoch: int):
    """``opt``'s DSNTrainer (not yet initialised) on ``device``, its LR
    decaying over ``steps_per_epoch`` updates an epoch."""
    import torch

    from dasr_tpu_torch.losses.lpips import default_lpips
    from dasr_tpu_torch.train.dsn_trainer import DSNConfig, DSNTrainer

    cfg = DSNConfig(
        generator=opt.generator, discriminator=opt.discriminator, filter=opt.filter,
        cat_or_sum=opt.cat_or_sum, norm_layer=opt.norm_layer, kernel_size=opt.kernel_size,
        num_res_blocks=opt.num_res_blocks, upscale_factor=opt.upscale_factor,
        highpass=opt.highpass, wgan=opt.wgan, ragan=opt.ragan, w_col=opt.w_col,
        w_tex=opt.w_tex, w_per=opt.w_per, use_per_loss=opt.use_per_loss,
        per_type=opt.per_type, learning_rate=opt.learning_rate, adam_beta_1=opt.adam_beta_1,
        disc_freq=opt.disc_freq, gen_freq=opt.gen_freq, seed=opt.seed,
        packed_trunk=opt.packed_trunk, dtype=torch.bfloat16 if opt.bf16 else torch.float32)
    lpips = None
    if opt.use_per_loss and opt.per_type == "LPIPS":
        lpips = default_lpips("alex", backbone_path=opt.lpips_backbone, seed=opt.seed,
                              dtype=cfg.dtype)
    return DSNTrainer(cfg, device, lpips=lpips,
                      decay=(opt.num_epochs, opt.num_decay_epochs, steps_per_epoch))


def bank_gate(opt, source_dir, target_dir):
    """Whether ``--device_bank`` can serve this run (the JAX CLI's budget and
    crop checks, and, repaired, at least one batch of noisy images); prints
    why the host loader serves where it cannot."""
    from dasr_tpu_torch.data.device_bank import bank_min_hw, bank_nbytes
    from dasr_tpu_torch.data.io import list_images

    crop = opt.crop_size - opt.crop_size % opt.upscale_factor
    need = bank_nbytes(source_dir) + bank_nbytes(target_dir)
    if need > opt.device_bank_gb * 2**30:
        reason = f"padded corpus needs {need / 2**30:.1f} GiB > budget {opt.device_bank_gb} GiB"
    elif (min(bank_min_hw(source_dir)) < crop // opt.upscale_factor
          or min(bank_min_hw(target_dir)) < crop):
        reason = f"corpus has images smaller than the {crop}px crop"
    elif len(list_images(source_dir)) < opt.batch_size:
        reason = f"fewer source images than one batch of {opt.batch_size}"
    else:
        return True
    print(f"--device_bank: {reason}; using the host loader", flush=True)
    return False


def main(argv=None):
    opt = build_argparser().parse_args(argv)

    import numpy as np
    import torch

    from dasr_tpu_torch.core import dist
    from dasr_tpu_torch.core.config import dataset_paths
    from dasr_tpu_torch.core.device import resolve_device
    from dasr_tpu_torch.data.datasets import DSNValDataset
    from dasr_tpu_torch.train.checkpoints import load_train_state, save_dsn_tar, save_train_state
    from dasr_tpu_torch.utils.guards import check_finite
    from dasr_tpu_torch.utils.metrics_writer import MetricsWriter

    world = dist.init_world(resolve_device(opt.device))
    device, main_rank = world.device, world.is_main
    if main_rank:
        print(world.mesh_line(), flush=True)
    world.batch_slice(opt.batch_size)  # refuses a batch the world does not divide
    if opt.source_dir and opt.target_dir:
        source_dir, target_dir = opt.source_dir, opt.target_dir
        valid_hr, valid_lr = opt.valid_hr_dir, opt.valid_lr_dir
    else:
        paths_yml = opt.paths_yml or os.path.join(os.path.dirname(__file__), "..", "..",
                                                  "paths.yml")
        reg = dataset_paths(paths_yml, opt.dataset, opt.artifacts)
        source_dir, target_dir = reg["source"], reg["target"]
        valid_hr, valid_lr = reg.get("valid_hr"), reg.get("valid_lr")
    if opt.decode_cache_gb is not None:
        from dasr_tpu_torch.data.io import enable_decode_cache

        enable_decode_cache(opt.decode_cache_gb)

    loader = banks = None
    crop = opt.crop_size - opt.crop_size % opt.upscale_factor
    if opt.device_bank and bank_gate(opt, source_dir, target_dir):
        import time

        from dasr_tpu_torch.data.device_bank import build_bank, epoch_rows, nbytes, upload

        t0 = time.perf_counter()
        hosts = (build_bank(target_dir, min_size=crop),
                 build_bank(source_dir, min_size=crop // opt.upscale_factor))
        t1 = time.perf_counter()
        banks = tuple(upload(b, device) for b in hosts)  # (clean, noisy)
        n_noisy = hosts[1].data.shape[0]
        steps_per_epoch = n_noisy // opt.batch_size
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if main_rank:
                print(f"device bank: {nbytes(banks) / 2**30:.3f} GiB resident "
                  f"({hosts[0].data.shape[0]} clean / {n_noisy} noisy images; decode "
                  f"{t1 - t0:.2f} s, upload {time.perf_counter() - t1:.2f} s)", flush=True)
        del hosts
    else:
        loader = make_loader(opt, source_dir, target_dir, device)
        steps_per_epoch = max(1, len(loader))
    trainer = make_trainer(opt, device, steps_per_epoch=steps_per_epoch)
    state = trainer.init_state()

    save_path = os.path.join(opt.experiments_root, opt.save_path or "dsn_run")
    ckpt_dir = os.path.join(save_path, "checkpoints")
    start_epoch = 1
    if opt.checkpoint:
        step = load_train_state(opt.checkpoint, state)
        start_epoch = step // steps_per_epoch + 1
        if main_rank:
            print(f"Continuing training at epoch {start_epoch}")
    for name, net in (("G", trainer.g_model), ("D", trainer.d_model)):
        world.check_replicated(net.state_dict().items(), f"dsn_train {name}")

    writer = None
    if opt.saving and main_rank:
        os.makedirs(save_path, exist_ok=True)
        with open(os.path.join(save_path, "commandline_args.txt"), "w") as f:
            json.dump(vars(opt), f, indent=2)
        # metrics JSONL and a TensorBoard event file (the reference writes
        # DSN_tb_logger/<save_path>, DSN/train.py:186-191)
        writer = MetricsWriter(os.path.join(save_path, "metrics.jsonl"),
                               tb_dir=os.path.join(save_path, "tb_logger"))
    val_set = None
    if valid_hr:
        val_set = DSNValDataset(valid_hr, valid_lr, crop_size=opt.crop_size_val,
                                upscale_factor=opt.upscale_factor,
                                random_crop=opt.val_random_crop)

    k_steps = max(1, opt.steps_per_call)
    if k_steps > 1 and (opt.disc_freq != 1 or opt.gen_freq != 1 or opt.debug):
        print("steps_per_call > 1 needs disc_freq == gen_freq == 1 (and no --debug); "
              "one step a window")
        k_steps = 1

    def boundary(it, k):
        return it // LOG_EVERY > (it - k) // LOG_EVERY

    def write(it, k, metrics):
        host = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))  # one sync
        if boundary(it, k):
            check_finite(host, it)
        if writer:
            writer.write(it, host, imgs=opt.batch_size)

    # A resumed run continues from the saved step. This deviates from the JAX
    # CLI on purpose (ROADMAP C.2): dasr_tpu/cli/dsn_train.py:407 sets
    # iteration = 0 after a resume, so it saves under the wrong step, the next
    # resume computes the wrong start epoch, and its banked windows reseed
    # from 0 and replay the first run's stream.
    iteration = state.step
    lagged = last = None  # a boundary window's device metrics, read after the next is issued

    def run_window(window):
        """Issue one window (host batches or index rows) of len(window) steps."""
        nonlocal iteration, lagged, last
        k, start = len(window), iteration
        iteration += k
        do_g, do_d = iteration % opt.gen_freq == 0, iteration % opt.disc_freq == 0
        if banks is not None:
            idx = torch.from_numpy(np.stack(window).astype(np.int64)).to(device)
            metrics = trainer.train_banked_step(*banks, idx, start, crop, opt.flips,
                                                opt.rotations, do_g=do_g, do_d=do_d)
        else:
            metrics = trainer.train_multi_step([to_device(b, device) for b in window],
                                               do_g=do_g, do_d=do_d)
        if lagged is not None:
            write(*lagged)
        lagged = (iteration, k, metrics) if boundary(iteration, k) else None
        last = (iteration, k, metrics)

    pending = []
    try:
        for epoch in range(start_epoch, opt.num_epochs + 1):
            if banks is not None:
                source = epoch_rows(opt.seed, epoch, n_noisy, opt.batch_size)
            else:
                loader.set_epoch(epoch)
                source = loader
            for batch in source:
                pending.append(batch)
                if len(pending) == k_steps:
                    run_window(pending)
                    pending = []
                if opt.debug:
                    break
            if opt.debug:
                opt.val_interval = opt.save_model_interval = 1

            # rank 0 alone validates and saves; the others wait for it
            due = [val_set is not None and epoch % opt.val_interval == 0,
                   opt.saving and val_set is not None and epoch % opt.val_img_interval == 0,
                   opt.saving and epoch % opt.save_model_interval == 0]
            if due[0] and main_rank:
                mean_psnr = _validate(trainer, val_set, device)
                if writer:
                    writer.write(iteration, {"val/psnr_vs_bicubic": mean_psnr})
                print(f"[epoch {epoch}] val PSNR vs bicubic: {mean_psnr:.3f} dB")
            if due[1] and main_rank:
                _dump_val_images(trainer, val_set, device, opt, save_path, epoch, iteration,
                                 writer)
            if due[2] and main_rank:
                save_train_state(ckpt_dir, state, iteration)
                print(f"[epoch {epoch}] checkpoint @ iter {iteration}")
            if any(due):
                world.barrier()
            if opt.debug and epoch >= start_epoch + 1:
                break
        if pending:
            run_window(pending)
        # the last window's metrics always end the log (the reference's
        # end-of-run line), checked where they cross a boundary
        if last is not None:
            write(*last)
        if opt.saving and main_rank:
            # a final save whatever the interval, so stage 2 always finds one
            save_train_state(ckpt_dir, state, iteration)
            save_dsn_tar(os.path.join(ckpt_dir, "last_iteration.tar"), trainer.g_model,
                         trainer.d_model, epoch=opt.num_epochs, iteration=iteration,
                         fs_type=opt.filter, fs_kernel_size=opt.kernel_size,
                         d_type=opt.discriminator)
            print(f"[final] checkpoint @ iter {iteration}")
        world.barrier()
    finally:
        if writer:
            writer.close()
    return iteration


def _validate(trainer, val_set, device) -> float:
    """Mean PSNR of G's output against the bicubic over at most 16 val images,
    in one generator call."""
    import numpy as np
    import torch

    items = [val_set[i] for i in range(min(len(val_set), 16))]
    inp = torch.from_numpy(np.stack([it["input"] for it in items])).to(device)
    bic = torch.from_numpy(np.stack([it["bicubic"] for it in items])).to(device)
    fake = trainer.generate(inp.permute(0, 3, 1, 2)).float()
    mse = ((fake - bic.permute(0, 3, 1, 2)) ** 2).mean(dim=(1, 2, 3))
    return float((-10.0 * torch.log10(mse)).mean())


def _dump_val_images(trainer, val_set, device, opt, save_path, epoch, iteration, writer):
    """[fake | its high-pass | bicubic] PNGs of the first four val images
    (the reference's TB image grids, DSN/train.py:295-354)."""
    import torch

    from dasr_tpu_torch.data.io import save_img
    from dasr_tpu_torch.ops.filters import filter_high

    img_dir = os.path.join(save_path, "val_images", str(epoch))
    for i in range(min(len(val_set), 4)):
        item = val_set[i]
        x = torch.from_numpy(item["input"]).to(device).permute(2, 0, 1)[None]
        fake = trainer.generate(x).float()
        hf = filter_high(fake, kernel_size=opt.kernel_size, include_pad=False,
                         gaussian=opt.filter == "gau")
        fake_np, hf_np = (t[0].permute(1, 2, 0).cpu().numpy() for t in (fake, hf))
        save_img(fake_np, os.path.join(img_dir, f"{i}_fake.png"))
        save_img(hf_np, os.path.join(img_dir, f"{i}_fake_hf.png"))
        save_img(item["bicubic"], os.path.join(img_dir, f"{i}_bicubic.png"))
        if writer:
            writer.write_image(iteration, f"val/{i}_fake", fake_np)
            writer.write_image(iteration, f"val/{i}_fake_hf", hf_np)


if __name__ == "__main__":
    main()
