"""LPIPS 2AFC training / BAPPS evaluation CLI of the port.

Port of ``dasr_tpu.cli.lpips_train`` (reference scripts:
codes/PerceptualSimilarity/train.py, which trains the heads and the ranking
net on 2AFC human judgements, 5 epochs at the base LR and 5 linearly
decayed, and test_dataset_model.py, which scores a distance model on 2AFC
and JND dataset directories).

  python -m dasr_tpu_torch.cli.lpips_train train --datasets <2afc dirs> [--device cuda]
  python -m dasr_tpu_torch.cli.lpips_train eval  --datasets <dirs> --dataset_mode 2afc

``train`` writes ``latest_net_.pth`` after every epoch in the reference's
format (keys ``lin{k}.model.1.weight``, shape (1, C, 1, 1)), which
``load_lpips_params`` of either package reads. Batches are decoded on the
host and go to the device as NCHW tensors; the step's loss is read back only
on the lines it prints.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from dasr_tpu_torch.losses.lpips_train import Dist2LogitLayer, TwoAFCTrainer


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """An NHWC host batch as an NCHW tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device).permute(0, 3, 1, 2)


def _dist_fn_from_args(args, device):
    from dasr_tpu_torch.losses.lpips import create_dist_model

    fn = create_dist_model(model=args.model, net=args.net, version=args.version,
                           lin_path=args.lin_path, backbone_path=args.backbone, device=device)

    def compute(a, b):  # NHWC [-1, 1] batches -> (N,) distances
        d = fn(_to_device(a, device), _to_device(b, device))
        return (d.cpu().numpy() if torch.is_tensor(d) else np.asarray(d)).reshape(-1)

    return compute


def _cmd_eval(args, device):
    from dasr_tpu_torch.data.bapps import JNDDataset, TwoAFCDataset, score_2afc, score_jnd

    dist = _dist_fn_from_args(args, device)
    results = {}
    for root in args.datasets:
        if args.dataset_mode == "2afc":
            score, _ = score_2afc(dist, TwoAFCDataset(root, args.load_size), args.batch_size)
        else:
            score, _ = score_jnd(dist, JNDDataset(root, args.load_size), args.batch_size)
        results[root] = score
        print(f"  Dataset [{root}]: {100.0 * score:.2f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


def _export_lin_heads(path: str, lpips) -> None:
    """The heads in the reference's bundled-weights format."""
    torch.save({f"{name}.model.1.weight": w.detach().float().cpu().reshape(1, -1, 1, 1)
                for name, w in lpips.named_parameters(recurse=False)}, path)


def _cmd_train(args, device):
    from dasr_tpu_torch.data.bapps import TwoAFCDataset, score_2afc
    from dasr_tpu_torch.losses.lpips import LPIPS, load_lpips_params

    os.makedirs(args.save_dir, exist_ok=True)
    train_set = TwoAFCDataset(args.datasets, args.load_size)
    steps_per_epoch = max(1, len(train_set) // args.batch_size)
    print(f"Loading {len(train_set)} instances from {args.datasets}")

    # the reference's LR: constant for nepoch, then linear to 0 over
    # nepoch_decay (train.py:23-24 and dist_model.update_learning_rate), per
    # update as JAX's schedule takes it
    def schedule(step):
        frac = (step / steps_per_epoch - args.nepoch) / max(1, args.nepoch_decay)
        return args.lr * min(max(1.0 - frac, 0.0), 1.0)

    lpips = LPIPS(net=args.net).init_weights(torch.Generator().manual_seed(0))
    if not args.from_scratch:
        load_lpips_params(lpips, lin_path=args.lin_path, backbone_path=args.backbone)
    rank = Dist2LogitLayer().init_weights(torch.Generator().manual_seed(1))
    trainer = TwoAFCTrainer(lpips.to(device), rank.to(device), lr=schedule, beta1=0.5)

    rng = np.random.default_rng(0)
    total_steps = 0
    for epoch in range(1, args.nepoch + args.nepoch_decay + 1):
        order = rng.permutation(len(train_set))
        for lo in range(0, steps_per_epoch * args.batch_size, args.batch_size):
            items = [train_set[int(i)] for i in order[lo:lo + args.batch_size]]
            batch = {k: _to_device(np.stack([it[k] for it in items]), device)
                     for k in ("ref", "p0", "p1")}
            batch["judge"] = torch.from_numpy(
                np.stack([it["judge"] for it in items]).reshape(-1, 1, 1, 1)).to(device)
            m = trainer.step(batch)
            total_steps += 1
            if total_steps % args.print_freq == 0:
                print(f"epoch {epoch} step {total_steps}: "
                      f"loss {float(m['loss']):.4f} acc {float(m['acc']):.3f}")
        _export_lin_heads(os.path.join(args.save_dir, "latest_net_.pth"), lpips)
        print(f"End of epoch {epoch} / {args.nepoch + args.nepoch_decay}")

    if args.val_datasets:
        @torch.no_grad()
        def dist(a, b):
            return lpips(_to_device(a, device), _to_device(b, device)).cpu().numpy().reshape(-1)

        for root in args.val_datasets:
            score, _ = score_2afc(dist, TwoAFCDataset(root, args.load_size), args.batch_size)
            print(f"  Dataset [{root}]: {100.0 * score:.2f}")
    return trainer


def main(argv=None):
    p = argparse.ArgumentParser(description="LPIPS 2AFC training / eval")
    sub = p.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train")
    tr.add_argument("--datasets", nargs="+", required=True,
                    help="2AFC dataset roots (ref/ p0/ p1/ judge/)")
    tr.add_argument("--val_datasets", nargs="+", default=None)
    tr.add_argument("--net", default="alex", choices=["alex", "vgg", "squeeze"])
    tr.add_argument("--nepoch", type=int, default=5)
    tr.add_argument("--nepoch_decay", type=int, default=5)
    tr.add_argument("--batch_size", type=int, default=50)
    tr.add_argument("--lr", type=float, default=1e-4)
    tr.add_argument("--load_size", type=int, default=64)
    tr.add_argument("--print_freq", type=int, default=100)
    tr.add_argument("--save_dir", default="checkpoints/tmp")
    tr.add_argument("--lin_path", default=None)
    tr.add_argument("--backbone", default=None)
    tr.add_argument("--from_scratch", action="store_true")
    tr.set_defaults(fn=_cmd_train)

    ev = sub.add_parser("eval")
    ev.add_argument("--datasets", nargs="+", required=True)
    ev.add_argument("--dataset_mode", default="2afc", choices=["2afc", "jnd"])
    ev.add_argument("--model", default="net-lin",
                    choices=["net-lin", "net", "l2", "L2", "ssim", "DSSIM"])
    ev.add_argument("--net", default="alex", choices=["alex", "vgg", "squeeze"])
    ev.add_argument("--version", default="0.1", choices=["0.0", "0.1"])
    ev.add_argument("--lin_path", default=None,
                    help="heads to score, e.g. a latest_net_.pth of train (default: the "
                         "reference's bundled heads of --version, where mounted)")
    ev.add_argument("--backbone", default=None)
    ev.add_argument("--batch_size", type=int, default=50)
    ev.add_argument("--load_size", type=int, default=64)
    ev.add_argument("--out", default=None, help="JSON results path")
    ev.set_defaults(fn=_cmd_eval)
    for s in (tr, ev):
        s.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="run on the GPU or on the CPU (plain PyTorch)")

    args = p.parse_args(argv)
    from dasr_tpu_torch.core.device import resolve_device

    return args.fn(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
