"""Seeded inputs of the port's DSN-stage CLI tests, importing no jax: PNG
corpora and the auto_reproduce plumbing (paths.yml, a small stage-3
template, the smoke arguments)."""

import json
import os

import numpy as np

from dasr_tpu_torch.data.io import save_img

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_dsn_corpus(root, n_source=4, n_target=3, source=(40, 44), target=(150, 136),
                     n_val=2, val=(72, 64), seed=5, grow=True):
    """Seeded PNG dirs: noisy ``source`` LRs, clean ``target`` HRs, and
    ``valid_hr`` / ``valid_lr`` pairs (with ``grow``, image i is i rows and
    2i columns larger); returns the four paths."""
    rng = np.random.default_rng(seed)
    dirs = {d: os.path.join(root, d) for d in ("source", "target", "valid_hr", "valid_lr")}
    for name, (n, (h, w)) in (("source", (n_source, source)), ("target", (n_target, target)),
                              ("valid_hr", (n_val, val)),
                              ("valid_lr", (n_val, (val[0] // 4, val[1] // 4)))):
        for i in range(n):
            save_img(rng.random((h + i * grow, w + 2 * i * grow, 3), dtype=np.float32),
                     os.path.join(dirs[name], f"{name[0]}{i}.png"))
    return dirs


def auto_reproduce_args(root):
    """(argv of a tiny auto_reproduce run under ``root``, its corpus dirs):
    4 target HRs of 144x144 and 4 source LRs of 36x36, a paths.yml naming
    them as aim2019/tdsr, and a small stage-3 template of the shipped
    structure; DSN at nb 2, crop 128 (LR 32, the smallest input alex LPIPS
    takes), one epoch; SRN nf 16 nb 1, two iterations."""
    dirs = write_dsn_corpus(root, n_source=4, n_target=4, source=(36, 36), target=(144, 144),
                            val=(64, 64), seed=0, grow=False)
    paths_yml = os.path.join(root, "paths.yml")
    with open(paths_yml, "w") as f:
        f.write("aim2019:\n  tdsr:\n" + "".join(f"    {k}: '{v}'\n" for k, v in dirs.items()))
    with open(os.path.join(REPO, "dasr_tpu_torch", "configs",
                           "train_DASR_auto_reproduce.json")) as f:
        cfg = json.load(f)
    cfg["val_lpips"] = False
    cfg["network_G"].update({"nf": 16, "nb": 1, "gc": 8})
    cfg["network_D"].update({"nf": 16})
    cfg["datasets"]["train"].update({"batch_size": 2, "HR_size": 64, "n_workers": 2})
    cfg["logger"]["print_freq"] = 1
    cfg["max_val_images"] = 2
    template = os.path.join(root, "template.json")
    with open(template, "w") as f:
        json.dump(cfg, f)
    argv = ["--dataset", "aim2019", "--artifact", "tdsr", "--device", "cpu",
            "--paths_yml", paths_yml, "--work_root", os.path.join(root, "work"),
            "--num_epochs", "1", "--niter", "2", "--srn_template", template,
            "--dsn_extra", "--num_res_blocks 2 --crop_size 128 --batch_size 2 --num_workers 2 "
                           "--val_interval 1 --save_model_interval 1 --decode_cache_gb 1",
            "--dsn_create_extra", "--num_res_blocks 2"]
    return argv, dirs
