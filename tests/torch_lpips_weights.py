"""Seeded reference-format LPIPS weights for the port's tests: torchvision
alexnet, vgg16 and squeezenet1_1 ``features`` state dicts (weights of
variance 2 / fan_in, so activations keep their scale through the ReLUs)
and the reference's heads (``lin{k}.model.1.weight``, (1, C, 1, 1))."""

import numpy as np
import torch

CHNS = {
    "alex": (64, 192, 384, 256, 256),
    "vgg": (64, 128, 256, 512, 512),
    "squeeze": (64, 128, 256, 384, 384, 512, 512),
}
# (features index, out, in, k) of each conv of the two plain stacks
_ALEX = ((0, 64, 3, 11), (3, 192, 64, 5), (6, 384, 192, 3), (8, 256, 384, 3),
         (10, 256, 256, 3))
_VGG16 = ((0, 64, 3), (2, 64, 64), (5, 128, 64), (7, 128, 128), (10, 256, 128),
          (12, 256, 256), (14, 256, 256), (17, 512, 256), (19, 512, 512), (21, 512, 512),
          (24, 512, 512), (26, 512, 512), (28, 512, 512))
# squeezenet1_1 Fire index -> (in, squeeze, expand)
_FIRES = {3: (64, 16, 64), 4: (128, 16, 64), 6: (128, 32, 128), 7: (256, 32, 128),
          9: (256, 48, 192), 10: (384, 48, 192), 11: (384, 64, 256), 12: (512, 64, 256)}


def backbone_sd(net: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(key, cout, cin, k):
        w = rng.normal(0, np.sqrt(2.0 / (cin * k * k)), (cout, cin, k, k))
        sd[key + ".weight"] = torch.from_numpy(w.astype(np.float32))
        sd[key + ".bias"] = torch.from_numpy(rng.normal(0, 0.01, (cout,)).astype(np.float32))

    if net == "alex":
        for i, cout, cin, k in _ALEX:
            conv(f"features.{i}", cout, cin, k)
    elif net == "vgg":
        for i, cout, cin in _VGG16:
            conv(f"features.{i}", cout, cin, 3)
    else:
        conv("features.0", 64, 3, 3)
        for i, (cin, s, e) in _FIRES.items():
            conv(f"features.{i}.squeeze", s, cin, 1)
            conv(f"features.{i}.expand1x1", e, s, 1)
            conv(f"features.{i}.expand3x3", e, s, 3)
    return sd


def lin_sd(net: str, seed: int = 1):
    rng = np.random.default_rng(seed)
    return {f"lin{k}.model.1.weight": torch.from_numpy(
        rng.uniform(0, 0.1, (1, c, 1, 1)).astype(np.float32)) for k, c in enumerate(CHNS[net])}


def write(tmp_path, net: str):
    """(backbone path, heads path) of seeded files for ``net``."""
    bpath, lpath = str(tmp_path / f"{net}_backbone.pth"), str(tmp_path / f"{net}_lin.pth")
    torch.save(backbone_sd(net), bpath)
    torch.save(lin_sd(net), lpath)
    return bpath, lpath
