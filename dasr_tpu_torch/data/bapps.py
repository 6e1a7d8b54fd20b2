"""BAPPS perceptual-judgement datasets + scoring (host code, copied from
``dasr_tpu.data.bapps``).

Reference: codes/PerceptualSimilarity/data/dataset/twoafc_dataset.py
(dirs ``ref/ p0/ p1/ judge/``: two distortions of a reference patch plus
the fraction of humans preferring p1), data/dataset/jnd_dataset.py
(dirs ``p0/ p1/ same/``), and the scoring functions
models/dist_model.py:212-284 (2AFC agreement; JND mAP via VOC AP).

Images are returned HWC float32 in [-1, 1] and batched NHWC on the host;
the CLIs move a batch to the device as NCHW tensors. ``judge``/``same``
are scalars in [0, 1]. A ``dist_fn`` takes two NHWC batches and returns
one distance per pair, as an array.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Sequence, Tuple, Union

import numpy as np

from dasr_tpu_torch.data.io import list_images


def _load_patch(path: str, load_size: int) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    if min(w, h) != load_size:
        # torchvision transforms.Scale: shorter side -> load_size (bilinear)
        if w < h:
            w, h = load_size, int(round(h * load_size / w))
        else:
            w, h = int(round(w * load_size / h)), load_size
        img = img.resize((w, h), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    return arr * 2.0 - 1.0


def _list_npys(d: str) -> List[str]:
    return sorted(
        os.path.join(d, f) for f in os.listdir(d) if f.endswith(".npy")
    )


class TwoAFCDataset:
    """2AFC triplets from one or more BAPPS-layout roots."""

    def __init__(self, roots: Union[str, Sequence[str]], load_size: int = 64):
        if isinstance(roots, str):
            roots = [roots]
        self.load_size = load_size
        self.ref_paths, self.p0_paths, self.p1_paths, self.judge_paths = (
            [], [], [], [],
        )
        for root in roots:
            self.ref_paths += sorted(list_images(os.path.join(root, "ref")))
            self.p0_paths += sorted(list_images(os.path.join(root, "p0")))
            self.p1_paths += sorted(list_images(os.path.join(root, "p1")))
            self.judge_paths += _list_npys(os.path.join(root, "judge"))
        n = len(self.p0_paths)
        assert len(self.ref_paths) == len(self.p1_paths) == len(self.judge_paths) == n

    def __len__(self):
        return len(self.p0_paths)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return {
            "ref": _load_patch(self.ref_paths[i], self.load_size),
            "p0": _load_patch(self.p0_paths[i], self.load_size),
            "p1": _load_patch(self.p1_paths[i], self.load_size),
            "judge": np.float32(np.load(self.judge_paths[i]).reshape(())),
        }


class JNDDataset:
    """Just-noticeable-difference pairs (p0/p1 + fraction judged 'same')."""

    def __init__(self, root: str, load_size: int = 64):
        self.load_size = load_size
        self.p0_paths = sorted(list_images(os.path.join(root, "p0")))
        self.p1_paths = sorted(list_images(os.path.join(root, "p1")))
        self.same_paths = _list_npys(os.path.join(root, "same"))
        assert len(self.p0_paths) == len(self.p1_paths) == len(self.same_paths)

    def __len__(self):
        return len(self.p0_paths)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return {
            "p0": _load_patch(self.p0_paths[i], self.load_size),
            "p1": _load_patch(self.p1_paths[i], self.load_size),
            "same": np.float32(np.load(self.same_paths[i]).reshape(())),
        }


def _batched(dataset, keys: Sequence[str], batch_size: int):
    for lo in range(0, len(dataset), batch_size):
        items = [dataset[i] for i in range(lo, min(lo + batch_size, len(dataset)))]
        yield {k: np.stack([it[k] for it in items]) for k in keys}


DistFn = Callable[[np.ndarray, np.ndarray], np.ndarray]


def score_2afc(dist_fn: DistFn, dataset: TwoAFCDataset, batch_size: int = 50
               ) -> Tuple[float, Dict[str, np.ndarray]]:
    """Fraction of the time ``dist_fn`` agrees with the human majority
    (reference: dist_model.py:212-245). Ties score 0.5."""
    d0s, d1s, gts = [], [], []
    for batch in _batched(dataset, ("ref", "p0", "p1", "judge"), batch_size):
        d0s.append(np.asarray(dist_fn(batch["ref"], batch["p0"])).reshape(-1))
        d1s.append(np.asarray(dist_fn(batch["ref"], batch["p1"])).reshape(-1))
        gts.append(batch["judge"].reshape(-1))
    d0s, d1s, gts = map(np.concatenate, (d0s, d1s, gts))
    scores = (d0s < d1s) * (1.0 - gts) + (d1s < d0s) * gts + (d1s == d0s) * 0.5
    return float(np.mean(scores)), dict(d0s=d0s, d1s=d1s, gts=gts, scores=scores)


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """VOC-style average precision: precision envelope integrated over
    recall (reference: models/util.py:118-141, use_07_metric=False)."""
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def score_jnd(dist_fn: DistFn, dataset: JNDDataset, batch_size: int = 50
              ) -> Tuple[float, Dict[str, np.ndarray]]:
    """mAP of 'same' detection when thresholding the distance
    (reference: dist_model.py:247-284)."""
    ds, sames = [], []
    for batch in _batched(dataset, ("p0", "p1", "same"), batch_size):
        ds.append(np.asarray(dist_fn(batch["p0"], batch["p1"])).reshape(-1))
        sames.append(batch["same"].reshape(-1))
    ds, sames = np.concatenate(ds), np.concatenate(sames)
    order = np.argsort(ds)
    sames_sorted = sames[order]
    tps = np.cumsum(sames_sorted)
    fps = np.cumsum(1 - sames_sorted)
    fns = np.sum(sames_sorted) - tps
    precs = tps / np.maximum(tps + fps, 1e-12)
    recs = tps / np.maximum(tps + fns, 1e-12)
    return voc_ap(recs, precs), dict(ds=ds, sames=sames)
