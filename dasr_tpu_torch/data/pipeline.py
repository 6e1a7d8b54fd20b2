"""Host input pipeline: threaded map + prefetch, deterministic PRNG.

Copied from ``dasr_tpu.data.pipeline`` (which replaces the reference's
``DataLoader(num_workers=N, pin_memory=True)``, codes/SRN/data/__init__.py:30-45):
a thread pool (the work is numpy/cv2, which releases the GIL) and a bounded
prefetch queue, with the same law: shuffle from ``(seed, epoch)``, a
per-item ``np.random.Generator`` from ``(seed, epoch, index)``,
``drop_last``. With the same seed its batches are the JAX package's, bit for
bit. ``pin_memory`` hands each array over as a tensor in pinned host
memory, so the copy to the card can run asynchronously. In a world of
several ranks (``world``) each rank loads only its rows of each global
batch; an item's draws depend on its index, never on the rank.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch

from dasr_tpu_torch.core.dist import SINGLE, World


def _stack(items, pin_memory: bool):
    out: Dict = {}
    for k in items[0]:
        v = items[0][k]
        if isinstance(v, np.ndarray):
            out[k] = np.stack([it[k] for it in items])
            if pin_memory:
                out[k] = torch.from_numpy(out[k]).pin_memory()
        else:
            out[k] = [it[k] for it in items]
    return out


class Loader:
    """Iterable over stacked batches with shuffle/drop_last semantics.

    Each epoch reshuffles with a per-epoch generator seeded from
    (seed, epoch); each item gets its own Generator seeded from
    (seed, epoch, index) so augmentations replay identically on resume.
    ``batch_size`` is the global batch; each batch holds ``world``'s rows of
    it (``World.batch_slice``).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, num_workers: int = 6,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 4,
                 pin_memory: bool = False, world: World = SINGLE):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.world = world
        self.epoch = 0
        self.skip = 0

    def __len__(self):
        n = len(self.ds)
        return n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs

    def set_epoch(self, epoch: int, skip: int = 0):
        """Select the epoch's order; ``skip`` leaves out its first batches
        without loading them (a run resumed inside an epoch)."""
        self.epoch = epoch
        self.skip = skip

    def _indices(self):
        n = len(self.ds)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        if self.drop_last:
            idx = idx[: (n // self.bs) * self.bs]
        return idx

    def _get(self, i: int):
        rng = np.random.default_rng((self.seed, self.epoch, int(i)))
        try:
            return self.ds.__getitem__(int(i), rng=rng)
        except TypeError:
            return self.ds[int(i)]

    def __iter__(self) -> Iterator[Dict]:
        idx = self._indices()
        batches = [self.world.shard(idx[i : i + self.bs])
                   for i in range(0, len(idx), self.bs)][self.skip:]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        q.put(_stack(list(pool.map(self._get, b)), self.pin_memory))
                q.put(None)
            except BaseException as e:  # propagate instead of hanging the consumer
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
