"""Process worlds: data-parallel training and sharded inference over ranks.

Counterpart of ``dasr_tpu.core.mesh``. JAX runs one process over a
('data', 'spatial') mesh, and under ``jit`` a mean over the sharded batch
is the global batch's mean: XLA inserts the all-reduce. The port runs one
process per card, started by ``python -m torch.distributed.run``
(torchrun), and states its collectives. They all serve one rule: an N-rank
step equals the 1-rank step on the concatenated global batch.

* ``World``: this process's rank, the world's size, its device and process
  group, and the helpers of ``mesh.py``: a rank's rows of a global batch
  (``shard_batch``), a check that the replicated state is equal on every
  rank (``replicate``), the ``[mesh]`` line.
* ``init_world``: the world of torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``), NCCL on ``cuda:LOCAL_RANK`` or gloo on
  the CPU; without a launcher, a world of one rank and no process group, in
  which every helper below is the identity. ``current`` is the world the
  trainers and layers read, process-wide as torch.distributed's own
  default group is (threading it through every module's forward would
  change the layers' signatures for one value per process); ``using``
  swaps it for a block.
* ``world_mean``: a mean over the ranks that autograd differentiates (its
  backward is the same mean of the incoming gradients), for the terms that
  couple a batch: the RaGAN batch means and BatchNorm's statistics.
  ``average_grads`` averages a network's gradients in one flattened bucket
  (an explicit all-reduce: every step takes its gradients with
  ``torch.autograd.grad``, which DDP's AccumulateGrad hooks never see).

Only data parallelism is ported: no CLI shards the spatial axis of the
mesh, so the port's world is one data axis. One departure from JAX:
``make_mesh_for_batch`` shrinks the mesh to gcd(batch, devices), and a
process world cannot shrink, so ``World.batch_slice`` refuses a batch that
the world's size does not divide.

Gloo moves CUDA tensors through host copies here: the ranks may then share
one card, as the card's smoke run has them.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import datetime
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

TORCHRUN_HINT = "python -m torch.distributed.run --nproc_per_node {n} -m {module} ..."


@dataclasses.dataclass(frozen=True)
class World:
    """One process's place in a data-parallel world (``group`` None: a world
    of one rank without collectives)."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    group: Optional[object] = None
    backend: Optional[str] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def mesh_line(self) -> str:
        """The JAX CLIs' mesh line (the tests read it)."""
        return f"[mesh] data={self.size} spatial=1"

    def batch_slice(self, n: int) -> slice:
        """This rank's rows ``[r n / N, (r + 1) n / N)`` of a global batch of
        ``n`` (the counterpart of ``shard_batch``)."""
        if n % self.size:
            raise ValueError(
                f"a global batch of {n} does not split over {self.size} ranks: make the "
                f"batch a multiple of the world size (dasr_tpu shrinks its mesh to "
                f"gcd(batch, devices); a torchrun world cannot shrink)")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def shard(self, x):
        """This rank's rows of ``x`` (a tensor or array, batch first)."""
        return x[self.batch_slice(x.shape[0])]

    # -- collectives (the identity in a world without a group) ---------------

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self.backend == "gloo" and t.is_cuda else t

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        if self.group is not None:
            w = self._wire(t)
            tdist.all_reduce(w, group=self.group)
            if w is not t:
                t.copy_(w)
        return t

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """Average ``t`` over the ranks, in place."""
        if self.group is not None:
            self.all_reduce_(t).div_(self.size)
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (equal shapes), in rank order, on ``t``'s device."""
        if self.group is None:
            return [t]
        w = self._wire(t)
        out = [torch.empty_like(w) for _ in range(self.size)]
        tdist.all_gather(out, w, group=self.group)
        return [o.to(t.device) for o in out]

    def barrier(self) -> None:
        if self.group is not None:
            # a collective, not tdist.barrier: NCCL's barrier guesses its device
            self.all_reduce_(torch.zeros(1, device=self.device))

    def mean_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """0-d metrics averaged over the ranks in one all-reduce: with equal
        shards, each per-sample mean becomes the global batch's."""
        if self.group is None or not metrics:
            return metrics
        values = self.mean_(torch.stack([v.float() for v in metrics.values()]))
        return dict(zip(metrics, values.unbind(0)))

    def check_replicated(self, named: Iterable[Tuple[str, torch.Tensor]], what: str) -> None:
        """Fail unless every tensor is equal on every rank (a checksum of
        each: its f64 sum and sum of squares), as ``replicate`` leaves
        JAX's state."""
        if self.group is None:
            return
        named = list(named)
        sums = torch.stack([torch.stack([t.double().sum(), t.double().square().sum()])
                            for _, t in named]) if named else torch.zeros(0, 2)
        mine = sums.to(self.device)
        for r, theirs in enumerate(self.all_gather(mine)):
            diff = (theirs != mine).any(1).nonzero().flatten().tolist()
            if diff:
                raise RuntimeError(f"{what}: rank {r} and rank {self.rank} hold different "
                                   f"{named[diff[0]][0]}")


SINGLE = World()
_WORLD = SINGLE


def current() -> World:
    """The world the trainers and layers read (``SINGLE`` until
    ``init_world`` joins a launcher's)."""
    return _WORLD


@contextlib.contextmanager
def using(world: World):
    """``current()`` is ``world`` within the block."""
    global _WORLD
    before, _WORLD = _WORLD, world
    try:
        yield world
    finally:
        _WORLD = before


def init_world(device, backend: Optional[str] = None,
               timeout: Optional[datetime.timedelta] = None) -> World:
    """This process's world, made current. Under a launcher it joins the
    process group of ``WORLD_SIZE`` ranks (address ``MASTER_ADDR`` /
    ``MASTER_PORT``): NCCL on ``cuda:LOCAL_RANK`` (modulo the cards there
    are) for a CUDA ``device``, gloo on the CPU; ``backend="gloo"`` asks
    for gloo on the cards too; ``timeout`` bounds every collective (torch's
    default: 10 minutes for NCCL, 30 for gloo). Without a launcher:
    ``SINGLE`` on ``device``.
    A second call returns the world the first one joined, so a caller may
    join with its own backend before a CLI asks."""
    global _WORLD
    if _WORLD.group is not None:
        return _WORLD
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ:  # no launcher started this process
        _WORLD = dataclasses.replace(SINGLE, device=device)
        return _WORLD
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if not tdist.is_initialized():
        kw = {} if timeout is None else {"timeout": timeout}
        tdist.init_process_group(backend, rank=rank, world_size=size, **kw)
        atexit.register(_leave)
    _WORLD = World(rank, size, device, tdist.group.WORLD, backend)
    return _WORLD


def _leave():
    if tdist.is_initialized():
        tdist.destroy_process_group()


def refuse_mismatch(mesh: int, module: str) -> World:
    """The current world when its size is ``--mesh``'s (``mesh`` 0: one
    rank); else a message that gives the torchrun command."""
    world = current()
    if mesh and mesh != world.size or not mesh and world.size > 1:
        n = mesh or 1
        raise ValueError(
            f"--mesh {mesh} needs a world of {n} rank(s) and this process is one of "
            f"{world.size}: run " + TORCHRUN_HINT.format(n=n, module=module)
            + f" --mesh {n}")
    return world


class _WorldMean(torch.autograd.Function):
    """The mean over the ranks; its backward is the same mean of the
    incoming gradients (the adjoint of a mean over ranks that all use the
    result), itself differentiable for a double backward."""

    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        return world.mean_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad):
        return _WorldMean.apply(grad, ctx.world), None


def world_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the current world's ranks, under autograd."""
    world = current()
    return x if world.group is None else _WorldMean.apply(x, world)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the global batch (dim 0, kept) of per-rank equal
    shards: the RaGAN terms' ``mean(0, keepdim=True)``."""
    return world_mean(x.mean(0, keepdim=True))


def average_grads(grads: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """A network's gradients averaged over the current world, in one
    flattened all-reduce."""
    world = current()
    if world.group is None or not grads:
        return grads
    flat = world.mean_(torch.cat([g.reshape(-1) for g in grads]))
    return [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in grads]), grads)]
