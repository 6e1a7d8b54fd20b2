"""Train state of the port's GAN trainers.

Counterpart of ``dasr_tpu.train.state``: where JAX keeps one immutable
pytree that a jitted step maps to the next, the port keeps the modules, a
``torch.optim.Adam`` and a scheduler per network, updated in place, as the
reference does (codes/SRN/models/DASR_model.py:120-151). In a world of
several ranks (``core/dist.py``) ``NetState.update`` first averages the
gradients over the ranks, as XLA's all-reduce does under JAX's mesh.

An update has a device part (``NetState.update``: the gradients, Adam's
step) and a host part (``NetState.advance``: the LR schedule). On CUDA the
Adam is ``capturable`` and its LR a 0-d device tensor, so a CUDA graph of
the device part (``train/step_graph.py``) reads Adam's count and each
step's LR on the card, and ``advance`` writes the LR between replays.

Adam's step takes two paths, by the parameters' device. On the card it is
the hand-written kernel of ``ops/adam.py`` (one pass over p, g, m and v,
each gradient read through its own strides), driven by the plan kept in
``NetState.plan``; ``torch.optim.Adam`` stays the holder of the moments,
the counts and the param group the schedulers read. On the CPU it is
``self.opt.step()``. The counters ``adam.kernel_tensors``,
``adam.torch_tensors`` and ``adam.launches`` (``utils/trace.py``) say which
path updated how many tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Sequence

import torch
import torch.nn as nn

from dasr_tpu_torch.core import dist
from dasr_tpu_torch.ops import adam
from dasr_tpu_torch.train.schedules import multistep
from dasr_tpu_torch.utils import trace


@dataclasses.dataclass
class NetState:
    """One network with its optimizer and LR scheduler; ``lr``: the Adam's
    LR tensor where it is capturable (CUDA), else None; ``plan``: the Adam
    kernel's plan on the card, made by the first update there."""

    net: nn.Module
    opt: torch.optim.Optimizer
    sched: torch.optim.lr_scheduler.LRScheduler
    lr: Optional[torch.Tensor] = None
    plan: Optional[adam.AdamPlan] = dataclasses.field(default=None, repr=False, compare=False)

    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """Apply ``grads`` (one per trainable parameter, in order), averaged
        over the current world's ranks, and advance the schedule."""
        self.update(grads)
        self.advance()

    def update(self, grads: Sequence[torch.Tensor]) -> None:
        """The device part of ``step``: Adam's step on the averaged
        gradients; on the card the Adam kernel (``ops/adam.py``), which
        reads each gradient where it lies, elsewhere ``torch.optim.Adam``
        through ``p.grad``. It changes no host state that a later step
        reads, so a CUDA graph can capture it."""
        grads = dist.average_grads(grads)
        params = self.params()
        if params and params[0].is_cuda:
            self.plan = adam.plan_for(self.opt, params, self.plan)
            trace.count("adam.launches", self.plan.step(grads))
            trace.count("adam.kernel_tensors", len(params))
            # what torch's own step sets, so that the first schedule step
            # does not warn of a schedule stepped before its optimizer
            self.opt._opt_called = True
            return
        for p, g in zip(params, grads):
            p.grad = g
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        trace.count("adam.torch_tensors", len(params))

    def advance(self) -> None:
        """The host part of ``step``: the schedule's next LR, written into
        ``lr`` in place where there is one (torch's schedulers fill a tensor
        LR themselves; an older torch assigns a float, which goes back into
        the tensor here)."""
        self.sched.step()
        self.set_lr(self.opt.param_groups[0]["lr"])

    def set_lr(self, value) -> None:
        """Set the optimizer's LR; on CUDA into the tensor a graph reads."""
        _set_lr(self.opt.param_groups[0], self.lr, value)

    def params(self):
        return [p for p in self.net.parameters() if p.requires_grad]

    def tensors(self) -> Iterator[torch.Tensor]:
        """Every tensor an update reads or writes: the network's parameters
        and buffers, Adam's state, the LR tensor, the Adam kernel's table."""
        yield from self.net.parameters()
        yield from self.net.buffers()
        for state in self.opt.state.values():
            yield from (v for v in state.values() if isinstance(v, torch.Tensor))
        if self.lr is not None:
            yield self.lr
        if self.plan is not None and self.plan.device_table is not None:
            yield self.plan.device_table


def _set_lr(group, lr: Optional[torch.Tensor], value) -> None:
    if lr is not None and value is not lr:
        lr.fill_(float(value))
        value = lr
    group["lr"] = value


def keep_form(lr: Optional[torch.Tensor]):
    """A load post-hook for an Adam whose LR tensor is ``lr`` (None: a float
    LR). ``load_state_dict`` takes the saved param group whole: a file from
    a CPU run brings ``capturable`` off, a float LR and counts on the host,
    one from the card a tensor LR. The hook puts back the Adam's own form:
    capturable with its counts on the parameters' device and its LR in
    ``lr`` on CUDA, plain with host counts on the CPU. It holds ``lr``
    only, so the optimizer and its ``NetState`` form no reference cycle."""

    def hook(opt: torch.optim.Optimizer) -> None:
        group = opt.param_groups[0]
        group["capturable"] = lr is not None
        _set_lr(group, lr, float(group["lr"]))
        for p in group["params"]:
            state = opt.state.get(p)
            if state and "step" in state:
                state["step"] = state["step"].to(p.device if lr is not None else "cpu",
                                                 torch.float32)

    return hook


def net_state(net: nn.Module, lr: float, beta1: float,
              schedule: Callable[[torch.optim.Optimizer], torch.optim.lr_scheduler.LambdaLR]
              ) -> NetState:
    """Adam (b2 0.999, eps 1e-8, optax's defaults) on ``net``'s parameters,
    with the LR schedule ``schedule(opt)``. On a network on CUDA the Adam is
    capturable and its LR a 0-d device tensor; the schedule's base LR stays
    a float, so no step reads the LR back to the host."""
    device = next(net.parameters()).device
    lr_t = torch.tensor(float(lr), device=device) if device.type == "cuda" else None
    opt = torch.optim.Adam(net.parameters(), lr=lr if lr_t is None else lr_t,
                           betas=(beta1, 0.999), eps=1e-8, capturable=lr_t is not None)
    opt.param_groups[0]["initial_lr"] = float(lr)
    ns = NetState(net, opt, schedule(opt), lr_t)
    ns.set_lr(opt.param_groups[0]["lr"])
    opt.register_load_state_dict_post_hook(keep_form(lr_t))
    return ns


def make_net_state(net: nn.Module, lr: float, beta1: float, milestones: Sequence[int],
                   gamma: float) -> NetState:
    """Adam with a multistep LR (``net_state``)."""
    return net_state(net, lr, beta1, lambda opt: multistep(opt, milestones, gamma))


@dataclasses.dataclass
class GANTrainState:
    """Generator, up to two discriminators, and the step counter."""

    step: int
    g: NetState
    d_target: Optional[NetState] = None
    d_source: Optional[NetState] = None
