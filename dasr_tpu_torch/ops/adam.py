"""Adam over one network's f32 tensors in one pass over memory: the
hand-written CUDA kernel (``csrc/adam.cu``), the host-side plan it reads,
and the checks of what it implements.

What it replaces: on the card, ``NetState.update`` called torch's
capturable ``torch.optim.Adam`` (``_multi_tensor_adam``). Its two divisions
by a list of 0-d tensors never take ATen's foreach fast path (which needs
every list to share sizes and strides), and its lerp and addcmul do not
where a gradient's strides differ from its parameter's, as the RDB
kernels' OIHW-contiguous gradients of ``channels_last`` parameters do
(``ops/rdb.py:_launch_backward``): each falls back to one kernel a tensor,
~2,800 launches over G's 702 tensors a step. It counterparts no Pallas
kernel: the JAX package's Adam is optax, compiled by XLA.

What bounds it on the H100: bytes. p, g, m and v read once and p, m and v
written once, ``BYTES_PER_PARAM`` 28 a parameter (``bound_ms``).

The plan (``AdamPlan``), built once per network and rebuilt only when a
parameter's or a moment's address moves (a loaded train state):

* the device table: a row a tensor (p, m, v and step pointers, the size,
  whether p, m and v take 16-byte vector accesses), then the units,
  (tensor, chunk) pairs of ``CHUNK`` elements in the parameter's memory
  order, packed as one int64 tensor;
* per call (``args``): each gradient's pointer and code, ``SAME_VEC``
  or ``SAME`` where its strides are its parameter's, else 2 + the index of
  its layout among the call's distinct layouts (``grad_layout``: the map
  from the parameter's memory order to the gradient's offsets, up to four
  merged dimensions, divided out with multiply-shift divisors
  (``divisor``)). The per-call part travels in the kernel's parameters, so
  a captured launch holds its own gradients' addresses.

An update is two launches: one counts (every tensor's step + 1), one
updates. A network of more than ``MAX_TENSORS`` tensors, or whose gradients
come in more than ``MAX_LAYOUTS`` layouts, is refused (the port's largest,
the Adaptive G, has 718 tensors and 5 layouts). The moments stay ``opt.state``'s
``exp_avg`` / ``exp_avg_sq`` in their parameter's layout, so state dicts
and checkpoints are torch's. Only what ``check_group`` accepts runs: Adam
with betas, eps and a device LR, no weight decay, amsgrad or maximize.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import torch

CHUNK = 4096  # elements of one unit (kChunk in csrc/adam.cu)
MAX_TENSORS = 1024  # tensors the update launch takes (kMaxTensors)
MAX_LAYOUTS = 32  # distinct gradient layouts the update launch takes (kMaxLayouts)
THREADS = 256  # threads a block (kThreads)
BLOCKS_PER_SM = 8  # the grid: at most this many blocks an SM
SAME_VEC, SAME = 0, 1  # gradient codes; 2 + i reads through layout i
ROW = 6  # int64 words of a table row: p, m, v, step, n, vec
BYTES_PER_PARAM = 28  # p, g, m, v read; p, m, v written; f32
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA's data sheet)


def bound_ms(n_params: int) -> float:
    """The least time in ms the H100 could take for Adam over ``n_params``
    f32 parameters: bytes, at the published HBM peak."""
    return n_params * BYTES_PER_PARAM / PEAK_BYTES_PER_S * 1e3


def check_group(group: dict, on_card: bool = True) -> None:
    """Raise on a param group the kernel does not implement: weight decay,
    amsgrad, maximize, a differentiable Adam or tensor betas; and, for
    tensors on the card (``on_card``), a non-capturable Adam or an LR that
    is not a 0-d f32 tensor on the card, since the kernel reads its count
    and its LR there."""
    bad = [name for name in ("weight_decay", "amsgrad", "maximize", "differentiable",
                             "decoupled_weight_decay") if group.get(name)]
    if any(isinstance(b, torch.Tensor) for b in group["betas"]):
        bad.append("tensor betas")
    if on_card and not group.get("capturable"):
        bad.append("capturable off")
    lr = group["lr"]
    if on_card and not (isinstance(lr, torch.Tensor) and lr.numel() == 1
                        and lr.dtype == torch.float32 and lr.is_cuda):
        bad.append("an LR that is not a 0-d f32 tensor on the card")
    if bad:
        raise ValueError(f"adam kernel: a param group with {', '.join(bad)} is not implemented "
                         f"(ops/adam.py implements Adam with betas, eps and a device LR)")


def memory_order(t: torch.Tensor) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(dims, sizes) of dense ``t`` in memory order, outermost first, its
    size-1 dims left out; raises where ``t`` is not dense (a parameter, or
    a moment, the kernel walks as one block of memory)."""
    dims = sorted((d for d in range(t.dim()) if t.shape[d] != 1), key=lambda d: -t.stride(d))
    expect = 1
    for d in reversed(dims):
        if t.stride(d) != expect:
            raise ValueError(f"adam kernel: a tensor of shape {tuple(t.shape)} and strides "
                             f"{t.stride()} is not dense")
        expect *= t.shape[d]
    return tuple(dims), tuple(t.shape[d] for d in dims)


def grad_layout(dims: Sequence[int], sizes: Sequence[int], stride: Sequence[int]
                ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The map from a parameter's memory order to its gradient's offsets:
    (sizes, gradient strides) of the parameter's dims in memory order
    (``memory_order``), each pair of neighbours merged where the gradient
    walks them as one. ((n,), (1,)) is the parameter's own layout."""
    out_sizes, out_strides = [], []
    for d, n in zip(dims, sizes):
        s = stride[d]
        if out_sizes and out_strides[-1] == s * n:
            out_sizes[-1] *= n
            out_strides[-1] = s
        else:
            out_sizes.append(n)
            out_strides.append(s)
    return tuple(out_sizes) or (1,), tuple(out_strides) or (1,)


def divisor(d: int) -> Tuple[int, int]:
    """(mul, shr) with q // d == (q * mul >> 32) >> shr for 0 <= q < 2^31
    (CUTLASS's FastDivmod); (0, 0) for d 1, which the kernel skips."""
    if d == 1:
        return 0, 0
    log2 = (d - 1).bit_length()  # ceil(log2(d))
    return ((1 << (31 + log2)) + d - 1) // d, log2 - 1


def pack_layout(layout) -> List[int]:
    """A layout as the kernel's 13 words: the four gradient strides of
    (i0, i1, i2, i3), then the divisors of i3, i2, i1, their multipliers
    and their shifts (``GradLayout`` in ``csrc/adam.cu``)."""
    sizes, strides = layout
    if len(sizes) > 4:
        raise ValueError(f"adam kernel: a gradient layout of {len(sizes)} merged dims "
                         f"(sizes {sizes}, strides {strides}); the kernel takes 4")
    sizes = (1,) * (4 - len(sizes)) + tuple(sizes)
    strides = (0,) * (4 - len(strides)) + tuple(strides)
    divs = [sizes[3], sizes[2], sizes[1]]
    muls, shrs = zip(*(divisor(d) for d in divs))
    return [*strides, *divs, *muls, *shrs]


class GradArgs(NamedTuple):
    """The update launch's per-call part: each gradient's pointer and code,
    and the call's distinct layouts (code 2 + i reads through layouts[i])."""

    grads: List[int]
    codes: List[int]
    layouts: List[tuple]


def init_state(opt: torch.optim.Optimizer, p: torch.Tensor) -> dict:
    """``p``'s Adam state, made as torch's capturable Adam makes it at its
    first step where there is none: a 0-d f32 count on p's device and zero
    moments in p's layout."""
    state = opt.state[p]
    if not state:
        state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
        state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return state


def _in_layout_of(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in ``p``'s strides (``t`` itself where it has them): a
    moment loaded from a file written with another layout."""
    if t.stride() == p.stride():
        return t
    return torch.empty_like(p, memory_format=torch.preserve_format).copy_(t)


def fingerprint(opt: torch.optim.Optimizer, params: Sequence[torch.Tensor]) -> tuple:
    """The addresses a plan bakes in: each parameter's and its Adam state's."""
    out = []
    for p in params:
        st = opt.state.get(p)
        if not st:
            return ()
        out += (p.data_ptr(), st["exp_avg"].data_ptr(), st["exp_avg_sq"].data_ptr(),
                st["step"].data_ptr())
    return tuple(out)


class AdamPlan:
    """The kernel's plan over ``params`` (the tensors an update takes, in
    order) of ``opt``, whose param groups ``check_group`` accepts where they
    are on the card. Makes each missing Adam state (``init_state``) and puts
    each moment into its parameter's layout first. ``table``: (tensors, ROW)
    int64 on the host, ``units``: (units, 2) int32 (tensor, chunk);
    ``device_table``: both packed into one int64 tensor on the parameters'
    device (None on the CPU, where the tests read the plan)."""

    def __init__(self, opt: torch.optim.Optimizer, params: Sequence[torch.Tensor]):
        params = list(params)
        if len(params) > MAX_TENSORS:
            raise ValueError(f"adam kernel: a network of {len(params)} tensors; the kernel "
                             f"takes {MAX_TENSORS}")
        device = params[0].device if params else torch.device("cpu")
        for group in opt.param_groups:
            check_group(group, device.type == "cuda")
        self.group = opt.param_groups[0]
        self.params = params
        rows, units = [], []
        self.orders, self.strides, self.vec = [], [], []
        for i, p in enumerate(params):
            if p.dtype != torch.float32 or p.device != device:
                raise ValueError(f"adam kernel: parameter {i} is {p.dtype} on {p.device}; the "
                                 f"kernel takes f32 tensors on one device ({device})")
            if p.numel() >= 2 ** 31:
                raise ValueError(f"adam kernel: parameter {i} has {p.numel()} elements (< 2^31)")
            self.orders.append(memory_order(p))
            state = init_state(opt, p)
            for name in ("exp_avg", "exp_avg_sq"):
                state[name] = _in_layout_of(p, state[name])
            m, v, step = state["exp_avg"], state["exp_avg_sq"], state["step"]
            if step.dtype != torch.float32 or step.numel() != 1 or step.device != device:
                raise ValueError(f"adam kernel: parameter {i}'s step is {step.dtype} "
                                 f"{tuple(step.shape)} on {step.device}; the kernel takes a 0-d "
                                 f"f32 count on {device}")
            ptrs = (p.data_ptr(), m.data_ptr(), v.data_ptr())
            vec = int(all(a % 16 == 0 for a in ptrs))
            rows.append([*ptrs, step.data_ptr(), p.numel(), vec])
            units += [(i, c) for c in range(-(-p.numel() // CHUNK))]
            self.strides.append(p.stride())
            self.vec.append(vec)
        self.table = torch.tensor(rows, dtype=torch.int64).reshape(-1, ROW)
        self.units = torch.tensor(units, dtype=torch.int32).reshape(-1, 2)
        self.fingerprint = fingerprint(opt, params)
        self._layouts = [{} for _ in params]  # per tensor: gradient strides -> layout
        self.device_table = None
        if device.type == "cuda":
            packed = torch.cat([self.table.flatten(),
                                self.units.contiguous().view(torch.int64).flatten()])
            self.device_table = packed.to(device)

    def current(self, opt: torch.optim.Optimizer, params: Sequence[torch.Tensor]) -> bool:
        """Whether the plan still holds ``params``' and their state's
        addresses."""
        return len(params) == len(self.params) and fingerprint(opt, params) == self.fingerprint

    def code(self, i: int, g: torch.Tensor, layouts: dict) -> int:
        """Tensor i's gradient code; a new layout is added to ``layouts``
        (layout -> index)."""
        p = self.params[i]
        if g.shape != p.shape or g.dtype != torch.float32 or g.device != p.device:
            raise ValueError(f"adam kernel: gradient {i} is {g.dtype} {tuple(g.shape)} on "
                             f"{g.device}; its parameter {p.dtype} {tuple(p.shape)} on {p.device}")
        stride = g.stride()
        if stride != self.strides[i]:
            layout = self._layouts[i].get(stride)
            if layout is None:
                layout = self._layouts[i][stride] = grad_layout(*self.orders[i], stride)
            if layout[1] != (1,):
                if layout not in layouts:
                    layouts[layout] = len(layouts)
                return 2 + layouts[layout]
        return SAME_VEC if self.vec[i] and g.data_ptr() % 16 == 0 else SAME

    def args(self, grads: Sequence[torch.Tensor]) -> GradArgs:
        """The update launch's per-call part for ``grads`` (one per
        parameter, in order)."""
        if len(grads) != len(self.params):
            raise ValueError(f"adam kernel: {len(grads)} gradients for {len(self.params)} "
                             f"parameters")
        layouts = {}
        codes = [self.code(i, g, layouts) for i, g in enumerate(grads)]
        if len(layouts) > MAX_LAYOUTS:
            raise ValueError(f"adam kernel: gradients in {len(layouts)} layouts; the kernel "
                             f"takes {MAX_LAYOUTS}")
        return GradArgs([g.data_ptr() for g in grads], codes, list(layouts))

    def step(self, grads: Sequence[torch.Tensor]) -> int:
        """One Adam step on the card over ``grads``, on the current stream:
        the count, then the update. Returns the launches made."""
        from dasr_tpu_torch.kernels import build

        if not self.params:
            return 0
        lib = build.load()
        check_group(self.group)
        args = self.args(grads)
        n = len(self.params)
        words = [w for layout in args.layouts for w in pack_layout(layout)]
        device = self.device_table.device
        table = self.device_table.data_ptr()
        b1, b2 = self.group["betas"]
        grid = min(len(self.units), BLOCKS_PER_SM * _sm_count(device.index))
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            build.check(lib, lib.dasr_adam_count(table, n, stream), "adam count")
            rc = lib.dasr_adam_update(
                table, table + 8 * ROW * n, len(self.units), self.group["lr"].data_ptr(), n,
                (ctypes.c_void_p * n)(*args.grads), (ctypes.c_ubyte * n)(*args.codes),
                (ctypes.c_uint * max(len(words), 1))(*words), len(args.layouts),
                float(b1), float(b2), float(self.group["eps"]), grid, stream)
            build.check(lib, rc, "adam update")
        return 2


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_constants() -> List[int]:
    """The constants compiled into the kernel: CHUNK, MAX_TENSORS,
    MAX_LAYOUTS, THREADS and the size of its parameter block. Loads the
    library, so it needs nvcc."""
    from dasr_tpu_torch.kernels import build

    out = (ctypes.c_int * 8)()
    n = build.load().dasr_adam_plan(out, len(out))
    return list(out[:n])


def plan_for(opt: torch.optim.Optimizer, params: Sequence[torch.Tensor],
             plan: "AdamPlan | None") -> AdamPlan:
    """``plan`` where it still holds ``params``' addresses, else a new one."""
    return plan if plan is not None and plan.current(opt, params) else AdamPlan(opt, params)
