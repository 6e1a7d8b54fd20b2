"""Shared body of the port's multi-rank tests: a gloo world of N processes
on the CPU (``run_ranks``), and the train-step cases that an N-rank run and
a 1-rank run on the concatenated global batch both take (``run_case``).

This module imports torch and the port only: ``mp.spawn``'s children
import it, and they stay free of JAX. Each child joins its world through
the launcher's variables (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` /
``MASTER_PORT``), as torchrun's children do, runs one intra-op thread, and
hands its result back through a file."""

import contextlib
import datetime
import importlib
import io
import logging
import os
import socket
import tempfile

import numpy as np
import torch
import torch.multiprocessing as mp

from dasr_tpu_torch.core import dist

# widths: nf <= 16, nb <= 2; the global batches are 4 (2 a rank)
NF, NB, GC, D_NF = 16, 1, 8, 16
B, LR, SCALE = 4, 16, 4
HR = LR * SCALE
DSN_HR = 128  # LPIPS alex needs a 32-px LR
SRGAN_LR, SRGAN_NF = 12, 8  # HR 48 for discriminator_vgg_48
STEPS = 3


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launcher_env(rank: int, n: int, port: int) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(n), LOCAL_RANK=str(rank))


def _child(rank, n, port, out_dir, fn, args):
    launcher_env(rank, n, port)
    torch.set_num_threads(1)
    # a collective that waits longer fails the child, and mp.spawn the call
    world = dist.init_world("cpu", timeout=datetime.timedelta(seconds=120))
    result = fn(world, *args)
    torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
    world.barrier()


def run_ranks(fn, n: int, *args):
    """``fn(world, *args)`` in each of ``n`` processes of a gloo world on the
    CPU; their results, in rank order. A child that fails fails the call."""
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_child, args=(n, free_port(), out_dir, fn, args), nprocs=n, join=True)
        return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False)
                for r in range(n)]


def run_cli(world: dist.World, module: str, argv, expect_error: bool = False):
    """``module``'s ``main(argv)`` on this rank: its return value and what
    it printed and logged; with ``expect_error``, the exception's type and
    message instead of a failed child."""
    out = io.StringIO()
    logging.root.handlers.clear()  # the CLI binds its log handler to this stdout
    try:
        with contextlib.redirect_stdout(out):
            ret = importlib.import_module(module).main(argv)
    except Exception as e:
        if not expect_error:
            raise
        return {"error": type(e).__name__, "msg": str(e), "out": out.getvalue()}
    return {"ret": ret, "out": out.getvalue()}


# -- the step cases -----------------------------------------------------------


def _nchw(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
            for k, v in b.items()}


def _srn_batch(rng, with_w=True):
    b = {"LR_fake": rng.random((B, LR, LR, 3), dtype=np.float32),
         "LR_real": rng.random((B, LR, LR, 3), dtype=np.float32),
         "HR": rng.random((B, HR, HR, 3), dtype=np.float32),
         "HR_unpair": rng.random((B, HR, HR, 3), dtype=np.float32)}
    if with_w:
        b["fake_w"] = rng.random((B, LR // 2, LR // 2, 1), dtype=np.float32)
    return b


def _srn(**kw):
    from dasr_tpu_torch.train.srn_trainer import SRNConfig, SRNTrainer

    tr = SRNTrainer(SRNConfig(nf=NF, nb=NB, gc=GC, d_nf=D_NF, lr_steps=(), **kw))
    tr.init_state()
    return tr, [_srn_batch(np.random.default_rng(i)) for i in range(STEPS)]


def _dsn(**kw):
    from dasr_tpu_torch.train.dsn_trainer import DSNConfig, DSNTrainer

    tr = DSNTrainer(DSNConfig(num_res_blocks=1, **kw))
    tr.init_state()
    batches = []
    for i in range(STEPS):
        rng = np.random.default_rng(10 + i)
        batches.append({"input": rng.random((B, DSN_HR, DSN_HR, 3), dtype=np.float32),
                        "disc": rng.random((B, DSN_HR // 4, DSN_HR // 4, 3),
                                           dtype=np.float32)})
    return tr, batches


def _srragan():
    from dasr_tpu_torch.models.registry import create_model

    opt = {"model": "srragan", "scale": 4, "bf16": False, "is_train": True,
           "network_G": {"which_model_G": "RRDB_net", "nf": SRGAN_NF, "nb": NB, "gc": GC},
           "network_D": {"which_model_D": "discriminator_vgg_48", "nf": SRGAN_NF},
           "train": {"manual_seed": 0, "lr_steps": []}}
    tr = create_model(opt).init().trainer
    batches = []
    for i in range(STEPS):
        rng = np.random.default_rng(20 + i)
        batches.append({"LR": rng.random((B, SRGAN_LR, SRGAN_LR, 3), dtype=np.float32),
                        "HR": rng.random((B, 4 * SRGAN_LR, 4 * SRGAN_LR, 3),
                                         dtype=np.float32)})
    return tr, batches


def _adaptive():
    from dasr_tpu_torch.nn.discriminators import FSDiscriminator
    from dasr_tpu_torch.nn.generators import RRDBNetResidualConv
    from dasr_tpu_torch.train.dasr_adaptive_trainer import AdaptiveConfig, DASRAdaptiveTrainer

    g = RRDBNetResidualConv(nf=NF, nb=NB, gc=GC, nb_ada=1)
    patchd = FSDiscriminator(d_arch="FSD", filter_type="avg_pool", kernel_size=5)
    tr = DASRAdaptiveTrainer(AdaptiveConfig(nf=NF, nb=NB, gc=GC, d_nf=D_NF, lr_steps=(),
                                            use_patchD_opt=True), g, patchd)
    tr.init_state()
    return tr, [_srn_batch(np.random.default_rng(30 + i), with_w=False) for i in range(STEPS)]


CASES = {
    "dasr_wavelet": lambda: _srn(),
    "dasr_ragan_source": lambda: _srn(ragan=True, gan_H_source=0.005),
    "dsn_vanilla": lambda: _dsn(),
    "dsn_ragan_wgan": lambda: _dsn(ragan=True, wgan=True),
    "srragan_bn": _srragan,
    "adaptive": _adaptive,
}

BANK_K, BANK_N = 2, 6  # a window of K rows of B indices into N banked images


def _banks():
    from dasr_tpu_torch.data.device_bank import ImageBank, SrnBanks

    rng = np.random.default_rng(40)

    def bank(n, size, c=3):
        data = rng.integers(0, 256, (n, size + 4, size + 6, c), dtype=np.uint8)
        sizes = np.tile([size + 4, size + 6], (n, 1)).astype(np.int32)
        return ImageBank(torch.from_numpy(data), torch.from_numpy(sizes))

    ddm = bank(BANK_N, LR, 1)
    ddm = ImageBank(ddm.data.float() / 255.0, ddm.sizes)
    return SrnBanks(bank(BANK_N, LR), bank(BANK_N, HR), bank(BANK_N, LR), ddm)


def _nets(tr):
    st = tr.state
    nets = {"G": st.g, "D_target": st.d_target}
    for name in ("d_source", "patchd"):
        ns = getattr(st, name, None)
        if ns is not None:
            nets[name] = ns
    return nets


def _state(ns):
    """A network's params and buffers by name, and Adam's two moments
    flattened (0 before its first step)."""
    def moment(key):
        return torch.cat([ns.opt.state[p][key].flatten() if p in ns.opt.state
                          else torch.zeros(p.numel()) for p in ns.params()])

    return {"params": {k: p.detach().clone() for k, p in ns.net.named_parameters()
                       if p.requires_grad},
            "buffers": {k: b.clone() for k, b in ns.net.named_buffers()},
            "exp_avg": moment("exp_avg"), "exp_avg_sq": moment("exp_avg_sq")}


def cancelled(net) -> set:
    """The biases whose gradient is zero but for rounding: a conv's bias
    before a BatchNorm or an InstanceNorm (the norm subtracts it)."""
    from dasr_tpu_torch.nn.discriminators import InstanceNorm

    norms = (torch.nn.BatchNorm2d, torch.nn.InstanceNorm2d, InstanceNorm)
    out = set()
    for prefix, mod in net.named_modules():
        if isinstance(mod, torch.nn.Sequential):
            kids = list(mod.named_children())
            for (name, a), (_, b) in zip(kids, kids[1:]):
                if isinstance(a, torch.nn.Conv2d) and a.bias is not None and isinstance(b, norms):
                    out.add(f"{prefix}.{name}.bias" if prefix else f"{name}.bias")
    return out


def run_case(name: str, world: dist.World):
    """Case ``name``'s three steps in ``world``, each rank on its rows of the
    global batches: the metrics of each step and each network's state after
    them. The replicated state is checked equal on every rank."""
    if name == "banked":
        tr, _ = _srn()
        idx = torch.from_numpy(np.random.default_rng(41).integers(0, BANK_N, (BANK_K, B)))
        steps = [tr.train_banked_step(_banks(), idx, seed=7, hr_size=HR)]
    else:
        tr, batches = CASES[name]()
        steps = [tr.train_step(_nchw({k: world.shard(v) for k, v in b.items()}))
                 for b in batches]
    nets = _nets(tr)
    for net_name, ns in nets.items():
        world.check_replicated(ns.net.state_dict().items(), f"{name} {net_name}")
    return {"metrics": [{k: float(v) for k, v in m.items()} for m in steps],
            "nets": {k: _state(ns) for k, ns in nets.items()},
            "cancelled": {k: cancelled(ns.net) for k, ns in nets.items()}}


def run_cases(world: dist.World, names):
    return {name: run_case(name, world) for name in names}


# -- against JAX's mesh: children given the parent's exported weights ----------


def run_srn_steps(world: dist.World, sds, batches, kw):
    """Three SRN steps from the state dicts ``sds`` (G, D_target, LPIPS),
    each rank on its rows of the global batches: the metrics and G's and D's
    state dicts after them."""
    from dasr_tpu_torch.losses.lpips import LPIPS
    from dasr_tpu_torch.train.srn_trainer import SRNConfig, SRNTrainer

    lpips = LPIPS()
    lpips.load_state_dict(sds["LPIPS"])
    tr = SRNTrainer(SRNConfig(**kw), lpips=lpips.requires_grad_(False))
    st = tr.init_state()
    st.g.net.load_state_dict(sds["G"])
    st.d_target.net.load_state_dict(sds["D_target"])
    metrics = [tr.train_step(_nchw({k: world.shard(v) for k, v in b.items()})) for b in batches]
    return {"metrics": [{k: float(v) for k, v in m.items()} for m in metrics],
            "G": st.g.net.state_dict(), "D_target": st.d_target.net.state_dict()}


def run_sharded_rrdbs(world: dist.World, sd, nf, nb, gc, xs, halo):
    """An x4 RRDBNet from ``sd`` over each NHWC image of ``xs`` ({name:
    image}) with its H axis split over the ranks
    (``spatially_sharded_apply``), NHWC."""
    from dasr_tpu_torch.nn.generators import RRDBNet
    from dasr_tpu_torch.ops.spatial_shard import spatially_sharded_apply

    net = RRDBNet(nf=nf, nb=nb, gc=gc)
    net.load_state_dict(sd)
    with torch.no_grad():
        return {k: spatially_sharded_apply(_nchw({"x": x})["x"], net, 4, halo, world)
                .permute(0, 2, 3, 1).numpy() for k, x in xs.items()}


def blur3(x):
    """A depthwise 3x3 box blur with zero padding, NCHW."""
    c = x.shape[1]
    return torch.nn.functional.conv2d(x, torch.full((c, 1, 3, 3), 1 / 9.0), padding=1, groups=c)


def run_sharded_blur(world: dist.World, x, halo):
    from dasr_tpu_torch.ops.spatial_shard import spatially_sharded_apply

    return spatially_sharded_apply(_nchw({"x": x})["x"], blur3, 1, halo, world).permute(
        0, 2, 3, 1).numpy()


def run_tiled_rrdb(world: dist.World, sd, nf, nb, gc, x, tile, halo):
    """``tiled_apply`` of an x4 RRDBNet from ``sd`` over ``world``'s ranks,
    and the number of tiles this rank ran."""
    from dasr_tpu_torch.nn.generators import RRDBNet
    from dasr_tpu_torch.ops.tiled import tiled_apply

    net = RRDBNet(nf=nf, nb=nb, gc=gc)
    net.load_state_dict(sd)
    seen = []

    def model(t):
        seen.append(t.shape[0])
        return net(t)

    with torch.no_grad():
        out = tiled_apply(_nchw({"x": x})["x"], model, 4, tile=tile, halo=halo, world=world)
    return out.permute(0, 2, 3, 1).numpy(), seen


def run_clis(world: dist.World, calls):
    """``run_cli`` over a list of (module, argv[, expect_error]), in order."""
    return [run_cli(world, *call) for call in calls]


def create_model_errors(world: dist.World, opts):
    """For each options dict, the NotImplementedError ``create_model`` raises
    on this rank, as text (None where it builds the model)."""
    from dasr_tpu_torch.models.registry import create_model

    out = []
    for opt in opts:
        try:
            create_model(opt)
            out.append(None)
        except NotImplementedError as e:
            out.append(str(e))
    return out
