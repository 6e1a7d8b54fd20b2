"""The banked windows replayed from a CUDA graph on the card against the
eager loop, at a small size: the DASR step (RRDBNet nf 32 nb 1 gc 32, so
the RDB kernel runs; LPIPS alex; HR 32) and the DSN step (DeResnet nb 1,
FSD, LPIPS alex, crop 128), f32, two windows of 4 steps from one state;
the DASR step at bf16 and the DASR Adaptive step (nf 32 nb 1 ada_nb 1, the
gau patch D, bf16, with and without the patch D's Adam step) and the
srragan step (RRDBNet nf 32 nb 1 gc 32, the BatchNorm VGG D for 48-px
crops at nf 16, VGG19-54, bf16; D's running statistics moved on its two own
forwards a step, replayed) bit for bit, each generator forward one launch
of its RDB weight plan and no RDB casting its own kernels; and a dropped
graphed trainer leaves no device memory behind.

Imports neither jax nor the JAX package, so it runs where only the port is
installed, without the suite's conftest:

    python3 -m pytest --noconftest tests/test_torch_step_graph_card.py

Every test is marked ``cuda`` and skips without a card."""

import gc

import numpy as np
import pytest
import torch

from dasr_tpu_torch.core.device import resolve_device
from dasr_tpu_torch.data import device_bank as bank
from dasr_tpu_torch.nn.discriminators import FSDiscriminator, make_vgg_discriminator
from dasr_tpu_torch.nn.generators import RRDBNet, RRDBNetResidualConv
from dasr_tpu_torch.ops.rdb import TOLERANCES, fused_rdb
from dasr_tpu_torch.train import step_graph
from dasr_tpu_torch.train.dasr_adaptive_trainer import AdaptiveConfig, DASRAdaptiveTrainer
from dasr_tpu_torch.train.dsn_trainer import DSNConfig, DSNTrainer
from dasr_tpu_torch.train.srgan_trainer import SRGANConfig, SRGANTrainer
from dasr_tpu_torch.train.srn_trainer import SRNConfig, SRNTrainer
from dasr_tpu_torch.utils import trace

K = 4


def _bank(rng, n, hw, c=3, f32=False):
    data = (rng.random((n, *hw, c), dtype=np.float32) if f32
            else rng.integers(0, 256, (n, *hw, c)).astype(np.uint8))
    return bank.upload(bank.ImageBank(data, np.array([hw] * n, np.int32)), "cuda")


def _trainers(kind, dtype=torch.float32):
    """Two trainers from one seeded state on the card, and their window."""
    rng = np.random.default_rng(0)
    if kind == "dasr":
        banks = bank.SrnBanks(_bank(rng, 3, (12, 14)), _bank(rng, 3, (48, 56)),
                              _bank(rng, 2, (10, 9)), _bank(rng, 3, (12, 14), 1, f32=True))
        cfg = SRNConfig(nf=32, nb=1, gc=32, d_nf=16, seed=5, lr_steps=(3,), dtype=dtype)
        make = lambda: SRNTrainer(cfg, "cuda")  # noqa: E731

        def window(tr, start, idx):
            return tr.train_banked_step(banks, idx, start, 32)
    else:
        clean, noisy = _bank(rng, 3, (140, 132)), _bank(rng, 4, (40, 44))
        cfg = DSNConfig(num_res_blocks=1, filter="avg_pool", seed=3)
        make = lambda: DSNTrainer(cfg, "cuda", decay=(3, 2, 2))  # noqa: E731

        def window(tr, start, idx):
            return tr.train_banked_step(clean, noisy, idx, start, 128, True, True)
    out = []
    for _ in range(2):
        tr = make()
        tr.init_state()
        out.append(tr)
    out[1].graphs = step_graph.StepGraphs(out[1].device, capture=None)  # the eager loop
    n = 3 if kind == "dasr" else 4
    idx = torch.from_numpy(rng.integers(0, n, (2, K, 2))).cuda()
    return out, window, idx


def _flat(ns, what):
    if what == "params":
        return torch.cat([p.detach().flatten() for p in ns.params()])
    return torch.cat([ns.opt.state[p][what].flatten() for p in ns.params()])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dasr", "dsn"])
def test_replayed_windows_equal_the_eager_loop(kind):
    """Losses within the three-step loss limits, each network's update and
    Adam moments within the update and moment limits of their norm, the
    same LR and step, the same kernel launches, and replays counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    resolve_device("cuda")  # the port's f32 rule: TF32 off
    (graphed, eager), window, idx = _trainers(kind)
    init = {name: _flat(getattr(eager.state, name), "params").clone() for name in ("g",
                                                                                   "d_target")}
    launches, got, want = [], [], []
    for tr, is_eager, sink in ((graphed, False, got), (eager, True, want)):
        before, replays = fused_rdb.launches, trace.counters().get("graph.replays", 0)
        for w in range(2):
            sink.append(window(tr, w * K, idx[w]))
        torch.cuda.synchronize()
        launches.append(fused_rdb.launches - before)
        if not is_eager:
            assert trace.counters()["graph.replays"] - replays == 2 * K - 1
    # nb 1: three RDBs of five launches a generator forward; DeResnet has none
    assert launches[0] == launches[1] == (2 * K * 3 * 5 if kind == "dasr" else 0)
    atol, rtol = TOLERANCES["train_loss_f32"]
    for g, w in zip(got, want):
        for k in w:
            assert abs(float(g[k]) - float(w[k])) <= atol + rtol * abs(float(w[k])), k
    assert graphed.state.step == eager.state.step == 2 * K
    for name in ("g", "d_target"):
        a, b = getattr(graphed.state, name), getattr(eager.state, name)
        p, pr = _flat(a, "params"), _flat(b, "params")
        assert ((p - pr).norm() / (pr - init[name]).norm()).item() <= (
            TOLERANCES["train_update_f32"][1])
        for what in ("exp_avg", "exp_avg_sq"):
            m, mr = _flat(a, what), _flat(b, what)
            assert ((m - mr).norm() / mr.norm()).item() <= TOLERANCES["train_moment_f32"][1]
        assert float(a.lr) == float(b.lr)
        assert a.opt.param_groups[0]["lr"] is a.lr and a.opt.param_groups[0]["capturable"]


def _adaptive_trainers(use_patchd_opt):
    """Two Adaptive trainers from one seeded state on the card at bf16
    (RRDB_Residual_conv nf 32 nb 1 ada_nb 1, the shipped config's patch D),
    banks with no DDM bank, and their window."""
    rng = np.random.default_rng(0)
    banks = bank.SrnBanks(_bank(rng, 3, (12, 14)), _bank(rng, 3, (48, 56)),
                          _bank(rng, 2, (10, 9)), None)
    cfg = AdaptiveConfig(nf=32, nb=1, gc=32, d_nf=16, seed=5, lr_steps=(3,),
                         use_patchD_opt=use_patchd_opt, dtype=torch.bfloat16)
    out = []
    for _ in range(2):
        g = RRDBNetResidualConv(nf=32, nb=1, gc=32, nb_ada=1, dtype=torch.bfloat16)
        patchd = FSDiscriminator(d_arch="FSD", filter_type="gau", kernel_size=5,
                                 norm_layer="Instance", dtype=torch.bfloat16)
        tr = DASRAdaptiveTrainer(cfg, g, patchd, "cuda")
        tr.init_state()
        out.append(tr)
    out[1].graphs = step_graph.StepGraphs(out[1].device, capture=None)  # the eager loop

    def window(tr, start, idx):
        return tr.train_banked_step(banks, idx, start, 32)

    return out, window, torch.from_numpy(rng.integers(0, 3, (2, K, 2))).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("use_patchd_opt", [False, True])
def test_adaptive_replayed_windows_equal_the_eager_loop_bit_for_bit(use_patchd_opt):
    """The DASR Adaptive step at bf16 (the online DDM; with
    ``use_patchD_opt`` the patch D's Adam step first): two replayed windows
    of 4 steps equal the eager loop's bit for bit in the metrics, every
    network's params and Adam moments, with the same kernel launches (30 a
    generator forward, and one launch of its weight plan), the bf16
    backward through the kernels, no RDB casting its own kernels, and every
    step but the first replayed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    resolve_device("cuda")
    (graphed, eager), window, idx = _adaptive_trainers(use_patchd_opt)
    _bit_for_bit(graphed, eager, window, idx, rdbs=6,
                 nets=("g", "d_target") + (("patchd",) if use_patchd_opt else ()),
                 patchd_loss=use_patchd_opt)


def _bit_for_bit(graphed, eager, window, idx, rdbs, nets, patchd_loss=False):
    """Two windows of ``graphed`` (replayed) and ``eager`` (the eager loop)
    from one state give the same bits in the metrics, the params and Adam
    moments of ``nets``, with the same counts: a generator forward of
    ``rdbs`` RDBs (5 launches each) is one weight plan launch, and every RDB
    takes the plan's kernels and runs the backward kernels. Returns the
    counts of the RDB kernels and of BatchNorm's statistic moves."""
    counts, got, want = [], [], []
    for tr, is_eager, sink in ((graphed, False, got), (eager, True, want)):
        before, replays = trace.counters(), trace.counters().get("graph.replays", 0)
        for w in range(2):
            sink.append(window(tr, w * K, idx[w]))
        torch.cuda.synchronize()
        counts.append({k: v - before.get(k, 0) for k, v in trace.counters().items()
                       if k.startswith(("fused_rdb.", "rdb_prep.", "bn."))})
        if not is_eager:
            assert trace.counters()["graph.replays"] - replays == 2 * K - 1
    assert counts[0] == counts[1]
    assert counts[0]["fused_rdb.launches"] == 2 * K * rdbs * 5
    assert counts[0]["fused_rdb.bwd_kernel"] > 0 and counts[0]["fused_rdb.bwd_chain"] == 0
    assert counts[0]["rdb_prep.launches"] == 2 * K
    assert counts[0]["fused_rdb.prepared"] == 2 * K * rdbs and counts[0]["fused_rdb.cast"] == 0
    for g, w in zip(got, want):
        assert set(g) == set(w) and ("loss/patch_D_gan_loss" in w) == patchd_loss
        for k in w:
            assert torch.equal(g[k], w[k]), k
    assert graphed.state.step == eager.state.step == 2 * K
    for name in nets:
        a, b = getattr(graphed.state, name), getattr(eager.state, name)
        for what in ("params", "exp_avg", "exp_avg_sq"):
            assert torch.equal(_flat(a, what), _flat(b, what)), (name, what)
        for (key, x), (_, y) in zip(a.net.named_buffers(), b.net.named_buffers()):
            assert torch.equal(x, y), (name, key)
        assert float(a.lr) == float(b.lr)
    return counts[0]


@pytest.mark.cuda
def test_srragan_replayed_windows_equal_the_eager_loop_bit_for_bit():
    """The srragan step at bf16 (RaGAN, VGG19-54, the 48 VGG D with its 11
    BatchNorms), two replayed windows of 4 steps against the eager loop, as
    the Adaptive step: the same bits in the metrics, G's and D's params,
    Adam moments and D's running statistics; every RDB on the weight plan,
    none casting its own kernels; and the statistics moved by D's two own
    forwards a step, replayed or not (``bn.stat_updates``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    resolve_device("cuda")
    rng = np.random.default_rng(0)
    banks = bank.PairedBanks(_bank(rng, 4, (14, 16)), _bank(rng, 4, (56, 64)))
    cfg = SRGANConfig(seed=5, lr_steps=(3,), ragan=True, dtype=torch.bfloat16)
    trainers = []
    for _ in range(2):
        tr = SRGANTrainer(cfg, RRDBNet(nf=32, nb=1, gc=32, dtype=torch.bfloat16),
                          make_vgg_discriminator("discriminator_vgg_48", nf=16), "cuda")
        tr.init_state()
        trainers.append(tr)
    trainers[1].graphs = step_graph.StepGraphs(trainers[1].device, capture=None)
    idx = torch.from_numpy(rng.integers(0, 4, (2, K, 2))).cuda()
    counts = _bit_for_bit(*trainers, lambda tr, start, i: tr.train_banked_step(banks, i, start, 48),
                          idx, rdbs=3, nets=("g", "d_target"))
    assert counts["bn.stat_updates"] == 2 * 2 * K
    assert counts["bn.layer_updates"] == 2 * 2 * K * 11


@pytest.mark.cuda
def test_bf16_dasr_replayed_windows_equal_the_eager_loop_bit_for_bit():
    """The DASR step at bf16 (RRDBNet nf 32 nb 1: 3 RDBs), two replayed
    windows of 4 steps against the eager loop, as the Adaptive step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    resolve_device("cuda")
    (graphed, eager), window, idx = _trainers("dasr", torch.bfloat16)
    _bit_for_bit(graphed, eager, window, idx, rdbs=3, nets=("g", "d_target"))


@pytest.mark.cuda
def test_dropped_graphed_trainers_leave_no_memory_behind():
    """A trainer that captured and replayed its step frees everything when
    dropped: after a first run (which sets up what a process keeps, such as
    cuBLAS's workspace on the one capture stream), a second one leaves the
    allocated memory where it found it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    resolve_device("cuda")

    def run():
        (tr, _), window, idx = _trainers("dasr")
        window(tr, 0, idx[0])
        torch.cuda.synchronize()

    run()
    gc.collect()
    base = torch.cuda.memory_allocated()
    run()
    gc.collect()
    assert torch.cuda.memory_allocated() == base
