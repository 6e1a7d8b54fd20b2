"""The replayed banked window (``dasr_tpu_torch/train/step_graph.py``) on the
CPU, with stand-ins for the CUDA graph: the step on static buffers, its
per-step inputs written the way a replay writes them, equals the eager
``train_banked_step`` for the DASR step (RRDBNet nf 16 nb 1) and the DSN
step (DeResnet nb 1, vanilla and WGAN-GP) in losses, params and Adam's
moments (f32, RTOL 1e-6 as tests/test_torch_banked_step.py; exact equality
is expected), and the DASR Adaptive step bit for bit (with and without the
patch D's Adam step), which tests/test_torch_banked_step.py holds against
``train_step`` and tests/test_torch_{srn,dsn}_step_*.py against JAX, and
the srragan step bit for bit, D's BatchNorm statistics with it (which
tests/test_torch_esrgan_reference.py holds against ``train_step``). Also:
the LR a tensor-LR ``NetState`` is given each step equals the float
``LambdaLR``'s across a multistep milestone and a ``dsn_linear_decay``
step; a window's metrics do not change when the next window runs; a
replay is credited with the kernel launches and the Adam counts its
capture recorded, and with a counter the step graph does not name; a
window without a capture is the eager loop; with
tracing on, each step's host work is a span of its step's id, and the
captures, recaptures and replays are counted (``utils/trace.py``)."""

import copy
import gc
import weakref

import numpy as np
import pytest
import torch

from dasr_tpu_torch.data import device_bank as bank
from dasr_tpu_torch.nn.discriminators import FSDiscriminator
from dasr_tpu_torch.nn.generators import RRDBNetResidualConv
from dasr_tpu_torch.ops.rdb import fused_rdb
from dasr_tpu_torch.train import step_graph
from dasr_tpu_torch.train.dasr_adaptive_trainer import AdaptiveConfig, DASRAdaptiveTrainer
from dasr_tpu_torch.train.dsn_trainer import DSNConfig, DSNTrainer
from dasr_tpu_torch.train.schedules import dsn_linear_decay, multistep
from dasr_tpu_torch.train.srn_trainer import SRNConfig, SRNTrainer
from dasr_tpu_torch.train.state import NetState, keep_form, net_state
from dasr_tpu_torch.utils import trace

RTOL = 1e-6
HR_SIZE = 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small ops: torch's intra-op threads only contend with the other
    test workers for the cores (as in tests/test_torch_banked_step.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def replaying_capture(step, args, stream):
    """A CUDA graph's memory behaviour on the CPU: the capture runs nothing;
    each replay runs ``step`` on the static inputs and writes its outputs
    into the same tensors, which the first replay made."""
    outputs = {}

    def replay():
        out = step(*args)
        if not outputs:
            outputs.update(out)
        else:
            for k, v in out.items():
                outputs[k].copy_(v)
        return outputs

    return replay


def recording_capture(step, args, stream):
    """A CUDA graph's launch behaviour: the capture runs the step's Python
    once (where the kernel wrappers count), a replay runs no Python."""
    out = step(*args)
    return lambda: out


def _bank(rng, n, hw, c=3, f32=False):
    data = (rng.random((n, *hw, c), dtype=np.float32) if f32
            else rng.integers(0, 256, (n, *hw, c)).astype(np.uint8))
    return bank.ImageBank(torch.from_numpy(data), torch.tensor([hw] * n, dtype=torch.int32))


@pytest.fixture
def tracing():
    """The recorder on for one test, from an empty list; off after it."""
    trace.drain()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.drain()


def _replays():
    return trace.counters().get("graph.replays", 0)


@pytest.fixture(scope="module")
def srn_banks():
    rng = np.random.default_rng(0)
    return bank.SrnBanks(_bank(rng, 3, (12, 14)), _bank(rng, 3, (48, 56)),
                         _bank(rng, 2, (10, 9)), _bank(rng, 3, (12, 14), 1, f32=True))


@pytest.fixture(scope="module")
def dsn_banks():
    rng = np.random.default_rng(1)
    return _bank(rng, 3, (70, 66)), _bank(rng, 4, (20, 22))


def _srn_trainer():
    tr = SRNTrainer(SRNConfig(nf=16, nb=1, gc=8, d_nf=16, d_n_layers=2, seed=5,
                              lr_steps=(2,)))
    tr.init_state()
    return tr


def _dsn_trainer(wgan):
    tr = DSNTrainer(DSNConfig(num_res_blocks=1, use_per_loss=False, filter="avg_pool",
                              wgan=wgan, seed=3), decay=(3, 2, 1))
    tr.init_state()
    return tr


def _flat(ns, what):
    if what == "params":
        return torch.cat([p.detach().flatten() for p in ns.params()])
    return torch.cat([ns.opt.state[p][what].flatten() for p in ns.params()])


def _assert_close(a, b):
    torch.testing.assert_close(a, b, rtol=RTOL, atol=RTOL * float(b.abs().max()))


def _assert_same_state(a, b, names):
    assert a.state.step == b.state.step
    for name in names:
        na, nb = getattr(a.state, name), getattr(b.state, name)
        for what in ("params", "exp_avg", "exp_avg_sq"):
            _assert_close(_flat(na, what), _flat(nb, what))
        assert na.opt.param_groups[0]["lr"] == nb.opt.param_groups[0]["lr"]


def _windows(run, windows):
    """Each window's metrics, read after every window has run."""
    return [run(start, idx) for start, idx in windows]


WINDOWS = [(0, torch.tensor([[0, 2], [1, 1], [2, 0]])), (3, torch.tensor([[1, 2], [0, 0]]))]


def test_srn_replayed_window_equals_eager(srn_banks):
    """Two windows (3 steps across the milestone at 2, then 2): the first
    step of the key is the eager warm-up, the other four replay."""
    a, b = _srn_trainer(), _srn_trainer()
    a.graphs = step_graph.StepGraphs("cpu", capture=replaying_capture)
    got = _windows(lambda s, idx: a.train_banked_step(srn_banks, idx, s, HR_SIZE), WINDOWS)
    want = _windows(lambda s, idx: b.train_banked_step(srn_banks, idx, s, HR_SIZE), WINDOWS)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            _assert_close(g[k], w[k])
    _assert_same_state(a, b, ("g", "d_target"))
    assert a.state.step == 5 and len(a.graphs._graphs) == 1


@pytest.mark.parametrize("wgan", [False, True])
def test_dsn_replayed_window_equals_eager(dsn_banks, wgan):
    """As the DASR case, across ``dsn_linear_decay``'s steps at 2 and 3; with
    WGAN-GP the mixing draws are written before each replay."""
    clean, noisy = dsn_banks
    windows = [(0, torch.tensor([[3, 0], [1, 2], [0, 1]])), (3, torch.tensor([[2, 3], [1, 0]]))]
    a, b = _dsn_trainer(wgan), _dsn_trainer(wgan)
    a.graphs = step_graph.StepGraphs("cpu", capture=replaying_capture)
    got = _windows(lambda s, idx: a.train_banked_step(clean, noisy, idx, s, 64, True, True),
                   windows)
    want = _windows(lambda s, idx: b.train_banked_step(clean, noisy, idx, s, 64, True, True),
                    windows)
    for g, w in zip(got, want):
        for k in w:
            _assert_close(g[k], w[k])
    _assert_same_state(a, b, ("g", "d_target"))


def _adaptive_trainer(use_patchd_opt):
    """The Adaptive trainer at a small width: RRDB_Residual_conv nf 16 nb 1
    ada_nb 1, the shipped config's patch D (FSD, gau, kernel 5,
    InstanceNorm)."""
    g = RRDBNetResidualConv(nf=16, nb=1, gc=8, nb_ada=1)
    patchd = FSDiscriminator(d_arch="FSD", filter_type="gau", kernel_size=5,
                             norm_layer="Instance")
    tr = DASRAdaptiveTrainer(AdaptiveConfig(nf=16, nb=1, gc=8, d_nf=16, d_n_layers=2, seed=5,
                                            lr_steps=(2,), use_patchD_opt=use_patchd_opt),
                             g, patchd)
    tr.init_state()
    return tr


@pytest.mark.parametrize("use_patchd_opt", [False, True])
def test_adaptive_replayed_window_equals_eager(srn_banks, tracing, use_patchd_opt):
    """The DASR Adaptive step (the online DDM, with ``use_patchD_opt`` the
    patch D's Adam step first) on banks with no DDM bank, over the DASR
    case's two windows: the replayed window equals the eager loop bit for
    bit in the metrics, every network's params and Adam moments (the patch
    D's among them where it steps); the captured step marks the phase
    ``ddm`` between ``batch`` and ``g_forward``."""
    banks = srn_banks._replace(ddm=None)
    a, b = _adaptive_trainer(use_patchd_opt), _adaptive_trainer(use_patchd_opt)
    a.graphs = step_graph.StepGraphs("cpu", capture=replaying_capture)
    got = _windows(lambda s, idx: a.train_banked_step(banks, idx, s, HR_SIZE), WINDOWS)
    assert list(trace.phase_ms()) == ["batch", "ddm", "g_forward", "g_backward", "d", "adam"]
    want = _windows(lambda s, idx: b.train_banked_step(banks, idx, s, HR_SIZE), WINDOWS)
    for g, w in zip(got, want):
        assert set(g) == set(w) and ("loss/patch_D_gan_loss" in w) == use_patchd_opt
        for k in w:
            assert torch.equal(g[k], w[k]), k
    names = ("g", "d_target") + (("patchd",) if use_patchd_opt else ())
    assert a.state.step == b.state.step == 5 and len(a.graphs._graphs) == 1
    for name in names:
        na, nb = getattr(a.state, name), getattr(b.state, name)
        for what in ("params", "exp_avg", "exp_avg_sq"):
            assert torch.equal(_flat(na, what), _flat(nb, what)), (name, what)
        assert na.opt.param_groups[0]["lr"] == nb.opt.param_groups[0]["lr"]
    # the patch D's own tensors are among those the graph bakes in
    assert {t.data_ptr() for t in a.state.patchd.net.parameters()} <= {
        t.data_ptr() for t in a.graph_tensors()}


def test_srragan_replayed_window_equals_eager(tracing):
    """The srragan step (RRDBNet nf 16 nb 1, the BatchNorm VGG D for 48-px
    crops at nf 8, VGG19-54) on paired banks over the DASR case's two
    windows: the replayed window equals the eager loop bit for bit in the
    metrics, G's and D's params and Adam moments and D's running
    statistics; the captured step marks the phase ``feature`` inside G's
    loss; D's two own forwards a step move the statistics, replayed or not
    (``bn.stat_updates``)."""
    from dasr_tpu_torch.nn.discriminators import make_vgg_discriminator
    from dasr_tpu_torch.nn.generators import RRDBNet
    from dasr_tpu_torch.train.srgan_trainer import SRGANConfig, SRGANTrainer

    rng = np.random.default_rng(2)
    banks = bank.PairedBanks(_bank(rng, 3, (14, 16)), _bank(rng, 3, (56, 64)))

    def trainer():
        tr = SRGANTrainer(SRGANConfig(seed=5, lr_steps=(2,), ragan=True),
                          RRDBNet(nf=16, nb=1, gc=8),
                          make_vgg_discriminator("discriminator_vgg_48", nf=8))
        tr.init_state()
        return tr

    a, b = trainer(), trainer()
    a.graphs = step_graph.StepGraphs("cpu", capture=replaying_capture)
    moved = trace.counters().get("bn.stat_updates", 0)
    got = _windows(lambda s, idx: a.train_banked_step(banks, idx, s, 48), WINDOWS)
    assert list(trace.phase_ms()) == ["batch", "g_forward", "feature", "g_backward", "d",
                                      "adam"]
    assert trace.counters()["bn.stat_updates"] - moved == 2 * 5
    want = _windows(lambda s, idx: b.train_banked_step(banks, idx, s, 48), WINDOWS)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert torch.equal(g[k], w[k]), k
    assert a.state.step == b.state.step == 5 and len(a.graphs._graphs) == 1
    for name in ("g", "d_target"):
        na, nb = getattr(a.state, name), getattr(b.state, name)
        for what in ("params", "exp_avg", "exp_avg_sq"):
            assert torch.equal(_flat(na, what), _flat(nb, what)), (name, what)
        for (key, x), (_, y) in zip(na.net.named_buffers(), nb.net.named_buffers()):
            assert torch.equal(x, y), (name, key)


def test_srn_window_metrics_survive_the_next_window(srn_banks):
    """The next window's replays overwrite the graph's outputs, not the
    metrics a window returned (a CLI reads them one window late)."""
    tr = _srn_trainer()
    tr.graphs = step_graph.StepGraphs("cpu", capture=replaying_capture)
    first = tr.train_banked_step(srn_banks, WINDOWS[0][1], 0, HR_SIZE)
    kept = {k: v.clone() for k, v in first.items()}
    tr.train_banked_step(srn_banks, WINDOWS[1][1], 3, HR_SIZE)
    for k in kept:
        assert torch.equal(first[k], kept[k])
    # the graph's own outputs did move: the clone is what kept them
    outputs = tr.graphs._graphs[next(iter(tr.graphs._graphs))].replay()
    assert not all(torch.equal(outputs[k], kept[k]) for k in kept)


def test_replay_is_credited_with_its_captures_launches(tracing):
    """A stub step that counts five launches a call as the kernel wrapper
    does, and a backward's eight through the kernels: the warm-up counts
    them, the capture nets 0, each replay counts them again."""
    names = ("launches", "launches_f32", "backward_launches", "bwd_kernel", "bwd_chain")
    per_step = (5, 5, 8, 1, 0)

    def step(x):
        for name, n in zip(names, per_step):
            setattr(fused_rdb, name, getattr(fused_rdb, name) + n)
        return {"m": x.sum()}

    graphs = step_graph.StepGraphs("cpu", capture=recording_capture)
    before = [getattr(fused_rdb, name) for name in names]
    replays = _replays()
    hosts = []
    xs = [(torch.full((2,), float(i)),) for i in range(4)]
    graphs.window("k", lambda: [], step, iter(xs), lambda: hosts.append(1))
    assert [getattr(fused_rdb, name) - n for name, n in zip(names, before)] == [
        4 * n for n in per_step]
    assert _replays() - replays == 3
    assert len(hosts) == 4
    assert [s.id for s in trace.drain() if s.name == "graph.capture"] == [0]
    # the static input holds the last step's item
    assert torch.equal(graphs._graphs["k"].static[0], xs[-1][0])


def test_replayed_steps_are_spans_of_their_step(srn_banks, tracing):
    """Two windows of the DASR step (steps 0-2, 3-4): the first step is the
    warm-up and the capture, every later one a draw, a stage, a replay and
    a host step, each span with its step's id; a second window of the key
    captures nothing."""
    tr = _srn_trainer()
    tr.graphs = step_graph.StepGraphs("cpu", capture=replaying_capture)
    captures, replays = (trace.counters().get(k, 0) for k in ("graph.captures",
                                                              "graph.replays"))
    _windows(lambda s, idx: tr.train_banked_step(srn_banks, idx, s, HR_SIZE), WINDOWS)
    spans = trace.drain()
    ids = {}
    for s in spans:
        ids.setdefault(s.name, []).append(s.id)
    # each window also draws once past its last row: the loop's end
    assert ids["graph.draw"] == [0, 1, 2, 3, 3, 4, 5]
    assert ids["graph.warmup"] == ids["graph.capture"] == [0]
    assert ids["graph.stage"] == ids["graph.replay"] == [1, 2, 3, 4]
    assert ids["graph.host_step"] == [0, 1, 2, 3, 4]
    assert all(s.parent is None and s.start_ns <= s.end_ns for s in spans)
    got = trace.counters()
    assert got["graph.captures"] - captures == 1 and got["graph.replays"] - replays == 4


def test_replay_is_credited_with_its_captures_adam_counts(tracing):
    """A stub step that counts an Adam update as ``NetState.update`` does
    (``adam.kernel_tensors``, ``adam.launches``): the warm-up counts it, the
    capture nets 0, each replay counts it again."""
    names = ("adam.kernel_tensors", "adam.torch_tensors", "adam.launches")
    per_step = (702, 0, 2)

    def step(x):
        for name, n in zip(names, per_step):
            trace.count(name, n)
        return {"m": x.sum()}

    graphs = step_graph.StepGraphs("cpu", capture=recording_capture)
    before = trace.counters()
    xs = [(torch.full((2,), float(i)),) for i in range(4)]
    graphs.window("k", lambda: [], step, iter(xs), lambda: None)
    got = trace.counters()
    assert [got.get(name, 0) - before.get(name, 0) for name in names] == [
        4 * n for n in per_step]


def test_replay_credits_a_counter_the_step_graph_does_not_name():
    """A stub step that counts a name no module of the port keeps: a window
    of one step (the warm-up, then the capture) raises it by the warm-up's
    3 alone, so the capture added nothing; a window of K replays raises it
    by 3 K."""
    k = 4

    def step(x):
        trace.count("test.per_step", 3)
        return {"m": x.sum()}

    graphs = step_graph.StepGraphs("cpu", capture=recording_capture)
    xs = [(torch.full((2,), float(i)),) for i in range(k + 1)]
    before = trace.counters().get("test.per_step", 0)
    graphs.window("k", lambda: [], step, iter(xs[:1]), lambda: None)
    assert trace.counters()["test.per_step"] - before == 3
    replays = _replays()
    graphs.window("k", lambda: [], step, iter(xs[1:]), lambda: None, first=1)
    assert trace.counters()["test.per_step"] - before == 3 + 3 * k
    assert _replays() - replays == k


def test_window_without_a_capture_is_the_eager_loop(tracing):
    """``capture=None``: each item is ``step`` then ``host_step``, nothing is
    captured or replayed, no span is recorded, and the last step's outputs
    come back as the step gave them."""
    calls = []

    def step(x):
        calls.append("step")
        trace.count("test.eager_step")
        return {"m": x.sum()}

    graphs = step_graph.StepGraphs("cpu", capture=None)
    before = trace.counters()
    xs = [(torch.full((2,), float(i)),) for i in range(3)]
    out = graphs.window("k", lambda: [], step, iter(xs), lambda: calls.append("host"))
    assert calls == ["step", "host"] * 3 and float(out["m"]) == 4.0
    got = trace.counters()
    assert got["test.eager_step"] - before.get("test.eager_step", 0) == 3
    for name in ("graph.captures", "graph.replays"):
        assert got.get(name, 0) == before.get(name, 0)
    assert not graphs._graphs and trace.drain() == []


def test_state_moved_under_the_graph_is_captured_again(srn_banks):
    """Loading a train state replaces Adam's state tensors, whose addresses
    the graph holds: the next window captures the key again, and counts a
    recapture (the counters are on with tracing off)."""
    tr = _srn_trainer()
    tr.graphs = step_graph.StepGraphs("cpu", capture=replaying_capture)
    recaptures = trace.counters().get("graph.recaptures", 0)
    tr.train_banked_step(srn_banks, WINDOWS[0][1], 0, HR_SIZE)
    graph = tr.graphs._graphs[next(iter(tr.graphs._graphs))]
    assert trace.counters().get("graph.recaptures", 0) == recaptures
    tr.state.g.opt.load_state_dict(copy.deepcopy(tr.state.g.opt.state_dict()))
    tr.train_banked_step(srn_banks, WINDOWS[1][1], 3, HR_SIZE)
    assert tr.graphs._graphs[next(iter(tr.graphs._graphs))] is not graph
    assert trace.counters()["graph.recaptures"] == recaptures + 1


def _tensor_lr_state(schedule):
    """The form ``net_state`` gives a network on CUDA (a tensor LR, written
    in place), on the CPU."""
    net = torch.nn.Linear(2, 2)
    lr = torch.tensor(1e-3)
    opt = torch.optim.Adam(net.parameters(), lr=lr, foreach=False)
    opt.param_groups[0]["initial_lr"] = 1e-3
    ns = NetState(net, opt, schedule(opt), lr)
    ns.set_lr(opt.param_groups[0]["lr"])
    opt.register_load_state_dict_post_hook(keep_form(lr))
    return ns


@pytest.mark.parametrize("schedule, steps", [
    (lambda opt: multistep(opt, (2, 5), 0.5), 7),
    (lambda opt: dsn_linear_decay(opt, 4, 2, 2), 9),
])
def test_tensor_lr_follows_the_float_schedule(schedule, steps):
    """Each step's LR written into the tensor equals the float LambdaLR's,
    and the optimizer keeps reading that tensor."""
    t = _tensor_lr_state(schedule)
    f = net_state(torch.nn.Linear(2, 2), 1e-3, 0.9, schedule)
    assert f.lr is None
    seen = []
    for _ in range(steps):
        assert t.opt.param_groups[0]["lr"] is t.lr
        assert float(t.lr) == pytest.approx(f.opt.param_groups[0]["lr"], rel=1e-7)
        seen.append(f.opt.param_groups[0]["lr"])
        for ns in (t, f):
            ns.opt.step()  # no gradients: no update, the schedule's order only
            ns.advance()
    assert len(set(seen)) == 3  # the window crossed two changes
    # a float the scheduler or a load assigns goes into the tensor
    t.set_lr(0.25)
    assert t.opt.param_groups[0]["lr"] is t.lr and float(t.lr) == 0.25
    t.opt.load_state_dict(f.opt.state_dict())
    assert t.opt.param_groups[0]["lr"] is t.lr
    assert float(t.lr) == pytest.approx(f.opt.param_groups[0]["lr"], rel=1e-7)
    assert t.opt.param_groups[0]["capturable"]


def test_net_state_is_freed_without_the_cycle_collector():
    """The optimizer's load hook holds the LR tensor only: a dropped
    ``NetState`` (its network and Adam state) is freed at once, not at the
    next cycle collection."""
    ns = net_state(torch.nn.Linear(2, 2), 1e-3, 0.9, lambda opt: multistep(opt, (2,), 0.5))
    ref = weakref.ref(ns.opt)
    gc.disable()
    try:
        del ns
        assert ref() is None
    finally:
        gc.enable()
