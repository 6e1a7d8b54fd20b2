"""The Adam kernel (``csrc/adam.cu`` through ``ops/adam.py``) on the card, at
the full width of ``dasr_srn``'s networks: G (RRDBNet nf 64 nb 23 gc 32,
``channels_last``, bf16 activations) and its NLayer D, with real gradients
from a bf16 forward and backward (G's RDB kernels' gradients as
``_FusedRDB``'s backward kernels write them, OIHW-contiguous views of one
buffer). Against ``torch.optim.Adam(capturable=True)`` on the same
gradients over three steps with ``set_lr`` between them: the parameters
within 1e-3 x lr per element, the moments within 1e-6 relative per element,
the step counts exact. A CUDA graph's replays equal the eager kernel bit
for bit; a state dict saved and loaded mid-run continues identically; the
step graph credits the Adam counters per replay; the kernel's compiled
constants equal ``ops/adam.py``'s.

Imports neither jax nor the JAX package, so it runs where only the port is
installed, without the suite's conftest:

    python3 -m pytest --noconftest tests/test_torch_adam_card.py

Every test is marked ``cuda`` and skips without a card."""

import copy
import ctypes

import pytest
import torch

from dasr_tpu_torch.core.device import resolve_device
from dasr_tpu_torch.nn.discriminators import NLayerDiscriminator
from dasr_tpu_torch.nn.generators import RRDBNet
from dasr_tpu_torch.ops import adam
from dasr_tpu_torch.ops.rdb import fused_rdb
from dasr_tpu_torch.train import step_graph
from dasr_tpu_torch.train.schedules import multistep
from dasr_tpu_torch.train.state import net_state
from dasr_tpu_torch.utils import trace

LRS = (1e-4, 1e-4, 5e-5)
PARAM_ATOL = 1e-3  # x the smallest LR
MOMENT_RTOL = 1e-6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    resolve_device("cuda")


def _nets(seed=0):
    torch.manual_seed(seed)
    g = RRDBNet(nf=64, nb=23, gc=32, upscale=4, dtype=torch.bfloat16)
    d = NLayerDiscriminator(in_ch=9, ndf=64, n_layers=2, norm_layer="Instance", stride=2,
                            use_bias_middle=False)  # SRNConfig's D: 668,737 parameters
    return [n.to("cuda", memory_format=torch.channels_last) for n in (g, d)]


def _grads(nets, seed):
    """Each network's gradients of a seeded bf16 forward's weighted sum."""
    gen = torch.Generator("cuda").manual_seed(seed)
    out = []
    for net, shape in zip(nets, ((2, 3, 24, 24), (2, 9, 64, 64))):
        x = torch.rand(shape, device="cuda", generator=gen, dtype=torch.bfloat16)
        y = net(x.contiguous(memory_format=torch.channels_last)).float()
        loss = (y * torch.randn(y.shape, device="cuda", generator=gen)).mean()
        params = [p for p in net.parameters() if p.requires_grad]
        out.append(list(torch.autograd.grad(loss, params)))
    return out


def _states(nets, beta1=0.9):
    return [net_state(n, LRS[0], beta1, lambda opt: multistep(opt, (), 1.0)) for n in nets]


def _flat(ns, what):
    if what == "params":
        return torch.cat([p.detach().flatten() for p in ns.params()])
    return torch.cat([ns.opt.state[p][what].flatten() for p in ns.params()])


@pytest.mark.cuda
def test_three_steps_agree_with_torch_capturable_adam():
    _card()
    nets = _nets()
    refs = [copy.deepcopy(n) for n in nets]
    states = _states(nets)
    ref_opts = [torch.optim.Adam(r.parameters(), lr=torch.tensor(LRS[0], device="cuda"),
                                 betas=(0.9, 0.999), eps=1e-8, capturable=True) for r in refs]
    before = fused_rdb.bwd_kernel
    strided = 0
    for step, lr in enumerate(LRS):
        grads = _grads(nets, step)
        for ns, ref_opt, ref, gs in zip(states, ref_opts, refs, grads):
            ns.set_lr(lr)
            ref_opt.param_groups[0]["lr"].fill_(lr)
            strided += sum(g.stride() != p.stride() for g, p in zip(gs, ns.params()))
            ns.update(gs)
            for p, g in zip(ref.parameters(), gs):
                p.grad = g.clone()
            ref_opt.step()
    torch.cuda.synchronize()
    assert fused_rdb.bwd_kernel - before == 3 * 69 and strided >= 3 * 345
    atol = PARAM_ATOL * min(LRS)
    for ns, ref, ref_opt in zip(states, refs, ref_opts):
        assert ns.plan is not None
        for i, (p, pr) in enumerate(zip(ns.params(), ref.parameters())):
            assert (p - pr).abs().max().item() <= atol, i
            st, sr = ns.opt.state[p], ref_opt.state[pr]
            assert float(st["step"]) == float(sr["step"]) == len(LRS)
            for name in ("exp_avg", "exp_avg_sq"):
                err = (st[name] - sr[name]).abs()
                assert bool((err <= MOMENT_RTOL * sr[name].abs()).all()), (i, name)


@pytest.mark.cuda
def test_a_graph_replay_equals_the_eager_kernel_bit_for_bit():
    """Three steps: eagerly on one copy; on the other one eager step, then
    a capture of the update on static gradients and two replays, each
    after the step's gradients and LR are written in."""
    _card()
    nets = _nets()
    twins = [copy.deepcopy(n) for n in nets]
    eager, graphed = _states(nets), _states(twins)
    all_grads = [_grads(nets, s) for s in range(3)]
    for step, lr in enumerate(LRS):
        for ns, gs in zip(eager, all_grads[step]):
            ns.set_lr(lr)
            ns.update(gs)
    static = [[torch.empty_strided(g.shape, g.stride(), device="cuda") for g in gs]
              for gs in all_grads[0]]
    for ns, gs in zip(graphed, all_grads[0]):
        ns.set_lr(LRS[0])
        ns.update(gs)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for ns, gs in zip(graphed, static):
            ns.update(gs)
    for step in (1, 2):
        for ns, buf, gs in zip(graphed, static, all_grads[step]):
            ns.set_lr(LRS[step])
            for b, g in zip(buf, gs):
                b.copy_(g)
        graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(eager, graphed):
        for what in ("params", "exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(_flat(a, what), _flat(b, what)), what


@pytest.mark.cuda
def test_a_state_dict_saved_mid_run_continues_identically(tmp_path):
    _card()
    nets = _nets()
    states = _states(nets)
    all_grads = [_grads(nets, s) for s in range(3)]
    twins = [copy.deepcopy(n) for n in nets]
    first = _states(twins)
    for ns, gs in zip(first, all_grads[0]):
        ns.update(gs)
    path = tmp_path / "state.pt"
    torch.save([(ns.net.state_dict(), ns.opt.state_dict()) for ns in first], path)
    loaded = _states(_nets(seed=1))
    for ns, (net_sd, opt_sd) in zip(loaded, torch.load(path, weights_only=False)):
        ns.net.load_state_dict(net_sd)
        ns.opt.load_state_dict(opt_sd)
    for step, lr in enumerate(LRS):
        for ns, gs in zip(states, all_grads[step]):
            ns.set_lr(lr)
            ns.update(gs)
        if step:
            for ns, gs in zip(loaded, all_grads[step]):
                ns.set_lr(lr)
                ns.update(gs)
    torch.cuda.synchronize()
    for a, b in zip(states, loaded):
        for what in ("params", "exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(_flat(a, what), _flat(b, what)), what


@pytest.mark.cuda
def test_the_step_graph_credits_the_adam_counters_per_replay():
    """Four steps of a window whose step is the two networks' update: the
    warm-up and the three replays each count G's 702 tensors and D's as
    updated by the kernel, none by torch, and two launches a network."""
    _card()
    nets = _nets()
    states = _states(nets)
    grads = _grads(nets, 0)
    n_tensors = sum(len(ns.params()) for ns in states)
    graphs = step_graph.StepGraphs(torch.device("cuda", torch.cuda.current_device()))

    def step(k):
        for ns, gs in zip(states, grads):
            ns.update(gs)
        return {"k": k * 1}

    def tensors():
        for ns in states:
            yield from ns.tensors()

    names = ("adam.kernel_tensors", "adam.torch_tensors", "adam.launches")
    before = trace.counters()
    items = [(torch.full((1,), float(i), device="cuda"),) for i in range(4)]
    graphs.window("adam", tensors, step, iter(items), lambda: None)
    torch.cuda.synchronize()
    got = trace.counters()
    assert len(states[0].params()) == 702
    assert sum(p.numel() for ns in states for p in ns.params()) == 16_697_987 + 668_737
    assert [got.get(k, 0) - before.get(k, 0) for k in names] == [4 * n_tensors, 0, 4 * 4]
    assert got["graph.replays"] - before.get("graph.replays", 0) == 3


@pytest.mark.cuda
def test_the_kernels_constants_are_the_plans():
    _card()
    sizeof = (3 * 8 + 8 * adam.MAX_TENSORS + 13 * 4 * adam.MAX_LAYOUTS + 4 + 5 * 4
              + adam.MAX_TENSORS)
    assert adam.kernel_constants() == [adam.CHUNK, adam.MAX_TENSORS, adam.MAX_LAYOUTS,
                                       adam.THREADS, -(-sizeof // 8) * 8]
    assert ctypes.sizeof(ctypes.c_void_p) == 8
