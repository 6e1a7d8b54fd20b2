"""The Adam kernel's host-side plan (``dasr_tpu_torch/ops/adam.py``) on the
CPU, through a plain PyTorch emulation of what ``csrc/adam.cu`` does with
it: the counting launch (every table row's step + 1), then the update
launch's units, each unit's elements in its parameter's memory order, each
gradient read through its code (the parameter's strides, or a packed
layout divided out with the kernel's multiply-shift divisors), and the
update in f32 in the kernel's order (its fused multiply-adds emulated in
f64, where a product of two f32 values is exact).

Cases: RRDBNet (nf 64, nb 2) in ``channels_last`` with the RDB kernels'
gradients as views of ``_launch_backward``'s OIHW-contiguous buffer
(``ops/rdb.py:grad_layout``), the NLayer D with its autograd gradients, and
RRDBNet with every gradient contiguous. Three steps with an LR change
between them agree with ``torch.optim.Adam`` on the CPU: the parameters
within 1e-3 x lr per element (the emulation's f32 chain of scalars against
torch's double ones moves an update of ~lr by ~1e-7 of it), the moments
within 1e-6 relative per element (the same lerp and addcmul, up to one
rounding of v's product; m at beta1 0.9 and 0.5 takes both of the lerp's
formulas). Also: the table and the units, the layouts' codes, the
divisors, a network past the kernel's capacities refused, moments loaded in
another layout, the refused param groups, and the CPU path, which keeps
``torch.optim.Adam``."""

import copy
from unittest import mock

import pytest
import torch

from dasr_tpu_torch.nn.discriminators import NLayerDiscriminator
from dasr_tpu_torch.nn.generators import RRDBNet
from dasr_tpu_torch.ops import adam
from dasr_tpu_torch.ops.rdb import grad_layout
from dasr_tpu_torch.train.schedules import multistep
from dasr_tpu_torch.train.state import net_state
from dasr_tpu_torch.utils import trace

F32 = torch.float32
LRS = (1e-4, 1e-4, 5e-5)  # the LR of each of the three steps
PARAM_ATOL = 1e-3  # x the smallest LR
MOMENT_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rrdbnet():
    torch.manual_seed(0)
    return RRDBNet(nf=64, nb=2, gc=32, upscale=4).to(memory_format=torch.channels_last)


def _nlayer_d():
    torch.manual_seed(1)
    d = NLayerDiscriminator(in_ch=9, ndf=64, n_layers=3, norm_layer="Instance", stride=2,
                            use_bias_middle=False)
    return d.to(memory_format=torch.channels_last)


def _rdb_layout_grads(net, gen):
    """Random gradients as the card's RDB backward hands them over: each
    RDB's five kernels and biases views of one f32 buffer in
    ``grad_layout``'s order (the kernels OIHW-contiguous), every other
    gradient in its parameter's layout. Magnitudes span four decades, with
    some exact zeros."""
    layout, total = grad_layout(64, 32)
    buffers, out = {}, []
    for name, p in net.named_parameters():
        parts = name.split(".")
        if any(s.startswith("RDB") for s in parts) and parts[-3].startswith("conv"):
            rdb = ".".join(parts[:-3])
            level = int(parts[-3][4:]) - 1
            buf = buffers.setdefault(rdb, torch.empty(total))
            w_off, b_off = layout[level]
            cout = p.shape[0]
            g = (buf[w_off:b_off].view(cout, p.shape[1], 3, 3) if parts[-1] == "weight"
                 else buf[b_off:b_off + cout])
        else:
            g = torch.empty_like(p, memory_format=torch.preserve_format)
        scale = 10.0 ** -torch.randint(0, 4, g.shape, generator=gen).to(F32)
        g.copy_(torch.randn(g.shape, generator=gen) * scale * (torch.rand(g.shape, generator=gen)
                                                               > 0.02))
        out.append(g)
    return out


def _autograd_grads(net, gen):
    """The NLayer D's gradients as autograd gives them on the CPU."""
    x = torch.randn((2, 9, 64, 64), generator=gen).to(memory_format=torch.channels_last)
    y = net(x)
    loss = (y * torch.randn(y.shape, generator=gen)).sum()
    return list(torch.autograd.grad(loss, list(net.parameters())))


def _contiguous_grads(net, gen):
    return [g.contiguous() for g in _rdb_layout_grads(net, gen)]


CASES = {"rrdbnet_rdb_layout": (_rrdbnet, _rdb_layout_grads, 0.9),
         "nlayer_d": (_nlayer_d, _autograd_grads, 0.5),
         "rrdbnet_contiguous": (_rrdbnet, _contiguous_grads, 0.9)}


# -- the emulation ---------------------------------------------------------------


def _fma(a, b, c):
    """f32 a * b + c rounded once (the f32 product is exact in f64)."""
    return (a.double() * b.double() + c.double()).to(F32)


def _flat(t):
    """A dense tensor's elements in memory order."""
    return t.as_strided((t.numel(),), (1,))


def _offsets(words, q):
    """The kernel's ``grad_offset``: q split by the layout's divisors, each
    quotient by the multiply-shift, then dotted with its strides."""
    strides, divs, muls, shrs = words[:4], words[4:7], words[7:10], words[10:13]
    idx = []
    for d, mul, shr in zip(divs, muls, shrs):
        quo = ((q * mul) >> 32) >> shr if d != 1 else q
        idx.append(q - quo * d)
        q = quo
    i3, i2, i1 = idx
    return q * strides[0] + i1 * strides[1] + i2 * strides[2] + i3 * strides[3]


def _lookup(opt, params):
    out = {}
    for p in params:
        st = opt.state[p]
        for t in (p, st["exp_avg"], st["exp_avg_sq"], st["step"]):
            out[t.data_ptr()] = t
    return out


def emulate(plan, opt, grads, lr):
    """One step of the kernel as the plan of ``opt`` directs it, in place on
    the tensors its table points at, at the f32 LR ``lr``."""
    group = plan.group
    lookup = _lookup(opt, plan.params)
    with torch.no_grad():
        for row in plan.table.tolist():  # adam_count
            lookup[row[3]].add_(1)
        b1, b2 = group["betas"]
        b1f, b2f = torch.tensor(b1, dtype=F32), torch.tensor(b2, dtype=F32)
        w1, c2 = torch.tensor(1 - b1, dtype=F32), torch.tensor(1 - b2, dtype=F32)
        eps, lr = torch.tensor(group["eps"], dtype=F32), torch.tensor(lr, dtype=F32)
        args = plan.args(grads)
        words = [adam.pack_layout(layout) for layout in args.layouts]
        for t, chunk in plan.units.tolist():
            p, m, v, step = (lookup[a] for a in plan.table[t, :4].tolist())
            n = int(plan.table[t, 4])
            g = grads[t]
            assert g.data_ptr() == args.grads[t]
            q = torch.arange(chunk * adam.CHUNK, min(n, (chunk + 1) * adam.CHUNK))
            code = args.codes[t]
            off = q if code <= adam.SAME else _offsets(words[code - 2], q)
            gv = g.as_strided((int(off.max()) + 1,), (1,))[off]
            pf, mf, vf = _flat(p), _flat(m), _flat(v)
            pq, mq, vq = pf[q], mf[q], vf[q]
            step_size = 1 / ((torch.pow(b1f, step) - 1) / lr)
            bc2 = torch.sqrt(-(torch.pow(b2f, step) - 1))
            d = gv - mq
            mq = _fma(w1, d, mq) if w1 < 0.5 else _fma(w1 - 1, d, gv)
            vq = _fma(c2, gv * gv, vq * b2f)
            den = (torch.sqrt(vq) / bc2 + eps) / step_size
            pf[q], mf[q], vf[q] = pq + mq / den, mq, vq


def _two_copies(case):
    make, grads_of, beta1 = CASES[case]
    net = make()
    ref = copy.deepcopy(net)
    opts = [torch.optim.Adam(n.parameters(), lr=LRS[0], betas=(beta1, 0.999), eps=1e-8)
            for n in (net, ref)]
    return net, ref, opts, grads_of


# -- the tests ----------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_agree_with_torch_adam(case):
    net, ref, (opt, ref_opt), grads_of = _two_copies(case)
    params, ref_params = list(net.parameters()), list(ref.parameters())
    plan = adam.AdamPlan(opt, params)
    gen = torch.Generator().manual_seed(7)
    for lr in LRS:
        grads = grads_of(net, gen)
        for group in (opt.param_groups[0], ref_opt.param_groups[0]):
            group["lr"] = lr
        emulate(plan, opt, grads, lr)
        for p, g in zip(ref_params, grads):
            p.grad = g.clone()
        ref_opt.step()
    atol = PARAM_ATOL * min(LRS)
    for i, (p, pr) in enumerate(zip(params, ref_params)):
        assert (p - pr).abs().max().item() <= atol, i
        st, sr = opt.state[p], ref_opt.state[pr]
        assert float(st["step"]) == float(sr["step"]) == len(LRS)
        for name in ("exp_avg", "exp_avg_sq"):
            err = (st[name] - sr[name]).abs()
            assert bool((err <= MOMENT_RTOL * sr[name].abs()).all()), (i, name)
            assert st[name].stride() == p.stride()


def test_the_table_and_units_hold_every_tensor():
    net = _rrdbnet()
    params = list(net.parameters())
    opt = torch.optim.Adam(params, lr=1e-4)
    plan = adam.AdamPlan(opt, params)
    assert plan.table.shape == (len(params), adam.ROW)
    units = plan.units.tolist()
    for i, (p, row) in enumerate(zip(params, plan.table.tolist())):
        st = opt.state[p]
        assert row[:4] == [p.data_ptr(), st["exp_avg"].data_ptr(), st["exp_avg_sq"].data_ptr(),
                           st["step"].data_ptr()]
        assert row[4] == p.numel() and row[5] == int(all(a % 16 == 0 for a in row[:3]))
    assert units == [[i, c] for i, p in enumerate(params)
                     for c in range(-(-p.numel() // adam.CHUNK))]
    # the state is made as torch's Adam makes it, zero moments in p's layout
    assert all(float(opt.state[p]["step"]) == 0 and opt.state[p]["exp_avg"].stride() == p.stride()
               for p in params)


def test_rdb_gradients_read_through_a_transpose_of_each_output_channel():
    """An RDB kernel's OIHW-contiguous gradient of a channels_last OIHW
    parameter maps through ((cout, 9, cin), (9 cin, 1, 9)): per output
    channel a (cin, 9) block read as (9, cin). Five such layouts (one per
    level's cin); every other gradient in its parameter's layout, vector
    loads."""
    net = _rrdbnet()
    params = list(net.parameters())
    opt = torch.optim.Adam(params, lr=1e-4)
    plan = adam.AdamPlan(opt, params)
    grads = _rdb_layout_grads(net, torch.Generator().manual_seed(0))
    ln = plan.args(grads)
    assert ln.layouts == [((32, 9, cin), (9 * cin, 1, 9)) for cin in (64, 96, 128, 160)] + [
        ((64, 9, 192), (9 * 192, 1, 9))]
    for i, (p, g, code) in enumerate(zip(params, grads, ln.codes)):
        if g.stride() == p.stride():
            assert code == (adam.SAME_VEC if g.data_ptr() % 16 == 0 else adam.SAME), i
        else:
            assert code >= 2 and ln.layouts[code - 2][0][2] == p.shape[1], i


@pytest.mark.parametrize("seed", range(3))
def test_divisors_divide_as_the_kernel_does(seed):
    gen = torch.Generator().manual_seed(seed)
    divs = [1, 2, 3, 7, 9, 64, 96, 192, 576, 1728, 12345, 2 ** 20 + 1, 2 ** 31 - 1]
    divs += torch.randint(2, 2 ** 31, (20,), generator=gen).tolist()
    q = torch.cat([torch.randint(0, 2 ** 31, (4096,), generator=gen),
                   torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31 - 2, 2 ** 30])])
    for d in divs:
        mul, shr = adam.divisor(d)
        assert 0 <= mul < 2 ** 32
        quo = q if d == 1 else ((q * mul) >> 32) >> shr
        assert torch.equal(quo, q // d), d


def test_layouts_merge_what_the_gradient_walks_as_one():
    p = torch.empty(1, 512, 4, 4).to(memory_format=torch.channels_last)
    dims, sizes = adam.memory_order(p)
    assert sizes == (4, 4, 512)
    assert adam.grad_layout(dims, sizes, p.stride()) == ((8192,), (1,))
    assert adam.grad_layout(dims, sizes, p.contiguous().stride()) == ((16, 512), (1, 16))
    with pytest.raises(ValueError, match="not dense"):
        adam.memory_order(torch.empty(4, 6)[:, :3])
    with pytest.raises(ValueError, match="4"):
        adam.pack_layout(((2, 3, 2, 3, 2), (1, 2, 6, 12, 36)))


def test_a_network_past_the_kernels_capacities_is_refused():
    """More tensors than the kernel's parameter block holds, or gradients in
    more layouts than it takes, are refused with a message."""
    net, _, (opt, _), grads_of = _two_copies("rrdbnet_rdb_layout")
    params = list(net.parameters())
    grads = grads_of(net, torch.Generator().manual_seed(3))
    with mock.patch.object(adam, "MAX_TENSORS", len(params) - 1):
        with pytest.raises(ValueError, match=f"{len(params)} tensors"):
            adam.AdamPlan(opt, params)
    plan = adam.AdamPlan(opt, params)
    with mock.patch.object(adam, "MAX_LAYOUTS", 4):
        with pytest.raises(ValueError, match="5 layouts"):
            plan.args(grads)
    with pytest.raises(ValueError, match="gradients for"):
        plan.args(grads[:-1])


def test_moments_loaded_in_another_layout_go_into_the_parameters():
    net = _rrdbnet()
    params = list(net.parameters())
    opt = torch.optim.Adam(params, lr=1e-4)
    p = params[2]  # an RDB kernel, channels_last
    m = torch.randn(p.shape)  # contiguous, as a file from a contiguous run holds it
    opt.state[p] = {"step": torch.tensor(3.0), "exp_avg": m.clone(),
                    "exp_avg_sq": m.abs().clone()}
    plan = adam.AdamPlan(opt, params)
    st = opt.state[p]
    assert st["exp_avg"].stride() == p.stride() and torch.equal(st["exp_avg"], m)
    assert torch.equal(st["exp_avg_sq"], m.abs())
    assert plan.current(opt, params)
    opt.state[p]["exp_avg"] = st["exp_avg"].clone()  # a loaded state moves an address
    assert not plan.current(opt, params)


@pytest.mark.parametrize("option, value", [("weight_decay", 1e-2), ("amsgrad", True),
                                           ("maximize", True)])
def test_unsupported_param_groups_are_refused(option, value):
    net = _nlayer_d()
    opt = torch.optim.Adam(net.parameters(), lr=1e-4, **{option: value})
    with pytest.raises(ValueError, match=option):
        adam.AdamPlan(opt, list(net.parameters()))


def test_card_groups_need_a_capturable_adam_and_a_device_lr():
    group = {"betas": (0.9, 0.999), "lr": 1e-4, "capturable": False}
    with pytest.raises(ValueError, match="capturable off.*LR"):
        adam.check_group(group)
    adam.check_group(group, on_card=False)


def test_the_cpu_path_keeps_torch_adam():
    """On the CPU ``NetState.update`` steps ``torch.optim.Adam`` and counts
    its tensors; no plan is made."""
    net = _nlayer_d()
    ns = net_state(net, 1e-4, 0.5, lambda opt: multistep(opt, (), 1.0))
    params = ns.params()
    grads = _autograd_grads(net, torch.Generator().manual_seed(0))
    before = trace.counters()
    with mock.patch.object(ns.opt, "step", wraps=ns.opt.step) as step:
        ns.update(grads)
    assert step.call_count == 1
    got = {k: trace.counters().get(k, 0) - before.get(k, 0)
           for k in ("adam.torch_tensors", "adam.kernel_tensors", "adam.launches")}
    assert got == {"adam.torch_tensors": len(params), "adam.kernel_tensors": 0,
                   "adam.launches": 0}
    assert ns.plan is None and all(p.grad is None for p in params)
    assert all(float(ns.opt.state[p]["step"]) == 1 for p in params)
