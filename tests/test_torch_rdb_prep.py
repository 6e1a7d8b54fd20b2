"""The RDB weight plan (``ops/rdb.py:RDBWeightPlan``, the host side of
``csrc/rdb.cu:rdb_prep_weights``) on the CPU: its units, offsets and
alignment at the published generators' depth, which RDBs it covers, the
kernel's walk of its table emulated element by element against the plain
version (the per-call cast and ``dgrad_weights``), that a CPU or no-grad
forward prepares nothing, and the benchmark's reader of its counters.

The emulation is a model of the kernel, not the kernel:
``tests/test_torch_rdb_card.py`` holds the kernel itself against the
per-call path on the card."""

import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

from dasr_tpu_torch.nn.blocks import _weight_plan, fused_rdbs
from dasr_tpu_torch.nn.generators import RRDBNet, RRDBNetResidualConv, RRDBNetSEAN
from dasr_tpu_torch.ops.rdb import (
    PREP_ROW,
    PREP_TILE,
    PREP_TILES_PER_BLOCK,
    RDBWeightPlan,
    dgrad_weights,
    image_offsets,
    prep_bytes,
    prepare_reference,
)
from dasr_tpu_torch.utils import trace

NC, GC = 64, 32
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _plan(net):
    return RDBWeightPlan([tuple(c.weight for c in m.convs()) for m in fused_rdbs(net)])


@pytest.mark.parametrize("make", [
    lambda: RRDBNet(nf=NC, nb=23, gc=GC),
    lambda: RRDBNetResidualConv(nf=NC, nb=19, gc=GC, nb_ada=4),
], ids=["rrdbnet_nb23", "residual_conv_ada4_nb19"])
def test_plan_units_offsets_and_alignment(make):
    """69 RDBs and 345 units in module order, each read through its own
    channels_last strides; every HWIO kernel and every RDB's images 32-byte
    aligned and packed in order; the tiles cover every weight once, and the
    grid's blocks walk at most four of a unit's."""
    with torch.no_grad():
        net = make().to(memory_format=torch.channels_last)
    rdbs = fused_rdbs(net)
    assert len(rdbs) == 69
    plan = _plan(net)
    table = plan.table.numpy()
    assert table.shape == (345, PREP_ROW)
    _, n_images = image_offsets(NC, GC)
    ker = tile = 0
    for r, m in enumerate(rdbs):
        for k, conv in enumerate(m.convs()):
            w = conv.weight
            cin, cout = NC + k * GC, GC if k < 4 else NC
            ptr, so, si, sh, sw, k_off, i_off, level = table[5 * r + k]
            assert (ptr, (so, si, sh, sw), level) == (w.data_ptr(), w.stride(), k)
            assert w.stride() == (9 * cin, 1, 3 * cin, cin)  # channels_last OIHW
            assert (k_off, i_off) == (ker, r * n_images)
            ks, img = plan.slots[r]
            assert ks[k].shape == (3, 3, cin, cout) and ks[k].is_contiguous()
            assert ks[k].data_ptr() % 32 == 0 and img.data_ptr() % 32 == 0
            assert ks[k].data_ptr() == plan.kernels.data_ptr() + 2 * k_off
            ker += 9 * cin * cout
            tile += plan.tiles(k)
    n_weights = sum(c.weight.numel() for m in rdbs for c in m.convs())
    assert n_weights == 16_533_504
    assert plan.kernels.numel() == plan.images.numel() == ker == n_weights
    assert tile == n_weights // PREP_TILE ** 2
    assert [plan.tiles(k) for k in range(5)] == [18, 27, 36, 45, 108]
    assert plan.blocks == 27 == -(-108 // PREP_TILES_PER_BLOCK)
    assert prep_bytes(n_weights) == 132_268_032  # 0.0395 ms at 3.35 TB/s


def test_normed_rdbs_are_left_out():
    """RRDBNetSEAN with a norm: its trunk's RDBs run the literal chain and
    the plan takes only the three fused RDBs of each SEAN block."""
    net = RRDBNetSEAN(nf=32, nb=2, gc=32, nb_ada=1, norm_type="batch")
    sean = fused_rdbs(net.ada_blocks)
    assert len(sean) == 3
    assert fused_rdbs(net) == sean
    assert not any(m.fused for m in net.trunk.modules() if hasattr(m, "fused"))
    assert len(_plan(net).slots) == 3


def _emulate(plan):
    """The kernel's walk of the table: block (x, y) of the grid takes unit
    y's row and its tiles x, x + blocks, ..., each (output block, input
    block, tap), each element read through the unit's strides, written as
    bf16 into the HWIO kernel and as its one image element. Returns the two
    buffers and how many times each element was written."""
    table = plan.table.numpy()
    nc, gc = plan.nc, plan.gc
    offsets, _ = image_offsets(nc, gc)
    kernels = torch.zeros(plan.kernels.numel(), dtype=torch.bfloat16)
    images = torch.zeros(plan.images.numel(), dtype=torch.bfloat16)
    hits_k = np.zeros(kernels.numel(), np.int64)
    hits_i = np.zeros(images.numel(), np.int64)
    i = np.arange(PREP_TILE)[:, None]  # the tile's output channel (thread row)
    tx = np.arange(PREP_TILE)[None, :]  # the tile's input channel (lane)
    walked = []
    for n, w in enumerate(w for ws in plan.weights for w in ws):
        ptr, so, si, sh, sw, k_off, i_off, k = (int(v) for v in table[n])
        assert ptr == w.data_ptr()
        flat = torch.as_strided(w.detach(), (w.untyped_storage().nbytes() // 4,), (1,), 0)
        cin, cout = nc + k * gc, gc if k < 4 else nc
        tiles = [t for x in range(plan.blocks) for t in range(x, plan.tiles(k), plan.blocks)]
        walked.append(max(len(range(x, plan.tiles(k), plan.blocks)) for x in range(plan.blocks)))
        assert sorted(tiles) == list(range(plan.tiles(k)))
        for t in tiles:
            tap, r = t % 9, t // 9
            ci0, co0 = r % (cin // PREP_TILE) * PREP_TILE, r // (cin // PREP_TILE) * PREP_TILE
            co, ci = co0 + i, ci0 + tx
            b = flat[torch.from_numpy((tap // 3) * sh + (tap % 3) * sw + co * so + ci * si)] \
                .to(torch.bfloat16)
            s = 0 if ci0 < nc else 1 + (ci0 - nc) // gc
            j = 4 - s
            cin_j, cout_j = nc + j * gc, gc if j < 4 else nc
            src_lo = 0 if s == 0 else nc + (s - 1) * gc
            row0 = 0 if k == 4 else nc + (3 - k) * gc
            img = i_off + offsets[j] + ((8 - tap) * cin_j + row0 + co) * cout_j + ci - src_lo
            images[torch.from_numpy(img)] = (b.float() * 0.2).to(torch.bfloat16) if k == 4 else b
            np.add.at(hits_i, img, 1)
            ker = k_off + (tap * cin + ci) * cout + co
            kernels[torch.from_numpy(ker)] = b
            np.add.at(hits_k, ker, 1)
    assert max(walked) <= PREP_TILES_PER_BLOCK
    return kernels, images, hits_k, hits_i


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_emulated_kernel_and_plain_version_equal_cast_and_dgrad_weights(layout):
    """Every RDB of an Adaptive generator (one conditioned block, one
    RRDB: 6 RDBs), its parameters channels_last or OIHW-contiguous: the
    emulated kernel, the plain version and the per-call path (each kernel
    ``.to(bf16)``, then ``dgrad_weights``) agree bit for bit, and the
    emulated kernel writes every element of both buffers exactly once."""
    torch.manual_seed(0)
    net = RRDBNetResidualConv(nf=NC, nb=1, gc=GC, nb_ada=1)
    with torch.no_grad():
        for p in net.parameters():
            p.normal_(0, 0.05)
    if layout == "channels_last":
        net = net.to(memory_format=torch.channels_last)
    plan = _plan(net)
    assert len(plan.slots) == 6
    prepare_reference(plan)
    kernels, images, hits_k, hits_i = _emulate(plan)
    assert np.all(hits_k == 1) and np.all(hits_i == 1)
    assert torch.equal(kernels.view(torch.int16), plan.kernels.view(torch.int16))
    assert torch.equal(images.view(torch.int16), plan.images.view(torch.int16))
    for ws, (ks, img) in zip(plan.weights, plan.slots):
        cast = [w.detach().permute(2, 3, 1, 0).to(torch.bfloat16) for w in ws]
        want = torch.cat([m.flatten() for m in dgrad_weights(cast)])
        for a, b in zip(ks, cast):
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        assert torch.equal(img.view(torch.int16), want.view(torch.int16))


def test_cpu_and_no_grad_forwards_prepare_nothing():
    """A bf16 forward on the CPU, under grad and under no_grad, makes no
    plan, prepares nothing and counts no kernel-path call."""
    net = RRDBNet(nf=32, nb=1, gc=32, dtype=torch.bfloat16)
    x = torch.rand(1, 3, 8, 8)
    names = ("fused_rdb.prepared", "fused_rdb.cast", "rdb_prep.launches")
    before = trace.counters()
    assert _weight_plan(net, torch.bfloat16) is None
    net(x).float().sum().backward()
    with torch.no_grad():
        net(x)
    after = trace.counters()
    assert [after.get(n, 0) - before.get(n, 0) for n in names] == [0, 0, 0]


def test_prep_share_reader(monkeypatch):
    """``rdb_prep_share`` reads prepared / (prepared + cast) from the
    program's counters, and nothing where neither was counted."""
    spec = importlib.util.spec_from_file_location(
        "rdb_prep_share", ROOT / "port_bench" / "metrics" / "rdb_prep_share.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    run = types.SimpleNamespace()
    counts = {"fused_rdb.prepared": 0, "fused_rdb.cast": 0}
    monkeypatch.setattr(trace, "counters", lambda: dict(counts))
    assert reader.read(run) is None
    counts["fused_rdb.prepared"] = 69
    assert reader.read(run) == 1.0
    counts["fused_rdb.cast"] = 23
    assert reader.read(run) == 0.75
