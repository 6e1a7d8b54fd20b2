"""The bf16 backward's weight-gradient plan (``ops/rdb.py:wgrad_plan``,
``wgrad_tiles``, ``wgrad_units``, ``wgrad_row_level``), which
``csrc/rdb.cu:rdb_wgrad`` follows: every pixel tile is walked by exactly one
split of every unit, no cluster has more splits than tiles, and the order
of every sum is the plan's alone. An f64 emulation of the kernel's
decomposition (dv groups of 64 rows, input chunks, the nine taps, tiles
and their windows, splits added in rank order, the bias from the dv rows,
level 5's 0.2) is held against the weight gradient computed directly. The
kernel itself runs on the card only (tests/test_torch_rdb_card.py)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dasr_tpu_torch.ops.rdb import (
    WGRAD_MAX_SPLITS,
    WGRAD_N,
    WGRAD_TILE_W,
    grad_layout,
    wgrad_plan,
    wgrad_row_level,
    wgrad_tiles,
    wgrad_units,
)

# the three train cells' RDB shapes, chip_smoke's timing shape, a ragged one
SHAPES = [(12, 32, 32), (4, 48, 48), (8, 48, 48), (8, 128, 128), (3, 20, 28)]


def _tiles(b, h, w, th):
    return b * -(-h // th) * -(-w // WGRAD_TILE_W)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("nc", [64, 32])
def test_every_tile_once_and_splits_within_tiles(shape, nc):
    th, splits = wgrad_plan(*shape, nc=nc)
    tiles = _tiles(*shape, th)
    assert 1 <= splits <= min(tiles, WGRAD_MAX_SPLITS)
    walked = [t for r in wgrad_tiles(*shape, th, splits) for t in r]
    assert walked == list(range(tiles))  # once each, in rank order
    assert all(len(r) > 0 for r in wgrad_tiles(*shape, th, splits))


@pytest.mark.parametrize("sms", [132, 114, 16, 1])
def test_plan_follows_shape_and_sm_count_alone(sms):
    """One cluster of each unit in one wave of one block an SM: splits times
    units within the SMs wherever a split can be had; the same inputs give
    the same plan."""
    for shape in SHAPES:
        th, splits = wgrad_plan(*shape, sms=sms)
        assert wgrad_plan(*shape, sms=sms) == (th, splits)
        assert splits == 1 or splits * len(wgrad_units()) <= sms


def test_train_shapes_plan():
    """At the train cells' shapes on the H100 (132 SMs): 14 units, clusters
    of 8, 16 x 16 tiles but at (4, 48, 48), whose 36 would split 5 and 4;
    (12, 32, 32) walks 6 tiles a block."""
    assert len(wgrad_units(64, 32)) == 14
    assert [wgrad_plan(*shape) for shape in SHAPES[:4]] == [(16, 8), (8, 8), (16, 8), (16, 8)]
    assert [len(r) for r in wgrad_tiles(12, 32, 32, 16, 8)] == [6] * 8
    assert [len(r) for r in wgrad_tiles(4, 48, 48, 8, 8)] == [9] * 8


@pytest.mark.parametrize("nc", [64, 32])
def test_units_cover_each_level_once(nc):
    """Each level's output channels are rows of one dv group, and each of its
    input channels lies in exactly one chunk of that group; chunks are 64 or
    32 channels of one source."""
    gc = 32
    units = wgrad_units(nc, gc)
    for k in range(5):
        cin, cout = nc + k * gc, gc if k < 4 else nc
        rows = [(g, r) for g in range(3) for r in range(64) if wgrad_row_level(g, r, nc, gc)[0] == k]
        assert sorted(wgrad_row_level(g, r, nc, gc)[1] for g, r in rows) == list(range(cout))
        grp = {g for g, _ in rows}.pop()
        chans = [c for (g, c0) in units if g == grp for c in range(c0, c0 + WGRAD_N) if c < cin]
        assert chans == list(range(cin))
    for g, c0 in units:
        assert (c0 < nc) == (c0 + WGRAD_N <= nc)  # never across the two sources


def _direct(x, growth, dy, gg, nc, gc):
    """The weight and bias gradients as ``rdb_backward_reference`` takes
    them: dW_k = in_k (x) dv_k, db_k = sum dv_k, dv_5 = 0.2 dY."""
    src = torch.cat([x, growth], -1).permute(0, 3, 1, 2)
    dks, dbs = [], []
    for k in range(5):
        cin, cout = nc + k * gc, gc if k < 4 else nc
        dv = 0.2 * dy if k == 4 else gg[..., (3 - k) * gc:(4 - k) * gc]
        dv = dv.permute(0, 3, 1, 2)
        dks.append(torch.nn.grad.conv2d_weight(src[:, :cin], (cout, cin, 3, 3), dv, padding=1))
        dbs.append(dv.sum((0, 2, 3)))
    return dks, dbs


def _emulated(x, growth, dy, gg, nc, gc):
    """The kernel's decomposition in f64: per unit (a dv group's 64 rows,
    WGRAD_N input channels) and split, its tiles in order, each tile's dv
    rows times its window at the nine taps, and the bias from the dv rows of
    each group's first unit; the splits added in rank order, rows written to
    their levels where the level reads the chunk, level 5's 0.2."""
    b, h, w, _ = x.shape
    n = WGRAD_N
    th, splits = wgrad_plan(b, h, w, nc, gc)
    ty_n, tx_n = -(-h // th), -(-w // WGRAD_TILE_W)
    pad_h, pad_w = ty_n * th - h, tx_n * WGRAD_TILE_W - w
    src = F.pad(torch.cat([x, growth], -1), (0, 0, 1, 1 + pad_w, 1, 1 + pad_h))
    groups = [F.pad(dy, (0, 64 - nc)), gg[..., :64], gg[..., 64:]]
    dks = [torch.zeros(gc if k < 4 else nc, nc + k * gc, 3, 3, dtype=x.dtype) for k in range(5)]
    dbs = [torch.zeros(gc if k < 4 else nc, dtype=x.dtype) for k in range(5)]
    for grp, c0 in wgrad_units(nc, gc):
        dv_all = F.pad(groups[grp], (0, 0, 0, pad_w, 0, pad_h))
        parts, bparts = [], []
        for tiles in wgrad_tiles(b, h, w, th, splits):
            acc = torch.zeros(3, 3, 64, n, dtype=x.dtype)
            bacc = torch.zeros(64, dtype=x.dtype)
            for t in tiles:
                tx, ty, bb = t % tx_n, t // tx_n % ty_n, t // (tx_n * ty_n)
                y0, x0 = ty * th, tx * WGRAD_TILE_W
                win = src[bb, y0:y0 + th + 2, x0:x0 + WGRAD_TILE_W + 2, c0:c0 + n]
                dv = dv_all[bb, y0:y0 + th, x0:x0 + WGRAD_TILE_W].reshape(-1, 64)
                for r in range(3):
                    for dx in range(3):
                        a = win[r:r + th, dx:dx + WGRAD_TILE_W].reshape(-1, n)
                        acc[r, dx] += dv.T @ a
                bacc += dv.sum(0)
            parts.append(acc)
            bparts.append(bacc)
        total, btotal = parts[0], bparts[0]
        for p, q in zip(parts[1:], bparts[1:]):
            total, btotal = total + p, btotal + q
        for row in range(64):
            k, co = wgrad_row_level(grp, row, nc, gc)
            if k is None:
                continue
            scale = 0.2 if k == 4 else 1.0
            m = max(0, min(n, nc + k * gc - c0))
            dks[k][co, c0:c0 + m] = scale * total[:, :, row, :m].permute(2, 0, 1)
            if c0 == 0:
                dbs[k][co] = scale * btotal[row]
    return dks, dbs


@pytest.mark.parametrize("shape, nc", [((2, 20, 28), 32), ((3, 24, 40), 64), ((1, 16, 16), 64)])
def test_emulated_decomposition_equals_the_direct_gradient(shape, nc):
    gc = 32
    rng = np.random.default_rng(0)

    def t(c):
        return torch.from_numpy(rng.normal(0, 1, shape + (c,)))

    x, growth, dy, gg = t(nc), t(4 * gc), t(nc), t(4 * gc)
    want_k, want_b = _direct(x, growth, dy, gg, nc, gc)
    got_k, got_b = _emulated(x, growth, dy, gg, nc, gc)
    for a, b in zip(got_k + got_b, want_k + want_b):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-10)
    # the kernel writes each level's kernel then its bias, as grad_layout says
    layout, total = grad_layout(nc, gc)
    assert total == sum(k.numel() + b.numel() for k, b in zip(want_k, want_b))
