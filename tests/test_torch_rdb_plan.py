"""Host-side plan of the bf16 RDB kernel (dasr_tpu_torch/csrc/rdb.cu), held
on the CPU: the tile plan, the shared-memory layout the TMA boxes land in
and the wgmma descriptors read (``ops/rdb.py:WgmmaPlan``), and the
FLOP/byte bound chip_smoke.py prints.

The emulation below is a model of the kernel, not the kernel: it stages
every chunk as ``WgmmaPlan`` says the kernel does (window boxes zero-filled
outside the image, weight boxes from the HWIO matrix as it is), lands both
in TMA's address swizzle, reads each product's A and B through the plan's
descriptors in the same swizzle, and must reproduce the plain version and
JAX's ``_scatter_reference``. What ties the model to the kernel is
chip_smoke.py, which fails unless the plan compiled into the kernel
(``kernel_plan``) equals ``WgmmaPlan``'s, and which runs the kernel itself
against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.ops.pallas_rdb import _scatter_reference
from dasr_tpu_torch.ops.rdb import (
    TILES,
    TOLERANCES,
    WgmmaPlan,
    bound_ms,
    dgrad_weights,
    fused_rdb_reference,
    level_costs,
    rdb_backward_reference,
    rdb_cost,
    reference_levels,
    tile_plan,
)

NC, GC = 64, 32
KC = WgmmaPlan.kc


def swizzle(byte, span):
    """The shared-memory address that TMA writes, and wgmma reads, for byte
    ``byte`` of a layout with rows of ``span`` (32, 64 or 128) bytes: bits
    [4, 4 + n) XOR bits [7, 7 + n), n = log2(span / 16), of the absolute
    address (the kernel keeps its regions 1024-byte aligned)."""
    n = {32: 1, 64: 2, 128: 3}[span]
    return byte ^ (((byte >> 7) & ((1 << n) - 1)) << 4)


def _params(rng):
    kernels = [rng.normal(0, 0.05, (3, 3, NC + k * GC, GC if k < 4 else NC)).astype(np.float32)
               for k in range(5)]
    biases = [rng.normal(0, 0.01, (GC if k < 4 else NC,)).astype(np.float32) for k in range(5)]
    return kernels, biases


def _operand_index(off, lbo, sbo, span, rows, cols, k_major):
    """Element index (bf16 units) of each (row, col) of a wgmma operand whose
    descriptor is (off, lbo, sbo) in a ``span``-byte swizzle. K-major (A,
    rows = M, cols = K <= span / 2): a row of span bytes holds one M index's
    K values, 8-row groups SBO apart. MN-major (B, rows = K, cols = N): a
    row of span bytes holds span / 2 N values of one K index, 8-row groups
    SBO apart, span-wide column groups LBO apart."""
    r = np.arange(rows)[:, None]
    c = np.arange(cols)[None, :]
    if k_major:
        byte = off + (r // 8) * sbo + (r % 8) * span + c * 2
    else:
        byte = off + (c // (span // 2)) * lbo + (c % (span // 2)) * 2 + (r % 8) * span \
            + (r // 8) * sbo
    phys = swizzle(byte, span)
    assert np.all(phys % 2 == 0)
    return phys // 2


def _land(stage, region, box, span):
    """A TMA box landing in the 1024-byte-aligned ``region`` of the stage,
    its rows of ``span`` bytes swizzled by address."""
    logical = region + np.arange(box.size) * 2
    stage[swizzle(logical, span) // 2] = box.reshape(-1)


def _emulate_products(plan, x, growth, wmat, store):
    """One level's products as the kernel computes them, f32, from x's
    channels and then the growth buffer's: ``store(b, gy, gx, acc)`` takes
    each output pixel's (cout,) sums, the epilogue."""
    b_, h, w, nc = x.shape
    cin, cout = wmat.shape[2], wmat.shape[3]
    w9 = wmat.reshape(9, cin, cout)
    a_idx = [[_operand_index(*plan.a_desc(sb, tap), 64, KC, True) for tap in range(9)]
             for sb in range(plan.sub)]
    b_idx = [_operand_index(*plan.b_desc(tap), KC, cout, False) for tap in range(9)]
    src_x = np.pad(x, ((0, 0), (1, plan.th + 1), (1, plan.tw + 1), (0, 0)))
    src_g = np.pad(growth, ((0, 0), (1, plan.th + 1), (1, plan.tw + 1), (0, 0)))
    for b in range(b_):
        for y0 in range(0, h, plan.th):
            for x0 in range(0, w, plan.tw):
                acc = np.zeros((plan.sub, 64, cout), np.float32)
                for it in range(cin // KC):
                    stage = np.full(plan.stage_bytes // 2, np.nan, np.float32)
                    c = it * KC
                    src, cc = (src_x, c) if c < nc else (src_g, c - nc)
                    # the 4-D box at (cc, x0 - 1, y0 - 1, b); padding = OOB zeros
                    box = src[b, y0:y0 + plan.th + 2, x0:x0 + plan.tw + 2, cc:cc + KC]
                    _land(stage, 0, box, plan.pix_bytes)
                    # the 3-D box at (0, c, 0): [tap][ci][cout]
                    _land(stage, plan.win_bytes, w9[:, c:c + KC], plan.wrow_bytes)
                    for sb in range(plan.sub):
                        for tap in range(9):
                            acc[sb] += stage[a_idx[sb][tap]] @ stage[b_idx[tap]]
                for sb in range(plan.sub):
                    r0, c0 = plan.sub_block(sb)
                    for m in range(64):
                        gy, gx = y0 + r0 + m // 8, x0 + c0 + m % 8
                        if gy < h and gx < w:
                            store(b, gy, gx, acc[sb, m])


def _emulate_level(plan, x, growth, wmat, bias, k, out):
    """Level k + 1 as the kernel computes it, f32, written into ``out``
    (the growth slice or y)."""

    def store(b, gy, gx, acc):
        v = acc + bias
        if k == 4:
            out[b, gy, gx] = x[b, gy, gx] + 0.2 * v
        else:
            out[b, gy, gx, k * GC:(k + 1) * GC] = np.where(v >= 0, v, 0.2 * v)

    _emulate_products(plan, x, growth, wmat, store)


def _emulate_rdb(tile, x, kernels, biases):
    growth = np.zeros(x.shape[:3] + (4 * GC,), np.float32)
    y = np.zeros_like(x)
    for k in range(5):
        plan = WgmmaPlan(GC if k < 4 else NC, tile)
        _emulate_level(plan, x, growth, kernels[k], biases[k], k, y if k == 4 else growth)
    return y


@pytest.mark.parametrize("tile", [0, 1])
@pytest.mark.parametrize("shape", [(1, 37, 53), (2, 11, 19), (1, 16, 16)])
def test_emulated_kernel_matches_plain_version(rng, tile, shape):
    """Ragged H and W and B > 1, every tile: the emulated products agree
    with the plain version and with JAX (f32 on all sides, sums in another
    order). A stage starts as NaN, so a read of a byte no box wrote fails."""
    kernels, biases = _params(rng)
    x = rng.random(shape + (NC,), dtype=np.float32)
    got = _emulate_rdb(tile, x, kernels, biases)
    want = fused_rdb_reference(torch.from_numpy(x), [torch.from_numpy(k) for k in kernels],
                               [torch.from_numpy(v) for v in biases]).numpy()
    atol, _ = TOLERANCES["kernel_f32"]
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    jax_want = np.asarray(_scatter_reference(
        jnp.asarray(x), tuple(map(jnp.asarray, kernels)), tuple(map(jnp.asarray, biases))))
    np.testing.assert_allclose(got, jax_want, atol=TOLERANCES["jax_rdb"][0], rtol=0)


def _emulate_dgrad(tile, dy, growth, images):
    """The backward's reverse chain as its kernel computes it: the forward's
    products (the same plan) on the dgrad weight images, reading dY as x and
    the gradient growth buffer as the growth buffer, with the backward's
    epilogue: no bias; dv_{4-j} = acc times the slope at x_{4-j} into the
    buffer's slice j, and dx = dY + acc at the last level."""
    grown = np.zeros_like(growth)
    dx = np.zeros_like(dy)
    for j in range(5):
        def store(b, gy, gx, acc, j=j):
            if j == 4:
                dx[b, gy, gx] = dy[b, gy, gx] + acc
            else:
                xs = growth[b, gy, gx, (3 - j) * GC:(4 - j) * GC]
                grown[b, gy, gx, j * GC:(j + 1) * GC] = np.where(xs > 0, acc, 0.2 * acc)

        _emulate_products(WgmmaPlan(GC if j < 4 else NC, tile), dy, grown, images[j], store)
    return dx


@pytest.mark.parametrize("tile", [0, 1])
def test_emulated_dgrad_on_its_weight_images_matches_reverse_chain(rng, tile):
    """The dgrad weight images (taps flipped, in and out channels swapped,
    level 5's rows times 0.2), read through the forward kernel's plan with
    the backward's epilogue, give the plain reverse chain's dx (f32, ragged
    H and W, B > 1); and the images are what the image kernel's index
    arithmetic in csrc/rdb.cu:rdb_dgrad_weights reads, element by element."""
    kernels, biases = _params(rng)
    ks = [torch.from_numpy(k) for k in kernels]
    x = torch.from_numpy(rng.random((2, 11, 19, NC), dtype=np.float32))
    dy = torch.from_numpy(rng.normal(0, 1, (2, 11, 19, NC)).astype(np.float32))
    _, growth = reference_levels(x, ks, [torch.from_numpy(b) for b in biases])
    images = dgrad_weights(ks)
    for j, img in enumerate(images):
        cin_j, cout_j = NC + j * GC, GC if j < 4 else NC
        e = np.arange(9 * cin_j * cout_j)
        o, c, tap = e % cout_j, (e // cout_j) % cin_j, e // (cout_j * cin_j)
        k = np.where(c < NC, 4, 3 - (c - NC) // GC)
        co = np.where(c < NC, c, (c - NC) % GC)
        lo = NC + (3 - j) * GC if j < 4 else 0
        want = np.empty(e.size, np.float32)
        for kk in range(5):
            at = k == kk
            cin_k, cout_k = NC + kk * GC, GC if kk < 4 else NC
            flat = kernels[kk].reshape(-1)[((8 - tap[at]) * cin_k + lo + o[at]) * cout_k + co[at]]
            want[at] = flat * (0.2 if kk == 4 else 1.0)
        np.testing.assert_array_equal(img.numpy().reshape(-1), want, err_msg=f"image {j}")
    got = _emulate_dgrad(tile, dy.numpy(), growth.numpy(), [img.numpy() for img in images])
    want_dx, _, _ = rdb_backward_reference(x, growth, ks, dy)
    np.testing.assert_allclose(got, want_dx.numpy(), atol=TOLERANCES["kernel_f32"][0], rtol=0)


@pytest.mark.parametrize("cout", [GC, NC])
@pytest.mark.parametrize("tile", [0, 1])
def test_plan_fits_the_card(cout, tile):
    """Two blocks fit an SM's 228 KB; every region stays 1024-byte aligned
    (the swizzle repeats); TMA boxes keep their limits (rows no wider than
    their swizzle, dims <= 256); descriptor fields fit their 14 bits; the
    bytes a stage expects are exactly its two boxes; every A read of a tap
    stays inside the window."""
    plan = WgmmaPlan(cout, tile)
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
    assert plan.win_bytes % 1024 == 0 and plan.w_bytes % 1024 == 0
    assert plan.pix_bytes == 32 and plan.wrow_bytes in (64, 128)
    assert max(cout, plan.tw + 2, plan.th + 2, KC, 9) <= 256
    assert plan.tx_bytes == plan.win_pix * KC * 2 + 9 * KC * cout * 2
    assert plan.sub == plan.warpgroups * plan.mt and plan.threads % 32 == 0
    assert len(plan.vector()) == 14 + 9 + 9 * plan.sub <= 128  # kernel_plan's buffer
    for sb in range(plan.sub):
        for tap in range(9):
            for field in plan.a_desc(sb, tap)[:3] + plan.b_desc(tap)[:3]:
                assert field % 16 == 0 and field >> 4 < 1 << 14
    last = max(plan.a_desc(sb, 8)[0] for sb in range(plan.sub)) + 7 * plan.win_w * 32 + 7 * 32
    assert last + 32 <= plan.win_pix * 32


def test_swizzle_is_a_permutation_of_each_1024_bytes():
    for span in (32, 64, 128):
        block = np.arange(0, 1024, 2)
        assert sorted(swizzle(block, span)) == list(block)
        assert list(swizzle(block[:8], span)) == list(block[:8])  # row 0 stays


@pytest.mark.parametrize("shape, tile, blocks", [
    ((8, 128, 128), (16, 16), 512),
    ((1, 256, 256), (16, 16), 256),
    ((1, 339, 510), (16, 16), 704),
    ((12, 160, 160), (16, 16), 1200),
    ((3, 100, 90), (16, 16), 126),
    ((2, 64, 64), (8, 8), 128),
    ((12, 32, 32), (8, 8), 192),
    ((1, 64, 64), (8, 8), 64),
    ((1, 37, 53), (8, 8), 35),
])
def test_tile_plan(shape, tile, blocks):
    """16x16 unless it leaves more than half the 132 SMs without a block."""
    b, h, w = shape
    th, tw = TILES[tile_plan(b, h, w)]
    assert (th, tw) == tile
    assert b * -(-h // th) * -(-w // tw) == blocks


def test_bound_at_the_kernel_shape():
    """62.81 GFLOP and ~34.0 MB at (8, 128, 128): 63.5 us, set by the
    operations; five launches move more bytes, a floor of ~74 us."""
    flop, nbytes = rdb_cost(8, 128, 128)
    assert flop == 2 * 9 * 8 * 128 * 128 * 26624 == 62_813_896_704
    assert abs(nbytes / 1e6 - 34.03) < 0.01
    ms, by = bound_ms(flop, nbytes)
    assert by == "operations" and abs(ms * 1e3 - 63.5) < 0.05
    levels = level_costs(8, 128, 128)
    assert sum(f for f, _ in levels) == flop
    bounds = [bound_ms(f, n) for f, n in levels]
    assert [by for _, by in bounds] == ["bytes"] * 4 + ["operations"]
    assert abs(sum(t for t, _ in bounds) * 1e3 - 74.5) < 0.5
    ms32, _ = bound_ms(flop, rdb_cost(8, 128, 128, itemsize=4)[1], torch.float32)
    assert abs(ms32 - 3 * flop / 495e12 * 1e3) < 1e-9  # split-TF32, tests/test_torch_rdb_f32_plan.py
