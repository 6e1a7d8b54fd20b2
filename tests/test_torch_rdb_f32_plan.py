"""Host-side plan of the f32 RDB kernel (``rdb_level_tf32x3`` in
dasr_tpu_torch/csrc/rdb.cu), held on the CPU: the split-TF32 arithmetic, the
weight image ``split_weights`` makes, and the shared-memory layout the
copies land in and the lanes and wgmma descriptors read
(``ops/rdb.py:F32Plan``).

The emulation below is a model of the kernel, not the kernel: it stages
every chunk as ``F32Plan`` says the kernel does (the window box zero-filled
outside the image and unswizzled; the chunk's slice of the K-major hi/lo
weight image copied as it is), reads each lane's A fragment at the plan's
offsets and splits it into TF32 hi and lo with round-to-nearest on the
uint32 view, reads B_hi and B_lo through the plan's descriptors in the
32-byte swizzle, and sums hi.hi + hi.lo + lo.hi as the tensor cores do: each
wgmma adds its exact products to the accumulator and truncates the sum to
f32 (a model that put the kernel's first, unflushed version where the H100
put it, ~10x the plain version's error against f64), and each chunk's sum is
added into the total with rounding f32 adds. It must reproduce the plain
version, JAX's ``_scatter_reference`` and, within twice the plain f32
version's error, an f64 computation; one TF32 product (hi.hi alone) must
not, and neither must the three products without the per-chunk adds. What
ties the model to the kernel is chip_smoke.py, which fails unless the plan
compiled into the kernel (``kernel_plan``) equals ``F32Plan``'s, and which
holds the kernel itself against the plain version and f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasr_tpu.ops.pallas_rdb import _scatter_reference
from dasr_tpu_torch.ops.rdb import (
    TOLERANCES,
    F32Plan,
    bound_ms,
    fused_rdb_reference,
    rdb_cost,
    split_tf32,
    split_weights,
)
from test_torch_rdb_plan import swizzle

NC, GC = 64, 32
KC = F32Plan.kc


def rna_tf32(v):
    """``cvt.rna.tf32.f32`` on the uint32 view: round the magnitude to 10
    mantissa bits, ties away from zero."""
    u = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def truncate_f32(v):
    """f64 ``v`` to f32, rounded toward zero: how the tensor cores round
    the f32 sum of a product."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _params(rng):
    kernels = [rng.normal(0, 0.05, (3, 3, NC + k * GC, GC if k < 4 else NC)).astype(np.float32)
               for k in range(5)]
    biases = [rng.normal(0, 0.01, (GC if k < 4 else NC,)).astype(np.float32) for k in range(5)]
    return kernels, biases


def _a_index(plan, sb, tap):
    """Float index in a stage of A[m, k] of sub-block sb at tap: lane (g, t)
    of warp w holds rows 16 w + g + 8 h and K-columns t + 4 j, loaded as the
    j-th float of its 8-byte load from pixel row 2 w + h."""
    idx = np.zeros((64, KC), np.int64)
    for warp in range(4):
        for lane in range(32):
            g, t = divmod(lane, 4)
            for h in range(2):
                for j in range(2):
                    byte = (plan.a_offset(sb, tap) + plan.a_lane(warp, lane) + h * plan.row_bytes
                            + 4 * j)
                    idx[16 * warp + g + 8 * h, t + 4 * j] = byte // 4
    return idx


def _b_index(plan, hl, tap):
    """Float index in a stage of B[k, n] (K-major) through the descriptor of
    (hl, tap) in the 32-byte swizzle."""
    start, _, sbo, span = plan.b_desc(hl, tap)
    k = np.arange(KC)[:, None]
    n = np.arange(plan.cout)[None, :]
    byte = start + (n // 8) * sbo + (n % 8) * span + 4 * k
    return swizzle(byte, span) // 4


def _emulate_level(plan, x, growth, wimg, bias, k, out, products, flush):
    """Level k + 1 as the kernel computes it, written into ``out`` (the
    growth slice or y). ``products``: the split-TF32 products summed, each a
    wgmma into the chunk's accumulator; ``flush``: whether each chunk's
    accumulator is added into the total in f32 (as the kernel does) rather
    than carried on into the next chunk."""
    b_, h, w, nc = x.shape
    a_idx = np.stack([np.stack([_a_index(plan, sb, tap) for tap in range(9)])
                      for sb in range(plan.sub)])  # (sub, 9, 64, KC)
    b_idx = [[_b_index(plan, hl, tap) for tap in range(9)] for hl in range(2)]
    src_x = np.pad(x, ((0, 0), (1, plan.th + 1), (1, plan.tw + 1), (0, 0)))
    src_g = np.pad(growth, ((0, 0), (1, plan.th + 1), (1, plan.tw + 1), (0, 0)))
    tiles = [(b, y0, x0) for b in range(b_) for y0 in range(0, h, plan.th)
             for x0 in range(0, w, plan.tw)]
    total = np.zeros((len(tiles), plan.sub, 64, plan.cout), np.float32)
    acc = np.zeros_like(total)
    win = plan.win_pix * KC
    for it in range(wimg.shape[0]):
        if flush:
            acc[:] = 0
        stage = np.full((len(tiles), plan.stage_bytes // 4), np.nan, np.float32)
        c = it * KC
        src, cc = (src_x, c) if c < nc else (src_g, c - nc)
        for i, (b, y0, x0) in enumerate(tiles):
            # the 4-D box at (cc, x0 - 1, y0 - 1, b); padding = OOB zeros
            stage[i, :win] = src[b, y0:y0 + plan.th + 2, x0:x0 + plan.tw + 2,
                                 cc:cc + KC].reshape(-1)
        # the bulk copy of the chunk's image, as it is
        stage[:, plan.win_bytes // 4:plan.win_bytes // 4 + wimg[it].size] = wimg[it].reshape(-1)
        for tap in range(9):
            a = stage[:, a_idx[:, tap]]  # (tiles, sub, 64, KC)
            a_hi = rna_tf32(a)
            a_lo = rna_tf32(a - a_hi)
            b_hi = stage[:, b_idx[0][tap]][:, None]  # (tiles, 1, KC, cout)
            b_lo = stage[:, b_idx[1][tap]][:, None]
            terms = {"hh": (a_hi, b_hi), "hl": (a_hi, b_lo), "lh": (a_lo, b_hi)}
            for p in products:
                fa, fb = terms[p]
                acc = truncate_f32(acc.astype(np.float64) + np.matmul(fa.astype(np.float64),
                                                                      fb.astype(np.float64)))
        if flush:
            total += acc
    if not flush:
        total = acc
    for i, (b, y0, x0) in enumerate(tiles):
        for sb in range(plan.sub):
            r0, c0 = plan.sub_block(sb)
            for m in range(64):
                gy, gx = y0 + r0 + m // 8, x0 + c0 + m % 8
                if gy >= h or gx >= w:
                    continue
                v = total[i, sb, m] + bias
                if k == 4:
                    out[b, gy, gx] = x[b, gy, gx] + np.float32(0.2) * v
                else:
                    out[b, gy, gx, k * GC:(k + 1) * GC] = np.where(v >= 0, v,
                                                                   np.float32(0.2) * v)


def _emulate_rdb(tile, x, kernels, biases, products=("hh", "hl", "lh"), flush=True):
    growth = np.zeros(x.shape[:3] + (4 * GC,), np.float32)
    y = np.zeros_like(x)
    for k in range(5):
        plan = F32Plan(GC if k < 4 else NC, tile)
        wimg = split_weights(torch.from_numpy(kernels[k])).numpy()
        _emulate_level(plan, x, growth, wimg, biases[k], k, y if k == 4 else growth, products,
                       flush)
    return y


def _plain(x, kernels, biases, dtype=np.float32):
    """The plain version; at f64 the RDB that f32 computations approximate."""
    def t(a):
        return torch.from_numpy(np.asarray(a, dtype))

    return fused_rdb_reference(t(x), [t(k) for k in kernels], [t(v) for v in biases]).numpy()


@pytest.mark.parametrize("tile", [0, 1])
@pytest.mark.parametrize("shape", [(1, 19, 21), (2, 11, 19)])
def test_emulated_f32_kernel_matches_plain_version(rng, tile, shape):
    """Ragged H and W, B > 1, both tiles: the emulated split-TF32 products
    agree with the plain version (``kernel_f32``) and with JAX (``jax_rdb``),
    f32 on all sides. A stage starts as NaN, so a read of a byte no copy
    wrote fails."""
    kernels, biases = _params(rng)
    x = rng.random(shape + (NC,), dtype=np.float32)
    got = _emulate_rdb(tile, x, kernels, biases)
    np.testing.assert_allclose(got, _plain(x, kernels, biases),
                               atol=TOLERANCES["kernel_f32"][0], rtol=0)
    jax_want = np.asarray(_scatter_reference(
        jnp.asarray(x), tuple(map(jnp.asarray, kernels)), tuple(map(jnp.asarray, biases))))
    np.testing.assert_allclose(got, jax_want, atol=TOLERANCES["jax_rdb"][0], rtol=0)


def test_split_tf32_products_hold_f32_accuracy_and_one_product_does_not(rng):
    """Against the f64 RDB over a ragged shape: the emulation's max error is
    at most ``kernel_f32_f64`` (2x) the plain f32 version's; with one TF32
    product (hi.hi) it exceeds that, and so it does with the three products
    carried on in one truncating accumulator, without the per-chunk f32
    adds: the check tells each apart."""
    kernels, biases = _params(rng)
    x = rng.random((1, 21, 27, NC), dtype=np.float32)
    want = _plain(x, kernels, biases, np.float64)
    plain = np.abs(_plain(x, kernels, biases) - want).max()
    _, ratio = TOLERANCES["kernel_f32_f64"]
    split3 = np.abs(_emulate_rdb(1, x, kernels, biases) - want).max()
    split1 = np.abs(_emulate_rdb(1, x, kernels, biases, ("hh",)) - want).max()
    carried = np.abs(_emulate_rdb(1, x, kernels, biases, flush=False) - want).max()
    assert 0 < plain and split3 <= ratio * plain, (split3, plain)
    assert split1 > ratio * plain, (split1, plain)
    assert carried > ratio * plain, (carried, plain)


def test_split_weights(rng):
    """hi and lo are TF32 values (low 13 bits zero) with |w - hi - lo| <=
    2^-22 |w|, rounded as the kernel's cvt.rna rounds A; the image puts the
    split kernel where F32Plan reads it: K-column k of chunk c at input
    channel 8 c + perm[k], 8-row groups in the 32-byte swizzle."""
    kernel = rng.normal(0, 0.05, (3, 3, 16, GC)).astype(np.float32)
    w = torch.from_numpy(kernel)
    hi, lo = split_tf32(w)
    for part in (hi, lo):
        assert not (part.numpy().view(np.uint32) & 0x1FFF).any()
    assert np.array_equal(hi.numpy(), rna_tf32(kernel))
    assert np.array_equal(lo.numpy(), rna_tf32(kernel - hi.numpy()))
    rest = np.abs(kernel.astype(np.float64) - hi.numpy() - lo.numpy())
    assert (rest <= 2.0**-22 * np.abs(kernel)).all()
    img = split_weights(w).numpy()
    assert img.shape == (2, 2, 9, GC, KC) and img.dtype == np.float32
    plan = F32Plan(GC, 1)
    for c in range(2):
        stage = np.zeros(plan.stage_bytes // 4, np.float32)
        stage[plan.win_bytes // 4:plan.win_bytes // 4 + img[c].size] = img[c].reshape(-1)
        for hl, part in enumerate((hi, lo)):
            for tap in range(9):
                got = stage[_b_index(plan, hl, tap)]  # (K, cout)
                want = part.numpy()[tap // 3, tap % 3, 8 * c + np.array(F32Plan.perm)]
                assert np.array_equal(got, want)


@pytest.mark.parametrize("cout", [GC, NC])
@pytest.mark.parametrize("tile", [0, 1])
def test_f32_plan_fits_the_card(cout, tile):
    """The blocks an SM is to hold fit its 228 KB (1 KB each the system's),
    one block in 227 KB; every B operand starts a 1024-byte swizzle repeat;
    the window box keeps TMA's limits; descriptor fields fit their 14 bits;
    the bytes a stage expects are exactly its window box and weight copy;
    every lane's A load is 8-byte aligned and stays inside the window, and a
    warp's loads of one pixel row are 256 contiguous bytes (no bank
    conflict)."""
    plan = F32Plan(cout, tile)
    assert plan.blocks * (plan.smem_bytes + 1024) <= 228 * 1024 and plan.smem_bytes <= 232448
    assert 2 <= plan.stages <= 4
    assert plan.win_bytes % 1024 == 0 and plan.op_bytes % 1024 == 0
    assert plan.pix_bytes == 32 and max(plan.tw + 2, plan.th + 2, KC) <= 256
    assert plan.tx_bytes == plan.win_pix * KC * 4 + 2 * 9 * KC * cout * 4
    assert plan.sub == plan.warpgroups * plan.mt and plan.threads % 32 == 0
    assert len(plan.vector()) == 15 + 18 + 9 * plan.sub <= 128  # kernel_plan's buffer
    for hl in range(2):
        for tap in range(9):
            for field in plan.b_desc(hl, tap)[:3]:
                assert field % 16 == 0 and field >> 4 < 1 << 14
    for warp in range(4):
        loads = sorted(plan.a_lane(warp, lane) for lane in range(32))
        assert loads == list(range(loads[0], loads[0] + 256, 8))
    last = (max(plan.a_offset(sb, 8) for sb in range(plan.sub)) + plan.a_lane(3, 31)
            + plan.row_bytes)
    assert last + 8 <= plan.win_pix * 32
    assert sorted(F32Plan.perm) == list(range(KC))


def test_f32_bound_is_split_tf32():
    """f32's bound: three TF32 products per f32 product at 495 TFLOP/s, which
    beats the CUDA cores' 67: 0.381 ms at (8, 128, 128)."""
    flop, nbytes = rdb_cost(8, 128, 128, itemsize=4)
    ms, by = bound_ms(flop, nbytes, torch.float32)
    assert by == "operations"
    assert abs(ms - min(flop / 67e12, 3 * flop / 495e12) * 1e3) < 1e-12
    assert abs(ms - 0.3807) < 1e-4
