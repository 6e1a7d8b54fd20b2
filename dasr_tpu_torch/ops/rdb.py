"""Residual Dense Block (RDB5C): the hand-written CUDA kernel, its plain
PyTorch version, and the autograd Function that trains through the kernel.

What it computes: exactly ``dasr_tpu.ops.pallas_rdb._scatter_reference``.
For k = 1..4, x_k = lrelu_0.2(conv3x3_k([x, x_1..x_{k-1}]) + b_k), rounded
to the working type before the next conv; the output is
x + 0.2 * (conv3x3_5([x, x_1..x_4]) + b_5), accumulated in f32 and rounded
once. Every conv is SAME with zero padding.

Which TPU kernel it replaces: ``dasr_tpu/ops/pallas_rdb.py:_rdb_kernel``,
launched by ``_fused_rdb_impl`` (the one ``pl.pallas_call`` of the JAX
package), and the custom VJP around it (``pallas_rdb.py:276-294``).

Backward, two paths that share no logic, chosen by the input's device and type:

* bf16 on the card: hand-written kernels (``dasr_rdb_backward`` in
  ``csrc/rdb.cu``, six launches an RDB) that read what the forward kept,
  x and the growth buffer x_1..x_4, and recompute nothing: on the dgrad
  weight images (made by the network's weight plan, or else by one launch
  more), the reverse dense chain on the forward's machinery (dv_4..dv_1
  into a gradient growth buffer, then dx), and the weight and bias
  gradients of all five levels in one launch (its pixel splits added inside
  it, over a thread-block cluster's shared memory, ``wgrad_plan``), written
  in f32 in the parameters' OIHW layout. ``rdb_backward_reference`` is its
  plain version. The TPU kernel had no backward kernel (JAX's custom VJP is XLA's stock chain), so
  this one replaces none; the source note says what bounds it.
* f32 on the card, and the CPU: as in JAX, the VJP of the stock dense chain
  (``rdb_chain``, the counterpart of ``_scatter_reference`` in the working
  type: convs in the working type, f32 sums of the level terms, rounding
  where it rounds), recomputed from the saved input and weights; on the
  card its convs run on cuDNN. A split-TF32 backward is later work.

What bounds it on the H100: arithmetic. One RDB (nc 64, gc 32) does
2 * 9 * (64 * 32 + 96 * 32 + 128 * 32 + 160 * 32 + 192 * 64) = 479,232 FLOP
per pixel: 62.81 GFLOP at (8, 128, 128), 63.5 us at the 989 TFLOP/s bf16
peak, against 10.2 us for the ~34 MB it must move (x in, y out, 0.48 MB of
weights); ``rdb_cost`` and ``bound_ms`` compute both. At f32 the least
time is 0.381 ms, three TF32 products per f32 product (``PEAK_FLOPS``). Run
as five launches, each level also moves its own inputs and output: levels
1-4 lie below the card's ~295 FLOP/byte ridge and level 5 above it, a floor
of ~74 us at (8, 128, 128) (``level_costs``). The 69 RDBs of the x4 RRDBNet
are 33.1 of its 35.9 MFLOP per LR pixel. So the design keeps the bytes near
the minimum and puts the FLOPs on the tensor cores:

* a preallocated NHWC growth buffer (B, H, W, 4 gc) takes x_1..x_4; level k
  reads channels [0, nc) of x and [0, (k-1) gc) of the buffer and writes its
  own gc-channel slice, so the dense concat is never copied;
* input pixels outside the image read as zeros, which is the SAME padding
  of every level, with no per-level masks (the Pallas kernel's ``_mask``
  existed only because it kept a whole RDB in one VMEM tile);
* bf16 runs on Hopper's ``wgmma``: a block owns 8x8-pixel sub-blocks (a
  tile of 16x16 pixels, or 8x8 where ``tile_plan`` finds too few tiles to
  fill the SMs), each one 64-row product that one of one or two consumer
  warpgroups accumulates in f32 registers. K is walked in chunks of 16
  input channels x 9 taps; a producer warp stages each chunk with two TMA
  loads into a ring of shared-memory stages signalled by mbarriers: the
  input window (tile + 1-px halo, zero-filled outside the image by TMA), one
  box of whole 32-byte pixel rows (the chunk's 16 channels), and the chunk's
  weight rows, one box of whole 64- or 128-byte rows (all cout columns)
  read from the HWIO matrix as it is. Every warpgroup of the block reads
  the weights from there, and all nine taps read the one staged window
  through shifted ``wgmma`` descriptors. ``WgmmaPlan`` states that layout;
  the CPU tests emulate the products through it and ``chip_smoke.py`` holds
  it against the plan compiled into the kernel. Each level but the first
  is a programmatic dependent launch, so its blocks set up while the
  previous level drains (a first level chained to the previous RDB let
  early blocks queue up across RDBs, 0.33 ms of the train step's forward).
  The epilogue runs on the accumulators: bias + leaky ReLU or the
  residual, rounded once, 16-byte stores;
* f32 runs on the same machinery with split-TF32 products (``rdb_level_tf32x3``,
  CUTLASS's "3xTF32"): each operand v is split into hi = tf32(v) and
  lo = tf32(v - hi), both rounded to nearest, and each product is
  hi.hi + hi.lo + lo.hi, three tf32 ``wgmma`` into one f32 accumulator set.
  What it drops (lo.lo and the split's remainders) is ~2^-22 of each product.
  The tensor cores truncate each f32 sum, so each 8-channel chunk's 27
  products are summed apart and added into the level's total in f32.
  A stage holds 8 input channels (one k8 step). ``wgmma`` has no transpose
  for 32-bit types, so B is K-major: ``split_weights`` makes, once per
  parameter version, each level's image [chunk][hi, lo][tap][cout][8 ci],
  already split and in the 32-byte swizzle, which one bulk copy a stage
  lands. A comes from registers: each lane loads its fragment from the
  staged window (unswizzled), splits it and issues the three products; the
  8 input channels of each chunk are ordered in B (``F32Plan.perm``) so that
  a lane's two K-columns are adjacent channels. ``F32Plan`` states that
  layout; the CPU tests emulate the products through it and
  ``chip_smoke.py`` holds it against the plan compiled into the kernel.

Weights are HWIO, which read as (9 * cin, cout) matrices with rows ordered
(dy, dx, ci), the layout of ``_im2col_weights``; ``prepare_weights`` makes
them once per parameter version, with the f32 kernel's split images beside
them on the card, and the modules cache the result; under autograd the split
images are made on every call. Under autograd at bf16 on the card a
generator's forward first fills its ``RDBWeightPlan`` (``csrc/rdb.cu:
rdb_prep_weights``, one launch for every RDB: the bf16 HWIO kernels and the
backward's dgrad weight images, from one read of the f32 parameters), and
each RDB takes its slot; a call without one casts its kernels itself and
its backward makes its images. Not done yet, and left to later PRs: fusing
levels 1-4 per tile (worth it once the kernel nears the five-launch floor),
a persistent grid. The Pallas design (a whole RDB per tile) does not fit:
five on-chip activations of a 16x16 tile already take ~196 KiB of the 227 KB
of shared memory.

Tolerances, stated once here; the tests and ``chip_smoke.py`` import
``TOLERANCES``:

==================  ======  ======  ==================================================
check               atol    rtol    why
==================  ======  ======  ==================================================
kernel_f32          1e-4    0       f32 kernel vs f32 plain version on the card: the
                                    kernel's split-TF32 products (hi.hi + hi.lo +
                                    lo.hi, each off the f32 product by ~2^-22 of it)
                                    summed in another order over K <= 1728 terms than
                                    the plain version's f32 products (TF32 off).
kernel_f32_f64      0       2       f32 kernel vs an f64 computation of the same RDB:
                                    max |kernel - f64| <= rtol x max |plain - f64|, the
                                    plain version's f32 error on the same inputs. The
                                    split-TF32 products drop ~2^-22 of each product,
                                    which beside the f32 rounding of the sums must not
                                    more than double the error. One TF32 product
                                    (2^-11 of each) is ~280x off in the CPU emulation;
                                    the three products in one truncating accumulator
                                    over a level, without the per-chunk f32 adds,
                                    were 8-22x off on the H100.
kernel_bf16         3e-3    2^-7    bf16 kernel vs the plain version on the same bf16
                                    tensors, which rounds x_1..x_4 and the output
                                    where the kernel does: the f32 sums differ only
                                    in order, so the output's rounding can flip by
                                    one bf16 ulp (at most 2^-7 |y|), and flips in
                                    x_1..x_4 carry into it; on the H100, over the
                                    check's seven shapes, no element needed more
                                    than 1.4e-3 of atol beside that rtol.
bf16_vs_f32         3e-2    2e-2    a bf16 computation vs the f32 one on the same
                                    bf16-rounded inputs: x_1..x_4 and the output are
                                    rounded to bf16 (8 significant bits) in one and
                                    not in the other.
jax_rdb             1e-4    0       port's plain version vs JAX ``_scatter_reference``
                                    and the interpreted Pallas kernel, f32 on the CPU:
                                    two conv implementations, different sum orders.
jax_blocks          1e-5    0       nn modules (RDB5C, RRDB, upconv, conv_block) vs
                                    flax at f32 on the CPU: one or a few convs deep.
jax_network         1e-4    0       RRDBNet, forward_chop, tiled_apply vs JAX at f32
                                    on the CPU: 2 RRDBs plus stem and x4 tail.
network_f32         1e-4    0       the full nb 23 network with the kernel vs the same
                                    network on the plain version, f32 on the card; the
                                    JAX-vs-torch CPU check of the reference reached
                                    3.8e-5 at full size (PARITY.md).
grad_f32            0       1e-2    the Function (kernel forward, VJP of the f32
                                    ``rdb_chain`` on cuDNN) vs autograd through the plain
                                    version (cuDNN off) on the same f32 tensors on the
                                    card: dL/dx and the ten parameter gradients, each
                                    held in the Frobenius norm, |got - want| <= rtol
                                    |want| (a weight gradient sums up to 12288
                                    products, so an elementwise limit says little).
                                    Not a precision limit: a pre-activation within
                                    rounding of 0 takes the other slope of the leaky
                                    ReLU in one computation and not in the other, and
                                    one such element moves an upstream gradient by up
                                    to ~1e-3 of its norm; on the H100 f32 gradients
                                    differed from the f64 one by up to 1.9e-3 that way,
                                    plain version included, and cuDNN's f32 backward
                                    of the plain version's convs by up to 4.7e-3 (TF32
                                    off), so it runs with cuDNN off. A wrong gradient
                                    is off by O(1).
grad_bf16           0       1e-1    the same at bf16 (the Function's backward there is
                                    the kernels): two bf16 computations of one gradient,
                                    neither exact. The backward rounds every level's
                                    gradient to bf16 (2^-9 relative each; the chain also
                                    every conv output), the plain version only where the
                                    forward rounds; against the f64 gradient of the
                                    unrounded function both are off by 1-5% (CPU,
                                    oneDNN bf16 convs), and the chain and the plain
                                    version differed from each other by 0.4-4.9%.
train_loss_f32      2e-5    2e-3    three f32 DASR steps at nb 2, full width, on the
                                    card with the kernel vs with the plain version: the
                                    limits of the CPU check against the JAX trainer.
train_update_f32    0       5e-2    that run's three-step update of each network's
                                    params, dtheta = theta_3 - theta_0, in the Frobenius
                                    norm. Not elementwise: Adam divides each gradient
                                    element by its own running RMS, so an element whose
                                    gradient lies within rounding of 0 moves by up to lr
                                    (1e-4) a step whichever way the rounding tips it; on
                                    the H100 179 of D_target's 668737 params differed by
                                    more than 2e-5 (up to 3.6e-4), which made 7.4e-3 of
                                    its update's norm (G: 5.4e-5), while the CPU check
                                    against JAX (nf 16) holds 2e-5 elementwise. A wrong
                                    gradient moves dtheta by O(1) of its norm.
train_moment_f32    0       1e-2    that run's Adam first moments after the three steps
                                    (a weighted sum of the step gradients, linear in
                                    them, where Adam's update is not): held as grad_f32.
psnr_db             1e-2    0       srn_test per-set PSNR (and PSNR_Y), port vs JAX:
                                    an f32 difference can flip a uint8 rounding.
ssim                1e-4    0       srn_test per-set SSIM (and SSIM_Y), same reason.
==================  ======  ======  ==================================================
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from dasr_tpu_torch.utils import trace

TOLERANCES = {
    "kernel_f32": (1e-4, 0.0),
    "kernel_f32_f64": (0.0, 2.0),
    "kernel_bf16": (3e-3, 2.0**-7),
    "bf16_vs_f32": (3e-2, 2e-2),
    "jax_rdb": (1e-4, 0.0),
    "jax_blocks": (1e-5, 0.0),
    "jax_network": (1e-4, 0.0),
    "network_f32": (1e-4, 0.0),
    "grad_f32": (0.0, 1e-2),
    "grad_bf16": (0.0, 1e-1),
    "train_loss_f32": (2e-5, 2e-3),
    "train_update_f32": (0.0, 5e-2),
    "train_moment_f32": (0.0, 1e-2),
    "psnr_db": (1e-2, 0.0),
    "ssim": (1e-4, 0.0),
}

LAUNCHES_PER_RDB = 5  # one kernel launch per level
# the bf16 backward: five reverse-chain levels and the weight gradients;
# and, where no weight plan made them (``RDBWeightPlan``), the dgrad weight
# images first
BACKWARD_LAUNCHES = 6
IMAGE_LAUNCHES = 1
# kernel codes of the C entry point: f32 split-TF32 wgmma, bf16 wgmma
_KERNEL_CODE = {torch.float32: 0, torch.bfloat16: 1}

# H100 SXM peaks (NVIDIA's data sheet, dense): bf16 tensor cores, HBM3, and
# for f32 the faster of two ways to an f32-accurate product: the CUDA
# cores' 67 TFLOP/s, or three TF32 products (split-TF32) at 495 / 3 = 165.
# So f32's bound is min(flop / 67e12, 3 flop / 495e12), 0.381 ms at
# (8, 128, 128).
TF32_PEAK_FLOPS = 495e12
F32_CUDA_CORE_PEAK_FLOPS = 67e12
PEAK_FLOPS = {torch.bfloat16: 989e12,
              torch.float32: max(F32_CUDA_CORE_PEAK_FLOPS, TF32_PEAK_FLOPS / 3)}
PEAK_BYTES_PER_S = 3.35e12

# (rows, columns) of output pixels a block of the bf16 kernel owns, by the
# tile code the C entry point takes
TILES = ((8, 8), (16, 16))


# the weight-gradient kernel (rdb_wgrad): tile columns, the tile rows it
# takes, a unit's input channels, the most blocks of a cluster (the portable
# limit), and a stage's fixed cost in pixels of products (its barriers and
# copies; on the H100 8-row tiles won at (4, 48, 48), 36 16 x 16 tiles over
# 8 splits, and lost at the other train shapes)
WGRAD_TILE_W = 16
WGRAD_TILE_H = (16, 8)
WGRAD_N = 32
WGRAD_MAX_SPLITS = 8
WGRAD_STAGE_PX = 16


def wgrad_units(nc=64, gc=32):
    """The weight-gradient kernel's units, in its order (``wgrad_unit`` in
    ``csrc/rdb.cu``): (dv group, first input channel). A dv group is the 64
    output channels of wgmma's rows: level 5's dY (0), [dv_4 | dv_3] (1) or
    [dv_2 | dv_1] (2) of the gradient growth buffer; a unit takes WGRAD_N
    input channels (wgmma's columns) of the widest input of the group's
    levels, numbered as a level's input: x, then x_1, x_2, ..."""
    return [(grp, c0) for grp, widest in ((0, 4), (1, 3), (2, 1))
            for c0 in range(0, nc + widest * gc, WGRAD_N)]


def wgrad_row_level(grp, row, nc=64, gc=32):
    """(level, 0-based, and its output channel) of row ``row`` of dv group
    ``grp``, or (None, None) for a row past level 5's nc."""
    if grp == 0:
        return (4, row) if row < nc else (None, None)
    return (3 if grp == 1 else 1) - row // gc, row % gc


def wgrad_plan(b, h, w, nc=64, gc=32, sms=132):
    """(tile rows, splits) of the weight-gradient kernel at a (b, h, w)
    level. Tiles are WGRAD_TILE_W columns by 16 or 8 rows; each unit's block
    walks one of ``splits`` contiguous ranges of the tiles
    (``wgrad_tiles``), and the splits of a unit are the blocks of one
    thread-block cluster, which adds them inside the launch. Splits: as many
    as keep every block in one wave of one block an SM, at most
    WGRAD_MAX_SPLITS and never more than the tiles. Rows: the fewer stages'
    products and fixed costs on the busiest block (WGRAD_STAGE_PX), 16 on a
    tie. So the plan follows the shape, nc and the SM count alone, and so
    does the order of every sum."""
    units = len(wgrad_units(nc, gc))
    best = None
    for th in WGRAD_TILE_H:
        tiles = b * -(-h // th) * -(-w // WGRAD_TILE_W)
        splits = max(1, min(WGRAD_MAX_SPLITS, tiles, sms // units))
        cost = -(-tiles // splits) * (th * WGRAD_TILE_W + WGRAD_STAGE_PX)
        if best is None or cost < best[0]:
            best = (cost, th, splits)
    return best[1], best[2]


def wgrad_tiles(b, h, w, th, splits):
    """The tiles (flat index (b, tile row, tile column)) that each split,
    the block of that rank in a cluster, walks in order; the cluster adds
    the splits' sums in rank order."""
    tiles = b * -(-h // th) * -(-w // WGRAD_TILE_W)
    return [range(tiles * r // splits, tiles * (r + 1) // splits) for r in range(splits)]


def grad_layout(nc=64, gc=32):
    """[(weight offset, bias offset)] of each level in the backward's f32
    gradient buffer and its total length: each level's OIHW kernel
    (cout, cin, 3, 3), then its bias (``grad_offset`` in ``csrc/rdb.cu``)."""
    out, off = [], 0
    for k in range(5):
        cin, cout = nc + k * gc, gc if k < 4 else nc
        out.append((off, off + 9 * cin * cout))
        off += (9 * cin + 1) * cout
    return out, off


def tile_plan(b, h, w, sms=132):
    """Tile code for a (b, h, w) level: 16x16, which shares each staged
    weight chunk among 256 pixels, unless it would leave more than half the
    SMs without a block; then 8x8. On the H100 16x16 was the faster at
    (3, 100, 90), 126 blocks, and 8x8 fills the SMs at the train step's
    (12, 32, 32)."""
    return 1 if b * -(-h // 16) * -(-w // 16) >= sms // 2 else 0


class WgmmaPlan:
    """The bf16 kernel's shared-memory plan for one (cout, tile code), as
    ``Plan`` in ``csrc/rdb.cu`` lays it out (byte offsets within a stage,
    before the swizzle):

    * window: [row][col][kc ch] over the (th + 2) x (tw + 2) window, one
      32-byte row a pixel, in the 32-byte swizzle;
    * weights, after the window (1024-byte aligned): [tap][ci][cout] for the
      chunk's kc input channels, rows of 2 cout bytes in the swizzle of
      that width.

    ``a_desc`` and ``b_desc`` give each product's (start, leading byte
    offset, stride byte offset, swizzle span): A K-major (a row is a pixel;
    SBO the next 8 pixels, which are the next window row), B MN-major (a
    row is an input channel; SBO the next 8 channels). ``vector`` lists the
    plan in the order of the library's ``dasr_rdb_wgmma_plan``, which
    ``kernel_plan`` reads."""

    kc = 16  # input channels per pipeline stage

    def __init__(self, cout, tile):
        self.cout = cout
        self.th, self.tw = TILES[tile]
        self.sub = (self.th // 8) * (self.tw // 8)
        self.warpgroups = 1 if self.sub < 2 else 2
        self.mt = self.sub // self.warpgroups
        self.threads = 128 * self.warpgroups + 32
        self.win_w = self.tw + 2
        self.win_pix = (self.th + 2) * (self.tw + 2)
        self.pix_bytes = 2 * self.kc
        self.win_bytes = -(-self.win_pix * self.pix_bytes // 1024) * 1024
        self.wrow_bytes = 2 * cout
        self.w_bytes = 9 * self.kc * self.wrow_bytes
        self.stage_bytes = self.win_bytes + self.w_bytes
        self.tx_bytes = self.win_pix * self.pix_bytes + self.w_bytes
        self.stages = 4 if 4 * self.stage_bytes <= 110 * 1024 else 3
        self.smem_bytes = self.stages * self.stage_bytes + 16 * self.stages + 1024

    def sub_block(self, sb):
        """(row, col) of sub-block sb's first pixel in the tile."""
        cols = self.tw // 8
        return 8 * (sb // cols), 8 * (sb % cols)

    def a_desc(self, sb, tap):
        r, c = self.sub_block(sb)
        dy, dx = divmod(tap, 3)
        start = ((r + dy) * self.win_w + c + dx) * self.pix_bytes
        return start, 16, self.win_w * self.pix_bytes, self.pix_bytes

    def b_desc(self, tap):
        return (self.win_bytes + tap * self.kc * self.wrow_bytes, self.w_bytes,
                8 * self.wrow_bytes, self.wrow_bytes)

    def vector(self):
        _, a_lbo, a_sbo, a_span = self.a_desc(0, 0)
        _, b_lbo, b_sbo, b_span = self.b_desc(0)
        return ([self.kc, self.threads, self.stages, self.stage_bytes, self.win_bytes,
                 self.w_bytes, self.tx_bytes, self.smem_bytes, a_span, b_span, a_lbo, a_sbo,
                 b_lbo, b_sbo]
                + [self.b_desc(tap)[0] for tap in range(9)]
                + [self.a_desc(sb, tap)[0] for sb in range(self.sub) for tap in range(9)])


class F32Plan:
    """The f32 kernel's shared-memory plan for one (cout, tile code), as
    ``F32Plan`` in ``csrc/rdb.cu`` lays it out (byte offsets within a stage):

    * window: [row][col][kc ch] over the (th + 2) x (tw + 2) window, one
      unswizzled 32-byte row a pixel (the lanes load it, not ``wgmma``);
    * weights, after the window (1024-byte aligned): the chunk's slice of
      ``split_weights``' image, [hl][tap][cout][kc], hl 0 hi and 1 lo, one
      32-byte row per output channel in the 32-byte swizzle (pre-swizzled by
      ``split_weights``, so a linear copy lands it).

    A's fragment comes from registers: lane (g, t) of warp w holds rows
    16 w + g and 16 w + g + 8 of a sub-block (its pixels (2 w, g) and
    (2 w + 1, g)) at K-columns t and t + 4, read as one 8-byte load of
    channels 2t, 2t + 1 from each pixel (``a_lane``); so K-column k of a
    chunk is its channel ``perm[k]``, and B is ordered so. ``b_desc`` gives
    each B operand's (start, LBO, SBO, swizzle span): K-major, SBO the next
    8 output channels. ``vector`` lists the plan in the order of the
    library's ``dasr_rdb_f32_plan``, which ``kernel_plan`` reads."""

    kc = 8  # input channels per pipeline stage: one tf32 k8 step
    perm = (0, 2, 4, 6, 1, 3, 5, 7)  # K-column k of a chunk is channel perm[k]

    def __init__(self, cout, tile):
        self.cout = cout
        self.th, self.tw = TILES[tile]
        self.sub = (self.th // 8) * (self.tw // 8)
        self.warpgroups = 1 if self.sub < 2 else 2
        self.mt = self.sub // self.warpgroups
        self.threads = 128 * self.warpgroups
        self.blocks = 1 if cout == 64 and self.mt == 2 else 2
        self.win_w = self.tw + 2
        self.win_pix = (self.th + 2) * (self.tw + 2)
        self.pix_bytes = 4 * self.kc
        self.win_bytes = -(-self.win_pix * self.pix_bytes // 1024) * 1024
        self.op_bytes = cout * self.pix_bytes
        self.w_bytes = 2 * 9 * self.op_bytes
        self.stage_bytes = self.win_bytes + self.w_bytes
        self.tx_bytes = self.win_pix * self.pix_bytes + self.w_bytes
        share = (232448 if self.blocks == 1 else 233472 // 2 - 1024) - 1024 - 64
        self.stages = min(4, share // self.stage_bytes)
        self.smem_bytes = self.stages * self.stage_bytes + 16 * self.stages + 1024
        self.row_bytes = self.win_w * self.pix_bytes

    def sub_block(self, sb):
        """(row, col) of sub-block sb's first pixel in the tile."""
        cols = self.tw // 8
        return 8 * (sb // cols), 8 * (sb % cols)

    def a_offset(self, sb, tap):
        r, c = self.sub_block(sb)
        dy, dx = divmod(tap, 3)
        return ((r + dy) * self.win_w + c + dx) * self.pix_bytes

    def a_lane(self, warp, lane):
        """Byte offset, from ``a_offset``, of the 8-byte load of lane's pixel
        row 2 warp; the load of row 2 warp + 1 is ``row_bytes`` after it."""
        return 2 * warp * self.row_bytes + (lane // 4) * self.pix_bytes + (lane % 4) * 8

    def b_desc(self, hl, tap):
        return self.win_bytes + (9 * hl + tap) * self.op_bytes, 16, 8 * self.pix_bytes, \
            self.pix_bytes

    def vector(self):
        _, b_lbo, b_sbo, b_span = self.b_desc(0, 0)
        return ([self.kc, self.threads, self.blocks, self.stages, self.stage_bytes,
                 self.win_bytes, self.w_bytes, self.tx_bytes, self.smem_bytes, b_span, b_lbo,
                 b_sbo, self.row_bytes, self.a_lane(3, 0), self.a_lane(3, 31)]
                + [self.b_desc(hl, tap)[0] for hl in range(2) for tap in range(9)]
                + [self.a_offset(sb, tap) for sb in range(self.sub) for tap in range(9)])


def split_tf32(v):
    """(hi, lo) of f32 ``v``: hi = v rounded to TF32 (10 mantissa bits) to
    nearest, ties away from zero, as ``cvt.rna.tf32.f32`` does, and lo =
    v - hi rounded so; v - hi - lo is within 2^-22 |v|."""

    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(v)
    return hi, rna(v - hi)


def split_weights(kernel):
    """The f32 kernel's weight image of one level from its HWIO f32 kernel
    (3, 3, cin, cout): (cin / 8, 2, 9, cout, 8) f32, [chunk][hi, lo][tap]
    [output channel][K-column], K-column k of chunk c holding input channel
    8 c + ``F32Plan.perm[k]``, and each 256-byte group of 8 rows in the
    32-byte swizzle (rows 4-7 swap their 16-byte halves): the bytes the
    kernel's bulk copy lands in a stage, and its wgmma descriptors read."""
    kh, kw, cin, cout = kernel.shape
    hi, lo = split_tf32(kernel.detach().float().reshape(kh * kw, cin, cout))
    w = torch.stack((hi, lo)).reshape(2, 9, cin // 8, 8, cout).permute(2, 0, 1, 4, 3)
    idx = _image_columns(cout, kernel.device).expand(cin // 8, 2, 9, cout, 8)
    return torch.gather(w, 4, idx)


@functools.lru_cache(maxsize=None)
def _image_columns(cout, device):
    """(cout, 8): the input channel of a chunk that byte column j (in 4-byte
    units) of output channel n's row holds: K-column j, swizzled, in
    ``F32Plan.perm``'s order."""
    row = torch.arange(cout).view(cout, 1)
    col = torch.arange(8).view(1, 8)
    return torch.tensor(F32Plan.perm)[col ^ (4 * ((row >> 2) & 1))].to(device)


class PreparedKernels(tuple):
    """The five HWIO kernels ``fused_rdb`` takes, as ``prepare_weights``
    makes them; at f32 on the card also their ``split`` images
    (``split_weights``), which the f32 kernel reads. Any other tuple of
    kernels has them made on each call."""

    split = None


class PlannedKernels(tuple):
    """The five f32 HWIO kernel views ``RDB5C`` hands ``fused_rdb`` under
    autograd, with ``prepared``: the RDB's slot of a ``RDBWeightPlan``
    (bf16 HWIO kernels, dgrad weight images) filled for this forward, which
    the bf16 kernels take in place of casting their own."""

    prepared = None


def kernel_plan(cout, tile, dtype=torch.bfloat16):
    """The plan compiled into the bf16 kernel (``WgmmaPlan.vector``) or the
    f32 kernel (``F32Plan.vector``) for (cout, tile code). Loads the
    library, so it needs nvcc."""
    from dasr_tpu_torch.kernels import build

    lib = build.load()
    fn = lib.dasr_rdb_wgmma_plan if dtype == torch.bfloat16 else lib.dasr_rdb_f32_plan
    out = (ctypes.c_int * 128)()
    n = fn(cout, tile, out, len(out))
    if not 0 <= n <= len(out):
        raise ValueError(f"kernel_plan: no {dtype} kernel for cout {cout}, tile {tile}")
    return list(out[:n])


def kernel_wgrad_units(nc=64, gc=32):
    """The weight-gradient kernel's units as compiled (``wgrad_unit``), in
    the form of ``wgrad_units``. Loads the library, so it needs nvcc."""
    from dasr_tpu_torch.kernels import build

    lib = build.load()
    out = (ctypes.c_int * 256)()
    n = lib.dasr_rdb_wgrad_units(nc, gc, out, len(out))
    return [tuple(out[i:i + 2]) for i in range(0, min(n, len(out)), 2)]


def level_costs(b, h, w, nc=64, gc=32, itemsize=2):
    """[(FLOP, bytes)] of the five levels run as five launches: each reads
    its input channels and weights once and writes its output once."""
    pix = b * h * w
    out = []
    for k in range(5):
        cin, cout = nc + k * gc, gc if k < 4 else nc
        out.append((2 * 9 * pix * cin * cout,
                    pix * (cin + cout) * itemsize + 9 * cin * cout * itemsize + 4 * cout))
    return out


def rdb_cost(b, h, w, nc=64, gc=32, itemsize=2):
    """(FLOP, bytes) of one RDB as one function: x read once, y written
    once, the weights and biases read once."""
    macs = sum((nc + k * gc) * (gc if k < 4 else nc) for k in range(5))
    flop = 2 * 9 * b * h * w * macs
    nbytes = 2 * b * h * w * nc * itemsize + 9 * macs * itemsize + 4 * (4 * gc + nc)
    return flop, nbytes


def bound_ms(flop, nbytes, dtype=torch.bfloat16):
    """(the least time in ms the H100 could take, "operations" or "bytes",
    whichever sets it) at the published peaks."""
    t_ops = flop / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def prepare_weights(kernels, biases, dtype):
    """HWIO kernels in the working type and f32 biases, contiguous and
    detached: what ``fused_rdb`` takes on the card. At f32 on the card the
    kernels carry their ``split_weights`` images too (``PreparedKernels``)."""
    with torch.no_grad():
        ks = PreparedKernels(k.detach().to(dtype).contiguous() for k in kernels)
        bs = tuple(b.detach().to(torch.float32).contiguous() for b in biases)
        if dtype == torch.float32 and ks[0].is_cuda:
            ks.split = tuple(split_weights(k) for k in ks)
    return ks, bs


def reference_levels(x, kernels, biases):
    """The plain version's output and growth buffer (x_1..x_4 in x's dtype,
    (B, H, W, 4 gc) NHWC): what the kernel's forward computes and keeps."""
    dt = x.dtype
    ct = torch.promote_types(dt, torch.float32)
    feats = [x.permute(0, 3, 1, 2).to(ct)]
    out = None
    for k in range(5):
        w = kernels[k].to(dt).to(ct).permute(3, 2, 0, 1)
        v = F.conv2d(torch.cat(feats, 1), w, biases[k].to(ct), padding=1)
        if k < 4:
            feats.append(F.leaky_relu(v, 0.2).to(dt).to(ct))
        else:
            out = (feats[0] + 0.2 * v).to(dt)
    growth = torch.cat(feats[1:], 1).to(dt)
    return out.permute(0, 2, 3, 1), growth.permute(0, 2, 3, 1)


def fused_rdb_reference(x, kernels, biases):
    """Plain PyTorch version: ``F.conv2d`` over the concatenated prefix.

    x (B, H, W, nc) NHWC; kernels HWIO; biases (cout,). Convs run in f32 (in
    f64 for an f64 x, which makes this the f64 RDB the f32 kernel is held
    against) on working-type-rounded inputs; returns NHWC in x's dtype."""
    return reference_levels(x, kernels, biases)[0]


def dgrad_weights(kernels):
    """The reverse chain's five weight images from the forward's HWIO
    kernels (the plain version of ``csrc/rdb.cu:rdb_dgrad_weights``).

    Level j of the reverse chain (j = 0..4) convolves [dv_5 | dv_4 | ..
    | dv_{5-j}] (nc + j gc channels, the gradient growth buffer's order)
    into the gradient of the forward's source x_{4-j} (gc channels), or of
    x (nc) at j = 4. A transposed SAME 3x3 conv is a conv with the taps
    flipped and the in and out channels swapped, so image j is HWIO
    (3, 3, nc + j gc, cout): level 5's rows times 0.2 (dv_5 = 0.2 dY, so
    the chain reads dY), then levels 4, 3, .. 5-j, each the slice of its
    kernel that reads the source, in x's dtype."""
    dt = kernels[0].dtype
    nc, gc = kernels[4].shape[-1], kernels[0].shape[-1]
    out = []
    for j in range(5):
        lo, width = (nc + (3 - j) * gc, gc) if j < 4 else (0, nc)
        parts = [(kernels[4][:, :, lo:lo + width].float() * 0.2).to(dt)]
        parts += [kernels[k][:, :, lo:lo + width] for k in range(3, 3 - j, -1)]
        out.append(torch.cat([p.flip(0, 1).transpose(2, 3) for p in parts], 2).contiguous())
    return out


def image_offsets(nc=64, gc=32):
    """[element offset of each of an RDB's five dgrad weight images] and
    their total: the images one after another, as ``dgrad_weights`` lists
    them and ``csrc/rdb.cu:rdb_dgrad_weights`` writes them."""
    out, off = [], 0
    for j in range(5):
        out.append(off)
        off += 9 * (nc + j * gc) * (gc if j < 4 else nc)
    return out, off


PREP_TILE = 32  # output and input channels of the prep kernel's tile (kPrepTile)
PREP_ROW = 8  # int64 words of a unit of the prep kernel's table (kPrepRow)
PREP_TILES_PER_BLOCK = 4  # the most tiles a block of the prep kernel walks


def prep_bytes(n_weights, itemsize=2):
    """Bytes the weight preparation moves for ``n_weights`` f32 weights: each
    read once, and written once as a kernel and once as an image element."""
    return n_weights * (4 + 2 * itemsize)


class RDBWeightPlan:
    """Every bf16 RDB of a network prepared at once, once a forward: the
    host side of ``csrc/rdb.cu:rdb_prep_weights``.

    ``weights``: per RDB, its five f32 OIHW conv kernels (the parameters,
    in any strides), in the network's order. The plan owns two buffers in
    ``dtype``, made once: ``kernels``, every RDB's five contiguous HWIO
    kernels, and ``images``, every RDB's five dgrad weight images
    (``dgrad_weights``' layout), packed in order (nc and gc multiples of
    32 start every block 32-byte aligned, as the kernels need). ``slots[r]``
    is RDB r's (five HWIO kernel views, image view), what ``fused_rdb``
    takes in place of casting its own (``PlannedKernels``). ``table``: a
    row of ``PREP_ROW`` int64 words a parameter (a unit): its pointer, its
    OIHW strides, the offsets of its HWIO kernel and of its RDB's images,
    and its level; ``device_table`` the same on the card (None on the CPU,
    where ``prepare`` runs the plain version). The kernel's grid is
    (``blocks``, units): a unit's 32 x 32 tiles (``tiles(k)`` at level k)
    walked with a stride of ``blocks``, at most ``PREP_TILES_PER_BLOCK``
    each. ``current`` says whether the parameters still have the addresses
    and strides the table holds.

    One preparation is live at a time: the buffers are shared by every
    forward that takes the slots, and ``_FusedRDB`` keeps views of them for
    its backward. So each ``prepare`` bumps the buffers' autograd version,
    and the backward of a forward made before the last ``prepare`` raises
    (autograd's check of an in-place change to a saved tensor) instead of
    running on another preparation's kernels and images."""

    def __init__(self, weights: Sequence[Sequence[torch.Tensor]], dtype=torch.bfloat16):
        self.weights = [tuple(ws) for ws in weights]
        if not self.weights or any(len(ws) != 5 for ws in self.weights):
            raise ValueError("rdb weight plan: takes five kernels for each of one or more RDBs")
        gc, nc = self.weights[0][0].shape[0], self.weights[0][4].shape[0]
        device = self.weights[0][0].device
        if nc % PREP_TILE or gc % PREP_TILE:
            raise ValueError(f"rdb weight plan: nc and gc must be multiples of {PREP_TILE} "
                             f"(nc {nc}, gc {gc})")
        self.nc, self.gc, self.dtype = nc, gc, dtype
        _, n_images = image_offsets(nc, gc)
        rows, spans, ker, img = [], [], 0, 0
        for r, ws in enumerate(self.weights):
            kers = []
            for k, w in enumerate(ws):
                cin, cout = nc + k * gc, gc if k < 4 else nc
                if (tuple(w.shape) != (cout, cin, 3, 3) or w.dtype != torch.float32
                        or w.device != device):
                    raise ValueError(f"rdb weight plan: RDB {r} kernel {k} must be f32 "
                                     f"({cout}, {cin}, 3, 3) on {device}, got {w.dtype} "
                                     f"{tuple(w.shape)} on {w.device}")
                rows.append([w.data_ptr(), *w.stride(), ker, img, k])
                kers.append((ker, cin, cout))
                ker += 9 * cin * cout
            spans.append((kers, img))
            img += n_images
        self.blocks = -(-max(self.tiles(k) for k in range(5)) // PREP_TILES_PER_BLOCK)
        self.table = torch.tensor(rows, dtype=torch.int64).reshape(-1, PREP_ROW)
        self.kernels = torch.empty(ker, dtype=dtype, device=device)
        self.images = torch.empty(img, dtype=dtype, device=device)
        self.slots = [(tuple(self.kernels[o:o + 9 * cin * cout].view(3, 3, cin, cout)
                             for o, cin, cout in kers), self.images[i:i + n_images])
                      for kers, i in spans]
        self.fingerprint = self._fingerprint(self.weights)
        self.device_table = self.table.to(device) if device.type == "cuda" else None

    def tiles(self, k: int) -> int:
        """The prep kernel's tiles of a level-k unit (k = 0..4)."""
        cin, cout = self.nc + k * self.gc, self.gc if k < 4 else self.nc
        return 9 * (cin // PREP_TILE) * (cout // PREP_TILE)

    @staticmethod
    def _fingerprint(weights):
        return tuple((w.data_ptr(), w.stride()) for ws in weights for w in ws)

    def current(self, weights: Sequence[Sequence[torch.Tensor]]) -> bool:
        """Whether ``weights`` are the plan's and still where it reads them."""
        return len(weights) == len(self.weights) and self._fingerprint(weights) == \
            self.fingerprint

    def prepare(self) -> None:
        """Fill ``kernels`` and ``images`` from the parameters as they are now:
        on the card one launch on the current stream, on the CPU the plain
        version (``prepare_reference``). Either bumps the buffers' autograd
        version (the launch writes through raw pointers, so here by hand)."""
        from dasr_tpu_torch.kernels import build

        if self.device_table is None:
            prepare_reference(self)
            return
        torch.autograd.graph.increment_version(self.kernels)
        torch.autograd.graph.increment_version(self.images)
        lib = build.load()
        device = self.device_table.device
        with torch.cuda.device(device):
            rc = lib.dasr_rdb_prep_weights(
                self.device_table.data_ptr(), len(self.table), self.blocks, self.nc, self.gc,
                self.kernels.data_ptr(), self.images.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
        build.check(lib, rc, "rdb weight plan")
        trace.count("rdb_prep.launches")


def prepare_reference(plan: RDBWeightPlan) -> None:
    """Plain PyTorch version of ``rdb_prep_weights``: each RDB's kernels cast
    to the plan's type as HWIO, and ``dgrad_weights`` of them, written into
    the plan's slots."""
    with torch.no_grad():
        for ws, (ks, img) in zip(plan.weights, plan.slots):
            for k, w in zip(ks, ws):
                k.copy_(w.permute(2, 3, 1, 0))
            img.copy_(torch.cat([i.flatten() for i in dgrad_weights(ks)]))


def rdb_backward_reference(x, growth, kernels, dy):
    """Plain PyTorch version of the bf16 backward: the reverse dense chain
    over the saved growth buffer. Returns (dx NHWC in x's dtype, the five
    HWIO kernel gradients and five bias gradients, f32, or f64 for an f64 x).

    dv_5 = 0.2 dY; for s = 4..1, dx_s sums the transposed convs of every
    later level's dv_k, and dv_s = dx_s times the leaky ReLU's slope, read
    from the sign of x_s and rounded to x's dtype where the kernels round
    it; dx = dY + the transposed convs into x, rounded once;
    dW_k = in_k (x) dv_k and db_k = sum dv_k, with in_k = [x, x_1..x_{k-1}]."""
    dt = x.dtype
    ct = torch.promote_types(dt, torch.float32)
    nc, gc = x.shape[-1], kernels[0].shape[-1]

    def nchw(t):
        return t.permute(0, 3, 1, 2).to(ct)

    src = [nchw(x)] + [nchw(growth[..., s * gc:(s + 1) * gc]) for s in range(4)]
    d_src = [torch.zeros_like(t) for t in src]
    weights = [k.to(dt).to(ct).permute(3, 2, 0, 1) for k in kernels]  # OIHW
    dks, dbs = [None] * 5, [None] * 5
    dv = 0.2 * nchw(dy)
    for k in range(4, -1, -1):
        if k < 4:
            dv = torch.where(src[k + 1] > 0, d_src[k + 1], 0.2 * d_src[k + 1]).to(dt).to(ct)
        dks[k] = torch.nn.grad.conv2d_weight(torch.cat(src[:k + 1], 1), weights[k].shape, dv,
                                             padding=1).permute(2, 3, 1, 0)
        dbs[k] = dv.sum((0, 2, 3))
        for s, part in enumerate(F.conv_transpose2d(dv, weights[k], padding=1)
                                 .split([nc] + [gc] * k, 1)):
            d_src[s] = d_src[s] + part
    dx = (nchw(dy) + d_src[0]).to(dt)
    return dx.permute(0, 2, 3, 1), dks, dbs


def rdb_chain(x, kernels, biases):
    """The stock dense chain in the working type, differentiable: the
    counterpart of ``dasr_tpu.ops.pallas_rdb._scatter_reference``.

    Each source (x, x_1..x_4) is convolved once with its per-source weight
    block (the concatenated input-channel slices of every later level), in
    x's dtype; the level terms are summed in f32 with the bias, and x_1..x_4
    and the output are rounded to the working type where JAX rounds them.
    x (B, H, W, nc) NHWC; kernels HWIO (cast to x's dtype); biases f32
    (cout,). This is what the f32 and CPU backward differentiates; on the
    card its convs run on cuDNN (channels_last)."""
    dt = x.dtype
    nc, gc = x.shape[-1], kernels[0].shape[-1]
    lo = [0] + [nc + s * gc for s in range(4)]
    width = [nc] + [gc] * 4

    def conv(v, s):
        w = torch.cat([kernels[j][:, :, lo[s]:lo[s] + width[s], :] for j in range(s, 5)],
                      -1).to(dt)
        w = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        return F.conv2d(v, w, padding=1).float()

    def bias(k):
        return biases[k].float().view(1, -1, 1, 1)

    src = x.permute(0, 3, 1, 2)
    terms = []  # terms[s]: the f32 conv of source s, cout of levels s..5
    for s in range(5):
        terms.append(conv(src, s))
        # level s + 1 sums the slice that each earlier source gives it
        v = sum(t[:, (s - i) * gc:(s - i) * gc + (gc if s < 4 else nc)]
                for i, t in enumerate(terms)) + bias(s)
        if s < 4:
            src = F.leaky_relu(v, 0.2).to(dt)
    out = (x.permute(0, 3, 1, 2).float() + 0.2 * v).to(dt)
    return out.permute(0, 2, 3, 1)


def _forward(x, kernels, biases):
    if x.device.type == "cpu":
        return fused_rdb_reference(x, kernels, biases)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rdb: no kernel for device {x.device}")
    return _launch(x, kernels, biases)[0]


class _FusedRDB(torch.autograd.Function):
    """``jax.custom_vjp`` of ``pallas_rdb.fused_rdb``. The kernels may come
    in any float type (RDB5C hands over its f32 parameters' HWIO views); the
    forward casts them to x's dtype itself, so autograd records no cast.

    bf16 on the card: the forward takes the bf16 kernels and dgrad weight
    images that a weight plan made for this forward (``prepared``, counted
    in ``fused_rdb.prepared``), or else casts the kernels itself
    (``fused_rdb.cast``); it keeps x, the growth buffer it filled, the
    images where it has them and the bf16 kernels, and the backward
    launches the backward kernels on them (the images first where it has
    none) and returns the kernel gradients in f32 (cast to a kernel's own
    type where that is not f32). Elsewhere, as JAX's ``_fwd`` and ``_bwd``:
    the forward keeps x and the ten weights, and the backward recomputes
    ``rdb_chain`` from them and returns its VJP."""

    @staticmethod
    def forward(ctx, x, prepared, *weights):
        kernels, biases = weights[:5], weights[5:]
        ctx.on_kernels = x.is_cuda and x.dtype == torch.bfloat16
        images = None
        if ctx.on_kernels and prepared is not None:
            kernels, images = prepared
            fused_rdb.prepared += 1
        elif x.is_cuda:
            kernels = tuple(k.contiguous() if k.dtype == x.dtype
                            else torch.empty(k.shape, dtype=x.dtype, device=k.device).copy_(k)
                            for k in kernels)
            fused_rdb.cast += int(ctx.on_kernels)
        if not ctx.on_kernels:
            ctx.save_for_backward(x, *weights)
            return _forward(x, kernels, biases)
        y, growth = _launch(x, kernels, biases)
        ctx.save_for_backward(x, growth, images, *kernels)
        ctx.kernel_dtypes = [k.dtype for k in weights[:5]]
        return y

    @staticmethod
    def backward(ctx, grad):
        # grad may arrive as a permuted view of an NCHW gradient
        grad = grad.contiguous()
        if ctx.on_kernels:
            fused_rdb.bwd_kernel += 1
            x, growth, images, *kernels = ctx.saved_tensors
            dx, dks, dbs = _launch_backward(x, growth, kernels, images, grad)
            dks = [d.to(dt) for d, dt in zip(dks, ctx.kernel_dtypes)]
            return tuple(g if need else None
                         for g, need in zip((dx, None, *dks, *dbs), ctx.needs_input_grad))
        if grad.is_cuda:
            fused_rdb.bwd_chain += 1
        needs = ctx.needs_input_grad[:1] + ctx.needs_input_grad[2:]
        leaves = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
        wanted = [t for t in leaves if t.requires_grad]
        with torch.enable_grad():
            out = rdb_chain(leaves[0], leaves[1:6], leaves[6:])
            got = iter(torch.autograd.grad(out, wanted, grad))
        grads = [next(got) if t.requires_grad else None for t in leaves]
        return (grads[0], None, *grads[1:])


def fused_rdb(x, kernels, biases):
    """One RDB5C: x (B, H, W, nc) NHWC -> (B, H, W, nc).

    ``kernels``: the five HWIO conv kernels (3, 3, nc + k gc, gc or nc) in
    x's dtype; ``biases``: their f32 (cout,) biases. A CPU tensor goes to
    ``fused_rdb_reference``. A CUDA tensor launches the kernel, once per
    level, or raises on what the kernel does not take: there is no
    fallback. When a gradient is wanted, the call goes through
    ``_FusedRDB`` (whose kernels may then be of another float type, such as
    the f32 parameters, and may carry a weight plan's prepared bf16 kernels
    and images, ``PlannedKernels``): its backward is the backward kernels at
    bf16 on the card, else the VJP of ``rdb_chain``.
    """
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *kernels, *biases)
    ):
        return _FusedRDB.apply(x, getattr(kernels, "prepared", None), *kernels, *biases)
    return _forward(x, kernels, biases)


# forward kernel launches on the card since the last reset: of either kernel,
# and of the f32 one (rdb_level_tf32x3) alone; the backward kernels'
# launches; backward calls on the card, through the kernels and through
# rdb_chain; and bf16 calls on the card under autograd that took a weight
# plan's kernels and images, or cast their own (utils/trace.py:counters
# reports all seven)
fused_rdb.launches = 0
fused_rdb.launches_f32 = 0
fused_rdb.backward_launches = 0
fused_rdb.bwd_kernel = 0
fused_rdb.bwd_chain = 0
fused_rdb.prepared = 0
fused_rdb.cast = 0


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, kernels, biases):
    if x.dim() != 4 or x.dtype not in _KERNEL_CODE:
        raise ValueError(f"fused_rdb: x must be 4-D f32 or bf16, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 32:
        raise ValueError("fused_rdb: x must be contiguous NHWC and 32-byte aligned")
    nc = x.shape[-1]
    gc = kernels[0].shape[-1]
    if len(kernels) != 5 or len(biases) != 5 or nc % 32 or gc % 32:
        raise ValueError(f"fused_rdb: takes 5 levels with nc, gc multiples of 32 (nc {nc}, gc {gc})")
    for k in range(5):
        cout = gc if k < 4 else nc
        kk, bk = kernels[k], biases[k]
        if (
            tuple(kk.shape) != (3, 3, nc + k * gc, cout)
            or kk.dtype != x.dtype
            or kk.device != x.device
            or not kk.is_contiguous()
            or kk.data_ptr() % 32
        ):
            raise ValueError(
                f"fused_rdb: kernel {k} must be contiguous HWIO "
                f"(3, 3, {nc + k * gc}, {cout}) {x.dtype} on {x.device}, got "
                f"{kk.dtype} {tuple(kk.shape)} on {kk.device}"
            )
        if (
            tuple(bk.shape) != (cout,)
            or bk.dtype != torch.float32
            or bk.device != x.device
            or not bk.is_contiguous()
        ):
            raise ValueError(f"fused_rdb: bias {k} must be contiguous f32 ({cout},) on {x.device}")


def _launch(x, kernels, biases):
    """The five level launches of one RDB on x's current stream, in one call
    into the library: level k reads x and the growth buffer and writes its
    slice of the buffer (levels 1-4) or y (level 5). Returns (y, the growth
    buffer)."""
    from dasr_tpu_torch.kernels import build

    _check(x, kernels, biases)
    lib = build.load()
    b, h, w, nc = x.shape
    gc = kernels[0].shape[-1]
    growth = torch.empty((b, h, w, 4 * gc), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    f32 = x.dtype == torch.float32
    if f32:
        kernels = getattr(kernels, "split", None) or tuple(split_weights(k) for k in kernels)
    ptrs = ctypes.c_void_p * 5
    with torch.cuda.device(x.device):
        rc = lib.dasr_rdb_forward(
            _KERNEL_CODE[x.dtype], x.data_ptr(), growth.data_ptr(),
            ptrs(*(k.data_ptr() for k in kernels)), ptrs(*(v.data_ptr() for v in biases)),
            y.data_ptr(), b, h, w, nc, gc, tile_plan(b, h, w, _sm_count(x.device.index)),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(lib, rc, "fused_rdb")
    fused_rdb.launches += LAUNCHES_PER_RDB
    fused_rdb.launches_f32 += LAUNCHES_PER_RDB if f32 else 0
    return y, growth


def launch_images(kernels):
    """The five dgrad weight images of one bf16 RDB from its forward's HWIO
    kernels (contiguous, on the card), one launch of
    ``csrc/rdb.cu:rdb_dgrad_weights`` on the current stream: what the
    backward makes where no weight plan made them (``dgrad_weights`` is the
    plain version)."""
    from dasr_tpu_torch.kernels import build

    lib = build.load()
    nc, gc = kernels[4].shape[-1], kernels[0].shape[-1]
    device = kernels[0].device
    images = torch.empty(image_offsets(nc, gc)[1], dtype=kernels[0].dtype, device=device)
    with torch.cuda.device(device):
        rc = lib.dasr_rdb_dgrad_weights((ctypes.c_void_p * 5)(*(k.data_ptr() for k in kernels)),
                                        images.data_ptr(), nc, gc,
                                        torch.cuda.current_stream(device).cuda_stream)
    build.check(lib, rc, "fused_rdb backward images")
    return images


def _launch_backward(x, growth, kernels, images, dy):
    """The bf16 backward's launches on x's current stream, from the
    forward's x, growth buffer and HWIO kernels (as ``_launch`` took them),
    the five dgrad weight images (None: made here from the kernels, one
    launch more) and the output's contiguous gradient ``dy``. Returns (dx,
    the five kernel gradients as HWIO views of their OIHW f32 buffers, the
    five f32 bias gradients)."""
    from dasr_tpu_torch.kernels import build

    lib = build.load()
    b, h, w, nc = x.shape
    gc = kernels[0].shape[-1]
    if nc not in (32, 64) or gc != 32:
        raise ValueError(f"fused_rdb: the bf16 backward takes nc 32 or 64 and gc 32 "
                         f"(nc {nc}, gc {gc})")
    if dy.data_ptr() % 32:
        dy = dy.clone()  # TMA reads from 16-byte-aligned rows
    sms = _sm_count(x.device.index)
    th, splits = wgrad_plan(b, h, w, nc, gc, sms)
    layout, total = grad_layout(nc, gc)
    dv = torch.empty_like(growth)  # the gradient growth buffer: dv_4 | dv_3 | dv_2 | dv_1
    dx = torch.empty_like(x)
    grads = torch.empty(total, dtype=torch.float32, device=x.device)
    # the plan's images were written at the forward's start: the levels may
    # read them before the previous launch finished; this call's may not
    ready = images is not None
    if not ready:
        images = launch_images(kernels)
        fused_rdb.backward_launches += IMAGE_LAUNCHES
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dasr_rdb_backward(
            x.data_ptr(), growth.data_ptr(), images.data_ptr(), int(ready), dy.data_ptr(),
            dv.data_ptr(), dx.data_ptr(), grads.data_ptr(), b, h, w, nc, gc,
            tile_plan(b, h, w, sms), th, splits, stream,
        )
    build.check(lib, rc, "fused_rdb backward")
    fused_rdb.backward_launches += BACKWARD_LAUNCHES
    dks, dbs = [], []
    for k, (w_off, b_off) in enumerate(layout):
        cin, cout = nc + k * gc, gc if k < 4 else nc
        dks.append(grads[w_off:b_off].view(cout, cin, 3, 3).permute(2, 3, 1, 0))
        dbs.append(grads[b_off:b_off + cout])
    return dx, dks, dbs
