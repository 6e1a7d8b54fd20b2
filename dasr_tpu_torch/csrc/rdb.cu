// Residual Dense Block (RDB5C) forward, and its bf16 backward, for Hopper
// (sm_90a).
//
// Replaces dasr_tpu/ops/pallas_rdb.py:_rdb_kernel (built by
// _fused_rdb_impl). The tolerances and the Python wrapper are in
// dasr_tpu_torch/ops/rdb.py, which also holds the tile plan and states both
// kernels' shared-memory plans in Python (WgmmaPlan, F32Plan). The CPU
// tests (tests/test_torch_rdb_plan.py, tests/test_torch_rdb_f32_plan.py)
// emulate the kernels' products through those statements, and
// chip_smoke.py holds them against the plans compiled here, which
// dasr_rdb_wgmma_plan and dasr_rdb_f32_plan export.
//
// One launch computes one level of the block: a 3x3 SAME conv over a
// channel prefix of [x | x1 | x2 | x3 | x4] as an implicit GEMM
// (M = output pixels, N = cout, K = 9 * cin), plus its epilogue:
//   levels 1-4: x_k = lrelu_0.2(acc + b_k), rounded to the working type and
//               written into its gc-channel slice of the growth buffer;
//   level 5:    y = x + 0.2 * (acc + b_5), rounded once.
// Level k reads channels [0, nc) from x and [0, (k-1) gc) from the growth
// buffer, so the dense concat is never materialised. Input pixels outside
// the image read as zeros, which is the SAME zero padding of every level;
// output pixels outside the image are not stored.
//
// What bounds it: arithmetic. One RDB (nc 64, gc 32) is 479,232 FLOP per
// pixel, 62.81 GFLOP at (8, 128, 128): 63.5 us at the H100's 989 TFLOP/s
// bf16 peak, against 10.2 us for the ~34 MB it must move. At f32 the least
// time is 0.381 ms: three TF32 products per f32 product at 495 TFLOP/s,
// against 0.94 ms on the CUDA cores' 67 TFLOP/s.
//
// Both kernels are wgmma kernels of one shape:
//   * A block owns a tile of 8x8-pixel sub-blocks: 16x16 pixels, two
//     warpgroups of two sub-blocks each, or, where 16x16 tiles would leave
//     more than half the 132 SMs idle, 8x8 and one warpgroup
//     (ops/rdb.py:tile_plan). Each sub-block is one 64-row wgmma tile with
//     f32 accumulators in registers (n32 for levels 1-4, n64 for level 5).
//   * K is walked in chunks of input channels x 9 taps, each staged into a
//     ring of shared-memory stages, an mbarrier a stage signalling that its
//     bytes arrived; in the bf16 kernel by a producer warp once every
//     warp's products that read the stage are done (a second mbarrier), in
//     the f32 one by the last warp done with the stage. The input window
//     (tile + 1-px halo) is a 4-D TMA box from x or the growth buffer; TMA
//     fills the out-of-image part with zeros, which is the SAME padding.
//     All nine taps read the one staged window at shifted offsets.
//   * Programmatic dependent launch: each level's blocks but the first
//     level's start (barrier set-up) on the SMs the previous level frees,
//     and wait for it to finish (griddepcontrol.wait) before they read an
//     activation. Level 1 is a plain launch, so early blocks never queue up
//     across RDBs (dasr_rdb_forward).
//   * Epilogue in registers: the four lanes of a quad exchange their
//     column pairs so that each holds 8 consecutive channels of a pixel,
//     then bias + leaky ReLU (levels 1-4) or the residual (level 5), rounded
//     once and written as 16-byte stores.
//   Left for later: fusing levels 1-4 per tile (the five-launch floor is
//   ~74 us at (8, 128, 128) in bf16), a persistent grid.
//
// bf16, rdb_level_wgmma (Plan):
//   * 16 input channels a stage (one k16 step). The window lands as
//     [row][col][16 ch], 32 bytes a pixel, in TMA's 32-byte swizzle; the
//     chunk's weight rows are a 3-D box read straight from the HWIO matrix
//     that prepare_weights makes, landing as [tap][ci][cout] in the 64- or
//     128-byte swizzle. Wide rows matter: TMA costs a few clocks per box
//     row, and boxes of 16-byte rows (8 channels, 8 columns) left this
//     kernel bound by TMA at about twice its time.
//   * Both operands come from shared memory through wgmma descriptors in
//     the same swizzles: A K-major (a row is one window pixel's 16
//     channels, so a tap's pixel shift moves the start by whole rows), B
//     MN-major (the transpose bit).
//
// f32, rdb_level_tf32x3 (F32Plan): split-TF32 products ("3xTF32"). Each f32
// operand v is split into hi = tf32(v) and lo = tf32(v - hi), both rounded
// to nearest, and each product is hi.hi + hi.lo + lo.hi, three m64nNk8 tf32
// wgmmas into one f32 accumulator set; the dropped lo.lo term and the
// split's remainders are ~2^-22 of each product, below the f32 rounding of
// a K = 1728 sum.
//   * 8 input channels a stage (one k8 step): the window lands unswizzled
//     as [row][col][8 ch], 32 bytes a pixel; the chunk's weights are one
//     bulk copy of an image that ops/rdb.py:split_weights makes once per
//     parameter version: [hi, lo][tap][cout][8 ch] f32, K-major (wgmma has
//     no transpose for 32-bit types), already split and already in the
//     32-byte swizzle wgmma reads, so one copy with no per-row cost lands it.
//   * A comes from registers (the _RS form), because it must be split:
//     each lane loads its fragment with two 8-byte loads from the window,
//     splits it, and issues hi.hi, hi.lo and lo.hi; B_hi and B_lo come from
//     shared memory through descriptors. Lane (g, t) of a warp holds
//     K-columns t and t + 4 of its rows, which it reads as the adjacent
//     channels 2t and 2t + 1: split_weights orders each 8-channel group of
//     B's K to match (F32Plan.perm), so a warp's loads are 256 contiguous
//     bytes with no bank conflict.
//   * A's registers are read by the products until they retire, so they
//     alternate between two sets, one per tap, each tap's products committed
//     as one group and one group left in flight; the next tap's A is loaded
//     while it runs.
//   * The tensor cores truncate the f32 sum of each product to f32 (on the
//     H100 a kernel that carried one accumulator over a level's 648
//     products was ~10x further from an f64 RDB than f32 adds are), so each
//     chunk's 27 products go into an accumulator that is then added into
//     the level's total with rounding f32 adds.
//   * No producer warp: registers are split over an SM's four
//     sub-partitions, and a ninth warp leaves 168 a thread (96 at two
//     blocks an SM), fewer than the sums, accumulators and fragments need.
//     Thread 0 stages the first chunks; after that the last warp done with
//     a stage (a shared counter) stages the chunk that goes there next, so
//     no warp waits for another to release a stage.
// The C entry point launches the five levels and returns
// cudaGetLastError() after each launch.
//
// Backward, bf16 (dasr_rdb_backward: six launches an RDB). It replaces
// no TPU kernel: JAX's custom VJP of the Pallas kernel is XLA's stock
// convolution chain, whose counterpart (ops/rdb.py:rdb_chain, recomputed
// and differentiated through cuDNN and ~220 ATen ops an RDB) the f32 path
// keeps. This backward reads what the forward kept, x and the growth
// buffer x_1..x_4, and recomputes nothing. With dv_k the gradient of
// level k's pre-activation (dv_5 = 0.2 dY):
//   dx_s = sum_{k > s} conv3x3^T(dv_k, W_k[., slice s]),
//   dv_s = dx_s * (x_s > 0 ? 1 : 0.2)   (s = 4 .. 1; the slope 0.2 > 0, so
//          x_s > 0 exactly where the pre-activation is: no mask is kept),
//   dx   = dY + sum_k conv3x3^T(dv_k, W_k[., slice x]),
//   dW_k[tap, ci, co] = sum_p in_k[p + tap, ci] dv_k[p, co], db_k = sum_p dv_k[p].
// What bounds it: at the train step's (12, 32, 32) one RDB's backward is
// 11.8 GFLOP and ~15 MB, ~12 us at the card's peaks, so launches and their
// set-up bound it, not the tensor cores; at (8, 128, 128) it is 126 GFLOP,
// 127 us of bf16 products. The design keeps the launches few and the
// bytes near what is read once:
//   * the five dgrad weight images, taps flipped and in/out channels
//     swapped (ops/rdb.py:dgrad_weights), the 0.2 of dv_5 folded into level
//     5's rows, so dY is read as it is: made with the forward's kernels by
//     rdb_prep_weights, once a generator forward for all its RDBs, or, for
//     a call with no weight plan, by rdb_dgrad_weights (one launch more).
//   * rdb_dgrad_wgmma (five launches): the reverse chain is the forward's
//     dense chain in reverse, with the forward's shapes: level j reads
//     [dv_5 | dv_4 | .. | dv_{5-j}], nc + j gc = 64 .. 192 channels, dY as
//     "x" and a gradient growth buffer [dv_4 | dv_3 | dv_2 | dv_1] as the
//     growth buffer, and writes gc channels into it (nc into dx at the
//     last). So it is the forward's kernel (TMA, mbarrier ring, wgmma,
//     tile_plan, PDL) on another weight image with its own epilogue: no
//     bias; the slope read from the sign of the saved x_s, or + dY for dx;
//     each output the sum of every later level's terms in one f32
//     accumulator, rounded once.
//   * rdb_wgrad (one launch): the weight and bias gradients of all five
//     levels, their pixel splits added inside the launch, below.
// Left for later: fusing the dgrad and the wgrad per tile (the wgrad reads
// back the dv_k that the dgrad has just written).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <atomic>

namespace {

struct Level {
  const void* x;      // (B, H, W, nc) block input, working type
  const void* g;      // (B, H, W, gstride) growth buffer holding x1..x4
  const void* w;      // bf16: (9 * cin, cout), rows ordered (dy, dx, ci); f32: the
                      // split image of ops/rdb.py:split_weights, (cin / 8, 2, 9, cout, 8)
  const float* bias;  // (cout,); none in the backward
  void* out;          // output pixels of out_stride elements
  int B, H, W;
  int nc, gstride, cin, cout;
  int out_stride, out_off;
  int final_level;    // 0: lrelu epilogue; 1: residual epilogue
  // the backward's levels 1-4: the forward's growth buffer, whose channel
  // act_off + n holds x_s for output channel n (the leaky ReLU's slope)
  const void* act;
  int act_off;
  // the backward's levels: 1 where the weight images were written before
  // the previous launch began (a weight plan made them), so they may be read
  // before griddepcontrol.wait
  int weights_ready;
};

// ---------------------------------------------------------------------------
// bf16 on Hopper: TMA + mbarriers + wgmma.

constexpr int kKc = 16;  // input channels per pipeline stage (one wgmma K step)
constexpr uint32_t kPrefetchBytes = 16384;  // bytes of one L2 prefetch of a level's weights

__host__ __device__ constexpr int align1024(int v) { return (v + 1023) / 1024 * 1024; }

// wgmma descriptor layout type of an operand stored in a swizzle span of
// 128, 64 or 32 bytes, the same swizzle TMA applied when it wrote it there
__host__ __device__ constexpr int swizzle_mode(int span) {
  return span == 128 ? 1 : span == 64 ? 2 : 3;
}

// Shared-memory plan of one (COUT, tile) instantiation. ops/rdb.py:WgmmaPlan
// states the same plan in Python; the CPU tests emulate the products
// through it, and chip_smoke.py holds it against this one
// (dasr_rdb_wgmma_plan). A stage is the window (pixels of kKc * 2 = 32
// bytes, TMA's 32-byte swizzle) and then the weights ([tap][ci][COUT], rows
// of 64 or 128 bytes, the swizzle of that width), each region 1024-byte
// aligned so the swizzle repeats line up.
template <int COUT, int TH, int TW>
struct Plan {
  static constexpr int kSub = (TH / 8) * (TW / 8);          // 8x8 sub-blocks
  static constexpr int kWarpgroups = kSub < 2 ? 1 : 2;      // consumers
  static constexpr int kMt = kSub / kWarpgroups;            // sub-blocks per warpgroup
  static constexpr int kThreads = 128 * kWarpgroups + 32;   // + the producer warp
  static constexpr int kWinW = TW + 2;
  static constexpr int kWinPix = (TH + 2) * (TW + 2);
  static constexpr int kPixBytes = kKc * 2;
  static constexpr int kWinBytes = align1024(kWinPix * kPixBytes);
  static constexpr int kWRowBytes = COUT * 2;
  static constexpr int kWBytes = 9 * kKc * kWRowBytes;
  static constexpr int kStageBytes = kWinBytes + kWBytes;
  static constexpr int kTxBytes = kWinPix * kPixBytes + kWBytes;
  // four stages where two blocks still fit an SM, else three
  static constexpr int kStages = 4 * kStageBytes <= 110 * 1024 ? 4 : 3;
  // stages, then the full and empty barriers, plus slack to align the base
  static constexpr int kSmemBytes = kStages * kStageBytes + 16 * kStages + 1024;
  // swizzle spans: A a window pixel's row, B a weight row
  static constexpr int kASpan = kPixBytes;
  static constexpr int kBSpan = kWRowBytes;
  static constexpr int kAMode = swizzle_mode(kASpan);
  static constexpr int kBMode = swizzle_mode(kBSpan);
  // descriptor byte offsets. A K-major: SBO the next 8 pixels, which are
  // the next window row; LBO unused. B MN-major: SBO the next 8 input
  // channels; LBO the next span-wide column group (there is one).
  static constexpr int kALbo = 16;
  static constexpr int kASbo = kWinW * kPixBytes;
  static constexpr int kBLbo = kWBytes;
  static constexpr int kBSbo = 8 * kWRowBytes;
  // Byte offset in a stage, before the swizzle, of the A operand of
  // sub-block sb at tap (dy, dx) = (tap / 3, tap % 3): its row m is output
  // pixel (8 sr + m / 8, 8 sc + m % 8) of the tile, read at window pixel
  // (8 sr + m / 8 + dy, 8 sc + m % 8 + dx).
  __host__ __device__ static constexpr int a_offset(int sb, int tap) {
    return ((8 * (sb / (TW / 8)) + tap / 3) * kWinW + 8 * (sb % (TW / 8)) + tap % 3) * kPixBytes;
  }
  // ... and of the B operand of a tap: the tap's kKc weight rows
  __host__ __device__ static constexpr int b_offset(int tap) {
    return kWinBytes + tap * kKc * kWRowBytes;
  }
  static_assert(kSub % kWarpgroups == 0, "sub-blocks split evenly");
  static_assert(kWBytes % 1024 == 0, "the stages stay 1024-byte aligned");
};

// f32 on Hopper: split-TF32 wgmma.

constexpr int kKc32 = 8;  // input channels per pipeline stage (one tf32 k8 step)

// Shared-memory plan of one (COUT, tile) instantiation of the f32 kernel.
// ops/rdb.py:F32Plan states the same plan in Python; the CPU tests emulate
// the products through it, and chip_smoke.py holds it against this one
// (dasr_rdb_f32_plan). A stage is the window (pixels of kKc32 * 4 = 32
// bytes, unswizzled: the lanes read it, not wgmma) and then the weight
// image, [hi, lo][tap][COUT][8 ch], one 32-byte row per output channel in
// the 32-byte swizzle, each region 1024-byte aligned.
template <int COUT, int TH, int TW>
struct F32Plan {
  static constexpr int kSub = (TH / 8) * (TW / 8);
  static constexpr int kWarpgroups = kSub < 2 ? 1 : 2;
  static constexpr int kMt = kSub / kWarpgroups;
  static constexpr int kThreads = 128 * kWarpgroups;  // no producer warp
  // blocks an SM holds: two, unless two warpgroups each keep two 64 x 64
  // sums and accumulators (~180 registers a thread; two blocks of eight
  // warps leave 128)
  static constexpr int kBlocks = COUT == 64 && kMt == 2 ? 1 : 2;
  static constexpr int kWinW = TW + 2;
  static constexpr int kWinPix = (TH + 2) * (TW + 2);
  static constexpr int kPixBytes = kKc32 * 4;
  static constexpr int kWinBytes = align1024(kWinPix * kPixBytes);
  static constexpr int kOpBytes = COUT * kPixBytes;  // one tap's B_hi or B_lo
  static constexpr int kWBytes = 2 * 9 * kOpBytes;
  static constexpr int kStageBytes = kWinBytes + kWBytes;
  static constexpr int kTxBytes = kWinPix * kPixBytes + kWBytes;
  // as many stages (at most four) as fit beside the barriers and the
  // alignment slack in the block's share of shared memory: 227 KB alone,
  // else half the SM's 228 KB less the 1 KB the system keeps per block
  static constexpr int kShare = (kBlocks == 1 ? 232448 : 233472 / 2 - 1024) - 1024 - 64;
  static constexpr int kStages = kShare / kStageBytes < 4 ? kShare / kStageBytes : 4;
  static constexpr int kSmemBytes = kStages * kStageBytes + 16 * kStages + 1024;
  // B K-major in the 32-byte swizzle: a row is one output channel's 8 input
  // channels; SBO the next 8 rows; LBO unused
  static constexpr int kBSpan = kPixBytes;
  static constexpr int kBMode = swizzle_mode(kBSpan);
  static constexpr int kBLbo = 16;
  static constexpr int kBSbo = 8 * kPixBytes;
  static constexpr int kARowBytes = kWinW * kPixBytes;  // one window row
  // Byte offset in a stage of sub-block sb's window pixel at tap (dy, dx):
  // its row m is output pixel (8 sr + m / 8, 8 sc + m % 8), read at window
  // pixel (8 sr + m / 8 + dy, 8 sc + m % 8 + dx). Lane (g, t) of warp w
  // reads rows 16 w + g and 16 w + g + 8, i.e. pixels (2 w, g) and
  // (2 w + 1, g) of the sub-block, 8 bytes each at channel 2t.
  __host__ __device__ static constexpr int a_offset(int sb, int tap) {
    return ((8 * (sb / (TW / 8)) + tap / 3) * kWinW + 8 * (sb % (TW / 8)) + tap % 3) * kPixBytes;
  }
  __host__ __device__ static constexpr int a_lane(int warp, int lane) {
    return 2 * warp * kARowBytes + (lane / 4) * kPixBytes + (lane % 4) * 8;
  }
  // ... and of the B operand of (hl, tap), hl 0 hi and 1 lo
  __host__ __device__ static constexpr int b_offset(int hl, int tap) {
    return kWinBytes + (9 * hl + tap) * kOpBytes;
  }
  static_assert(kSub % kWarpgroups == 0, "sub-blocks split evenly");
  static_assert(kOpBytes % 1024 == 0, "every operand starts a swizzle repeat");
  static_assert(kStages >= 2, "a ring of two stages at least");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase with this parity has completed. A barrier that never
// completes (a fault in the kernel) traps after ~10 s rather than hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A contiguous copy of `bytes` (a multiple of 16) from global to shared
// memory, completing on the barrier as the tensor loads do.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (each in 16-byte units) and the swizzle mode (see Plan). The
// hardware swizzles by absolute address, as TMA does, so a start shifted
// by whole rows (a tap's pixel shift) reads what TMA wrote.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               int swizzle) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32) = A (64 x 16, K-major) * B (16 x N, MN-major) + (accumulate
// ? D : 0), A and B bf16 in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b,
                                           int accumulate);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// v = hi + lo + r with hi and lo TF32 values (low 13 bits zero), each
// rounded to nearest, ties away (cvt.rna), and |r| <= 2^-22 |v|. v - hi is
// exact in f32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// D (64 x N, f32) = A (64 x 8, tf32, registers) * B (8 x N, tf32, K-major in
// shared memory) + (accumulate ? D : 0). Register a[i] of lane (g, t) of
// warp w holds A[16 w + g + 8 (i % 2)][t + 4 (i / 2)].
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t* a, uint64_t b,
                                           int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t* a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t* a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ float2 pick(const float2 (&v)[4], int i) {
  float2 r = v[0];
  r = i == 1 ? v[1] : r;
  r = i == 2 ? v[2] : r;
  r = i == 3 ? v[3] : r;
  return r;
}

// Within each quad, lane j holds the column pairs (8q + 2j, +1) of
// n-groups q = 0..3; afterwards it holds columns 8j .. 8j + 7 of n-group j,
// pair i in v[i]. A 4 x 4 transpose by shuffles.
__device__ __forceinline__ void quad_transpose(float2 (&v)[4], int lane) {
  const int j = lane & 3;
  float2 out[4] = {v[0], v[1], v[2], v[3]};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 send = pick(v, (j + k) & 3);
    const int src = (j - k) & 3;
    float2 got;
    got.x = __shfl_sync(0xffffffffu, send.x, (lane & ~3) | src);
    got.y = __shfl_sync(0xffffffffu, send.y, (lane & ~3) | src);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = i == src ? got : out[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = out[i];
}

// Eight consecutive channels as f32, and back in the working type, with
// 16-byte accesses.
__device__ __forceinline__ void load8(const float* p, float (&t)[8]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  const float4 v = *reinterpret_cast<const float4*>(p + 4);
  t[0] = u.x, t[1] = u.y, t[2] = u.z, t[3] = u.w, t[4] = v.x, t[5] = v.y, t[6] = v.z, t[7] = v.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&t)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 rf = __bfloat1622float2(r2[i]);
    t[2 * i] = rf.x;
    t[2 * i + 1] = rf.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&t)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(t[0], t[1], t[2], t[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(t[4], t[5], t[6], t[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&t)[8]) {
  uint4 packed;
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int i = 0; i < 4; ++i) p2[i] = __floats2bfloat162_rn(t[2 * i], t[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = packed;
}

// The level's epilogue on a consumer warpgroup's accumulators, sub-blocks
// wg * KMT .. wg * KMT + KMT - 1 of the tile at (y0, x0): accumulator
// d[4q + 2h + e] is row 16 warp + lane / 4 + 8 h, column 8q + 2 (lane % 4) + e
// (the layout of m64nNk16 bf16 and m64nNk8 tf32 alike). BWD: the
// backward's epilogue, with no bias: dx = dY + acc at the last level (dY
// in L.x), else acc times the leaky ReLU's slope at x_s (L.act).
template <typename T, int COUT, int TW, int KMT, bool BWD = false>
__device__ __forceinline__ void epilogue(const Level& L, float (&acc)[KMT][COUT / 2], int wg,
                                         int warp, int lane, int x0, int y0, int b) {
  const T* xin = static_cast<const T*>(L.x);
  const T* act = static_cast<const T*>(L.act);
  T* out = static_cast<T*>(L.out);
#pragma unroll
  for (int mt = 0; mt < KMT; ++mt) {
    const int sb = wg * KMT + mt;
    const int sr = sb / (TW / 8);
    const int sc = sb % (TW / 8);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gy = y0 + 8 * sr + 2 * warp + h;
      const int gx = x0 + 8 * sc + lane / 4;
      const bool inside = gy < L.H && gx < L.W;
      const size_t pix = static_cast<size_t>(b * L.H + gy) * L.W + gx;
#pragma unroll
      for (int set = 0; set < COUT / 32; ++set) {
        float2 v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[k] = make_float2(acc[mt][4 * (4 * set + k) + 2 * h],
                             acc[mt][4 * (4 * set + k) + 2 * h + 1]);
        }
        quad_transpose(v, lane);
        const int n0 = 8 * (4 * set + (lane & 3));
        if (!inside) continue;
        float t[8];
        if constexpr (BWD) {
          // no bias: dx = dY + acc, or acc times the slope at x_s
          float r[8];
          if (L.final_level) {
            load8(xin + pix * L.nc + n0, r);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              t[2 * i] = r[2 * i] + v[i].x;
              t[2 * i + 1] = r[2 * i + 1] + v[i].y;
            }
          } else {
            load8(act + pix * L.gstride + L.act_off + n0, r);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              t[2 * i] = r[2 * i] > 0.f ? v[i].x : 0.2f * v[i].x;
              t[2 * i + 1] = r[2 * i + 1] > 0.f ? v[i].y : 0.2f * v[i].y;
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            t[2 * i] = v[i].x + __ldg(L.bias + n0 + 2 * i);
            t[2 * i + 1] = v[i].y + __ldg(L.bias + n0 + 2 * i + 1);
          }
          if (L.final_level) {
            float r[8];
            load8(xin + pix * L.nc + n0, r);
#pragma unroll
            for (int i = 0; i < 8; ++i) t[i] = r[i] + 0.2f * t[i];
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) t[i] = t[i] >= 0.f ? t[i] : 0.2f * t[i];
          }
        }
        store8(out + pix * L.out_stride + L.out_off + n0, t);
      }
    }
  }
}

// One level on the bf16 machinery: the forward's (BWD false) or the
// backward's reverse chain (BWD true: the dgrad weight image, its epilogue).
template <int COUT, int TH, int TW, bool BWD>
__device__ __forceinline__ void wgmma_level(const CUtensorMap* tm_x, const CUtensorMap* tm_g,
                                            const CUtensorMap* tm_w, const Level& L) {
  using P = Plan<COUT, TH, TW>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full0 = base + P::kStages * P::kStageBytes;
  const uint32_t empty0 = full0 + 8 * P::kStages;

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int b = blockIdx.z;
  const int chunks = L.cin / kKc;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * P::kWarpgroups);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // The next launch on the stream (the next level) may start its blocks on
  // the SMs this grid frees; they wait for this grid to finish before they
  // touch the activations (griddepcontrol.wait below).
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int wg = threadIdx.x / 128;
  if (wg == P::kWarpgroups) {
    // producer warp: one thread keeps the ring full
    if (threadIdx.x % 32 == 0) {
      // The forward's weights were written before the first level began,
      // and so were the backward's weight images where a weight plan made
      // them (weights_ready): they are read while the previous launch may
      // still run, so a block launched early has them on the way. Images
      // that the launch just before the first backward level made
      // (rdb_dgrad_weights, where no plan made them), and x and the growth
      // buffer always, are read only once the previous launch finished.
      const bool early = !BWD || L.weights_ready;
      // The first block also brings the level's whole weight matrix into L2
      // then: a weight plan writes the weights long before, so each later
      // chunk's would otherwise come from HBM on the level's critical path
      // (on the H100, 0.05-0.07 ms of the train step's backward).
      if (early && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) {
        const char* w = static_cast<const char*>(L.w);
        const uint32_t bytes = 9u * L.cin * COUT * 2u;
        for (uint32_t off = 0; off < bytes; off += kPrefetchBytes) {
          const uint32_t n = bytes - off < kPrefetchBytes ? bytes - off : kPrefetchBytes;
          asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(w + off), "r"(n)
                       : "memory");
        }
      }
      for (int it = 0; it < chunks; ++it) {
        const int s = it % P::kStages;
        if (it >= P::kStages) mbar_wait(empty0 + 8 * s, ((it / P::kStages) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, P::kTxBytes);
        const uint32_t dst = base + s * P::kStageBytes;
        const int c0 = it * kKc;
        if (!early && it == 0) asm volatile("griddepcontrol.wait;\n" ::: "memory");
        tma_load_3d(dst + P::b_offset(0), tm_w, full, 0, c0, 0);
        if (early && it == 0) asm volatile("griddepcontrol.wait;\n" ::: "memory");
        if (c0 < L.nc) {
          tma_load_4d(dst, tm_x, full, c0, x0 - 1, y0 - 1, b);
        } else {
          tma_load_4d(dst, tm_g, full, c0 - L.nc, x0 - 1, y0 - 1, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup `wg`: sub-blocks wg * kMt .. wg * kMt + kMt - 1. The
  // accumulators are first written by the first chunk's first products
  // (accumulate = 0), so that no other instruction defines them while
  // products are in flight, which would serialise the products.
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  float acc[P::kMt][COUT / 2];

  for (int it = 0; it < chunks; ++it) {
    const int s = it % P::kStages;
    mbar_wait(full0 + 8 * s, (it / P::kStages) & 1);
    const uint32_t stage = base + s * P::kStageBytes;
#pragma unroll
    for (int mt = 0; mt < P::kMt; ++mt) fence_regs(acc[mt]);
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < P::kMt; ++mt) {
      const int sb = wg * P::kMt + mt;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint64_t a =
            wgmma_desc(stage + P::a_offset(sb, tap), P::kALbo, P::kASbo, P::kAMode);
        const uint64_t bd =
            wgmma_desc(stage + P::b_offset(tap), P::kBLbo, P::kBSbo, P::kBMode);
        wgmma_bf16<COUT>(acc[mt], a, bd, it > 0 || tap > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous chunk's products are done: release its stage
#pragma unroll
    for (int mt = 0; mt < P::kMt; ++mt) fence_regs(acc[mt]);
    if (it > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % P::kStages));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < P::kMt; ++mt) fence_regs(acc[mt]);

  epilogue<__nv_bfloat16, COUT, TW, P::kMt, BWD>(L, acc, wg, warp, lane, x0, y0, b);
}

template <int COUT, int TH, int TW>
__global__ void __launch_bounds__(Plan<COUT, TH, TW>::kThreads, 2)
    rdb_level_wgmma(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_g,
                    const __grid_constant__ CUtensorMap tm_w, Level L) {
  wgmma_level<COUT, TH, TW, false>(&tm_x, &tm_g, &tm_w, L);
}

// The backward's reverse dense chain, one level a launch (see the note at
// the top): named apart from the forward, whose device time the serving
// benchmark reads by the name rdb_level.
template <int COUT, int TH, int TW>
__global__ void __launch_bounds__(Plan<COUT, TH, TW>::kThreads, 2)
    rdb_dgrad_wgmma(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_g,
                    const __grid_constant__ CUtensorMap tm_w, Level L) {
  wgmma_level<COUT, TH, TW, true>(&tm_x, &tm_g, &tm_w, L);
}

template <int COUT, int TH, int TW>
__global__ void __launch_bounds__(F32Plan<COUT, TH, TW>::kThreads, F32Plan<COUT, TH, TW>::kBlocks)
    rdb_level_tf32x3(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_g, Level L) {
  using P = F32Plan<COUT, TH, TW>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full0 = base + P::kStages * P::kStageBytes;
  // warps done with each stage's chunk, after the full barriers
  unsigned* done = reinterpret_cast<unsigned*>(smem_raw + (full0 - raw) + 8 * P::kStages);

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int b = blockIdx.z;
  const int chunks = L.cin / kKc32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // Stage chunk `it` in stage it % kStages: the window box from x or the
  // growth buffer, and the chunk's weight image in one bulk copy.
  const CUtensorMap* map_x = &tm_x;
  const CUtensorMap* map_g = &tm_g;
  const unsigned char* wimg = static_cast<const unsigned char*>(L.w);
  auto stage_chunk = [=](int it) {
    const uint32_t full = full0 + 8 * (it % P::kStages);
    const uint32_t dst = base + (it % P::kStages) * P::kStageBytes;
    const int c0 = it * kKc32;
    mbar_expect_tx(full, P::kTxBytes);
    bulk_load(dst + P::b_offset(0, 0), wimg + static_cast<size_t>(it) * P::kWBytes, P::kWBytes,
              full);
    if (c0 < L.nc) {
      tma_load_4d(dst, map_x, full, c0, x0 - 1, y0 - 1, b);
    } else {
      tma_load_4d(dst, map_g, full, c0 - L.nc, x0 - 1, y0 - 1, b);
    }
  };
  if (threadIdx.x == 0) {
    // The weight image may have been written by the launch just before the
    // first level, so nothing is read before that launch has finished.
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    for (int it = 0; it < P::kStages && it < chunks; ++it) stage_chunk(it);
  }

  // Warpgroup `wg` owns sub-blocks wg * kMt .. wg * kMt + kMt - 1. Each tap's
  // products are one commit group; the A fragments of a group stay
  // untouched until it retires, so taps alternate between two fragment
  // sets, with one group left in flight, and the next tap's A is loaded
  // while it runs. The tensor cores' f32 accumulation truncates, and 648
  // truncating accumulations (level 5) put the sum ~10x further from the
  // exact one than f32 adds do; so a chunk's 27 products go into `acc`,
  // which is added into `total` with rounding f32 adds once they have
  // retired. Then the warp is done with the stage, and the last warp done
  // with it stages the chunk kStages on. There is no producer warp: a ninth
  // warp would take a third warp's share of one SM sub-partition's
  // registers, leaving 168 a thread (96 at two blocks an SM) where the sums,
  // accumulators and fragments need more.
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const uint32_t lane_off = P::a_lane(warp, lane);
  constexpr int kFragSets = 2;
  float total[P::kMt][COUT / 2] = {};
  float acc[P::kMt][COUT / 2];
  uint32_t frag[kFragSets][P::kMt][8];  // [set][sub-block][hi a0..a3, lo a0..a3]
  // A of a tap, two 8-byte loads a sub-block: rows g (pixel row 2 warp) and
  // g + 8 (2 warp + 1), K-columns t and t + 4, which are channels 2t and
  // 2t + 1 (F32Plan.perm)
  auto load_a = [&](float2 (&v)[P::kMt][2], uint32_t stage, int tap) {
#pragma unroll
    for (int mt = 0; mt < P::kMt; ++mt) {
      const uint32_t a = stage + P::a_offset(wg * P::kMt + mt, tap) + lane_off;
      v[mt][0] = lds_f2(a);
      v[mt][1] = lds_f2(a + P::kARowBytes);
    }
  };

  for (int it = 0; it < chunks; ++it) {
    const int s = it % P::kStages;
    mbar_wait(full0 + 8 * s, (it / P::kStages) & 1);
    const uint32_t stage = base + s * P::kStageBytes;
    float2 a_f32[P::kMt][2];  // the tap's A before its split
    load_a(a_f32, stage, 0);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      uint32_t(&f)[P::kMt][8] = frag[tap % kFragSets];
#pragma unroll
      for (int mt = 0; mt < P::kMt; ++mt) {
        split_tf32(a_f32[mt][0].x, f[mt][0], f[mt][4]);
        split_tf32(a_f32[mt][1].x, f[mt][1], f[mt][5]);
        split_tf32(a_f32[mt][0].y, f[mt][2], f[mt][6]);
        split_tf32(a_f32[mt][1].y, f[mt][3], f[mt][7]);
      }
#pragma unroll
      for (int mt = 0; mt < P::kMt; ++mt) fence_regs(acc[mt]);
      wgmma_fence();
      const uint64_t b_hi =
          wgmma_desc(stage + P::b_offset(0, tap), P::kBLbo, P::kBSbo, P::kBMode);
      const uint64_t b_lo =
          wgmma_desc(stage + P::b_offset(1, tap), P::kBLbo, P::kBSbo, P::kBMode);
#pragma unroll
      for (int mt = 0; mt < P::kMt; ++mt) {
        wgmma_tf32<COUT>(acc[mt], f[mt], b_hi, tap > 0);
        wgmma_tf32<COUT>(acc[mt], f[mt], b_lo, 1);
        wgmma_tf32<COUT>(acc[mt], f[mt] + 4, b_hi, 1);
      }
      wgmma_commit();
      if (tap < 8) {
        load_a(a_f32, stage, tap + 1);  // while the products run
        // the group of tap + 1 - kFragSets has retired: its set is free
        wgmma_wait<kFragSets - 1>();
#pragma unroll
        for (int mt = 0; mt < P::kMt; ++mt) {
          fence_regs(acc[mt]);
          fence_frag(frag[(tap + 1) % kFragSets][mt]);
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < P::kMt; ++mt) {
      fence_regs(acc[mt]);
#pragma unroll
      for (int set = 0; set < kFragSets; ++set) fence_frag(frag[set][mt]);
    }
    // the last warp done with the stage refills it (no empty barrier: no
    // thread waits for the others to be done)
    if (lane == 0 && it + P::kStages < chunks) {
      __threadfence_block();
      if (atomicAdd(done + s, 1u) == 4 * P::kWarpgroups - 1) {
        done[s] = 0;
        __threadfence_block();
        stage_chunk(it + P::kStages);
      }
    }
#pragma unroll
    for (int mt = 0; mt < P::kMt; ++mt) {
#pragma unroll
      for (int i = 0; i < COUT / 2; ++i) total[mt][i] += acc[mt][i];
    }
  }
  epilogue<float, COUT, TW, P::kMt>(L, total, wg, warp, lane, x0, y0, b);
}

// ---------------------------------------------------------------------------
// The backward's weight images and weight gradients (bf16).

// Element offset of level k's weight gradient in the backward's f32
// gradient buffer, levels in order, each its OIHW kernel (cout, cin, 3, 3)
// then its bias (cout): the parameters' own layout, so that no copy or cast
// follows. ops/rdb.py:grad_layout states the same.
__host__ __device__ inline int grad_offset(int k, int nc, int gc) {
  int off = 0;
  for (int j = 0; j < k; ++j) {
    const int cout = j < 4 ? gc : nc;
    off += (9 * (nc + j * gc) + 1) * cout;
  }
  return off;
}

// The five dgrad weight images, one thread an element (ops/rdb.py:
// dgrad_weights is the plain version). Image j (cin nc + j gc, cout gc, or
// nc at j = 4) is HWIO, as a forward kernel: its input channels are dv_5
// (nc) then dv_4 .. dv_{5-j} (gc each), the sources' order in the gradient
// growth buffer; its output channels are source s of the forward
// (x_{4-j}, or x at j = 4). Element (tap, c, o) is W_k[8 - tap][lo_s + o][co]
// for the level k and output channel co that c names, times 0.2 for k = 5.
struct Images {
  const __nv_bfloat16* w[5];  // the forward's HWIO kernels
  __nv_bfloat16* img;         // the five images, one after another
  int nc, gc;
};

__global__ void rdb_dgrad_weights(Images P) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int nc = P.nc, gc = P.gc;
  __nv_bfloat16* out = P.img + e;
  int j = 0;
  for (; j < 5; ++j) {
    const int n = 9 * (nc + j * gc) * (j < 4 ? gc : nc);
    if (e < n) break;
    e -= n;
  }
  if (j == 5) return;
  const int cin_j = nc + j * gc, cout_j = j < 4 ? gc : nc;
  const int o = e % cout_j;
  const int c = (e / cout_j) % cin_j;
  const int tap = e / (cout_j * cin_j);
  const int k = c < nc ? 4 : 3 - (c - nc) / gc;
  const int co = c < nc ? c : (c - nc) % gc;
  const int lo = j < 4 ? nc + (3 - j) * gc : 0;
  const int cin_k = nc + k * gc, cout_k = k < 4 ? gc : nc;
  float v = __bfloat162float(P.w[k][((8 - tap) * cin_k + lo + o) * cout_k + co]);
  if (k == 4) v *= 0.2f;
  *out = __float2bfloat16(v);
}

// Element offset of image j in an RDB's five dgrad weight images, which lie
// one after another as rdb_dgrad_weights writes them.
__host__ __device__ inline int image_offset(int j, int nc, int gc) {
  int off = 0;
  for (int i = 0; i < j; ++i) off += 9 * (nc + i * gc) * (i < 4 ? gc : nc);
  return off;
}

// Every RDB's weights of a network prepared at once (rdb_prep_weights; the
// host side and its plain version: ops/rdb.py:RDBWeightPlan). It replaces
// no TPU kernel: JAX casts the parameters inside the compiled step. It
// replaces, on the card, what each bf16 RDB under autograd did per call:
// five strided copies of its f32 parameters into bf16 HWIO kernels in the
// forward, and rdb_dgrad_weights in the backward, 345 + 69 launches a
// forward and backward of the x4 RRDBNet, on data that changes once a step.
// One launch at the start of the generator's forward reads each f32 weight
// once and writes both what the forward's levels read and what the reverse
// chain reads: bf16(w) into the RDB's HWIO kernel, and its one element of
// the dgrad images, bf16(0.2 * float(bf16(w))) for level 5's rows and
// bf16(w) for the others (rounded before the 0.2, as rdb_dgrad_weights
// does), so both are bit for bit the per-call path's.
// What bounds it: bytes. 4 bytes read and 2 + 2 written a weight, 132 MB
// for the 16.5M RDB weights of the x4 RRDBNet: 0.0395 ms at 3.35 TB/s.
// Each weight lands in exactly one image element, so the pass is a
// permutation. The work is 32 x 32 tiles of one parameter (32 output by 32
// input channels at one tap). A block reads a tile with lanes along the
// input channel (contiguous in a channels_last OIHW parameter; any strides
// are read as the table gives them), all four loads of a thread in flight
// at once, writes the image elements in the same order (an image's output
// channel is the forward's input channel, so those writes are contiguous
// too), and writes the HWIO kernel, whose output channel is innermost, from
// the tile transposed through shared memory (two buffers, one barrier a
// tile). The grid is (blocks a parameter, parameters): a block reads its
// unit's row of the table once, with no search (a first design found each
// block's unit by bisection over a flat grid of tiles, nine dependent loads
// before any weight, and ran at 37% of the bound), and walks the unit's
// tiles with a stride of the grid, at most four each.
// The table holds a row of kPrepRow int64 words a parameter (a unit): its
// f32 pointer, its OIHW strides (o, i, h, w), the offset of its HWIO kernel
// in the kernel buffer, the offset of its RDB's images in the image buffer,
// and its level. The launch is a plain one, and the kernel does not trigger
// its dependents early: the level kernels read their weights before
// griddepcontrol.wait, so they must start after it has finished.
constexpr int kPrepTile = 32;  // a tile's output and input channels
constexpr int kPrepRows = 8;   // thread rows of a block: 4 elements a thread
constexpr int kPrepRow = 8;    // int64 words of a unit

__global__ void __launch_bounds__(kPrepTile * kPrepRows)
    rdb_prep_weights(const int64_t* __restrict__ table, int nc, int gc,
                     __nv_bfloat16* __restrict__ kernels, __nv_bfloat16* __restrict__ images) {
  constexpr int kPer = kPrepTile / kPrepRows;
  __shared__ float tile[2][kPrepTile][kPrepTile + 1];
  const int64_t* u = table + static_cast<int64_t>(blockIdx.y) * kPrepRow;
  const float* src = reinterpret_cast<const float*>(u[0]);
  const int64_t so = u[1], si = u[2], sh = u[3], sw = u[4], ker_off = u[5], img_off = u[6];
  const int k = static_cast<int>(u[7]);
  const int cin = nc + k * gc, cout = k < 4 ? gc : nc;
  const int in_blocks = cin / kPrepTile;
  const int tiles = 9 * in_blocks * (cout / kPrepTile);
  // the images' rows that level k + 1's output channels feed: level 5's are
  // rows 0.., level k + 1 < 5's rows nc + (3 - k) gc..
  const int row0 = k == 4 ? 0 : nc + (3 - k) * gc;
  const int tx = threadIdx.x, ty = threadIdx.y;
  int buf = 0;
  // tiles in the order (output block, input block, tap), the tap innermost
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, buf ^= 1) {
    const int tap = t % 9;
    const int ci0 = t / 9 % in_blocks * kPrepTile;
    const int co0 = t / 9 / in_blocks * kPrepTile;
    const float* in = src + (tap / 3) * sh + (tap % 3) * sw + (ci0 + tx) * si;
    float v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = __ldg(in + (co0 + ty + i * kPrepRows) * so);
    // The image of the source that input channels ci0.. read (x, or x_s):
    // image j = 4 - s, whose output channel is the source's channel ci -
    // src_lo, whose input channel is row0 + the output channel, and whose
    // tap is 8 - tap.
    const int s = ci0 < nc ? 0 : 1 + (ci0 - nc) / gc;
    const int j = 4 - s;
    const int cin_j = nc + j * gc, cout_j = j < 4 ? gc : nc;
    const int src_lo = s == 0 ? 0 : nc + (s - 1) * gc;
    __nv_bfloat16* img = images + img_off + image_offset(j, nc, gc) +
                         static_cast<int64_t>((8 - tap) * cin_j + row0 + co0) * cout_j +
                         ci0 - src_lo + tx;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + i * kPrepRows;
      const __nv_bfloat16 b = __float2bfloat16(v[i]);
      const float f = __bfloat162float(b);
      tile[buf][r][tx] = f;
      img[static_cast<int64_t>(r) * cout_j] = k == 4 ? __float2bfloat16(0.2f * f) : b;
    }
    __syncthreads();
    __nv_bfloat16* out = kernels + ker_off + static_cast<int64_t>(tap * cin + ci0) * cout + co0 + tx;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + i * kPrepRows;
      out[static_cast<int64_t>(r) * cout] = __float2bfloat16(tile[buf][tx][r]);
    }
  }
}

// The weight and bias gradients of all five levels: one launch,
// rdb_wgrad. dW_k[tap, ci, co] = sum over output pixels p of
// in_k[p + tap, ci] dv_k[p, co]: per tap a product of M = output channels by
// N = input channels by K = pixels. db_k = sum_p dv_k[p].
//
// What bounds it: operations, the forward's 479,232 FLOP a pixel, 5.89
// GFLOP at the train step's (12, 32, 32): 6.0 us at 989 TFLOP/s, against
// ~10 MB that must be read (x, the growth buffer, dY and the gradient growth
// buffer once), 3 us at 3.35 TB/s. The first design (mma.sync on 32 x 32
// channel blocks of 8x8 tiles, ten pixel splits, a second launch to add
// them) ran at 10% of the bound: its epilogue wrote every block's partial
// sums as scattered 4-byte stores (~0.026 ms whatever the shape), its
// producer warp summed the bias, and mma.sync itself issues at about a third
// of the tensor cores' rate on the H100 (a 16 x 16-tile redesign on mma.sync
// took as long with its operands from registers as from shared memory).
// Staging is the next limit: every block's tiles come from L2, which gave
// ~6 TB/s in all, so the bytes staged a product matter as much as the
// products (a design with one tap row a block staged each dv tile 24 times
// a pixel, ~80 MB an RDB at (12, 32, 32), and spent as long staging as
// multiplying).
//
// Design: wgmma with both operands MN-major in shared memory.
//   * M = 64 output channels of one "dv group": level 5's dY (nc channels),
//     or the adjacent pairs [dv_4 | dv_3] and [dv_2 | dv_1] of the gradient
//     growth buffer (gc = 32 each), so levels 1-4 reach wgmma's 64 rows two
//     at a time. A block owns one unit (ops/rdb.py:wgrad_units): a dv group
//     and a chunk of N = 32 input channels of the widest of its levels,
//     from x or from the growth buffer (rows of a level that does not read
//     the chunk are computed and not written: two of the 14 units, half of
//     theirs), and all nine taps: three consumer warpgroups, one a tap row
//     dy, each keeping its three taps' 64 x 32 sums in registers.
//   * A producer warp stages 16 x th tiles (th 16 or 8, ops/rdb.py:
//     wgrad_plan) into a ring of four stages: the tile's 64 dv channels and
//     the window (tile + 1-px halo, 32 channels, zeros outside the image by
//     TMA), 53 KB a 16 x 16 tile for 9 x 64 x 32 x 256 products, ~35 MB an
//     RDB at (12, 32, 32). A k16 step is one tile row of 16 pixels. Both
//     operands are pixel-major, so both are MN-major (K over pixels), which
//     wgmma takes for bf16 through the transpose bits: A, the dv tile, in
//     TMA's 128-byte swizzle; B, the window shifted by the tap, in the
//     64-byte swizzle through a descriptor whose start moves by whole pixel
//     rows (the swizzle is of the absolute address, as TMA wrote it). A
//     stage's 48 products a warpgroup are one commit group, one group left
//     in flight. wgmma and not mma.sync: mma.sync issued at about a third of
//     the tensor cores' rate here; A from registers (ldmatrix, reused by a
//     row's three taps) measured 2-4% slower than from shared memory.
//   * Pixel splits: the unit's tiles are cut into `splits` contiguous
//     ranges, one a block of a thread-block cluster. Each block writes its
//     sums into its own shared memory, in the gradient's order; after a
//     cluster barrier block r adds the r-th slice of every block's sums
//     over distributed shared memory in rank order 0, 1, .., applies level
//     5's 0.2 (dv_5 = 0.2 dY is read as dY), and writes them 16 bytes at a
//     time in the parameters' OIHW layout. No partial buffer, no second
//     launch, no atomics: two runs give the same bits.
//   * The bias in the consumers: while a stage's products run, the threads
//     add its dv (f32 adds in a fixed order, then across threads in order);
//     every block does (a branch among the products would serialise them),
//     and each group's first unit writes it.
// It replaces no TPU kernel (JAX's custom VJP is XLA's stock chain).

constexpr int kWTw = 16;         // tile columns
constexpr int kWThMax = 16;      // tile rows: 16 or 8 (ops/rdb.py:wgrad_plan)
constexpr int kWN = 32;          // input channels of a unit (wgmma's N)
constexpr int kWRows = 3;        // consumer warpgroups: tap rows
constexpr int kWThreads = 128 * kWRows + 32;  // and the producer warp
constexpr int kWStages = 4;
constexpr int kWMaxSplits = 8;   // blocks of a cluster, the portable most
constexpr int kWDvBytes = kWThMax * kWTw * 128;  // 64 dv channels
constexpr int kWStageBytes = kWDvBytes + align1024((kWThMax + 2) * (kWTw + 2) * kWN * 2);
constexpr int kWSmemBytes = kWStages * kWStageBytes + 16 * kWStages + 1024;

struct Wgrad {
  float* grads;  // laid out as grad_offset
  int B, nc, gc;
  int th, tiles_x, tiles_y, splits;
};

// Unit u of the weight gradient (ops/rdb.py:wgrad_units, in the same
// order): its dv group (0: level 5; 1: levels 4 and 3; 2: levels 2 and 1)
// and its first input channel c0 (a level's numbering: x, then x_1, ..),
// kWN of them. Per group, x's channels and then the growth buffer's up to
// the widest input of its levels. Returns the number of units where u is
// past the last.
__host__ __device__ inline int wgrad_unit(int u, int nc, int gc, int* grp, int* c0) {
  int count = 0;
  for (int g = 0; g < 3; ++g) {
    const int cin = nc + (g == 0 ? 4 : g == 1 ? 3 : 1) * gc;
    for (int c = 0; c < cin; c += kWN, ++count) {
      if (count == u) {
        *grp = g, *c0 = c;
        return -1;
      }
    }
  }
  return count;
}

// The level (0-based) whose output channel row `row` of dv group grp is,
// and that channel; -1 for a row past level 5's nc.
__host__ __device__ inline int wgrad_row_level(int grp, int row, int nc, int gc, int* co) {
  if (grp == 0) {
    *co = row;
    return row < nc ? 4 : -1;
  }
  *co = row % gc;
  return (grp == 1 ? 3 : 1) - row / gc;
}

// The byte at `byte` of a region of 128-byte rows, as TMA's 128-byte
// swizzle lays it out in a 1024-byte-aligned region.
__device__ __forceinline__ uint32_t swz128(uint32_t byte) {
  return byte ^ (((byte >> 7) & 7) << 4);
}

// D (64 x 32, f32) += A (64 x 16) * B (16 x 32), both bf16, MN-major in
// shared memory (the transpose bits).
__device__ __forceinline__ void wgmma_bf16_mn32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: the writes to shared memory
// before it are seen by the reads of any block after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared-memory address of block `rank` of the cluster that `addr` has
// in this block.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// One block: unit (grp, c0), all nine taps, its split's tiles through the
// ring, then the cluster's sum of its slice.
__device__ __forceinline__ void wgrad_block(const CUtensorMap* tm_win, int win_c,
                                            const CUtensorMap* tm_dv, int dv_c, const Wgrad& P,
                                            int grp, int c0) {
  constexpr int kBRow = kWN * 2;  // bytes of a window pixel
  constexpr int kBMode = swizzle_mode(kBRow);
  constexpr int kWinW = kWTw + 2;
  constexpr int kAcc = kWN / 2;  // accumulators a thread a tap
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full0 = base + kWStages * kWStageBytes;
  const uint32_t empty0 = full0 + 8 * kWStages;
  const int th = P.th;
  const int dv_bytes = th * kWTw * 128;  // the window's offset in a stage
  const uint32_t tx_bytes = dv_bytes + (th + 2) * kWinW * kBRow;
  const bool bias = c0 == 0;  // a group's first unit sums its bias

  const int rank = static_cast<int>(cluster_rank());
  const int tiles = P.B * P.tiles_y * P.tiles_x;
  const int t0 = static_cast<int>(static_cast<long long>(tiles) * rank / P.splits);
  const int n = static_cast<int>(static_cast<long long>(tiles) * (rank + 1) / P.splits) - t0;
  const int wg = threadIdx.x / 128;  // tap row of a consumer warpgroup; kWRows: the producer
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * kWRows);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // dv_1 .. dv_4 come from the launches just before; nothing is read, and
  // nothing written, before they have finished
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // acc[dx][4 q + 2 h + e]: output row 16 warp + lane / 4 + 8 h of the
  // group, input channel c0 + 8 q + 2 (lane % 4) + e, at tap (wg, dx)
  float acc[3][kAcc];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[dx][i] = 0.f;
  }
  float bsum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // see the consumers
  if (wg == kWRows) {
    // producer: lane 0 stages tile `it` once the consumers are done with
    // tile it - kWStages in its stage
    if (lane == 0) {
      for (int it = 0; it < n; ++it) {
        const int s = it % kWStages;
        if (it >= kWStages) mbar_wait(empty0 + 8 * s, ((it / kWStages) - 1) & 1);
        const uint32_t stage = base + s * kWStageBytes;
        const uint32_t full = full0 + 8 * s;
        const int t = t0 + it;
        const int tx = t % P.tiles_x;
        const int ty = (t / P.tiles_x) % P.tiles_y;
        const int b = t / (P.tiles_x * P.tiles_y);
        mbar_expect_tx(full, tx_bytes);
        tma_load_4d(stage, tm_dv, full, dv_c, kWTw * tx, th * ty, b);
        tma_load_4d(stage + dv_bytes, tm_win, full, win_c, kWTw * tx - 1, th * ty - 1, b);
      }
    }
  } else {
    // consumer warpgroup wg, tap row wg. A k16 step is one tile row kk of
    // 16 pixels: A is the dv group's 64 channels by those pixels (MN-major,
    // whole 128-byte pixel rows, SBO the next 8 pixels), B tap (wg, dx)'s
    // window from window pixel (kk + wg, dx), its start moved by whole
    // 64-byte pixel rows. A stage's 48 products are one commit group, one
    // group left in flight. While they run, the threads add the stage's dv
    // into bsum: thread t takes channels 8 (t % 8) .. + 7 of pixels t / 8,
    // t / 8 + 48, .. (every block does, so no branch sits among the
    // products; the bias blocks write it).
    const int c8 = threadIdx.x % 8;
    for (int it = 0; it < n; ++it) {
      const int s = it % kWStages;
      mbar_wait(full0 + 8 * s, (it / kWStages) & 1);
      const uint32_t dv = base + s * kWStageBytes;
      const uint32_t win = dv + dv_bytes;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) fence_regs(acc[dx]);
      wgmma_fence();
      for (int kk = 0; kk < th; ++kk) {
        const uint64_t a = wgmma_desc(dv + kk * kWTw * 128, 16, 1024, swizzle_mode(128));
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const uint64_t b =
              wgmma_desc(win + ((kk + wg) * kWinW + dx) * kBRow, 16, 8 * kBRow, kBMode);
          wgmma_bf16_mn32(acc[dx], a, b);
        }
      }
      wgmma_commit();
      for (int p = threadIdx.x / 8; p < th * kWTw; p += 128 * kWRows / 8) {
        uint32_t v[4];
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                     : "r"(dv + swz128(p * 128 + c8 * 16)));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v[j]));
          bsum[2 * j] += f.x;
          bsum[2 * j + 1] += f.y;
        }
      }
      wgmma_wait<1>();  // the previous stage's products are done: release it
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) fence_regs(acc[dx]);
      if (it > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kWStages));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) fence_regs(acc[dx]);
  }

  // Every staged tile was waited on and every product has retired: the ring
  // becomes the block's sums, [row][kWN][tap] (each row's kWN x 9 floats in
  // the order of the OIHW gradient, so they are written contiguously), rows
  // kRowPitch floats apart (4 more than a row: the eight rows a warp writes
  // fall on other banks), then the bias rows [64], then the consumers' bias
  // sums [thread / 8][64].
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw + (base - raw));
  constexpr int kRow = kWN * 9;
  constexpr int kRowPitch = kRow + 4;
  constexpr int kSums = 64 * kRowPitch;
  float* brow = red + kSums;
  if (wg < kWRows) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int rw = 16 * warp + lane / 4 + 8 * (i / 2 % 2);
        const int col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        red[rw * kRowPitch + col * 9 + 3 * wg + dx] = acc[dx][i];
      }
    }
    if (bias) {
      float* part = brow + 64 + threadIdx.x / 8 * 64 + 8 * (threadIdx.x % 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) part[j] = bsum[j];
    }
  }
  if (bias) {
    __syncthreads();
    if (threadIdx.x < 64) {
      float v = brow[64 + threadIdx.x];
      for (int t = 1; t < 128 * kWRows / 8; ++t) v += brow[64 + t * 64 + threadIdx.x];
      brow[threadIdx.x] = v;
    }
  }
  cluster_sync();

  // This block's slice of the unit's sums, 16 bytes at a time, each the
  // splits' sums added in rank order; a thread takes two of them a round,
  // all its loads in flight at once. A row's kWN x 9 floats are one
  // contiguous run of the gradient.
  const int splits = P.splits;
  constexpr int kQuads = 64 * kRow / 4;
  const int q0 = kQuads * rank / splits, q1 = kQuads * (rank + 1) / splits;
  for (int qd = q0 + threadIdx.x; qd < q1; qd += 2 * kWThreads) {
    float4 v[2][kWMaxSplits];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = qd + j * kWThreads;
      const int rw = e / (kRow / 4);
      const uint32_t at = base + 4u * (rw * kRowPitch) + 16u * (e - rw * (kRow / 4));
#pragma unroll
      for (int q = 0; q < kWMaxSplits; ++q) {
        if (e < q1 && q < splits) v[j][q] = ld_cluster4(map_rank(at, q));
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = qd + j * kWThreads;
      const int rw = e / (kRow / 4);
      int co;
      const int k = wgrad_row_level(grp, rw, P.nc, P.gc, &co);
      // past the slice, or a row or channels that the level does not have
      if (e >= q1 || k < 0 || c0 >= P.nc + k * P.gc) continue;
      float4 sum = v[j][0];
#pragma unroll
      for (int q = 1; q < kWMaxSplits; ++q) {
        if (q < splits) {
          sum.x += v[j][q].x, sum.y += v[j][q].y, sum.z += v[j][q].z, sum.w += v[j][q].w;
        }
      }
      const float scale = k == 4 ? 0.2f : 1.f;
      const int cin = P.nc + k * P.gc;
      float* out = P.grads + grad_offset(k, P.nc, P.gc) +
                   (static_cast<int64_t>(co) * cin + c0) * 9 + 4 * (e - rw * (kRow / 4));
      *reinterpret_cast<float4*>(out) =
          make_float4(scale * sum.x, scale * sum.y, scale * sum.z, scale * sum.w);
    }
  }
  if (bias && rank == 0 && threadIdx.x < 64) {
    int co;
    const int k = wgrad_row_level(grp, threadIdx.x, P.nc, P.gc, &co);
    if (k >= 0) {
      const int cin = P.nc + k * P.gc, cout = k < 4 ? P.gc : P.nc;
      const uint32_t at = base + 4u * (kSums + threadIdx.x);
      float v = ld_cluster(map_rank(at, 0));
      for (int q = 1; q < splits; ++q) v += ld_cluster(map_rank(at, q));
      P.grads[grad_offset(k, P.nc, P.gc) + 9 * cin * cout + co] = (k == 4 ? 0.2f : 1.f) * v;
    }
  }
  // no block leaves while another may still read its shared memory
  cluster_sync();
}

// Grid (units, splits), clusters of (1, splits): blockIdx.x is the unit, the
// block's rank in its cluster its split. The window maps have boxes of kWN
// channels over (th + 2) x 18 pixels, the dv maps boxes of 64 channels over
// th x 16 (dY's past nc, at nc 32, read as zeros).
__global__ void __launch_bounds__(kWThreads, 1)
    rdb_wgrad(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_g,
              const __grid_constant__ CUtensorMap tm_dy, const __grid_constant__ CUtensorMap tm_gg,
              Wgrad P) {
  int grp = 0, c0 = 0;
  wgrad_unit(blockIdx.x, P.nc, P.gc, &grp, &c0);
  const bool from_x = c0 < P.nc;
  wgrad_block(from_x ? &tm_x : &tm_g, from_x ? c0 : c0 - P.nc, grp == 0 ? &tm_dy : &tm_gg,
              grp == 0 ? 0 : (grp - 1) * 2 * P.gc, P, grp, c0);
}

// ---------------------------------------------------------------------------
// host side

// Above 48 KB a block's shared memory must be asked for. The setting is
// made once per device (bit `dev` of `done`) and kernel rather than on
// every launch.
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// cuTensorMapEncodeTiled from libcuda, which the process has loaded, so
// the library links against the runtime only.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A bf16 or f32 tensor map, zero fill outside the tensor. dims and box
// innermost first; strides in bytes of dims 1.. .
bool encode(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
            CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Maps of x and the growth buffer as (C, W, H, B) of `e`-byte elements,
// boxes of kc channels over a th x tw tile's window.
bool window_maps(CUtensorMap* tm_x, CUtensorMap* tm_g, const Level& L, CUtensorMapDataType type,
                 cuuint64_t e, cuuint32_t kc, int th, int tw, CUtensorMapSwizzle swizzle) {
  const cuuint32_t box[4] = {kc, cuuint32_t(tw + 2), cuuint32_t(th + 2), 1};
  const cuuint64_t x_dims[4] = {cuuint64_t(L.nc), cuuint64_t(L.W), cuuint64_t(L.H), cuuint64_t(L.B)};
  const cuuint64_t x_strides[3] = {L.nc * e, L.W * L.nc * e, cuuint64_t(L.H) * L.W * L.nc * e};
  const cuuint64_t g_dims[4] = {cuuint64_t(L.gstride), cuuint64_t(L.W), cuuint64_t(L.H),
                                cuuint64_t(L.B)};
  const cuuint64_t g_strides[3] = {L.gstride * e, L.W * L.gstride * e,
                                   cuuint64_t(L.H) * L.W * L.gstride * e};
  return encode(tm_x, type, 4, L.x, x_dims, x_strides, box, swizzle) &&
         encode(tm_g, type, 4, L.g, g_dims, g_strides, box, swizzle);
}

// Launch with programmatic dependent launch where `chained`: the grid may
// start while the previous launch on the stream finishes, see griddepcontrol
// in the kernels; else a plain launch, after it.
template <typename Kernel, typename... Args>
cudaError_t launch_pdl(Kernel kernel, dim3 grid, int threads, int smem, cudaStream_t s,
                       bool chained, Args... args) {
  cudaLaunchAttribute pdl{};
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = chained ? 1 : 0;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

CUtensorMapSwizzle tma_swizzle(int span) {
  return span == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_32B;
}

template <int COUT, int TH, int TW, bool BWD>
cudaError_t launch_wgmma(const Level& L, bool chained, cudaStream_t s) {
  using P = Plan<COUT, TH, TW>;
  constexpr auto kernel = BWD ? rdb_dgrad_wgmma<COUT, TH, TW> : rdb_level_wgmma<COUT, TH, TW>;
  const cudaError_t err = allow_smem<kernel>(P::kSmemBytes);
  if (err != cudaSuccess) return err;
  // the window boxes of kKc channels; the weights as (cout, cin, 9), boxes
  // of all columns over kKc input channels and the nine taps
  CUtensorMap tm_x, tm_g, tm_w;
  const cuuint64_t e = 2;  // bytes per element
  const cuuint32_t w_box[3] = {COUT, kKc, 9};
  const cuuint64_t w_dims[3] = {cuuint64_t(COUT), cuuint64_t(L.cin), 9};
  const cuuint64_t w_strides[2] = {COUT * e, cuuint64_t(L.cin) * COUT * e};
  if (!window_maps(&tm_x, &tm_g, L, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, e, kKc, TH, TW,
                   tma_swizzle(P::kASpan)) ||
      !encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, L.w, w_dims, w_strides, w_box,
              tma_swizzle(P::kBSpan))) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((L.W + TW - 1) / TW, (L.H + TH - 1) / TH, L.B);
  return launch_pdl(kernel, grid, P::kThreads, P::kSmemBytes, s, chained, tm_x, tm_g, tm_w, L);
}

template <int COUT, bool BWD = false>
cudaError_t launch_wgmma_tile(const Level& L, int tile, bool chained, cudaStream_t s) {
  switch (tile) {
    case 0: return launch_wgmma<COUT, 8, 8, BWD>(L, chained, s);
    case 1: return launch_wgmma<COUT, 16, 16, BWD>(L, chained, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int COUT, int TH, int TW>
cudaError_t launch_tf32x3(const Level& L, cudaStream_t s) {
  using P = F32Plan<COUT, TH, TW>;
  constexpr auto kernel = rdb_level_tf32x3<COUT, TH, TW>;
  const cudaError_t err = allow_smem<kernel>(P::kSmemBytes);
  if (err != cudaSuccess) return err;
  // the window boxes of kKc32 channels, unswizzled; the weights come as one
  // bulk copy a chunk, with no tensor map
  CUtensorMap tm_x, tm_g;
  if (!window_maps(&tm_x, &tm_g, L, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, kKc32, TH, TW,
                   CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((L.W + TW - 1) / TW, (L.H + TH - 1) / TH, L.B);
  return launch_pdl(kernel, grid, P::kThreads, P::kSmemBytes, s, true, tm_x, tm_g, L);
}

template <int COUT>
cudaError_t launch_tf32x3_tile(const Level& L, int tile, cudaStream_t s) {
  switch (tile) {
    case 0: return launch_tf32x3<COUT, 8, 8>(L, s);
    case 1: return launch_tf32x3<COUT, 16, 16>(L, s);
    default: return cudaErrorInvalidValue;
  }
}

// A 4-D map of a (B, H, W, C) bf16 tensor as (C, W, H, B), boxes of
// (box_c, box_w, box_h, 1) in the swizzle of box_c * 2 bytes.
bool map_nhwc(CUtensorMap* map, const void* ptr, int B, int H, int W, int C, int box_c,
              int box_w, int box_h) {
  const cuuint64_t e = 2;
  const cuuint32_t box[4] = {cuuint32_t(box_c), cuuint32_t(box_w), cuuint32_t(box_h), 1};
  const cuuint64_t dims[4] = {cuuint64_t(C), cuuint64_t(W), cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t strides[3] = {C * e, cuuint64_t(W) * C * e, cuuint64_t(H) * W * C * e};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box,
                tma_swizzle(box_c * 2));
}

// The weight and bias gradients, one launch of rdb_wgrad into grads. x
// and g the forward's input and growth buffer, dy the output's gradient, gg
// the gradient growth buffer; th the tile's rows (16 or 8) and splits the
// blocks of a cluster (at most kWMaxSplits), from ops/rdb.py:wgrad_plan.
cudaError_t launch_wgrad(const void* x, const void* g, const void* dy, const void* gg,
                         float* grads, int B, int H, int W, int nc, int gc, int th, int splits,
                         cudaStream_t s) {
  if ((th != 8 && th != kWThMax) || splits < 1 || splits > kWMaxSplits) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_smem<rdb_wgrad>(kWSmemBytes);
  if (err != cudaSuccess) return err;
  Wgrad P{grads, B, nc, gc, th, (W + kWTw - 1) / kWTw, (H + th - 1) / th, splits};
  CUtensorMap tm_x, tm_g, tm_dy, tm_gg;
  if (!map_nhwc(&tm_x, x, B, H, W, nc, kWN, kWTw + 2, th + 2) ||
      !map_nhwc(&tm_g, g, B, H, W, 4 * gc, kWN, kWTw + 2, th + 2) ||
      !map_nhwc(&tm_dy, dy, B, H, W, nc, 64, kWTw, th) ||
      !map_nhwc(&tm_gg, gg, B, H, W, 4 * gc, 64, kWTw, th)) {
    return cudaErrorInvalidValue;
  }
  int grp, c0;
  const int units = wgrad_unit(-1, nc, gc, &grp, &c0);
  cudaLaunchAttribute attrs[2] = {};
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = 1;
  attrs[1].val.clusterDim.y = splits;
  attrs[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(units, splits);
  cfg.blockDim = dim3(kWThreads);
  cfg.dynamicSmemBytes = kWSmemBytes;
  cfg.stream = s;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, rdb_wgrad, tm_x, tm_g, tm_dy, tm_gg, P);
  return err == cudaSuccess ? cudaGetLastError() : err;
}

// Plan<COUT, TH, TW> as ints, in the order of ops/rdb.py:WgmmaPlan.vector:
// kKc, threads, stages, stage bytes, window bytes, weight bytes, bytes a
// stage expects, dynamic shared memory, A and B swizzle spans, A's LBO and
// SBO, B's LBO and SBO, B's offset at each tap, A's offset at each
// (sub-block, tap). At most n are written to out; returns how many there
// are.
template <int COUT, int TH, int TW>
int export_plan(int* out, int n) {
  using P = Plan<COUT, TH, TW>;
  int v[14 + 9 + 9 * P::kSub] = {kKc,        P::kThreads, P::kStages, P::kStageBytes,
                                 P::kWinBytes, P::kWBytes, P::kTxBytes, P::kSmemBytes,
                                 P::kASpan,  P::kBSpan,   P::kALbo,   P::kASbo,
                                 P::kBLbo,   P::kBSbo};
  int i = 14;
  for (int tap = 0; tap < 9; ++tap) v[i++] = P::b_offset(tap);
  for (int sb = 0; sb < P::kSub; ++sb) {
    for (int tap = 0; tap < 9; ++tap) v[i++] = P::a_offset(sb, tap);
  }
  for (int j = 0; j < i && j < n; ++j) out[j] = v[j];
  return i;
}

// F32Plan<COUT, TH, TW> as ints, in the order of ops/rdb.py:F32Plan.vector:
// kKc32, threads, blocks an SM, stages, stage bytes, window bytes, weight
// bytes, bytes a stage expects, dynamic shared memory, B's swizzle span,
// LBO and SBO, a window row's bytes, lane 0's and lane 31's A offset in
// warp 3, B's offset at each (hl, tap), A's offset at each (sub-block, tap).
template <int COUT, int TH, int TW>
int export_f32_plan(int* out, int n) {
  using P = F32Plan<COUT, TH, TW>;
  int v[15 + 18 + 9 * P::kSub] = {kKc32,         P::kThreads,  P::kBlocks,   P::kStages,
                                  P::kStageBytes, P::kWinBytes, P::kWBytes,   P::kTxBytes,
                                  P::kSmemBytes,  P::kBSpan,    P::kBLbo,     P::kBSbo,
                                  P::kARowBytes,  P::a_lane(3, 0), P::a_lane(3, 31)};
  int i = 15;
  for (int hl = 0; hl < 2; ++hl) {
    for (int tap = 0; tap < 9; ++tap) v[i++] = P::b_offset(hl, tap);
  }
  for (int sb = 0; sb < P::kSub; ++sb) {
    for (int tap = 0; tap < 9; ++tap) v[i++] = P::a_offset(sb, tap);
  }
  for (int j = 0; j < i && j < n; ++j) out[j] = v[j];
  return i;
}

}  // namespace

extern "C" {

// The five levels of one RDB, one launch each, in order on `stream`.
// x (B, H, W, nc); g the growth buffer (B, H, W, 4 gc); w and bias the five
// levels' weights (bf16: (9 * cin, cout); f32: ops/rdb.py:split_weights'
// images) and f32 biases; y (B, H, W, nc). kernel: 0 = float32
// (rdb_level_tf32x3), 1 = bfloat16 (rdb_level_wgmma). tile: 0 = 8x8, 1 =
// 16x16 output pixels a block, see ops/rdb.py:TILES.
// Returns a cudaError_t: cudaErrorInvalidValue for an unsupported kernel,
// width or tile, or a tensor map cuTensorMapEncodeTiled refuses; else
// cudaGetLastError() after each launch, stopping at the first that fails.
int dasr_rdb_forward(int kernel, const void* x, void* g, const void* const* w,
                     const void* const* bias, void* y, int B, int H, int W, int nc, int gc,
                     int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int k = 0; k < 5; ++k) {
    const bool final_level = k == 4;
    const int cin = nc + k * gc;
    const int cout = final_level ? nc : gc;
    Level L{x, g, w[k], static_cast<const float*>(bias[k]), final_level ? y : g, B, H, W,
            nc, 4 * gc, cin, cout, final_level ? nc : 4 * gc, final_level ? 0 : k * gc,
            final_level ? 1 : 0};
    cudaError_t err = cudaSuccess;
    if (kernel == 1 && (cout == 64 || cout == 32) && cin % kKc == 0) {
      // Level 1 is a plain launch: chained to the launch before it (the
      // previous RDB's level 5, whose dependents start as soon as it has set
      // up), early blocks queued up across RDBs and held SMs the levels still
      // running needed: at the train step's (12, 32, 32) the x4 RRDBNet's
      // forward took 3.34 ms chained and 3.01 ms so on the H100, at
      // (1, 339, 510) 22.1 ms either way.
      const bool chained = k > 0;
      err = cout == 64 ? launch_wgmma_tile<64>(L, tile, chained, s)
                       : launch_wgmma_tile<32>(L, tile, chained, s);
    } else if (kernel == 0 && (cout == 64 || cout == 32) && cin % kKc32 == 0) {
      err = cout == 64 ? launch_tf32x3_tile<64>(L, tile, s) : launch_tf32x3_tile<32>(L, tile, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// The five dgrad weight images of one bf16 RDB (into img, one after
// another) from the forward's HWIO kernels w, one launch on `stream`: the
// backward's first launch where no weight plan made them
// (dasr_rdb_prep_weights). Takes nc and gc as dasr_rdb_backward does;
// returns a cudaError_t.
int dasr_rdb_dgrad_weights(const void* const* w, void* img, int nc, int gc, void* stream) {
  if ((nc != 32 && nc != 64) || gc != 32) return static_cast<int>(cudaErrorInvalidValue);
  Images images{{}, static_cast<__nv_bfloat16*>(img), nc, gc};
  for (int k = 0; k < 5; ++k) images.w[k] = static_cast<const __nv_bfloat16*>(w[k]);
  const int elems = image_offset(5, nc, gc);
  rdb_dgrad_weights<<<(elems + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(images);
  return static_cast<int>(cudaGetLastError());
}

// The backward of one bf16 RDB, six launches in order on `stream`: the
// reverse chain's five levels (dv_4 .. dv_1 into the gradient growth buffer
// gg, (B, H, W, 4 gc), then dx, (B, H, W, nc)), and the weight gradients
// (rdb_wgrad, into grads, laid out as grad_offset). x, g: the forward's
// input and growth buffer; img the five dgrad weight images, made by
// dasr_rdb_prep_weights before the previous launch began (img_ready 1) or by
// dasr_rdb_dgrad_weights as the previous launch (img_ready 0); dy the
// output's gradient, (B, H, W, nc). tile as in dasr_rdb_forward; wgrad_th
// and splits the weight gradient's tile rows and blocks of a cluster
// (ops/rdb.py:wgrad_plan). Takes nc 32 or 64 and gc 32; returns a
// cudaError_t as dasr_rdb_forward does.
int dasr_rdb_backward(const void* x, const void* g, const void* img, int img_ready,
                      const void* dy, void* gg, void* dx, void* grads, int B, int H, int W,
                      int nc, int gc, int tile, int wgrad_th, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((nc != 32 && nc != 64) || gc != 32) return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* level_img = static_cast<const __nv_bfloat16*>(img);
  for (int k = 0; k < 5; ++k) {
    const bool final_level = k == 4;
    const int cin = nc + k * gc;
    const int cout = final_level ? nc : gc;
    Level L{dy, gg, level_img, nullptr, final_level ? dx : gg, B, H, W,
            nc, 4 * gc, cin, cout, final_level ? nc : 4 * gc, final_level ? 0 : k * gc,
            final_level ? 1 : 0, g, (3 - k) * gc, img_ready};
    level_img += 9 * cin * cout;
    cudaError_t err = cout == 64 ? launch_wgmma_tile<64, true>(L, tile, true, s)
                                 : launch_wgmma_tile<32, true>(L, tile, true, s);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(launch_wgrad(x, g, dy, gg, static_cast<float*>(grads), B, H, W, nc,
                                       gc, wgrad_th, splits, s));
}

// The weight gradient's units for nc and gc as (dv group, first input
// channel), in the order of ops/rdb.py:wgrad_units. At most n ints are
// written to out; returns how many there are.
int dasr_rdb_wgrad_units(int nc, int gc, int* out, int n) {
  int grp, c0, i = 0;
  const int units = wgrad_unit(-1, nc, gc, &grp, &c0);
  for (int u = 0; u < units; ++u, i += 2) {
    wgrad_unit(u, nc, gc, &grp, &c0);
    if (i + 1 < n) out[i] = grp, out[i + 1] = c0;
  }
  return i;
}

// Every bf16 RDB's weights of a network, one launch on `stream`
// (rdb_prep_weights): table the plan's units (kPrepRow int64 words each),
// blocks the blocks a unit, kernels and images the plan's buffers. Takes nc
// and gc multiples of 32; returns a cudaError_t.
int dasr_rdb_prep_weights(const void* table, int units, int blocks, int nc, int gc,
                          void* kernels, void* images, void* stream) {
  if (units < 1 || units > 65535 || blocks < 1 || nc % kPrepTile || gc % kPrepTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rdb_prep_weights<<<dim3(blocks, units), dim3(kPrepTile, kPrepRows), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table), nc, gc, static_cast<__nv_bfloat16*>(kernels),
      static_cast<__nv_bfloat16*>(images));
  return static_cast<int>(cudaGetLastError());
}

// The bf16 kernel's shared-memory plan for cout (32 or 64) and tile (as in
// dasr_rdb_forward), see export_plan; -1 for another cout or tile.
int dasr_rdb_wgmma_plan(int cout, int tile, int* out, int n) {
  if (cout == 32 && tile == 0) return export_plan<32, 8, 8>(out, n);
  if (cout == 32 && tile == 1) return export_plan<32, 16, 16>(out, n);
  if (cout == 64 && tile == 0) return export_plan<64, 8, 8>(out, n);
  if (cout == 64 && tile == 1) return export_plan<64, 16, 16>(out, n);
  return -1;
}

// The f32 kernel's shared-memory plan for cout (32 or 64) and tile, see
// export_f32_plan; -1 for another cout or tile.
int dasr_rdb_f32_plan(int cout, int tile, int* out, int n) {
  if (cout == 32 && tile == 0) return export_f32_plan<32, 8, 8>(out, n);
  if (cout == 32 && tile == 1) return export_f32_plan<32, 16, 16>(out, n);
  if (cout == 64 && tile == 0) return export_f32_plan<64, 8, 8>(out, n);
  if (cout == 64 && tile == 1) return export_f32_plan<64, 16, 16>(out, n);
  return -1;
}

const char* dasr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
