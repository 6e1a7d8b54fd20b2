// Residual Dense Block (RDB5C) forward for Hopper (sm_90a).
//
// Replaces dasr_tpu/ops/pallas_rdb.py:_rdb_kernel (built by
// _fused_rdb_impl). The design note, the tolerances and the Python wrapper
// are in dasr_tpu_torch/ops/rdb.py.
//
// One launch computes one level of the block: a 3x3 SAME conv over a
// channel prefix of [x | x1 | x2 | x3 | x4] as an implicit GEMM
// (M = output pixels, N = cout, K = 9 * cin), plus its epilogue:
//   levels 1-4: x_k = lrelu_0.2(acc + b_k), rounded to the working type and
//               written into its gc-channel slice of the growth buffer;
//   level 5:    y = x + 0.2 * (acc + b_5), rounded once.
// Level k reads channels [0, nc) from x and [0, (k-1) gc) from the growth
// buffer, so the dense concat is never materialised. Input pixels outside
// the image are staged as zeros, which is the SAME zero padding of every
// level; output pixels outside the image are not stored.
//
// A block owns a tile of output pixels, 16 wide, and walks the input
// channels in chunks of 32: it stages the chunk's input window (the tile
// plus a 1-pixel halo) in shared memory and accumulates all nine taps in
// f32.
//   bf16: tensor cores through WMMA (16x16x16 bf16 -> f32). A 16 x 16 tile;
//         each of the eight warps owns two output rows (two 16-row A
//         fragments) against all cout columns, so every weight fragment it
//         loads feeds two products. The window is double-buffered: cp.async
//         stages chunk c + 1 while chunk c is multiplied.
//   f32:  CUDA cores (full f32, no TF32). An 8 x 16 tile; each thread owns
//         a few pixels times 8 output channels.
// The C entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTileW = 16;
constexpr int kHaloW = kTileW + 2;
constexpr int kChunk = 32;     // input channels staged per step
constexpr int kThreads = 256;  // 8 warps

// tensor-core path
constexpr int kTcTileH = 16;
constexpr int kTcHaloPix = (kTcTileH + 2) * kHaloW;
// staged pixel stride in elements: 32 channels + 16 unused, 96 bytes, which
// keeps WMMA's 32-byte pointer alignment and makes the A-fragment loads
// 2-way rather than 4-way bank conflicted
constexpr int kTcPixStride = 48;

// dynamic shared memory of the tensor-core kernel: two staged windows and
// the per-warp f32 epilogue staging
constexpr int kTcWindowBytes = kTcHaloPix * kTcPixStride * 2;
constexpr int kTcStageBytes = (kThreads / 32) * 2 * 16 * 16 * 4;
constexpr int kTcSmemBytes = 2 * kTcWindowBytes + kTcStageBytes;

// CUDA-core path
constexpr int kSimtTileH = 8;
constexpr int kSimtHaloPix = (kSimtTileH + 2) * kHaloW;

struct Level {
  const void* x;      // (B, H, W, nc) block input, working type
  const void* g;      // (B, H, W, gstride) growth buffer holding x1..x4
  const void* w;      // (9 * cin, cout) working type, rows ordered (dy, dx, ci)
  const float* bias;  // (cout,)
  void* out;          // output pixels of out_stride elements
  int B, H, W;
  int nc, gstride, cin, cout;
  int out_stride, out_off;
  int final_level;    // 0: lrelu epilogue; 1: residual epilogue
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16-byte global -> shared copy that does not wait; `valid` false writes 16
// zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage input channels [c0, c0 + kChunk) of the (HaloPix / kHaloW, kHaloW)
// window around the tile whose first output pixel is (y0, x0). `tile` is
// pixel-major with Stride elements per pixel; pixels outside the image are 0.
// Channels below nc come from x, the others from the growth buffer.
// Async: issue cp.async copies and return; else copy through registers.
template <typename T, int HaloPix, int Stride, bool Async>
__device__ __forceinline__ void stage_window(const Level& L, int b, int y0, int x0,
                                             int c0, T* tile) {
  const bool from_x = c0 < L.nc;
  const int stride = from_x ? L.nc : L.gstride;
  const T* src = from_x ? static_cast<const T*>(L.x) + c0
                        : static_cast<const T*>(L.g) + (c0 - L.nc);
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int kVecPerPix = kChunk / kVec;
  for (int i = threadIdx.x; i < HaloPix * kVecPerPix; i += blockDim.x) {
    const int pix = i / kVecPerPix;
    const int v = i % kVecPerPix;
    const int gy = y0 + pix / kHaloW - 1;
    const int gx = x0 + pix % kHaloW - 1;
    const bool valid = gy >= 0 && gy < L.H && gx >= 0 && gx < L.W;
    const T* from =
        src + (valid ? (static_cast<size_t>(b * L.H + gy) * L.W + gx) * stride + v * kVec : 0);
    T* to = tile + pix * Stride + v * kVec;
    if constexpr (Async) {
      cp_async16(to, from, valid);
    } else {
      *reinterpret_cast<uint4*>(to) =
          valid ? *reinterpret_cast<const uint4*>(from) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_out(const Level& L, int b, int gy, int gx, int co,
                                          float acc) {
  float v = acc + L.bias[co];
  const size_t pix = static_cast<size_t>(b * L.H + gy) * L.W + gx;
  if (L.final_level) {
    const float r = to_f32(static_cast<const T*>(L.x)[pix * L.nc + co]);
    v = r + 0.2f * v;
  } else {
    v = v >= 0.f ? v : 0.2f * v;
  }
  static_cast<T*>(L.out)[pix * L.out_stride + L.out_off + co] = from_f32<T>(v);
}

// bf16 level on tensor cores. Warp w computes output rows y0 + 2w and
// y0 + 2w + 1, pixels x0 .. x0 + 15 of each (the 16 rows of one A
// fragment), against all COUT columns.
template <int COUT>
__global__ void __launch_bounds__(kThreads) rdb_level_wmma(Level L) {
  using namespace nvcuda;
  constexpr int kFrags = COUT / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* windows = reinterpret_cast<__nv_bfloat16*>(smem);  // two buffers
  float* stage = reinterpret_cast<float*>(smem + 2 * kTcWindowBytes);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTcTileH;
  const int x0 = blockIdx.x * kTileW;
  const __nv_bfloat16* wmat = static_cast<const __nv_bfloat16*>(L.w);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][kFrags];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int n = 0; n < kFrags; ++n) wmma::fill_fragment(acc[r][n], 0.0f);
  }
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a0, a1;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bw;

  const int chunks = L.cin / kChunk;
  stage_window<__nv_bfloat16, kTcHaloPix, kTcPixStride, true>(L, b, y0, x0, 0, windows);
  cp_async_commit();
  for (int ci = 0; ci < chunks; ++ci) {
    if (ci + 1 < chunks) {
      // buffer (ci + 1) & 1 was last read in iteration ci - 1, which ended
      // with a barrier
      stage_window<__nv_bfloat16, kTcHaloPix, kTcPixStride, true>(
          L, b, y0, x0, (ci + 1) * kChunk, windows + ((ci + 1) & 1) * (kTcWindowBytes / 2));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk ci is visible to every warp
    const __nv_bfloat16* tile = windows + (ci & 1) * (kTcWindowBytes / 2);
    const int c0 = ci * kChunk;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < kChunk; kk += 16) {
        // A row i = output pixel (y0 + 2 warp + r, x0 + i) at tap (dy, dx)
        const __nv_bfloat16* arow = tile + ((2 * warp + dy) * kHaloW + dx) * kTcPixStride + kk;
        wmma::load_matrix_sync(a0, arow, kTcPixStride);
        wmma::load_matrix_sync(a1, arow + kHaloW * kTcPixStride, kTcPixStride);
        const __nv_bfloat16* wrow = wmat + static_cast<size_t>(tap * L.cin + c0 + kk) * COUT;
#pragma unroll
        for (int n = 0; n < kFrags; ++n) {
          wmma::load_matrix_sync(bw, wrow + n * 16, COUT);
          wmma::mma_sync(acc[0][n], a0, bw, acc[0][n]);
          wmma::mma_sync(acc[1][n], a1, bw, acc[1][n]);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer ci & 1
  }

  // epilogue, one 16-column slice at a time through this warp's staging
  float* mine = stage + warp * 2 * 16 * 16;
#pragma unroll
  for (int n = 0; n < kFrags; ++n) {
    wmma::store_matrix_sync(mine, acc[0][n], 16, wmma::mem_row_major);
    wmma::store_matrix_sync(mine + 256, acc[1][n], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 512; e += 32) {
      const int gy = y0 + 2 * warp + e / 256;
      const int gx = x0 + (e / 16) % 16;
      if (gy < L.H && gx < L.W) store_out<__nv_bfloat16>(L, b, gy, gx, n * 16 + e % 16, mine[e]);
    }
    __syncwarp();
  }
}

// Level on CUDA cores. Thread t owns output channels [8 cg, 8 cg + 8) of
// kPix tile pixels.
template <typename T, int COUT>
__global__ void __launch_bounds__(kThreads) rdb_level_simt(Level L) {
  constexpr int kGroups = COUT / 8;
  constexpr int kPix = kSimtTileH * kTileW * kGroups / kThreads;
  __shared__ __align__(16) T tile[kSimtHaloPix * kChunk];

  const int cg = threadIdx.x % kGroups;
  const int pg = threadIdx.x / kGroups;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kSimtTileH;
  const int x0 = blockIdx.x * kTileW;
  const T* wmat = static_cast<const T*>(L.w);

  float acc[kPix][8];
  int base[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = pg * kPix + j;
    base[j] = ((p / kTileW) * kHaloW + p % kTileW) * kChunk;
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[j][q] = 0.f;
  }

  for (int c0 = 0; c0 < L.cin; c0 += kChunk) {
    __syncthreads();
    stage_window<T, kSimtHaloPix, kChunk, false>(L, b, y0, x0, c0, tile);
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * kHaloW + tap % 3) * kChunk;
      const T* wrow = wmat + static_cast<size_t>(tap * L.cin + c0) * COUT + cg * 8;
#pragma unroll 4
      for (int c = 0; c < kChunk; ++c) {
        float wv[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) wv[q] = to_f32(wrow[c * COUT + q]);
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          const float v = to_f32(tile[base[j] + toff + c]);
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[j][q] = fmaf(v, wv[q], acc[j][q]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int p = pg * kPix + j;
    const int gy = y0 + p / kTileW;
    const int gx = x0 + p % kTileW;
    if (gy < L.H && gx < L.W) {
#pragma unroll
      for (int q = 0; q < 8; ++q) store_out<T>(L, b, gy, gx, cg * 8 + q, acc[j][q]);
    }
  }
}

// Above 48 KB a block's shared memory must be asked for. The setting is
// made once per device (bit `dev` of `done`) rather than on every launch.
template <int COUT>
cudaError_t allow_wmma_smem() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(rdb_level_wmma<COUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTcSmemBytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).
// Returns a cudaError_t: cudaErrorInvalidValue for an unsupported dtype or
// cout, else cudaGetLastError() after the launch.
int dasr_rdb_level(int dtype, const void* x, const void* g, const void* w, const void* bias,
                   void* out, int B, int H, int W, int nc, int gstride, int cin, int cout,
                   int out_stride, int out_off, int final_level, void* stream) {
  Level L{x, g, w, static_cast<const float*>(bias), out, B, H, W, nc, gstride, cin, cout,
          out_stride, out_off, final_level};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile_h = dtype == 1 ? kTcTileH : kSimtTileH;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + tile_h - 1) / tile_h, B);
  if (dtype == 1 && (cout == 64 || cout == 32)) {
    const cudaError_t err = cout == 64 ? allow_wmma_smem<64>() : allow_wmma_smem<32>();
    if (err != cudaSuccess) return static_cast<int>(err);
    auto kernel = cout == 64 ? rdb_level_wmma<64> : rdb_level_wmma<32>;
    kernel<<<grid, kThreads, kTcSmemBytes, s>>>(L);
  } else if (dtype == 0 && cout == 64) {
    rdb_level_simt<float, 64><<<grid, kThreads, 0, s>>>(L);
  } else if (dtype == 0 && cout == 32) {
    rdb_level_simt<float, 32><<<grid, kThreads, 0, s>>>(L);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dasr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
