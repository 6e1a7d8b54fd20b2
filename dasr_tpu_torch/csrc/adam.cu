// Adam over all of one network's f32 tensors in one pass over memory
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package's Adam is optax, compiled by XLA.
// It replaces, on the card, torch's capturable multi-tensor Adam
// (torch.optim.Adam(capturable=True), _multi_tensor_adam), which the
// port's NetState.update called. That path makes a dozen passes over the
// state, and several of them fall back to one kernel a tensor: the two
// divisions by a list of 0-d tensors always (ATen's foreach fast path needs
// every list to share sizes and strides), and the lerp and addcmul
// wherever a gradient's strides differ from its parameter's, as the RDB
// kernels' OIHW gradients of channels_last parameters do. Over G's 702
// tensors that was ~2,800 launches a step.
//
// What bounds it on the H100: bytes. An f32 Adam step reads p, g, m and v
// and writes p, m and v, 28 bytes a parameter: 0.145 ms for dasr_srn's
// G + D (17.4M parameters) at 3.35 TB/s, a few FLOP a byte.
//
// The design (ops/adam.py states the host-side plan; the CPU tests
// emulate the index map and the update through it):
//   * One launch counts (adam_count: step += 1 for every tensor, as torch's
//     _foreach_add_ does), one launch updates (adam_update). Both read their
//     state from the device: the per-parameter step tensors, the 0-d LR
//     tensor that NetState.advance writes between replays. So a CUDA graph
//     of the update stays right on every replay.
//   * A device table, built once per plan: each tensor's p, m, v and step
//     pointers, its size and whether p, m and v take 16-byte vector
//     accesses; then the units, (tensor, chunk) pairs of kChunk elements in
//     the parameter's memory order. A block walks units with a stride of
//     the grid, so one launch fills the SMs whatever the tensor sizes.
//   * The per-call part lies in the kernel's parameters (AdamArgs, ~11 KB;
//     sm_90 with CUDA >= 12.1 takes 32 KB): each gradient's pointer and its
//     layout code, and the distinct layouts. A captured node holds its own
//     gradients' addresses; no host staging buffer exists that an eager call
//     could overwrite under a graph.
//   * Each gradient is read through its own strides. Code kSameVec: the
//     parameter's strides and 16-byte aligned, read as float4 like p, m, v;
//     kSame: the same strides, unaligned, read a float at a time; 2 + i:
//     through layout i, the index map from the parameter's memory order to
//     the gradient's offset: up to four merged dimensions, divided out with
//     precomputed multiply-shift divisors (CUTLASS's FastDivmod). For an RDB
//     kernel (a channels_last OIHW parameter, an OIHW-contiguous gradient)
//     that map is a transpose of each output channel's (cin, 9) block, at
//     most 6.9 KB, which the gather reads through L1 and L2 while p, m and v
//     stream from HBM.
//   * p, m and v are read once and written once, g read once: no
//     intermediate tensor reaches device memory.
// Numerics: the order of torch's capturable branch, every step rounded as
// IEEE f32 (explicit __f*_rn intrinsics, so contraction cannot change a
// rounding the flags would otherwise leave to the compiler):
//   m = lerp(m, g, 1 - b1)        (ATen's lerp: fma(w, g - m, m) for w < 0.5,
//                                  else fma(w - 1, g - m, g))
//   v = fma(1 - b2, g * g, b2 v)
//   step_size = 1 / ((b1^t - 1) / lr),   bc2 = sqrt(-(b2^t - 1))
//   p = p + m / (((sqrt(v) / bc2) + eps) / step_size)

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 4096;       // elements of one unit (ops/adam.py:CHUNK)
constexpr int kMaxTensors = 1024;  // tensors of the update (ops/adam.py:MAX_TENSORS)
constexpr int kMaxLayouts = 32;    // gradient layouts of the update (MAX_LAYOUTS)
constexpr int kThreads = 256;
constexpr int kSameVec = 0;
constexpr int kSame = 1;

// One row of the device table (ops/adam.py:AdamPlan.table).
struct AdamTensor {
  float* p;
  float* m;
  float* v;
  float* step;
  long long n;
  long long vec;  // p, m and v 16-byte aligned
};

// One unit of work: elements [chunk * kChunk, +kChunk) of a tensor.
struct AdamUnit {
  int tensor;
  int chunk;
};

// A gradient's offsets in the parameter's memory order: index q splits into
// (i0, i1, i2, i3) by the divisors div[0..2] (of i3, i2, i1), and the offset
// is sum_k i_k stride[k] (ops/adam.py:grad_layout, pack_layout).
struct GradLayout {
  unsigned stride[4];
  unsigned div[3];
  unsigned mul[3];
  unsigned shr[3];
};

struct AdamArgs {
  const AdamTensor* tensors;
  const AdamUnit* units;
  const float* lr;
  const float* grad[kMaxTensors];
  GradLayout layout[kMaxLayouts];
  int n_units;
  float beta1, beta2, w1, c2, eps;
  unsigned char code[kMaxTensors];
};

struct Scalars {
  float w1, b2, c2, eps, bc2, step_size;
};

__device__ __forceinline__ unsigned divmod(unsigned& q, unsigned div, unsigned mul,
                                           unsigned shr) {
  const unsigned quo = div != 1 ? __umulhi(q, mul) >> shr : q;
  const unsigned rem = q - quo * div;
  q = quo;
  return rem;
}

__device__ __forceinline__ unsigned grad_offset(const GradLayout& L, unsigned q) {
  const unsigned i3 = divmod(q, L.div[0], L.mul[0], L.shr[0]);
  const unsigned i2 = divmod(q, L.div[1], L.mul[1], L.shr[1]);
  const unsigned i1 = divmod(q, L.div[2], L.mul[2], L.shr[2]);
  return q * L.stride[0] + i1 * L.stride[1] + i2 * L.stride[2] + i3 * L.stride[3];
}

__device__ __forceinline__ float grad_at(const AdamArgs& a, int code, const float* g,
                                         unsigned q) {
  return code <= kSame ? __ldg(g + q) : __ldg(g + grad_offset(a.layout[code - 2], q));
}

__device__ __forceinline__ void adam_elem(float& p, float& m, float& v, float g,
                                          const Scalars& s) {
  const float d = __fsub_rn(g, m);
  m = s.w1 < 0.5f ? __fmaf_rn(s.w1, d, m) : __fmaf_rn(__fsub_rn(s.w1, 1.f), d, g);
  v = __fmaf_rn(s.c2, __fmul_rn(g, g), __fmul_rn(v, s.b2));
  float den = __fdiv_rn(__fsqrt_rn(v), s.bc2);
  den = __fdiv_rn(__fadd_rn(den, s.eps), s.step_size);
  p = __fadd_rn(p, __fdiv_rn(m, den));
}

__global__ void adam_count(const AdamTensor* tensors, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) *tensors[i].step = __fadd_rn(*tensors[i].step, 1.f);
}

__global__ void __launch_bounds__(kThreads) adam_update(const __grid_constant__ AdamArgs a) {
  const float lr = *a.lr;
  for (int u = blockIdx.x; u < a.n_units; u += gridDim.x) {
    const AdamUnit unit = a.units[u];
    const AdamTensor t = a.tensors[unit.tensor];
    const float* g = a.grad[unit.tensor];
    const int code = a.code[unit.tensor];
    const float step = *t.step;
    Scalars s;
    s.w1 = a.w1;
    s.b2 = a.beta2;
    s.c2 = a.c2;
    s.eps = a.eps;
    s.step_size = __fdiv_rn(1.f, __fdiv_rn(__fsub_rn(powf(a.beta1, step), 1.f), lr));
    s.bc2 = __fsqrt_rn(-__fsub_rn(powf(a.beta2, step), 1.f));
    const unsigned begin = static_cast<unsigned>(unit.chunk) * kChunk;
    const int len = static_cast<int>(min(static_cast<long long>(kChunk), t.n - begin));
    const int nvec = t.vec ? len / 4 : 0;
    float4* p4 = reinterpret_cast<float4*>(t.p + begin);
    float4* m4 = reinterpret_cast<float4*>(t.m + begin);
    float4* v4 = reinterpret_cast<float4*>(t.v + begin);
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      float4 P = p4[i], M = m4[i], V = v4[i], G;
      const unsigned q = begin + 4 * i;
      if (code == kSameVec) {
        G = __ldg(reinterpret_cast<const float4*>(g + q));
      } else {
        G.x = grad_at(a, code, g, q);
        G.y = grad_at(a, code, g, q + 1);
        G.z = grad_at(a, code, g, q + 2);
        G.w = grad_at(a, code, g, q + 3);
      }
      adam_elem(P.x, M.x, V.x, G.x, s);
      adam_elem(P.y, M.y, V.y, G.y, s);
      adam_elem(P.z, M.z, V.z, G.z, s);
      adam_elem(P.w, M.w, V.w, G.w, s);
      p4[i] = P;
      m4[i] = M;
      v4[i] = V;
    }
    for (int i = 4 * nvec + threadIdx.x; i < len; i += kThreads) {
      const unsigned q = begin + i;
      adam_elem(t.p[q], t.m[q], t.v[q], grad_at(a, code, g, q), s);
    }
  }
}

}  // namespace

extern "C" {

// step += 1 for each of the table's n tensors, one launch on `stream`.
// Returns a cudaError_t (cudaGetLastError() after the launch).
int dasr_adam_count(const void* tensors, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  adam_count<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const AdamTensor*>(tensors), n);
  return static_cast<int>(cudaGetLastError());
}

// The update launch on `stream` over the table's n_tensors tensors and
// n_units units: grads[i] and codes[i] are tensor i's gradient and layout
// code, layouts n_layouts rows of 13 (stride[4], div[3], mul[3], shr[3]),
// lr the 0-d f32 LR on the card; grid blocks of kThreads. Returns
// cudaErrorInvalidValue past the kernel's capacities or for a code without
// its layout, else cudaGetLastError() after the launch.
int dasr_adam_update(const void* tensors, const void* units, int n_units, const void* lr,
                     int n_tensors, const void* const* grads, const unsigned char* codes,
                     const unsigned* layouts, int n_layouts, double beta1, double beta2,
                     double eps, int grid, void* stream) {
  if (n_tensors < 0 || n_tensors > kMaxTensors || n_layouts < 0 || n_layouts > kMaxLayouts ||
      grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_units <= 0) return static_cast<int>(cudaSuccess);
  AdamArgs a;
  a.tensors = static_cast<const AdamTensor*>(tensors);
  a.units = static_cast<const AdamUnit*>(units);
  a.lr = static_cast<const float*>(lr);
  for (int i = 0; i < n_tensors; ++i) {
    if (codes[i] > kSame && codes[i] - 2 >= n_layouts) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.grad[i] = static_cast<const float*>(grads[i]);
    a.code[i] = codes[i];
  }
  for (int l = 0; l < n_layouts; ++l) {
    const unsigned* row = layouts + 13 * l;
    for (int k = 0; k < 4; ++k) a.layout[l].stride[k] = row[k];
    for (int k = 0; k < 3; ++k) {
      a.layout[l].div[k] = row[4 + k];
      a.layout[l].mul[k] = row[7 + k];
      a.layout[l].shr[k] = row[10 + k];
    }
  }
  a.n_units = n_units;
  // the scalars as torch rounds them: each Python float to an f32 opmath
  a.beta1 = static_cast<float>(beta1);
  a.beta2 = static_cast<float>(beta2);
  a.w1 = static_cast<float>(1.0 - beta1);
  a.c2 = static_cast<float>(1.0 - beta2);
  a.eps = static_cast<float>(eps);
  adam_update<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's compiled constants, for ops/adam.py to check its own against:
// kChunk, kMaxTensors, kMaxLayouts, kThreads, sizeof(AdamArgs).
int dasr_adam_plan(int* out, int n) {
  const int v[5] = {kChunk, kMaxTensors, kMaxLayouts, kThreads,
                    static_cast<int>(sizeof(AdamArgs))};
  for (int j = 0; j < 5 && j < n; ++j) out[j] = v[j];
  return 5;
}

}  // extern "C"
