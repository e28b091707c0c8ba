// K5: coordinate-wise trimmed mean of the (m, N) client-gradient block
// over its live rows, into (N,) float32. Per coordinate n:
//   total = sum_{u=0}^{m-1} (live[u] ? f32(G[u, n]) : 0.0f), in order;
//   top   = `trim` sweeps over x = (live ? G : -BIG): each takes the
//           first strictly greater value from (-BIG, u = 0), adds it to
//           a sum that starts at 0 and knocks out its row, even when
//           nothing beat the sentinel;
//   bot   = the same over x = (live ? G : +BIG) with "strictly less"
//           (only when trim > 0);
//   out   = ((total - top) - bot) / (n_live - 2 trim),
// with n_live the f32 sum of 1.0 and 0.0 over the rows and BIG = 3e38
// rounded to float.
//
// Replaces: src/repro/kernels/meta_update/aggregate.py,
//   `trimmed_mean_flat` (`_trimmed_kernel`).
//
// Bound on the H100: memory. Each coordinate reads m values and writes
// one float, so the floor is (m·itemsize + 4) bytes an element over
// 3.35 TB/s: 2.16 ms for an f32 (4, 361,821,184) block, 1.30 ms in bf16.
//
// Design: one pass, every input byte read once. Each thread owns 4
// consecutive columns (16-byte loads of f32, 8-byte loads of bf16,
// neighbouring threads on neighbouring addresses) and a grid-stride loop
// covers N. For m <= 16 (a template on m) the thread keeps its 4·m values
// in registers and runs the reference's sweeps on them literally; the
// knock-out compares each row index with the winner, so every register
// index is static. Larger m takes a generic loop that finds each sweep's
// winner as the next element in (value desc, index asc) order after the
// previous winner, re-reading its column (from L1/L2) once a sweep. The
// live mask is staged once per block in shared memory; dead rows are
// reached only through a select, never a multiply, so they may hold NaN.
//
// Rounding contract: every sum, difference and the quotient are single
// IEEE operations (__fadd_rn, __fsub_rn, __fdiv_rn), so nvcc cannot
// reorder or contract them. The kernel is then bitwise equal, on the
// card, to the eager PyTorch version `trimmed_mean_plain`, degenerate
// rounds (n_live <= 2 trim: x/0, overflowing sentinels) included.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float4 load4(const float* g, long long i) {
  return reinterpret_cast<const float4*>(g)[i];
}

// bf16 -> f32 is exact: the 16 bits are the high half of the float
__device__ __forceinline__ float4 load4(const uint16_t* g, long long i) {
  const uint2 r = reinterpret_cast<const uint2*>(g)[i];
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xffff0000u));
}

__device__ __forceinline__ float get(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// `trim` extraction sweeps over the M values of one coordinate; `x` is
// destroyed. sign > 0: largest first from -BIG; sign < 0: smallest first
// from +BIG.
template <int M>
__device__ __forceinline__ float extract(float (&x)[M], int trim, float sign) {
  const float fill = sign > 0.f ? -kBig : kBig;
  float ext = 0.f;
  for (int t = 0; t < trim; ++t) {
    float bv = fill;
    int bu = 0;
#pragma unroll
    for (int u = 0; u < M; ++u) {
      const bool better = sign > 0.f ? x[u] > bv : x[u] < bv;
      bv = better ? x[u] : bv;
      bu = better ? u : bu;
    }
    ext = __fadd_rn(ext, bv);
#pragma unroll
    for (int u = 0; u < M; ++u) x[u] = bu == u ? fill : x[u];
  }
  return ext;
}

template <int M, typename T>
__global__ void trimmed_mean_reg_kernel(const T* __restrict__ G,
                                        const float* __restrict__ live,
                                        float* __restrict__ out, int trim,
                                        long long n4) {
  __shared__ bool alive[M];
  if (threadIdx.x < M) alive[threadIdx.x] = live[threadIdx.x] > 0.f;
  __syncthreads();
  float n_live = 0.f;
#pragma unroll
  for (int u = 0; u < M; ++u) n_live = __fadd_rn(n_live, alive[u] ? 1.f : 0.f);
  const float den = __fsub_rn(n_live, 2.f * static_cast<float>(trim));
  const long long row = 4 * n4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 g[M];
#pragma unroll
    for (int u = 0; u < M; ++u) g[u] = load4(G + u * row, i);
    float res[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float total = 0.f;
      float x[M];
#pragma unroll
      for (int u = 0; u < M; ++u)
        total = __fadd_rn(total, alive[u] ? get(g[u], j) : 0.f);
#pragma unroll
      for (int u = 0; u < M; ++u) x[u] = alive[u] ? get(g[u], j) : -kBig;
      const float top = extract<M>(x, trim, 1.f);
      float bot = 0.f;
      if (trim > 0) {
#pragma unroll
        for (int u = 0; u < M; ++u) x[u] = alive[u] ? get(g[u], j) : kBig;
        bot = extract<M>(x, trim, -1.f);
      }
      res[j] = __fdiv_rn(__fsub_rn(__fsub_rn(total, top), bot), den);
    }
    reinterpret_cast<float4*>(out)[i] =
        make_float4(res[0], res[1], res[2], res[3]);
  }
}

__device__ __forceinline__ float load1(const float* g, long long i) {
  return g[i];
}

__device__ __forceinline__ float load1(const uint16_t* g, long long i) {
  return __uint_as_float(static_cast<uint32_t>(g[i]) << 16);
}

// One coordinate's `trim` sweeps for any m. A sweep's winner in the
// reference is the greatest remaining value, the lowest row among equal
// ones; with dead rows and values at or below the sentinel read as the
// sentinel, that is the next element after the previous winner in the
// order (value desc, row asc). A sweep that finds no element above the
// sentinel adds the sentinel, as the reference's does.
template <typename T>
__device__ float extract_any(const T* G, const bool* alive, int m,
                             long long row, long long n, int trim,
                             float sign) {
  const float fill = sign > 0.f ? -kBig : kBig;
  float ext = 0.f;
  float pv = 0.f;
  int pu = -1;  // no previous winner yet
  for (int t = 0; t < trim; ++t) {
    float bv = fill;
    int bu = -1;
    for (int u = 0; u < m; ++u) {
      if (!alive[u]) continue;
      const float v = load1(G + u * row, n);
      // after the previous winner (pv, pu) in the order ...
      const bool after = pu < 0 || (sign > 0.f ? v < pv : v > pv) ||
                         (v == pv && u > pu);
      // ... and strictly beyond the best so far (first row wins ties)
      const bool better = sign > 0.f ? v > bv : v < bv;
      if (after && better) {
        bv = v;
        bu = u;
      }
    }
    ext = __fadd_rn(ext, bv);
    if (bu < 0) {
      // only sentinels remain: every further sweep adds the sentinel
      for (++t; t < trim; ++t) ext = __fadd_rn(ext, fill);
      break;
    }
    pv = bv;
    pu = bu;
  }
  return ext;
}

template <typename T>
__global__ void trimmed_mean_any_kernel(const T* __restrict__ G,
                                        const float* __restrict__ live,
                                        float* __restrict__ out, int m,
                                        int trim, long long N) {
  extern __shared__ bool alive_any[];
  for (int u = threadIdx.x; u < m; u += blockDim.x)
    alive_any[u] = live[u] > 0.f;
  __syncthreads();
  float n_live = 0.f;
  for (int u = 0; u < m; ++u)
    n_live = __fadd_rn(n_live, alive_any[u] ? 1.f : 0.f);
  const float den = __fsub_rn(n_live, 2.f * static_cast<float>(trim));
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x; n < N;
       n += stride) {
    float total = 0.f;
    for (int u = 0; u < m; ++u)
      total = __fadd_rn(total, alive_any[u] ? load1(G + u * N, n) : 0.f);
    const float top = extract_any(G, alive_any, m, N, n, trim, 1.f);
    const float bot =
        trim > 0 ? extract_any(G, alive_any, m, N, n, trim, -1.f) : 0.f;
    out[n] = __fdiv_rn(__fsub_rn(__fsub_rn(total, top), bot), den);
  }
}

long long grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  return blocks > kMaxBlocks ? kMaxBlocks : blocks;
}

template <int M, typename T>
cudaError_t launch_reg(const T* G, const float* live, float* out, int trim,
                       long long n4, cudaStream_t stream) {
  trimmed_mean_reg_kernel<M, T><<<(unsigned)grid_for(n4), kThreads, 0,
                                  stream>>>(G, live, out, trim, n4);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const T* G, const float* live, float* out, int m,
                         int trim, long long N, cudaStream_t stream) {
  const long long n4 = N / 4;
  switch (m) {
#define REPRO_K5_CASE(M) \
  case M:                \
    return launch_reg<M, T>(G, live, out, trim, n4, stream);
    REPRO_K5_CASE(1)
    REPRO_K5_CASE(2)
    REPRO_K5_CASE(3)
    REPRO_K5_CASE(4)
    REPRO_K5_CASE(5)
    REPRO_K5_CASE(6)
    REPRO_K5_CASE(7)
    REPRO_K5_CASE(8)
    REPRO_K5_CASE(9)
    REPRO_K5_CASE(10)
    REPRO_K5_CASE(11)
    REPRO_K5_CASE(12)
    REPRO_K5_CASE(13)
    REPRO_K5_CASE(14)
    REPRO_K5_CASE(15)
    REPRO_K5_CASE(16)
#undef REPRO_K5_CASE
    default:
      trimmed_mean_any_kernel<T><<<(unsigned)grid_for(N), kThreads,
                                   m * sizeof(bool), stream>>>(
          G, live, out, m, trim, N);
      return cudaGetLastError();
  }
}

}  // namespace

// G: (m, N) contiguous, dtype 0 f32 / 1 bf16, N % 4 == 0 and rows aligned
// for their vector loads; live: (m,) f32 on the device; out: (N,) f32;
// 0 <= 2 trim < m. m bytes of shared memory for m > 16.
cudaError_t launch_trimmed_mean(int dtype, const void* G, const float* live,
                                float* out, int m, int trim, long long N,
                                cudaStream_t stream) {
  if (m <= 0 || N <= 0) return cudaSuccess;
  if (dtype == 0)
    return launch_typed(static_cast<const float*>(G), live, out, m, trim, N,
                        stream);
  return launch_typed(static_cast<const uint16_t*>(G), live, out, m, trim, N,
                      stream);
}
