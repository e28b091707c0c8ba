// K2: weighted aggregation of the (m, N) client-gradient block,
//   out[n] = sum_{u=0}^{m-1} w[u] * f32(G[u, n])   into (N,) float32.
//
// Replaces: src/repro/kernels/meta_update/aggregate.py,
//   `weighted_aggregate_flat` (`_agg_kernel`).
//
// Bound on the H100: memory. Each output element costs 2·m flops
// against (m·itemsize + 4) bytes, so the floor is those bytes over
// 3.35 TB/s: 2.16 ms for an f32 (4, 361,821,184) block, 1.30 ms in bf16.
//
// Design: one pass, every byte moved once. Each thread owns 4
// consecutive columns and walks the m rows for them (16-byte loads of
// f32, 8-byte loads of bf16, 4-byte loads of int8, neighbouring threads
// on neighbouring addresses), keeping the four sums in registers; a
// grid-stride loop covers N. The m weights are staged once per block in
// shared memory. G may be f32, bf16 or int8 (the int8 codec's slice
// folds each row's scale into its weight); the sum is always f32.
//
// Rounding contract: the rows are summed in the order u = 0..m-1, as
// the Pallas `fori_loop` does, and each step rounds the product and the
// sum separately (__fmul_rn, then __fadd_rn), so nvcc cannot contract
// them into an FMA. The kernel is then bitwise equal, on the card, to
// the eager loop `acc = acc + w[u] * G[u].float()` from acc = 0.
// Weights arrive normalized; the kernel does not renormalize.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

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

__device__ __forceinline__ float4 load4(const int8_t* g, long long i) {
  const char4 c = reinterpret_cast<const char4*>(g)[i];
  return make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                     static_cast<float>(c.z), static_cast<float>(c.w));
}

__device__ __forceinline__ float acc_step(float acc, float w, float g) {
  return __fadd_rn(acc, __fmul_rn(w, g));
}

template <typename T>
__global__ void weighted_aggregate_kernel(const T* __restrict__ G,
                                          const float* __restrict__ w,
                                          float* __restrict__ out, int m,
                                          long long n4) {
  extern __shared__ float sw[];
  for (int u = threadIdx.x; u < m; u += blockDim.x) sw[u] = w[u];
  __syncthreads();
  const long long row = 4 * n4;  // elements per client row
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int u = 0; u < m; ++u) {
      const float4 g = load4(G + u * row, i);
      const float wu = sw[u];
      acc.x = acc_step(acc.x, wu, g.x);
      acc.y = acc_step(acc.y, wu, g.y);
      acc.z = acc_step(acc.z, wu, g.z);
      acc.w = acc_step(acc.w, wu, g.w);
    }
    reinterpret_cast<float4*>(out)[i] = acc;
  }
}

template <typename T>
cudaError_t launch(const T* G, const float* w, float* out, int m,
                   long long n4, cudaStream_t stream) {
  long long blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  weighted_aggregate_kernel<T><<<(unsigned)blocks, kThreads,
                                 m * sizeof(float), stream>>>(G, w, out, m,
                                                              n4);
  return cudaGetLastError();
}

}  // namespace

// G: (m, N) contiguous, dtype 0 f32 / 1 bf16 / 2 int8, N % 4 == 0 and
// rows aligned for their vector loads; w: (m,) f32 on the device;
// out: (N,) f32. m * 4 bytes of shared memory (m <= 12288).
cudaError_t launch_weighted_aggregate(int dtype, const void* G,
                                      const float* w, float* out, int m,
                                      long long N, cudaStream_t stream) {
  const long long n4 = N / 4;
  if (m <= 0 || n4 <= 0) return cudaSuccess;
  switch (dtype) {
    case 0:
      return launch(static_cast<const float*>(G), w, out, m, n4, stream);
    case 1:
      return launch(static_cast<const uint16_t*>(G), w, out, m, n4, stream);
    default:
      return launch(static_cast<const int8_t*>(G), w, out, m, n4, stream);
  }
}
