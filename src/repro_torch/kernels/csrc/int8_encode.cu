// K6: per-row-scaled int8 quantization of the (m, N) client-gradient
// block with the error-feedback residual in the same pass,
//   inv_u = s_u > 0 ? 1 / max(s_u, 1e-30) : 0
//   q[u, n] = clip(rint(G[u, n] * inv_u), -127, 127)      as int8
//   r[u, n] = G[u, n] - s_u * q[u, n]                     float32
//
// Replaces: src/repro/kernels/meta_update/compress.py,
//   `int8_encode_flat` (`_int8_encode_kernel`). The scales
//   s_u = max|G_u| / 127 stay outside the kernel, as in the reference.
//
// Bound on the H100: memory. Each element reads 4 bytes and writes
// 1 + 4, so the floor is 9 B over 3.35 TB/s: 3.89 ms for a
// (4, 361,821,184) f32 block, about 5 us for (4, 461,824).
//
// Design: one client row per blockIdx.y (its scale and reciprocal are
// computed once per block), grid-stride over the row in float4 loads
// with char4 and float4 stores, neighbouring threads on neighbouring
// addresses. Each element is read and written by the same thread, so
// `resid` may be `G` itself: the packed step hands in the EF-corrected
// block, a temporary it owns, and the residual overwrites it in place.
//
// Rounding contract: the reciprocal, the product, the rounding and the
// residual are each rounded once (__fdiv_rn, __fmul_rn, rintf — round
// half to even, as torch.round and jnp.round — then __fmul_rn and
// __fsub_rn), so nvcc cannot contract s*q into the subtraction. The
// kernel is then bitwise equal, on the card, to the eager version
// `g * inv[:, None]` -> `torch.round` -> `clamp` -> `g - s[:, None] * q`.
// A row of zeros has s = 0, hence inv = 0, q = 0 and r = g.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;   // across all rows

__device__ __forceinline__ float quantize(float g, float inv) {
  const float x = rintf(__fmul_rn(g, inv));
  return fminf(fmaxf(x, -127.f), 127.f);
}

// G carries no __restrict__: `resid` may be G itself.
__global__ void int8_encode_kernel(const float* G,
                                   const float* __restrict__ scales,
                                   int8_t* __restrict__ q, float* resid,
                                   long long n4) {
  const long long u = blockIdx.y;
  const float s = scales[u];
  const float inv = s > 0.f ? __fdiv_rn(1.f, fmaxf(s, 1e-30f)) : 0.f;
  const float4* g4 = reinterpret_cast<const float4*>(G) + u * n4;
  char4* q4 = reinterpret_cast<char4*>(q) + u * n4;
  float4* r4 = reinterpret_cast<float4*>(resid) + u * n4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 g = g4[i];
    const float4 x = make_float4(quantize(g.x, inv), quantize(g.y, inv),
                                 quantize(g.z, inv), quantize(g.w, inv));
    q4[i] = make_char4(static_cast<signed char>(x.x),
                       static_cast<signed char>(x.y),
                       static_cast<signed char>(x.z),
                       static_cast<signed char>(x.w));
    r4[i] = make_float4(__fsub_rn(g.x, __fmul_rn(s, x.x)),
                        __fsub_rn(g.y, __fmul_rn(s, x.y)),
                        __fsub_rn(g.z, __fmul_rn(s, x.z)),
                        __fsub_rn(g.w, __fmul_rn(s, x.w)));
  }
}

}  // namespace

// G, resid: (m, N) f32 contiguous (resid may alias G); q: (m, N) int8;
// scales: (m,) f32 on the device. N % 4 == 0, rows 16-byte aligned,
// m <= 65535.
cudaError_t launch_int8_encode(const float* G, const float* scales, int8_t* q,
                               float* resid, int m, long long N,
                               cudaStream_t stream) {
  const long long n4 = N / 4;
  if (m <= 0 || n4 <= 0) return cudaSuccess;
  long long bx = (n4 + kThreads - 1) / kThreads;
  const long long cap = kMaxBlocks / m > 0 ? kMaxBlocks / m : 1;
  if (bx > cap) bx = cap;
  const dim3 grid((unsigned)bx, (unsigned)m);
  int8_encode_kernel<<<grid, kThreads, 0, stream>>>(G, scales, q, resid, n4);
  return cudaGetLastError();
}
