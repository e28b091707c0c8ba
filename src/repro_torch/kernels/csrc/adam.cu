// K3: one fused outer-Adam step over the flat (N,) φ plane, in place:
//   m' = b1·m + (1−b1)·g
//   v' = b2·v + (1−b2)·g·g
//   u  = (m'·s[0]) / (sqrt(v'·s[1]) + eps)   (+ wd·p when wd > 0)
//   p' = p − lr·u
//
// Replaces: src/repro/optim/fused_adam.py, `adam_flat_pallas`
//   (`_adam_kernel`, with input_output_aliases {1: 0, 3: 1, 4: 2}).
//
// Bound on the H100: memory. About 15 flops per element against 28
// bytes with f32 moments (p, g, m, v read; p, m, v written) or 20 with
// bf16 moments, so the floor is bytes / 3.35 TB/s: 3.02 ms (f32 state)
// or 2.16 ms (bf16 state) at N = 361,821,184.
//
// Design: one pass, every byte moved once. Each thread streams 4
// consecutive elements (16-byte loads of p and g, 16- or 8-byte loads
// of m and v) in a grid-stride loop, and writes p, m and v back where
// it read them: the in-place update of the Pallas aliases. p, m and v
// therefore carry no __restrict__. The bias-correction scales s are a
// (2,) device tensor computed from the device-side step count, so a
// round never waits on the host; the hyperparameters are arguments.
//
// Rounding contract: the reference's operation order, every product,
// sum, quotient and square root rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: no FMA contraction, no
// fast math), (1−b1) and (1−b2) computed by the caller in double, and
// (1−b2)·g·g evaluated left to right. bf16 moments are stored with
// round-to-nearest-even. The kernel is then bitwise equal to the eager
// PyTorch version `adam_flat_ref` on the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

struct Hyper {
  float lr, b1, c1, b2, c2, eps, wd;
};

__device__ __forceinline__ float4 load_state(const float* x, long long i) {
  return reinterpret_cast<const float4*>(x)[i];
}

__device__ __forceinline__ float4 load_state(const __nv_bfloat16* x,
                                             long long i) {
  const uint2 r = reinterpret_cast<const uint2*>(x)[i];
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xffff0000u));
}

__device__ __forceinline__ void store_state(float* x, long long i, float4 v) {
  reinterpret_cast<float4*>(x)[i] = v;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ void store_state(__nv_bfloat16* x, long long i,
                                            float4 v) {
  reinterpret_cast<uint2*>(x)[i] =
      make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}

__device__ __forceinline__ void adam_elem(float& p, float g, float& m,
                                          float& v, float s0, float s1,
                                          const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.c1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.c2, g), g));
  float u = __fdiv_rn(__fmul_rn(m, s0),
                      __fadd_rn(__fsqrt_rn(__fmul_rn(v, s1)), h.eps));
  if (h.wd > 0.f) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, u));
}

template <typename S>
__global__ void adam_kernel(float* p, const float* __restrict__ g, S* m,
                            S* v, const float* __restrict__ scales,
                            long long n4, Hyper h) {
  const float s0 = scales[0], s1 = scales[1];
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 pv = p4[i];
    const float4 gv = g4[i];
    float4 mv = load_state(m, i);
    float4 vv = load_state(v, i);
    adam_elem(pv.x, gv.x, mv.x, vv.x, s0, s1, h);
    adam_elem(pv.y, gv.y, mv.y, vv.y, s0, s1, h);
    adam_elem(pv.z, gv.z, mv.z, vv.z, s0, s1, h);
    adam_elem(pv.w, gv.w, mv.w, vv.w, s0, s1, h);
    p4[i] = pv;
    store_state(m, i, mv);
    store_state(v, i, vv);
  }
}

}  // namespace

// p, g: (N,) f32; m, v: (N,) f32 (state_dtype 0) or bf16 (1), all
// contiguous, 16-byte aligned, N % 4 == 0; scales: (2,) f32 on the
// device. p, m and v are updated in place.
cudaError_t launch_adam_flat(int state_dtype, float* p, const float* g,
                             void* m, void* v, const float* scales,
                             long long N, float lr, float b1, float c1,
                             float b2, float c2, float eps, float wd,
                             cudaStream_t stream) {
  const long long n4 = N / 4;
  if (n4 <= 0) return cudaSuccess;
  long long blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const Hyper h{lr, b1, c1, b2, c2, eps, wd};
  if (state_dtype == 0) {
    adam_kernel<float><<<(unsigned)blocks, kThreads, 0, stream>>>(
        p, g, static_cast<float*>(m), static_cast<float*>(v), scales, n4, h);
  } else {
    adam_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, stream>>>(
        p, g, static_cast<__nv_bfloat16*>(m), static_cast<__nv_bfloat16*>(v),
        scales, n4, h);
  }
  return cudaGetLastError();
}
