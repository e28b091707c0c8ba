// K1: fused client-plane inner update  θ ← θ − α∘g  over a (C, N) plane.
//
// Replaces: src/repro/kernels/meta_update/fused.py, the Pallas kernels
//   `_inner_plane_scalar_call` (`_plane_kernel_scalar`) and
//   `_inner_plane_vec_call` (`_plane_kernel_vec`) behind
//   `inner_update_plane`.
//
// Bound on the H100: memory. Each element is 2 flops against 12 bytes
// (θ read, g read, θ written; 16 with a (C, N) α), so the floor is
// bytes / 3.35 TB/s — about 5.2 ms for a (4, 361,821,184) f32 plane.
//
// Design: one pass, every byte moved once. Each thread streams float4s
// (16-byte loads and stores, neighbouring threads on neighbouring
// addresses); blockIdx.y is the client row, so a shared (N,) α is read
// with stride 0 over C and a scalar α is a kernel argument. θ may alias
// the output (the in-place update of the reference's
// input_output_aliases={0: 0}): each element is read and then written
// by the same thread, so θ and out carry no __restrict__.
//
// Rounding contract: the product and the difference are rounded
// separately (__fmul_rn, then __fsub_rn), so nvcc cannot contract them
// into an FMA. The result is then bitwise equal to eager PyTorch's
// `theta - alpha * g` (two kernels, two roundings) on the card.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 4096;

__device__ __forceinline__ float upd(float t, float a, float g) {
  return __fsub_rn(t, __fmul_rn(a, g));
}

// kMode 0: scalar α; 1: shared (N,) α; 2: per-client (C, N) α
template <int kMode>
__global__ void inner_update_kernel(const float* theta, float* out,
                                    const float* __restrict__ alpha,
                                    float alpha_s,
                                    const float* __restrict__ g,
                                    long long n4) {
  const long long row = blockIdx.y;
  const float4* t4 = reinterpret_cast<const float4*>(theta) + row * n4;
  const float4* g4 = reinterpret_cast<const float4*>(g) + row * n4;
  float4* o4 = reinterpret_cast<float4*>(out) + row * n4;
  const float4* a4 = reinterpret_cast<const float4*>(alpha);
  if (kMode == 2) a4 += row * n4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 t = t4[i];
    const float4 gv = g4[i];
    float4 a;
    if (kMode == 0) {
      a = make_float4(alpha_s, alpha_s, alpha_s, alpha_s);
    } else {
      a = a4[i];
    }
    float4 r;
    r.x = upd(t.x, a.x, gv.x);
    r.y = upd(t.y, a.y, gv.y);
    r.z = upd(t.z, a.z, gv.z);
    r.w = upd(t.w, a.w, gv.w);
    o4[i] = r;
  }
}

}  // namespace

// theta, out, g: (C, N) f32, 16-byte aligned rows, N % 4 == 0.
// alpha_mode 0 uses alpha_s; 1 reads alpha as (N,); 2 as (C, N).
cudaError_t launch_inner_update(const float* theta, float* out,
                                const float* alpha, float alpha_s,
                                int alpha_mode, const float* g, long long C,
                                long long N, cudaStream_t stream) {
  const long long n4 = N / 4;
  if (C <= 0 || n4 <= 0) return cudaSuccess;
  long long bx = (n4 + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  const dim3 grid((unsigned)bx, (unsigned)C);
  switch (alpha_mode) {
    case 0:
      inner_update_kernel<0><<<grid, kThreads, 0, stream>>>(
          theta, out, alpha, alpha_s, g, n4);
      break;
    case 1:
      inner_update_kernel<1><<<grid, kThreads, 0, stream>>>(
          theta, out, alpha, alpha_s, g, n4);
      break;
    default:
      inner_update_kernel<2><<<grid, kThreads, 0, stream>>>(
          theta, out, alpha, alpha_s, g, n4);
      break;
  }
  return cudaGetLastError();
}
