// K1: fused client-plane inner update  θ ← θ − α∘g  over a (C, N) plane.
//
// Replaces: src/repro/kernels/meta_update/fused.py, the Pallas kernels
//   `_inner_plane_scalar_call` (`_plane_kernel_scalar`) and
//   `_inner_plane_vec_call` (`_plane_kernel_vec`) behind
//   `inner_update_plane`; K4 (`meta_update_flat`, fused.py
//   `_meta_update_kernel`) is this kernel at C = 1.
//
// Bound on the H100: memory. Each element is 2 flops against 12 bytes
// (θ read, g read, θ written; 16 with a (C, N) α), so the floor is
// bytes / 3.35 TB/s — about 5.2 ms for a (4, 361,821,184) f32 plane.
// Reaching it takes enough bytes in flight: θ may alias the output (the
// reference's input_output_aliases={0: 0}), so θ and out carry no
// __restrict__, and a loop of one load, one store a thread cannot start
// its next loads before its last store.
//
// Design: every byte moved once, as float4s (16-byte accesses,
// neighbouring threads on neighbouring addresses).
// - Each thread first loads kUnroll float4s of θ and g (and α) into
//   registers, then computes and stores them: kUnroll times the bytes in
//   flight of the aliasing-bound loop, and still legal with θ aliased,
//   since each element is read and then written by the same thread.
// - The grid covers the plane once, one block a chunk of
//   kThreads · kUnroll float4s (the loop over chunks only runs for a
//   plane beyond the grid's limits). A grid of whole waves walking the
//   chunks measured 3–9 % slower on the H100 (tools/probe_k1_k8.py).
// - Plain loads and stores: the streaming hints (__ldcs / __stcs) cost
//   2–4 % on the H100 against the same loop without them, though the
//   plane never fits the 50 MB L2 (tools/probe_k1_k8.py). Every block
//   size from 128 to 512 threads and 1 to 4 float4s a thread ties
//   PyTorch's elementwise kernels there.
// - A scalar α is a kernel argument; a per-client (C, N) α is read like
//   θ, one client row a grid row; a shared (N,) α is read once for all C
//   rows: one thread applies its α float4s to every row in turn.
//
// Rounding contract: the product and the difference are rounded
// separately (__fmul_rn, then __fsub_rn), so nvcc cannot contract them
// into an FMA. The result is then bitwise equal to eager PyTorch's
// `theta - alpha * g` (two kernels, two roundings) on the card.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;                    // float4s of each operand
constexpr long long kChunk = (long long)kThreads * kUnroll;
constexpr long long kMaxBlocksX = 1LL << 30;

__device__ __forceinline__ float upd(float t, float a, float g) {
  return __fsub_rn(t, __fmul_rn(a, g));
}

__device__ __forceinline__ float4 upd4(float4 t, float4 a, float4 g) {
  return make_float4(upd(t.x, a.x, g.x), upd(t.y, a.y, g.y),
                     upd(t.z, a.z, g.z), upd(t.w, a.w, g.w));
}

// kMode 0: scalar α; 1: shared (N,) α; 2: per-client (C, N) α.
// Grid: x over chunks of a row; y over rows (1 for kMode 1, whose
// threads walk every row).
template <int kMode>
__global__ void __launch_bounds__(kThreads)
inner_update_kernel(const float* theta, float* out,
                    const float* __restrict__ alpha, float alpha_s,
                    const float* __restrict__ g, long long rows,
                    long long n4) {
  const float4* t4 = reinterpret_cast<const float4*>(theta);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* a4 = reinterpret_cast<const float4*>(alpha);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long long base = blockIdx.x * kChunk + threadIdx.x; base < n4;
       base += (long long)gridDim.x * kChunk) {
    float4 a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      a[u] = make_float4(alpha_s, alpha_s, alpha_s, alpha_s);
      if (kMode == 1 && i < n4) a[u] = a4[i];
    }
    for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
      const long long off = row * n4;
      float4 t[kUnroll], gv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * kThreads;
        if (i < n4) {
          t[u] = t4[off + i];
          gv[u] = g4[off + i];
          if (kMode == 2) a[u] = a4[off + i];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * kThreads;
        if (i < n4) o4[off + i] = upd4(t[u], a[u], gv[u]);
      }
    }
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
  long long bx = (n4 + kChunk - 1) / kChunk;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  const dim3 grid((unsigned)bx, alpha_mode == 1 ? 1u : (unsigned)C);
  switch (alpha_mode) {
    case 0:
      inner_update_kernel<0><<<grid, kThreads, 0, stream>>>(
          theta, out, alpha, alpha_s, g, C, n4);
      break;
    case 1:
      inner_update_kernel<1><<<grid, kThreads, 0, stream>>>(
          theta, out, alpha, alpha_s, g, C, n4);
      break;
    default:
      inner_update_kernel<2><<<grid, kThreads, 0, stream>>>(
          theta, out, alpha, alpha_s, g, C, n4);
      break;
  }
  return cudaGetLastError();
}
