// K8: flash-decode — one-token attention of q (B, H, hd) over a KV cache
// (B, C, Kv, hd), slots with position >= kv_length[b] masked.
//
// Replaces: src/repro/kernels/decode_attention/flash_decode.py,
//   `flash_decode` (`_flash_decode_kernel`).
//
// Bound on the H100: memory. Each cache element is read once for
// 2·G flops (G = H / Kv query heads share it), far below the ~295
// flops per byte where the tensor cores would bind; the floor is the
// valid cache bytes / 3.35 TB/s. At the serving path's shapes (C = 64)
// the cache of one layer is a few tens of KB, so the kernel is bound
// by latency and launch.
//
// Design: one block of 4 warps per (kv head, batch row) holds the G
// query rows of that kv head in shared memory, so one pass over the
// cache serves all G heads (the reference's GQA packing). Key tiles of
// 32 slots go round-robin to the warps; in a tile each lane scores one
// slot, reading its K row with 16-byte vector loads (bf16 in, f32 math),
// then the warp accumulates P·V lane-per-dimension with p broadcast by
// shuffle. Each warp keeps its own online-softmax state (m, l, acc) in
// registers; at the end the 4 partial states are merged through shared
// memory. Any cache length C is accepted (the Pallas kernel asserted
// C % min(512, C) == 0). Splitting one (b, kv head)'s cache across
// blocks, with a combine pass, is later work.
#include "common.cuh"

namespace {

using repro_torch::from_f;
using repro_torch::kFullMask;
using repro_torch::kNegInf;
using repro_torch::to_f;
using repro_torch::warp_max;
using repro_torch::warp_sum;

constexpr int kWarps = 4;
constexpr int kMaxG = 8;           // query heads per kv head
constexpr int kMaxD = 128;         // largest head dim
constexpr int kDPL = kMaxD / 32;   // output dims per lane

struct CacheStrides {
  long long b, c, h;  // element strides; the head dim is contiguous
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ kvl,
                    T* __restrict__ o, CacheStrides sk, CacheStrides sv,
                    int C, int Kv, int G, int hd, float scale) {
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte load
  __shared__ float qs[kMaxG * kMaxD];
  __shared__ float red_m[kWarps][kMaxG];
  __shared__ float red_l[kWarps][kMaxG];
  __shared__ float red_acc[kWarps][kMaxG][kMaxD];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int H = Kv * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + ((long long)b * H + kvh * G) * hd;   // (G, hd) rows
  for (int idx = threadIdx.x; idx < G * hd; idx += blockDim.x)
    qs[(idx / hd) * kMaxD + idx % hd] = to_f(qb[idx]);
  __syncthreads();

  const int len = kvl[b];
  const T* kb = kc + b * sk.b + kvh * sk.h;
  const T* vb = vc + b * sv.b + kvh * sv.h;

  float m[kMaxG], l[kMaxG], acc[kMaxG][kDPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[g][i] = 0.f;
  }

  const int ntiles = (C + 31) / 32;
  for (int t = warp; t < ntiles; t += kWarps) {
    const int j = t * 32 + lane;
    const bool inb = j < C;
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
    if (inb) {
      const uint4* krow = reinterpret_cast<const uint4*>(kb + j * sk.c);
      for (int d0 = 0; d0 < hd; d0 += kVec) {
        const uint4 raw = krow[d0 / kVec];
        const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float kf = to_f(kv[e]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) s[g] += qs[g * kMaxD + d0 + e] * kf;
        }
      }
    }
    float p[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      const float sg = (inb && j < len) ? s[g] * scale : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(sg));
      const float a = expf(m[g] - m_new);
      p[g] = inb ? expf(sg - m_new) : 0.f;
      l[g] = a * l[g] + warp_sum(p[g]);
#pragma unroll
      for (int i = 0; i < kDPL; ++i) acc[g][i] *= a;
      m[g] = m_new;
    }
    const int nkeys = min(32, C - t * 32);
    for (int jj = 0; jj < nkeys; ++jj) {
      const T* vrow = vb + (long long)(t * 32 + jj) * sv.c;
      float vv[kDPL];
#pragma unroll
      for (int i = 0; i < kDPL; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < hd ? to_f(vrow[d]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float pj = __shfl_sync(kFullMask, p[g], jj);
#pragma unroll
        for (int i = 0; i < kDPL; ++i) acc[g][i] += pj * vv[i];
      }
    }
  }

  // merge the per-warp online-softmax states
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      red_m[warp][g] = m[g];
      red_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) red_acc[warp][g][d] = acc[g][i];
    }
  }
  __syncthreads();
  T* ob = o + ((long long)b * H + kvh * G) * hd;
  for (int idx = threadIdx.x; idx < G * hd; idx += blockDim.x) {
    const int g = idx / hd, d = idx % hd;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, red_m[w][g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(red_m[w][g] - mm);
      ll += red_l[w][g] * f;
      aa += red_acc[w][g][d] * f;
    }
    ob[idx] = from_f<T>(aa / fmaxf(ll, 1e-30f));
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* kvl, void* o, const long long* st, int B,
                         int C, int Kv, int G, int hd, float scale,
                         cudaStream_t stream) {
  const CacheStrides sk{st[0], st[1], st[2]};
  const CacheStrides sv{st[3], st[4], st[5]};
  const dim3 grid(Kv, B);
  flash_decode_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kvl, static_cast<T*>(o), sk, sv, C, Kv, G, hd,
      scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, o: contiguous (B, Kv*G, hd).
// strides: (b, c, h) element strides of the K cache, then of the V cache;
// the head dim of both caches is contiguous, rows 16-byte aligned.
// kvl: (B,) int32 valid slot counts. G <= 8, hd <= 128, hd % (16 / elem) == 0.
cudaError_t launch_flash_decode(int dtype, const void* q, const void* k,
                                const void* v, const int* kvl, void* o,
                                const long long* strides, int B, int C,
                                int Kv, int G, int hd, float scale,
                                cudaStream_t stream) {
  if (B == 0 || Kv == 0) return cudaSuccess;
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, kvl, o, strides, B, C, Kv, G,
                                       hd, scale, stream);
  return launch_typed<float>(q, k, v, kvl, o, strides, B, C, Kv, G, hd, scale,
                             stream);
}
