// K7: flash-attention forward (online softmax) over
//   q (B, H, Lq, hd) × k (B, Kv, Lk, hd) × v (B, Kv, Lk, hd_v) -> (B, H, Lq, hd_v)
// with GQA (head h reads kv head h / G, no repeat), causal and
// sliding-window masks from absolute positions (q_offset), f32 math and
// the output in q's dtype. Every tensor is addressed through its own
// (b, h, l, d) strides, so the models' (B, L, H, hd) activations are
// read and written in place, with no transpose copies.
//
// Replaces: src/repro/kernels/attention/flash_attention.py,
//   `flash_attention_bhld` (`_flash_kernel`).
//
// Bound on the H100: at the serving path's shapes (L = 64, hd = 64) the
// work is tiny and the kernel is bound by latency and launch, not by
// bytes (q, k, v, o read or written once) or flops (4·Lq·Lk·hd per head).
// At long L it would be bound by operations: this first version does its
// products on the f32 CUDA cores, not the tensor cores.
//
// Design: one block of 4 warps per (query tile of 16 rows, head, batch).
// The block stages the Q tile once and then each key tile of 32 rows of
// K and V in shared memory as f32 (K rows padded by one word, so the 32
// lanes reading 32 different K rows hit 32 different banks). Each warp
// owns 4 query rows; for a key tile a lane scores one key (lane-per-key),
// warp shuffles give the running max and sum, and the P·V product runs
// lane-per-dimension with p broadcast by shuffle. Running (m, l, acc)
// stay in registers for the whole pass. Key tiles wholly outside every
// row's causal / window range are skipped; keys past Lk (a ragged last
// tile — the Pallas kernel asserted Lq % bq == 0 instead) get p = 0.
// Masked in-range scores are -1e30 and the denominator is floored at
// 1e-30, as in the reference. wgmma, TMA and split-K are later work.
#include "common.cuh"

namespace {

using repro_torch::from_f;
using repro_torch::kFullMask;
using repro_torch::kNegInf;
using repro_torch::to_f;
using repro_torch::warp_max;
using repro_torch::warp_sum;

constexpr int kBQ = 16;                 // query rows per block
constexpr int kBK = 32;                 // keys per tile (one per lane)
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;     // query rows per warp
constexpr int kMaxD = 128;              // largest hd / hd_v
constexpr int kDPL = kMaxD / 32;        // output dims per lane

struct Strides4 {
  long long b, h, l, d;
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       Strides4 sq, Strides4 sk, Strides4 sv, Strides4 so,
                       int H, int Kv, int Lq, int Lk, int hd, int hdv,
                       float scale, int causal, int window, int q_offset) {
  extern __shared__ float smem[];
  float* Ks = smem;                       // kBK x (hd + 1)
  float* Vs = Ks + kBK * (hd + 1);        // kBK x hdv
  float* Qs = Vs + kBK * hdv;             // kBQ x hd

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = H / Kv;
  const int kvh = h / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nthr = blockDim.x;
  const int q0 = qt * kBQ;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  for (int idx = threadIdx.x; idx < kBQ * hd; idx += nthr) {
    const int r = idx / hd, d = idx % hd, qi = q0 + r;
    Qs[idx] = qi < Lq ? to_f(qb[qi * sq.l + d * sq.d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[r][i] = 0.f;
  }

  // key range any row of this tile can see
  const int qlast = min(q0 + kBQ, Lq) - 1;
  int kend = Lk;
  if (causal) kend = min(kend, qlast + q_offset + 1);
  int kbeg = 0;
  if (window > 0) kbeg = max(0, q0 + q_offset - window + 1);
  const int t_beg = kbeg / kBK;
  const int t_end = kend > 0 ? (kend + kBK - 1) / kBK : 0;

  for (int t = t_beg; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // Q staged / previous tile consumed
    for (int idx = threadIdx.x; idx < kBK * hd; idx += nthr) {
      const int r = idx / hd, d = idx % hd, kj = k0 + r;
      Ks[r * (hd + 1) + d] = kj < Lk ? to_f(kb[kj * sk.l + d * sk.d]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < kBK * hdv; idx += nthr) {
      const int r = idx / hdv, d = idx % hdv, kj = k0 + r;
      Vs[idx] = kj < Lk ? to_f(vb[kj * sv.l + d * sv.d]) : 0.f;
    }
    __syncthreads();

    const int kj = k0 + lane;
    const bool inb = kj < Lk;
    const float* krow = Ks + lane * (hd + 1);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qr = warp * kRows + r;
      const int qpos = q0 + qr + q_offset;
      const float* qrow = Qs + qr * hd;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += qrow[d] * krow[d];
      s *= scale;
      bool ok = inb;
      if (causal) ok = ok && kj <= qpos;
      if (window > 0) ok = ok && kj > qpos - window;
      s = ok ? s : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float a = expf(m[r] - m_new);
      const float p = inb ? expf(s - m_new) : 0.f;
      l[r] = a * l[r] + warp_sum(p);
#pragma unroll
      for (int i = 0; i < kDPL; ++i) acc[r][i] *= a;
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(kFullMask, p, j);
        const float* vrow = Vs + j * hdv;
#pragma unroll
        for (int i = 0; i < kDPL; ++i) {
          const int d = lane + 32 * i;
          if (d < hdv) acc[r][i] += pj * vrow[d];
        }
      }
      m[r] = m_new;
    }
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    if (qi >= Lq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (d < hdv) ob[qi * so.l + d * so.d] = from_f<T>(acc[r][i] / denom);
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o,
                         const long long* st, int B, int H, int Kv, int Lq,
                         int Lk, int hd, int hdv, float scale, int causal,
                         int window, int q_offset, cudaStream_t stream) {
  const Strides4 sq{st[0], st[1], st[2], st[3]};
  const Strides4 sk{st[4], st[5], st[6], st[7]};
  const Strides4 sv{st[8], st[9], st[10], st[11]};
  const Strides4 so{st[12], st[13], st[14], st[15]};
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  const size_t smem =
      sizeof(float) * (kBK * (hd + 1) + kBK * hdv + kBQ * hd);
  flash_attention_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, H, Kv, Lq,
      Lk, hd, hdv, scale, causal, window, q_offset);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
// strides: 16 element strides, (b, h, l, d) for q, k, v, o in turn.
// window <= 0 means no sliding window. hd, hd_v <= 128.
cudaError_t launch_flash_attention(int dtype, const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* strides, int B, int H,
                                   int Kv, int Lq, int Lk, int hd, int hdv,
                                   float scale, int causal, int window,
                                   int q_offset, cudaStream_t stream) {
  if (B == 0 || H == 0 || Lq == 0) return cudaSuccess;
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, o, strides, B, H, Kv, Lq, Lk,
                                       hd, hdv, scale, causal, window,
                                       q_offset, stream);
  return launch_typed<float>(q, k, v, o, strides, B, H, Kv, Lq, Lk, hd, hdv,
                             scale, causal, window, q_offset, stream);
}
