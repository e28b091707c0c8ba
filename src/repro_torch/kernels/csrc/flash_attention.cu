// K7: flash-attention forward (online softmax) over
//   q (B, H, Lq, hd) × k (B, Kv, Lk, hd) × v (B, Kv, Lk, hd_v) -> (B, H, Lq, hd_v)
// with GQA (head h reads kv head h / G, no repeat), causal and
// sliding-window masks from absolute positions (q_offset), f32 softmax
// and the output in q's dtype. Every tensor is addressed through its own
// (b, h, l, d) strides, so the models' (B, L, H, hd) activations are
// read and written in place, with no transpose copies. bf16: hd, hd_v
// <= 128, or hd <= 192 with hd_v <= 128 (DeepSeek-V2's MLA: qk 192,
// value 128); f32: hd, hd_v <= 192. Any Lq and Lk, G = H / Kv.
//
// Replaces: src/repro/kernels/attention/flash_attention.py,
//   `flash_attention_bhld` (`_flash_kernel`).
//
// Bound on the H100: at the serving and round shapes (L = 64 or 128, hd =
// 64, G = 3) one call moves ~1–3 MB and does ~0.1 GFLOP, a few
// microseconds at either roofline; the kernel is bound by latency (load,
// then a short chain of products per key tile). At 4,096 tokens and more
// (the launcher; mixtral, jamba and deepseek prefills) it is bound by
// operations: 2·pairs·(hd + hd_v) FLOPs against ~1 GB moved.
//
// Two kernels, chosen by dtype in `launch_flash_attention`:
//
// bf16 (serving, the LM round, the prefills): tensor cores,
//   FlashAttention-2 style, instantiated on the padded Q·K width DK and
//   V width DV: <64, 64>, <128, 128> and <192, 128> (MLA; 112 KB of
//   shared memory a block, so one block an SM).
//   One block of 8 warps per (tile of 64 packed rows, kv head, batch
//   row). The G query heads of the kv head are packed into the rows
//   (packed row r = query r / G of head kvh·G + r % G), so K and V are
//   staged once for all G heads, and a tile's rows span 64 / G query
//   positions, which keeps causal tile skipping tight. K and V tiles of
//   64 keys are double-buffered in shared memory with 16-byte cp.async
//   when the head dim's stride is 1 and rows are 16-byte aligned (the
//   models' transposed views are); other strides are staged element by
//   element into the same layout. Rows are padded by 8 elements, so the
//   ldmatrix row fetches hit distinct banks. Warp w owns 16 rows (w % 4)
//   and half of each key tile (w / 4), so at L <= 128 a row's serial
//   chain is one half tile a step and 8 warps share an SM; the halves
//   keep their own online softmax and merge once at the end through
//   shared memory, and the merged rows leave through shared memory too,
//   16 bytes a store where o's rows allow. Per warp and tile: S = Q Kᵀ
//   by mma.sync m16n8k16 (bf16
//   operands, f32 accumulators; a bf16 product is exact in f32, so only
//   the order of the sums moves), mask, scale to log2 units (exp2, as
//   FlashAttention does) and the online softmax in the accumulator
//   registers, then O += P V with P carried as hi + lo bf16 terms (two
//   MMAs): a single bf16 P adds up to 2^-9 relative error per weight,
//   which the 1e-4 absolute part of the bf16 check does not cover for
//   outputs near zero (tests/test_torch_kernels.py emulates both), while
//   hi + lo leaves 2^-17. Masked scores are -1e30, keys past Lk weigh 0,
//   the denominator is floored at 1e-30, as in the reference.
//
// f32 (the f32 handoff checks; no path runs f32 attention at speed): on
//   the CUDA cores. One block of 4 warps per (16 query rows, head,
//   batch); K and V tiles of 32 keys staged as f32, a lane scores one
//   key, shuffles give the running max and sum, and P V runs lane per
//   output dimension with p broadcast by shuffle. Instantiated on the
//   output dims a lane carries: 4 (hd_v <= 128) or 6 (hd_v <= 192);
//   above 48 KB (hd 192) its shared memory is opted into.
//
// Key tiles wholly outside every row's causal / window range are
// skipped in both. The backward pass is recomputation through the plain
// version (`flash_attention.py`).
#include <cstdint>

#include "common.cuh"

namespace {

using repro_torch::kFullMask;
using repro_torch::kNegInf;
using repro_torch::warp_max;
using repro_torch::warp_sum;

struct Strides4 {
  long long b, h, l, d;
};

// ------------------------------------------------------------ f32 kernel

constexpr int kBQ = 16;                 // query rows per block
constexpr int kBK = 32;                 // keys per tile (one per lane)
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;     // query rows per warp
constexpr int kMaxD = 192;              // largest hd / hd_v

// kDPL: output dims per lane (hd_v <= 32·kDPL)
template <int kDPL>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           Strides4 sq, Strides4 sk, Strides4 sv,
                           Strides4 so, int H, int Kv, int Lq, int Lk, int hd,
                           int hdv, float scale, int causal, int window,
                           int q_offset) {
  extern __shared__ float fsmem[];
  float* Ks = fsmem;                       // kBK x (hd + 1)
  float* Vs = Ks + kBK * (hd + 1);        // kBK x hdv
  float* Qs = Vs + kBK * hdv;             // kBQ x hd

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = H / Kv;
  const int kvh = h / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nthr = blockDim.x;
  const int q0 = qt * kBQ;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;

  for (int idx = threadIdx.x; idx < kBQ * hd; idx += nthr) {
    const int r = idx / hd, d = idx % hd, qi = q0 + r;
    Qs[idx] = qi < Lq ? (qb[qi * sq.l + d * sq.d]) : 0.f;
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
      Ks[r * (hd + 1) + d] = kj < Lk ? (kb[kj * sk.l + d * sk.d]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < kBK * hdv; idx += nthr) {
      const int r = idx / hdv, d = idx % hdv, kj = k0 + r;
      Vs[idx] = kj < Lk ? (vb[kj * sv.l + d * sv.d]) : 0.f;
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

  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    if (qi >= Lq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int d = lane + 32 * i;
      if (d < hdv) ob[qi * so.l + d * so.d] = acc[r][i] / denom;
    }
  }
}


// ----------------------------------------------------------- bf16 kernel

using bf16 = __nv_bfloat16;

constexpr int kMR = 64;                 // packed rows per block
constexpr int kSlice = 32;              // keys a warp takes of each tile
constexpr int kSlices = 2;              // key slices of a tile
constexpr int kMmaThreads = 128 * kSlices;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lanes 8m..8m+7 give the row addresses of matrix m
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) · b (16x8 bf16, col); not volatile
// (no memory access), so MMAs on different accumulators may interleave
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage ROWS rows of D columns into dst (row stride D + 8). row_ptr(r)
// gives row r's first element or nullptr (a zero row); columns at or
// past ncols are zero. vec: 16-byte cp.async (d stride 1, ncols % 8 ==
// 0, rows 16-byte aligned); else element loads with d stride ds.
template <int D, int ROWS, typename RowPtr>
__device__ __forceinline__ void stage_rows(bf16* dst, RowPtr row_ptr,
                                           int ncols, long long ds, bool vec,
                                           const bf16* any) {
  constexpr int kCh = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * kCh; idx += kMmaThreads) {
    const int r = idx / kCh, c = (idx - r * kCh) * 8;
    const bf16* src = row_ptr(r);
    bf16* d = dst + r * (D + 8) + c;
    if (vec) {
      const bool ok = src != nullptr && c < ncols;
      cp_async16(d, ok ? src + c : any, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (src != nullptr && c + e < ncols)
                   ? src[static_cast<long long>(c + e) * ds]
                   : __float2bfloat16_rn(0.f);
    }
  }
}

// DK: hd rounded up to 64, 128 or 192; DV: hd_v rounded up to 64 or 128
// (DV <= DK: the merged output rows are staged in Q's buffer). A tile is
// kSlices x 32 keys; a block 4 x kSlices warps.
template <int DK, int DV>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           Strides4 sq, Strides4 sk, Strides4 sv,
                           Strides4 so, int G, int Lq, int Lk, int hd,
                           int hdv, float scale_log2, int causal, int window,
                           int q_offset, int vec_q, int vec_kv, int vec_o) {
  static_assert(DV <= DK, "output rows are staged in Q's buffer");
  constexpr int LD = DK + 8;            // row stride of Q and K tiles
  constexpr int LDV = DV + 8;           // row stride of V tiles
  constexpr int KC = DK / 16;           // 16-wide k chunks of hd
  constexpr int NK = kSlice * kSlices;       // keys a tile
  constexpr int NT = kSlice / 8;        // 8-key n tiles of S a warp
  constexpr int DT = DV / 8;            // 8-wide n tiles of O
  constexpr int XW = DT * 4 + 4;        // floats a lane hands the merge
  extern __shared__ __align__(16) unsigned char bsmem[];
  bf16* Qs = reinterpret_cast<bf16*>(bsmem);   // kMR x LD
  bf16* Ks = Qs + kMR * LD;                    // 2 x NK x LD
  bf16* Vs = Ks + 2 * NK * LD;                 // 2 x NK x LDV

  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % 4, kh = warp / 4;      // row group, key slice
  const int g = lane / 4, t4 = lane % 4;
  const int rows = G * Lq;
  const int r0 = tile * kMR;

  const bf16* qb = q + b * sq.b + static_cast<long long>(kvh) * G * sq.h;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;

  // key range any row of this tile can see
  const int qfirst = r0 / G, qlast = (min(r0 + kMR, rows) - 1) / G;
  int kend = Lk;
  if (causal) kend = min(kend, qlast + q_offset + 1);
  int kbeg = 0;
  if (window > 0) kbeg = max(0, qfirst + q_offset - window + 1);
  const int t_beg = kbeg / NK;
  const int t_end = kend > 0 ? (kend + NK - 1) / NK : 0;

  auto stage_kv = [&](int t, int buf) {
    const int k0 = t * NK;
    stage_rows<DK, NK>(
        Ks + buf * NK * LD,
        [&](int r) -> const bf16* {
          return k0 + r < Lk ? kb + (k0 + r) * sk.l : nullptr;
        },
        hd, sk.d, vec_kv, kb);
    stage_rows<DV, NK>(
        Vs + buf * NK * LDV,
        [&](int r) -> const bf16* {
          return k0 + r < Lk ? vb + (k0 + r) * sv.l : nullptr;
        },
        hdv, sv.d, vec_kv, vb);
  };

  stage_rows<DK, kMR>(
      Qs,
      [&](int r) -> const bf16* {
        const int rr = r0 + r;
        if (rr >= rows) return nullptr;
        const int qi = rr / G;
        return qb + (rr - qi * G) * sq.h + qi * sq.l;
      },
      hd, sq.d, vec_q, qb);
  if (t_beg < t_end) stage_kv(t_beg, 0);
  cp_async_commit();

  // this thread's two rows (g and g + 8 of its row group's 16) and their
  // absolute query positions
  int qpos[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2)
    qpos[h2] = (r0 + rg * 16 + g + 8 * h2) / G + q_offset;

  unsigned qa[KC][4];
  // running max (in log2 units), partial row sum, output accumulators
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float oacc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;

  for (int t = t_beg; t < t_end; ++t) {
    const int buf = (t - t_beg) & 1;
    if (t + 1 < t_end) stage_kv(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == t_beg) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldsm_x4(qa[kc],
                Qs + (rg * 16 + (lane % 8) + 8 * ((lane / 8) & 1)) * LD +
                    kc * 16 + 8 * (lane / 16));
    }
    // this warp's 32 keys of the tile (none left of kbeg or right of
    // kend: then it skips the tile)
    const bf16* Kt = Ks + (buf * NK + kh * kSlice) * LD;
    const bf16* Vt = Vs + (buf * NK + kh * kSlice) * LDV;
    const int k0 = t * NK + kh * kSlice;
    if (k0 < kend && k0 + kSlice > kbeg) {
      // S = Q Kᵀ: 16 rows x 32 keys a warp
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned kf[4];
          ldsm_x4(kf, Kt + (np * 16 + (lane % 8) + 8 * (lane / 16)) * LD +
                          kc * 16 + 8 * ((lane / 8) & 1));
          mma_bf16(s[2 * np], qa[kc], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qa[kc], kf[2], kf[3]);
        }
      }

      // mask and scale (to log2 units); online softmax over the warp's keys
      // (a row's scores lie on the 4 lanes of its quad)
      float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h2 = e / 2;
          const int kj = k0 + nt * 8 + 2 * t4 + (e & 1);
          bool ok = kj < Lk;
          if (causal) ok = ok && kj <= qpos[h2];
          if (window > 0) ok = ok && kj > qpos[h2] - window;
          s[nt][e] = ok ? s[nt][e] * scale_log2 : kNegInf;
          tmax[h2] = fmaxf(tmax[h2], s[nt][e]);
        }
      float alpha[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        tmax[h2] = fmaxf(tmax[h2], __shfl_xor_sync(kFullMask, tmax[h2], 1));
        tmax[h2] = fmaxf(tmax[h2], __shfl_xor_sync(kFullMask, tmax[h2], 2));
        const float m_new = fmaxf(m[h2], tmax[h2]);
        alpha[h2] = exp2f(m[h2] - m_new);
        m[h2] = m_new;
        l[h2] *= alpha[h2];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h2 = e / 2;
          const int kj = k0 + nt * 8 + 2 * t4 + (e & 1);
          const float p = kj < Lk ? exp2f(s[nt][e] - m[h2]) : 0.f;
          s[nt][e] = p;
          l[h2] += p;
        }
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        oacc[dt][0] *= alpha[0];
        oacc[dt][1] *= alpha[0];
        oacc[dt][2] *= alpha[1];
        oacc[dt][3] *= alpha[1];
      }

      // O += P V, P as hi + lo bf16: the S accumulators of two 8-key n
      // tiles are the A fragment of one 16-key chunk
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) {
        unsigned ph[4], pl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // i: (row g, keys 2t4..), (row g+8, ..), (row g, keys 8+2t4..), ..
          const float x0 = s[2 * kc + i / 2][2 * (i & 1)];
          const float x1 = s[2 * kc + i / 2][2 * (i & 1) + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(
              x0 - __low2float(hi), x1 - __high2float(hi));
          ph[i] = *reinterpret_cast<const unsigned*>(&hi);
          pl[i] = *reinterpret_cast<const unsigned*>(&lo);
        }
        unsigned vf[DT / 2][4];
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp)
          ldsm_x4_trans(
              vf[dp], Vt + (kc * 16 + (lane % 8) + 8 * ((lane / 8) & 1)) * LDV +
                          dp * 16 + 8 * (lane / 16));
        // the lo pass over every output tile, then the hi pass
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          mma_bf16(oacc[2 * dp], pl, vf[dp][0], vf[dp][1]);
          mma_bf16(oacc[2 * dp + 1], pl, vf[dp][2], vf[dp][3]);
        }
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          mma_bf16(oacc[2 * dp], ph, vf[dp][0], vf[dp][1]);
          mma_bf16(oacc[2 * dp + 1], ph, vf[dp][2], vf[dp][3]);
        }
      }
    }
    __syncthreads();  // this buffer is restaged two tiles on
  }
  cp_async_wait<0>();
  __syncthreads();

  // the key slices of each row group meet: slices 1 .. kSlices-1 hand their
  // (m, l, O) to slice 0 through shared memory (K's buffers, now free;
  // [slice][value][row group][lane], so the 32 lanes hit 32 banks)
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    l[h2] += __shfl_xor_sync(kFullMask, l[h2], 1);
    l[h2] += __shfl_xor_sync(kFullMask, l[h2], 2);
  }
  float* xch = reinterpret_cast<float*>(Ks) + rg * 32 + lane;
  static_assert((kSlices - 1) * XW * 128 * sizeof(float) <=
                    2 * NK * (LD + LDV) * sizeof(bf16),
                "the exchange fits in the K and V buffers");
  if (kh > 0) {
    float* mine = xch + (kh - 1) * XW * 128;
    mine[0] = m[0];
    mine[128] = m[1];
    mine[2 * 128] = l[0];
    mine[3 * 128] = l[1];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(4 + dt * 4 + e) * 128] = oacc[dt][e];
  }
  __syncthreads();
  // slice 0 merges and writes its rows, as bf16, into Q's buffer (Q sits
  // in registers since the first tile); then all warps store the tile's
  // rows, 16 bytes a store where o's rows allow it
  if (kh == 0) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mm = m[h2];
#pragma unroll
      for (int sl = 0; sl < kSlices - 1; ++sl)
        mm = fmaxf(mm, xch[(sl * XW + h2) * 128]);
      float w[kSlices];                      // each slice's rescale
      w[0] = exp2f(m[h2] - mm);
      float lsum = w[0] * l[h2];
#pragma unroll
      for (int sl = 0; sl < kSlices - 1; ++sl) {
        w[sl + 1] = exp2f(xch[(sl * XW + h2) * 128] - mm);
        lsum += w[sl + 1] * xch[(sl * XW + 2 + h2) * 128];
      }
      const float inv = 1.f / fmaxf(lsum, 1e-30f);
      __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(
          Qs + (rg * 16 + g + 8 * h2) * LD + 2 * t4);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        float o0 = w[0] * oacc[dt][2 * h2], o1 = w[0] * oacc[dt][2 * h2 + 1];
#pragma unroll
        for (int sl = 0; sl < kSlices - 1; ++sl) {
          const float* x1 = xch + (sl * XW + 4 + dt * 4 + 2 * h2) * 128;
          o0 += w[sl + 1] * x1[0];
          o1 += w[sl + 1] * x1[128];
        }
        orow[dt * 4] = __floats2bfloat162_rn(o0 * inv, o1 * inv);
      }
    }
  }
  __syncthreads();
  constexpr int kCh = DV / 8;         // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < kMR * kCh; idx += kMmaThreads) {
    const int r = idx / kCh, c = (idx - r * kCh) * 8;
    const int rr = r0 + r;
    if (rr >= rows || c >= hdv) continue;
    const int qi = rr / G, hh = kvh * G + (rr - qi * G);
    bf16* orow = o + b * so.b + hh * so.h + qi * so.l;
    const bf16* src = Qs + r * LD + c;
    if (vec_o) {
      *reinterpret_cast<uint4*>(orow + c) =
          *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c + e < hdv; ++e) orow[(c + e) * so.d] = src[e];
    }
  }
}

bool rows_vec16(const void* base, const Strides4& s, int ncols) {
  return s.d == 1 && ncols % 8 == 0 && s.b % 8 == 0 && s.h % 8 == 0 &&
         s.l % 8 == 0 && reinterpret_cast<std::uintptr_t>(base) % 16 == 0;
}

template <int DK, int DV>
cudaError_t launch_mma(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                       const Strides4& sq, const Strides4& sk,
                       const Strides4& sv, const Strides4& so, int B, int H,
                       int Kv, int Lq, int Lk, int hd, int hdv, float scale,
                       int causal, int window, int q_offset,
                       cudaStream_t stream) {
  const size_t smem =
      sizeof(bf16) * ((kMR + 2 * kSlice * kSlices) * (DK + 8) +
                      2 * kSlice * kSlices * (DV + 8));
  static bool configured = false;   // once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_mma_kernel<DK, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int G = H / Kv;
  const dim3 grid((G * Lq + kMR - 1) / kMR, Kv, B);
  const int vec_q = rows_vec16(q, sq, hd);
  const int vec_kv = rows_vec16(k, sk, hd) && rows_vec16(v, sv, hdv);
  const int vec_o = rows_vec16(o, so, hdv);
  flash_attention_mma_kernel<DK, DV><<<grid, kMmaThreads, smem, stream>>>(
      q, k, v, o, sq, sk, sv, so, G, Lq, Lk, hd, hdv,
      scale * 1.4426950408889634f, causal, window, q_offset, vec_q, vec_kv,
      vec_o);
  return cudaGetLastError();
}

template <int kDPL>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       const Strides4& sq, const Strides4& sk,
                       const Strides4& sv, const Strides4& so, int B, int H,
                       int Kv, int Lq, int Lk, int hd, int hdv, float scale,
                       int causal, int window, int q_offset,
                       cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kBK * (hd + 1) + kBK * hdv + kBQ * hd);
  static bool configured = false;   // once per instantiation, at its most
  if (!configured) {
    const size_t most = sizeof(float) * (kBK * (kMaxD + 1) +
                                         kBK * 32 * kDPL + kBQ * kMaxD);
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_f32_kernel<kDPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  flash_attention_f32_kernel<kDPL><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, sv, so, H,
      Kv, Lq, Lk, hd, hdv, scale, causal, window, q_offset);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel); q, k, v and o share it.
// strides: 16 element strides, (b, h, l, d) for q, k, v, o in turn.
// window <= 0 means no sliding window. bf16: hd, hd_v <= 128, or hd <= 192
// with hd_v <= 128; f32: hd, hd_v <= 192 (the binding checks).
cudaError_t launch_flash_attention(int dtype, const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* st, int B, int H,
                                   int Kv, int Lq, int Lk, int hd, int hdv,
                                   float scale, int causal, int window,
                                   int q_offset, cudaStream_t stream) {
  if (B == 0 || H == 0 || Lq == 0) return cudaSuccess;
  const Strides4 sq{st[0], st[1], st[2], st[3]};
  const Strides4 sk{st[4], st[5], st[6], st[7]};
  const Strides4 sv{st[8], st[9], st[10], st[11]};
  const Strides4 so{st[12], st[13], st[14], st[15]};
  if (dtype == 1) {
    const auto* qb = static_cast<const bf16*>(q);
    const auto* kb = static_cast<const bf16*>(k);
    const auto* vb = static_cast<const bf16*>(v);
    auto* ob = static_cast<bf16*>(o);
    if (hd <= 64 && hdv <= 64)
      return launch_mma<64, 64>(qb, kb, vb, ob, sq, sk, sv, so, B, H, Kv, Lq,
                                Lk, hd, hdv, scale, causal, window, q_offset,
                                stream);
    if (hd <= 128 && hdv <= 128)
      return launch_mma<128, 128>(qb, kb, vb, ob, sq, sk, sv, so, B, H, Kv,
                                  Lq, Lk, hd, hdv, scale, causal, window,
                                  q_offset, stream);
    if (hd <= 192 && hdv <= 128)
      return launch_mma<192, 128>(qb, kb, vb, ob, sq, sk, sv, so, B, H, Kv,
                                  Lq, Lk, hd, hdv, scale, causal, window,
                                  q_offset, stream);
    return cudaErrorInvalidValue;
  }
  if (hd > kMaxD || hdv > kMaxD) return cudaErrorInvalidValue;
  return hdv <= 128
             ? launch_f32<4>(q, k, v, o, sq, sk, sv, so, B, H, Kv, Lq, Lk, hd,
                             hdv, scale, causal, window, q_offset, stream)
             : launch_f32<6>(q, k, v, o, sq, sk, sv, so, B, H, Kv, Lq, Lk, hd,
                             hdv, scale, causal, window, q_offset, stream);
}
