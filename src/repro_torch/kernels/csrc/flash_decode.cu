// K8: flash-decode — one-token attention of q (B, H, hd) over a KV cache
// (B, C, Kv, hd), slots with position >= kv_length[b] masked.
//
// Replaces: src/repro/kernels/decode_attention/flash_decode.py,
//   `flash_decode` (`_flash_decode_kernel`).
//
// What bounds it on the H100. Each cache element is read once for 2·G
// flops (G = H / Kv query heads share it), far below the ~295 flops a
// byte at which the tensor cores would bind, so the floor is the valid
// cache bytes / 3.35 TB/s. At the serving step (C = 64, Kv = 5, B = 1)
// that is 80 KB, 0.03 µs: the kernel is bound by latency, by how many
// dependent trips to device memory a block makes. At long caches
// (C = 32K: 42 MB) it is bound by bytes, if enough blocks keep enough
// loads in flight.
//
// Design:
// - Stage, then compute. A block starts the K and V tile copies of up
//   to kStages - 1 tiles (8 KB of K and 8 KB of V each) as cp.async,
//   16 bytes a thread, neighbouring threads on neighbouring bytes of a
//   row, before it touches any of them; it then waits once and scores
//   and accumulates from shared memory. No device-memory load sits in
//   the key loop: a longer range streams through the ring, the next
//   tile's copy in flight while one is consumed. At the serving step the
//   whole (b, kv head) cache (64 keys, 16 KB) is one tile: one trip.
// - Enough blocks. The grid is (splits, Kv, B): each split of the cache
//   axis keeps its own online-softmax state (m, l, acc for each of the G
//   query heads) and writes it to a scratch; flash_decode_combine_kernel
//   merges the splits. The split count comes from the wrapper
//   (`num_splits` in decode_attention/flash_decode.py): one split, one
//   launch and no scratch where the cache is short.
// - Skip dead slots. A split reads only slots below kv_length[b]: a tile
//   wholly at or past it is never copied. This is exact: the reference
//   masks with the finite -1e30, and exp(-1e30 - m) = 0 for any real m.
//   A row with kv_length 0 keeps the reference kernel's answer: every
//   slot scores -1e30, so the softmax is uniform and the output is the
//   mean of V over all C slots (the jnp oracle gives NaN there).
// - Short chains once the tiles land. At the serving step a block waits
//   ~2,000 SM cycles for its tiles and then, on the CUDA cores, spent
//   ~2,900 more on shuffles, exponentials and the merge of its warps
//   (clock64() phases, tools/probe_k1_k8.py). So bf16 with hd <= 64 (the
//   serving path) runs on the tensor cores: S = Q Kᵀ and O += P V by
//   mma.sync, the G query rows packed into one 16-row fragment, every
//   warp scoring the whole tile so that it holds the whole softmax and
//   writes its own 16 head dims with no merge (~1,300 cycles after
//   staging). Not for the flops: 2·G a cache element is far below what
//   the tensor cores would bind at.
// - Every other bf16 call (hd in (64, 192], or G in 9..12) runs
//   flash_decode_wide_kernel, on the tensor cores too. On the CUDA cores
//   a key of hd 128 cost ~2,000 FMAs, 16 shuffles and 128 exp2 for the
//   G = 8 rows, more instruction slots than the ~35 SM cycles in which the
//   device memory delivers its 512 bytes: that kernel ran at 34–42 % of
//   the bytes bound at G 7–12. On mma.sync the same key costs 3 MMAs
//   (4.5 at hd 192). All G <= 12 query rows fill rows 0..G-1 of one
//   16-row A fragment (rows 8..15 in its second and fourth registers).
//   The warps split the keys, not the head dims: each warp takes its own
//   16-key slice of every staged tile, keeps the online softmax of its
//   rows and O over all hd dims in registers, and the 4 warps merge (m,
//   l, O) once, at the end, through shared memory. Split over the dims,
//   as the hd <= 64 kernel is, every warp would redo S and read the
//   whole K tile through ldmatrix (12 warps and ~4.6 KB of shared-memory
//   reads a key at hd 192). Two blocks an SM keep ~100 KB or more of
//   copies in flight an SM (Little's law at ~1–2 µs and ~25 GB/s an SM):
//   three 34.8 KB stages a block at hd 128, two 51.2 KB stages at hd
//   192.
// - f32 runs flash_decode_kernel on the CUDA cores: kernels built for the
//   exact G, kLPR lanes a K row (two 16-byte chunks a lane where the
//   query rows fit in registers), each warp its own online softmax over
//   its rows, P through shared memory to P·V with the lanes over the
//   head dims, one merge of the 8 warps.
// - Nemotron-4's heads in f32 (G = 12 query heads a kv head, hd = 192):
//   a row of 192 is 48 chunks, not a power of two, so a lane reads three
//   chunks of it (kLPR = 16 lanes a row). The G · hd query values a lane
//   group would keep in registers do not fit beside the 12 · 6 P·V
//   accumulators, so where a lane's share passes 64 values the query
//   rows stay in shared memory, chunk-major, and each score reads them
//   there: the lanes of one chunk index share the address across the
//   rows (a broadcast), consecutive chunk indices hit consecutive banks.
//   Those kernels keep one block of 255 registers a thread on an SM
//   (kMinBlocks).
// - Softmax in log2 units: scores are scaled by scale·log2(e) and
//   exponentiated with exp2f.
// - A scalar kv_length (the decode path's Python int) is a kernel
//   argument; the wrapper then launches this kernel and nothing else.
//
// At a long cache (C = 32K) the blocks stream their tiles at ~2–3 TB/s
// and the device time is set by the device memory; the split count keeps
// every block in one wave (num_splits).
#include <algorithm>
#include <cmath>

#include "common.cuh"

namespace {

using repro_torch::from_f;
using repro_torch::kFullMask;
using repro_torch::kNegInf;
using repro_torch::to_f;
using repro_torch::warp_max;
using repro_torch::warp_sum;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;           // tiles of the ring
constexpr int kBlocksPerSM = 2;      // resident blocks an SM (num_splits)
constexpr int kMaxD = 192;           // largest head dim
constexpr int kMaxG = 12;            // most query heads a kv head
constexpr int kMaxSplits = 512;
constexpr int kCombineThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

struct CacheStrides {
  long long b, c, h;  // element strides; the head dim is contiguous
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* kvl;     // (B,) valid slots, or null: kvl_s for every row
  int kvl_s;
  void* o;
  float* part_acc;    // (B, Kv, splits, G, hd) when splits > 1
  float* part_ml;     // (B, Kv, splits, G, 2): m, l
  CacheStrides sk, sv;
  int C, Kv, G, hd, splits, per_split;
  float scale2;       // scale · log2(e)
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// src_bytes < 16 fills the rest of the 16 bytes with zeros
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The lane layout of one (dtype, head-dim bucket, query-head bucket):
// a K row of kHD elements is kChunks 16-byte chunks, read by kLPR lanes
// kCPL chunks each (two where the query rows fit in registers, so a
// score needs one shuffle level less; three at kHD = 192, whose chunk
// count is 3 · 2^k); a tile is kSteps row steps of every warp; in P·V
// each lane owns kDPL consecutive dims. kQShared: the query rows are
// read from shared memory, not registers. Only f32 is built on it.
template <typename T, int kHD, int kG>
struct Shape {
  static constexpr int kVec = 16 / sizeof(T);   // elements a chunk
  static constexpr int kChunks = kHD / kVec;
  static constexpr bool kThirds = kChunks % 3 == 0;
  static constexpr int kCPL = kThirds ? 3 : (kG <= 4 && kChunks >= 2) ? 2 : 1;
  static constexpr int kLPR = kChunks / kCPL;   // a power of two
  static constexpr int kRowsPerStep = 32 / kLPR;
  static constexpr int kSteps = kThirds ? 1 : 2 / kCPL;
  static constexpr int kRowsW = kSteps * kRowsPerStep;   // a warp's rows
  static constexpr int kTk = kWarps * kRowsW;             // keys a tile
  static constexpr int kGp = (kG + 3) / 4 * 4;            // P row stride
  static constexpr int kDPL = kHD / 32;
  static constexpr bool kQShared = kG * kCPL * kVec > 64;
  static constexpr int kMinBlocks = (kG > 8 || kHD > 128) ? 1 : kBlocksPerSM;
  static constexpr int kPlanes = kVec / 4;   // float4 planes of a q chunk
};
static_assert(Shape<float, 192, 12>::kLPR == 16,
              "a 192-wide row is read 3 chunks a lane");

template <int kBytes>
struct Bits;
template <>
struct Bits<4> { using type = unsigned int; };
template <>
struct Bits<8> { using type = uint2; };
template <>
struct Bits<16> { using type = uint4; };

// kN consecutive elements at src (aligned to their total size) as f32,
// in one load
template <typename T, int kN>
__device__ __forceinline__ void load_vec(const T* src, float (&dst)[kN]) {
  using V = typename Bits<kN * sizeof(T)>::type;
  const V raw = *reinterpret_cast<const V*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kN; ++i) dst[i] = to_f(e[i]);
}

// kN = 2^k elements in one load (load_vec), kN = 3 · 2^k in three
// (aligned to a third of their total size)
template <typename T, int kN>
__device__ __forceinline__ void load_dims(const T* src, float (&dst)[kN]) {
  if constexpr ((kN & (kN - 1)) == 0) {
    load_vec<T, kN>(src, dst);
  } else {
    constexpr int kP = kN / 3;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      float part[kP];
      load_vec<T, kP>(src + p * kP, part);
#pragma unroll
      for (int i = 0; i < kP; ++i) dst[p * kP + i] = part[i];
    }
  }
}

// f32: one block per (split, kv head, batch row), 8 warps, on the CUDA
// cores. Each warp scores
// its rows of every staged tile (kLPR lanes a row, reduced by shuffles),
// keeps its own online softmax over them, and accumulates P·V with its
// lanes over the head dims, P read back from shared memory; the warps
// merge once, at the end. kHD >= hd and kG >= G (the query heads of a
// kv head) are the buckets the kernel was built for.
template <typename T, int kHD, int kG>
__global__ void __launch_bounds__(kThreads, Shape<T, kHD, kG>::kMinBlocks)
flash_decode_kernel(const Args p) {
  using S = Shape<T, kHD, kG>;
  constexpr int kVec = S::kVec, kLPR = S::kLPR, kCPL = S::kCPL;
  constexpr int kTk = S::kTk, kDPL = S::kDPL;
  constexpr int kQR = S::kQShared ? 1 : kG;   // query rows in registers
  extern __shared__ __align__(16) unsigned char stage[];
  __shared__ __align__(16) float pw[kWarps][S::kRowsW][S::kGp];
  __shared__ float m_w[kWarps][kG], l_w[kWarps][kG];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / kLPR, c = lane % kLPR;  // row in the step, chunk
  const int G = p.G, hd = p.hd;
  const int chunks = hd / kVec;
  const int rowb = hd * static_cast<int>(sizeof(T));   // staged row pitch
  const int len = p.kvl ? p.kvl[b] : p.kvl_s;
  const bool empty = len <= 0;
  const int span = empty ? p.C : min(len, p.C);
  const int start = split * p.per_split;
  const int end = min(start + p.per_split, span);
  const int ntiles = end > start ? (end - start + kTk - 1) / kTk : 0;
  const T* kb = static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h;

  auto fetch = [&](int t) {  // tile t's K and V rows into its ring slot
    if (t < ntiles) {
      unsigned char* ks = stage + (t % kStages) * 2 * kTk * rowb;
      unsigned char* vs = ks + kTk * rowb;
      const int j0 = start + t * kTk;
      const int rows = min(kTk, end - j0);
      for (int idx = threadIdx.x; idx < rows * S::kChunks;
           idx += kThreads) {
        const int rr = idx / S::kChunks, cc = idx % S::kChunks;
        if (cc < chunks) {
          cp_async16(ks + rr * rowb + cc * 16,
                     kb + (long long)(j0 + rr) * p.sk.c + cc * kVec);
          cp_async16(vs + rr * rowb + cc * 16,
                     vb + (long long)(j0 + rr) * p.sv.c + cc * kVec);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) fetch(t);

  // this lane's chunks (c, c + kLPR, ...) of the G query rows, in
  // registers, while the copies fly; or all kG rows (zeros past G) in
  // shared memory past the ring and the merge, as f32 (kG, kPlanes,
  // kChunks, 4): element i of chunk ch at plane i / 4
  const int H = p.Kv * G;
  const T* qb = static_cast<const T*>(p.q) + ((long long)b * H + kvh * G) * hd;
  float qf[kQR][kCPL * kVec];
  float* qw = reinterpret_cast<float*>(
      stage + max(kStages * 2 * kTk * rowb, kWarps * G * hd * 4));
  const float4* qs = reinterpret_cast<const float4*>(qw);
  if constexpr (S::kQShared) {
    for (int idx = threadIdx.x; idx < kG * kHD; idx += kThreads) {
      const int g = idx / kHD, d = idx % kHD;
      const int ch = d / kVec, i = d % kVec;
      qw[((g * S::kPlanes + i / 4) * S::kChunks + ch) * 4 + i % 4] =
          g < G && d < hd ? to_f(qb[g * hd + d]) : 0.f;
    }
  } else {
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int j = 0; j < kCPL; ++j) {
        const int ch = c + j * kLPR;
        float e[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) e[i] = 0.f;
        if (g < G && ch < chunks) load_vec(qb + g * hd + ch * kVec, e);
#pragma unroll
        for (int i = 0; i < kVec; ++i) qf[g][j * kVec + i] = e[i];
      }
  }
  // this warp's online softmax (every lane holds m and l) and this
  // lane's dims of its P·V
  float m[kG], l[kG], acc[kG][kDPL];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[g][i] = 0.f;
  }
  const bool dims_live = lane * kDPL < hd;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile t
    __syncthreads();                // everyone's; slot t - 1 is free
    fetch(t + kStages - 1);
    const unsigned char* ks = stage + (t % kStages) * 2 * kTk * rowb;
    const unsigned char* vs = ks + kTk * rowb;
    const int rows = min(kTk, end - (start + t * kTk));

    // scores of this lane's rows; a row past the tile's end scores -inf,
    // so it weighs 0
    float s[S::kSteps][kG];
#pragma unroll
    for (int st = 0; st < S::kSteps; ++st) {
      const int rr = (st * kWarps + warp) * S::kRowsPerStep + r;
#pragma unroll
      for (int g = 0; g < kG; ++g) s[st][g] = 0.f;
#pragma unroll
      for (int j = 0; j < kCPL; ++j) {
        const int ch = c + j * kLPR;
        if (rr < rows && ch < chunks) {
          float kf[kVec];
          load_vec(reinterpret_cast<const T*>(ks + rr * rowb + ch * 16), kf);
          if constexpr (S::kQShared) {
#pragma unroll
            for (int g = 0; g < kG; ++g)
#pragma unroll
              for (int pl = 0; pl < S::kPlanes; ++pl) {
                const float4 x =
                    qs[(g * S::kPlanes + pl) * S::kChunks + ch];
                s[st][g] += x.x * kf[4 * pl];
                s[st][g] += x.y * kf[4 * pl + 1];
                s[st][g] += x.z * kf[4 * pl + 2];
                s[st][g] += x.w * kf[4 * pl + 3];
              }
          } else {
#pragma unroll
            for (int i = 0; i < kVec; ++i)
#pragma unroll
              for (int g = 0; g < kG; ++g)
                s[st][g] += qf[g][j * kVec + i] * kf[i];
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
#pragma unroll
        for (int o = kLPR / 2; o > 0; o >>= 1)
          s[st][g] += __shfl_xor_sync(kFullMask, s[st][g], o);
        s[st][g] = rr >= rows ? -INFINITY
                   : empty    ? kNegInf
                              : s[st][g] * p.scale2;
      }
    }
    // the warp's statistics over its rows of the tile; P to shared memory
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int st = 1; st < S::kSteps; ++st) mx = fmaxf(mx, s[st][g]);
#pragma unroll
      for (int o = kLPR; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float a = exp2f(m[g] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int st = 0; st < S::kSteps; ++st) {
        s[st][g] = exp2f(s[st][g] - m_new);
        sum += s[st][g];
      }
#pragma unroll
      for (int o = kLPR; o < 32; o <<= 1)
        sum += __shfl_xor_sync(kFullMask, sum, o);
      l[g] = a * l[g] + sum;
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < kDPL; ++i) acc[g][i] *= a;
    }
    if (c == 0) {
#pragma unroll
      for (int st = 0; st < S::kSteps; ++st)
#pragma unroll
        for (int g = 0; g < kG; ++g)
          pw[warp][st * S::kRowsPerStep + r][g] = s[st][g];
    }
    __syncwarp();
    // P·V over the warp's rows, this lane's kDPL dims
    if (dims_live) {
#pragma unroll
      for (int st = 0; st < S::kSteps; ++st)
#pragma unroll
        for (int rl = 0; rl < S::kRowsPerStep; ++rl) {
          const int rr = (st * kWarps + warp) * S::kRowsPerStep + rl;
          if (rr < rows) {
            float vf[kDPL], pr[S::kGp];
            load_dims(reinterpret_cast<const T*>(vs + rr * rowb) + lane * kDPL,
                      vf);
            const float4* p4 = reinterpret_cast<const float4*>(
                pw[warp][st * S::kRowsPerStep + rl]);
#pragma unroll
            for (int k = 0; k < S::kGp / 4; ++k) {
              const float4 x = p4[k];
              pr[4 * k] = x.x;
              pr[4 * k + 1] = x.y;
              pr[4 * k + 2] = x.z;
              pr[4 * k + 3] = x.w;
            }
#pragma unroll
            for (int g = 0; g < kG; ++g)
#pragma unroll
              for (int i = 0; i < kDPL; ++i) acc[g][i] += pr[g] * vf[i];
          }
        }
    }
  }

  // merge the warps' states through the ring's memory
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(stage);   // (kWarps, G, hd)
  if (dims_live) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
      if (g < G)
#pragma unroll
        for (int i = 0; i < kDPL; ++i)
          if (lane * kDPL + i < hd)
            red[(warp * G + g) * hd + lane * kDPL + i] = acc[g][i];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      m_w[warp][g] = m[g];
      l_w[warp][g] = l[g];
    }
  }
  __syncthreads();
  const long long bh = (long long)b * p.Kv + kvh;
  for (int idx = threadIdx.x; idx < G * hd; idx += kThreads) {
    const int g = idx / hd;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, m_w[w][g]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(m_w[w][g] - mm);
      a += f * red[w * G * hd + idx];
      ll += f * l_w[w][g];
    }
    if (p.splits == 1) {
      static_cast<T*>(p.o)[bh * G * hd + idx] =
          from_f<T>(a / fmaxf(ll, 1e-30f));
    } else {
      p.part_acc[((bh * p.splits + split) * G) * hd + idx] = a;
      if (idx % hd == 0) {
        float* ml = p.part_ml + ((bh * p.splits + split) * G + g) * 2;
        ml[0] = mm;
        ml[1] = ll;
      }
    }
  }
}

// ------------------------------------------- bf16, hd <= 64: tensor cores

using bf16 = __nv_bfloat16;
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaD = 64;              // head dim the kernel is built for
constexpr int kMmaLD = kMmaD + 8;      // staged row pitch, in elements
constexpr int kMmaTk = 64;             // keys a tile
static_assert(kMmaWarps * 16 == kMmaD, "a warp takes 16 dims of P V");

// four 8x8 b16 matrices; lanes 8m..8m+7 give the row addresses of matrix m
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c (16x8 f32) += a (16x16 bf16, row) · b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The serving step's kernel (bf16, hd <= 64): one block of 4 warps per
// (split, kv head, batch row), the same staging, splits and masking as
// flash_decode_kernel, but S = Q Kᵀ and O += P V on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulators), so the chains of
// shuffles and FMAs after the tiles land shrink to a few MMAs. The G
// query rows of the kv head are rows 0..G-1 of a 16-row A fragment
// (rows G..15 zero). Every warp scores all 64 keys of a tile (S is 32
// MMAs, cheap) and so holds the whole online softmax itself; it then
// accumulates P V for its own 16 of the 64 head dims and writes them:
// no merge between warps, no barrier after the last tile. P is carried
// as hi + lo bf16 terms (two MMAs), as in K7, so a weight keeps 2^-17
// of its value. Rows are staged with an 8-element pad so the ldmatrix
// row fetches hit distinct banks; slots past the range and columns past
// hd are zero-filled, so a padded key weighs 0 against a zero V row.
__global__ void __launch_bounds__(kMmaThreads, kBlocksPerSM)
flash_decode_mma_kernel(const Args p) {
  constexpr int KC = kMmaD / 16;        // 16-wide k chunks of hd
  constexpr int NT = kMmaTk / 8;        // 8-key n tiles of S
  constexpr int kTile = kMmaTk * kMmaLD;   // elements of one K or V tile
  extern __shared__ __align__(16) unsigned char stage[];
  bf16* ring = reinterpret_cast<bf16*>(stage);   // slots of {K, V} tiles

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t4 = lane % 4;   // query row, key/column pair
  const int G = p.G, hd = p.hd;
  const int len = p.kvl ? p.kvl[b] : p.kvl_s;
  const bool empty = len <= 0;
  const int span = empty ? p.C : min(len, p.C);
  const int start = split * p.per_split;
  const int end = min(start + p.per_split, span);
  const int ntiles = end > start ? (end - start + kMmaTk - 1) / kMmaTk : 0;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.sv.b + kvh * p.sv.h;

  auto fetch = [&](int t) {  // tile t's K and V rows into its ring slot
    if (t < ntiles) {
      bf16* ks = ring + (t % kStages) * 2 * kTile;
      bf16* vs = ks + kTile;
      const int j0 = start + t * kMmaTk;
      const int rows = min(kMmaTk, end - j0);
      constexpr int kCh = kMmaD / 8;
      for (int idx = threadIdx.x; idx < kMmaTk * kCh; idx += kMmaThreads) {
        const int rr = idx / kCh, cc = (idx % kCh) * 8;
        const bool ok = rr < rows && cc < hd;
        cp_async16_zfill(ks + rr * kMmaLD + cc,
                         ok ? kb + (long long)(j0 + rr) * p.sk.c + cc : kb,
                         ok ? 16 : 0);
        cp_async16_zfill(vs + rr * kMmaLD + cc,
                         ok ? vb + (long long)(j0 + rr) * p.sv.c + cc : vb,
                         ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) fetch(t);

  // Q as the A fragments of its KC k chunks: row gq (rows 8..15 zero)
  unsigned qa[KC][4];
  const long long bh = (long long)b * p.Kv + kvh;
  const bf16* qrow = static_cast<const bf16*>(p.q) + (bh * G + gq) * hd;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c0 = kc * 16 + 2 * t4, c1 = c0 + 8;
    qa[kc][0] = gq < G && c0 < hd
                    ? *reinterpret_cast<const unsigned*>(qrow + c0) : 0u;
    qa[kc][2] = gq < G && c1 < hd
                    ? *reinterpret_cast<const unsigned*>(qrow + c1) : 0u;
    qa[kc][1] = qa[kc][3] = 0u;
  }
  // the online softmax of row gq (l: this lane's part of the row sum),
  // and this warp's two 8-dim n tiles of O (rows gq and gq + 8)
  float m = kNegInf, l = 0.f;
  float oacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile t
    __syncthreads();                // everyone's; slot t - 1 is free
    fetch(t + kStages - 1);
    const bf16* Kt = ring + (t % kStages) * 2 * kTile;
    const bf16* Vt = Kt + kTile;
    const int rows = min(kMmaTk, end - (start + t * kMmaTk));

    // S = Q Kᵀ for the tile's 64 keys: NT n tiles of 8
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned kf[4];
        ldsm_x4(kf, Kt + (np * 16 + (lane % 8) + 8 * (lane / 16)) * kMmaLD +
                        kc * 16 + 8 * ((lane / 8) & 1));
        mma_bf16(s[2 * np], qa[kc], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa[kc], kf[2], kf[3]);
      }
    // row gq's scores (e = 0, 1; e = 2, 3 are the zero rows): a slot past
    // the range scores -inf, so it weighs 0
    float tmax = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kt = nt * 8 + 2 * t4 + e;
        s[nt][e] = kt >= rows ? -INFINITY
                   : empty    ? kNegInf
                              : s[nt][e] * p.scale2;
        tmax = fmaxf(tmax, s[nt][e]);
      }
    tmax = fmaxf(tmax, __shfl_xor_sync(kFullMask, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(kFullMask, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = exp2f(m - m_new);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m);
        l += s[nt][e];
      }
      s[nt][2] = s[nt][3] = 0.f;
    }
#pragma unroll
    for (int dt = 0; dt < 2; ++dt) {
      oacc[dt][0] *= alpha;
      oacc[dt][1] *= alpha;
    }

    // O += P V over this warp's 16 dims, P as hi + lo bf16: the S
    // accumulators of n tiles 2kc and 2kc + 1 are the A fragment of the
    // 16-key chunk kc
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      unsigned ph[4], pl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x0 = s[2 * kc + i / 2][2 * (i & 1)];
        const float x1 = s[2 * kc + i / 2][2 * (i & 1) + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            x0 - __low2float(hi), x1 - __high2float(hi));
        ph[i] = *reinterpret_cast<const unsigned*>(&hi);
        pl[i] = *reinterpret_cast<const unsigned*>(&lo);
      }
      unsigned vf[4];
      ldsm_x4_trans(vf, Vt + (kc * 16 + (lane % 8) + 8 * ((lane / 8) & 1)) *
                                 kMmaLD +
                            warp * 16 + 8 * (lane / 16));
      mma_bf16(oacc[0], pl, vf[0], vf[1]);
      mma_bf16(oacc[1], pl, vf[2], vf[3]);
      mma_bf16(oacc[0], ph, vf[0], vf[1]);
      mma_bf16(oacc[1], ph, vf[2], vf[3]);
    }
  }

  // row gq's sum over the quad; then this warp's dims of row gq
  l += __shfl_xor_sync(kFullMask, l, 1);
  l += __shfl_xor_sync(kFullMask, l, 2);
  if (gq >= G) return;
  if (p.splits == 1) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* orow = static_cast<bf16*>(p.o) + (bh * G + gq) * hd;
#pragma unroll
    for (int dt = 0; dt < 2; ++dt) {
      const int d = warp * 16 + dt * 8 + 2 * t4;
      if (d < hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(oacc[dt][0] * inv, oacc[dt][1] * inv);
    }
  } else {
    const long long row = (bh * p.splits + split) * G + gq;
    float* arow = p.part_acc + row * hd;
#pragma unroll
    for (int dt = 0; dt < 2; ++dt) {
      const int d = warp * 16 + dt * 8 + 2 * t4;
      if (d < hd)
        *reinterpret_cast<float2*>(arow + d) =
            make_float2(oacc[dt][0], oacc[dt][1]);
    }
    if (warp == 0 && t4 == 0) {
      p.part_ml[row * 2] = m;
      p.part_ml[row * 2 + 1] = l;
    }
  }
}

// --------------------- bf16, hd in (64, 192] or G in 9..12: tensor cores

constexpr int kWideWarps = 4;
constexpr int kWideThreads = kWideWarps * 32;
constexpr int kWideTk = kWideWarps * 16;   // keys a tile: 16 a warp

// The ring of one head-dim bucket: rows staged with an 8-element pad
// (kLD), kStages tiles of 64 keys of K and V; kBlocksPerSM blocks an SM
// (`blocks_per_sm` in decode_attention/flash_decode.py). Timed in
// turns on the H100 (tools/probe_k1_k8.py's k8_parent step): at hd 192
// two blocks of 2 stages beat one block of 4 (5 % on a full 32K cache,
// 26 % on decode_32k's 68-slot step, where a second block hides a
// block's first trip); at hd 128 one block of 4 stages was within 3 %
// of two blocks of 3 on the long caches and 36 % slower on the 68-slot
// step.
template <int kHD>
struct Wide {
  static constexpr int kLD = kHD + 8;
  static constexpr int kTile = kWideTk * kLD;   // elements of a K or V tile
  static constexpr int kStages = kHD <= 128 ? 3 : 2;
  static constexpr int kSmem = kStages * 2 * kTile * 2;   // bytes
  static constexpr int KC = kHD / 16;   // 16-wide k chunks of S
  static constexpr int NT = kHD / 8;    // 8-dim n tiles of O
};
// the blocks' rings, merge state (< 1 KB) and 1 KB reserved a block fit
// an SM (228 KB); the merge of the warps' O fits the ring
constexpr int kWideBlockExtra = 1024 + 1024;
static_assert(kBlocksPerSM * (Wide<128>::kSmem + kWideBlockExtra) <= 233472 &&
                  kBlocksPerSM * (Wide<192>::kSmem + kWideBlockExtra) <=
                      233472,
              "the ring fits the SM at its residency");
static_assert(kWideWarps * kMaxG * (kMaxD + 8) * 4 <= Wide<192>::kSmem &&
                  kWideWarps * kMaxG * (128 + 8) * 4 <= Wide<128>::kSmem,
              "the warps' partial O fit the ring");

// One block of 4 warps per (split, kv head, batch row), the staging,
// splits and masking of flash_decode_mma_kernel. The G query rows are
// rows 0..G-1 of the 16-row A fragment: row gq in registers 0 and 2,
// row gq + 8 in 1 and 3 (zero past G). Warp w takes keys 16w..16w+15 of
// every tile: S for its slice is 2 n tiles (KC MMAs each), its online
// softmax (m, l for rows gq and gq + 8, in log2 units) and O += P V over
// all kHD dims (NT n tiles, 2 KC MMAs each, P as hi + lo bf16 as in the
// hd <= 64 kernel, so a weight keeps 2^-17 of its value). After the
// last tile the warps' (m, l, O) merge through the ring's memory: each
// row's 4 warp weights are computed once, then every thread sums 4 dims
// of the 4 partial O a step. With one warp a scheduler nothing hides a
// latency, and an exp2, a division and a chain of shared-memory loads
// for every output element took ~7,900 SM cycles at G = 12, hd = 192,
// more than staging and the key loop (clock64() phases,
// tools/probe_k1_k8.py).
template <int kHD>
__global__ void __launch_bounds__(kWideThreads, kBlocksPerSM)
flash_decode_wide_kernel(const Args p) {
  using W = Wide<kHD>;
  constexpr int kLD = W::kLD, kTile = W::kTile, kStages = W::kStages;
  constexpr int KC = W::KC, NT = W::NT;
  extern __shared__ __align__(16) unsigned char stage[];
  bf16* ring = reinterpret_cast<bf16*>(stage);   // slots of {K, V} tiles
  // the warps' (m, l) of each row, then their merge weights
  __shared__ float m_w[kWideWarps][kMaxG], l_w[kWideWarps][kMaxG];
  __shared__ float f_w[kWideWarps][kMaxG];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t4 = lane % 4;   // query row, key/column pair
  const int G = p.G, hd = p.hd;
  const int len = p.kvl ? p.kvl[b] : p.kvl_s;
  const bool empty = len <= 0;
  const int span = empty ? p.C : min(len, p.C);
  const int start = split * p.per_split;
  const int end = min(start + p.per_split, span);
  const int ntiles = end > start ? (end - start + kWideTk - 1) / kWideTk : 0;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.sv.b + kvh * p.sv.h;

  auto fetch = [&](int t) {  // tile t's K and V rows into its ring slot
    if (t < ntiles) {
      bf16* ks = ring + (t % kStages) * 2 * kTile;
      bf16* vs = ks + kTile;
      const int j0 = start + t * kWideTk;
      const int rows = min(kWideTk, end - j0);
      constexpr int kCh = kHD / 8;
      for (int idx = threadIdx.x; idx < kWideTk * kCh; idx += kWideThreads) {
        const int rr = idx / kCh, cc = (idx % kCh) * 8;
        const bool ok = rr < rows && cc < hd;
        cp_async16_zfill(ks + rr * kLD + cc,
                         ok ? kb + (long long)(j0 + rr) * p.sk.c + cc : kb,
                         ok ? 16 : 0);
        cp_async16_zfill(vs + rr * kLD + cc,
                         ok ? vb + (long long)(j0 + rr) * p.sv.c + cc : vb,
                         ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) fetch(t);

  // Q as the A fragments of its KC k chunks: rows gq and gq + 8
  unsigned qa[KC][4];
  const long long bh = (long long)b * p.Kv + kvh;
  const bf16* q0 = static_cast<const bf16*>(p.q) + bh * G * hd;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = gq + 8 * (i & 1), c = kc * 16 + 2 * t4 + 8 * (i / 2);
      qa[kc][i] = g < G && c < hd
                      ? *reinterpret_cast<const unsigned*>(q0 + g * hd + c)
                      : 0u;
    }
  // the online softmax of rows gq and gq + 8 (l: this lane's part of
  // each row sum) and O over all dims: o[nt][0..1] row gq, [2..3] gq + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile t
    __syncthreads();                // everyone's; slot t - 1 is free
    fetch(t + kStages - 1);
    // this warp's 16 keys of the tile; a slice wholly past the range
    // weighs 0 and is skipped
    const int keys = min(kWideTk, end - (start + t * kWideTk)) - warp * 16;
    if (keys <= 0) continue;
    const bf16* Kt = ring + (t % kStages) * 2 * kTile + warp * 16 * kLD;
    const bf16* Vt = Kt + kTile;

    // S = Q Kᵀ over the slice: n tiles of keys 0..7 and 8..15
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      unsigned kf[4];
      ldsm_x4(kf, Kt + ((lane % 8) + 8 * (lane / 16)) * kLD + kc * 16 +
                      8 * ((lane / 8) & 1));
      mma_bf16(s[0], qa[kc], kf[0], kf[1]);
      mma_bf16(s[1], qa[kc], kf[2], kf[3]);
    }
    // e = 0, 1: row gq; e = 2, 3: row gq + 8. A key past the range
    // scores -inf, so it weighs 0
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kt = nt * 8 + 2 * t4 + (e & 1);
        s[nt][e] = kt >= keys ? -INFINITY
                   : empty    ? kNegInf
                              : s[nt][e] * p.scale2;
        tmax[e / 2] = fmaxf(tmax[e / 2], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(kFullMask, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(kFullMask, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m[e / 2]);
        l[e / 2] += s[nt][e];
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // P as the A fragment of the slice's 16 keys, hi + lo bf16
    unsigned ph[4], pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = s[i / 2][2 * (i & 1)];
      const float x1 = s[i / 2][2 * (i & 1) + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          x0 - __low2float(hi), x1 - __high2float(hi));
      ph[i] = *reinterpret_cast<const unsigned*>(&hi);
      pl[i] = *reinterpret_cast<const unsigned*>(&lo);
    }
    // O += P V, two n tiles of dims a V fragment
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned vf[4];
      ldsm_x4_trans(vf, Vt + ((lane % 8) + 8 * ((lane / 8) & 1)) * kLD +
                            np * 16 + 8 * (lane / 16));
      mma_bf16(o[2 * np], pl, vf[0], vf[1]);
      mma_bf16(o[2 * np + 1], pl, vf[2], vf[3]);
      mma_bf16(o[2 * np], ph, vf[0], vf[1]);
      mma_bf16(o[2 * np + 1], ph, vf[2], vf[3]);
    }
  }

  // merge the warps' states through the ring's memory:
  // red (kWideWarps, G, kLD) f32, row pitch kLD so the quads' float2
  // stores of 8 rows spread over the banks
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(stage);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFullMask, l[r], 1);
    l[r] += __shfl_xor_sync(kFullMask, l[r], 2);
    const int g = gq + 8 * r;
    if (g < G) {
      float* row = red + (warp * G + g) * kLD;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int d = nt * 8 + 2 * t4;
        if (d < hd)
          *reinterpret_cast<float2*>(row + d) =
              make_float2(o[nt][2 * r], o[nt][2 * r + 1]);
      }
      if (t4 == 0) {
        m_w[warp][g] = m[r];
        l_w[warp][g] = l[r];
      }
    }
  }
  __syncthreads();
  // each row's weights once: warp w's share exp2(m_w - M), over the row
  // sum L where this block writes the output; (M, L) to the combine
  // where there are splits
  if (threadIdx.x < G * kWideWarps) {
    const int g = threadIdx.x / kWideWarps, w = threadIdx.x % kWideWarps;
    float mm = kNegInf;
#pragma unroll
    for (int ww = 0; ww < kWideWarps; ++ww) mm = fmaxf(mm, m_w[ww][g]);
    float ll = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWideWarps; ++ww)
      ll += exp2f(m_w[ww][g] - mm) * l_w[ww][g];
    const float e = exp2f(m_w[w][g] - mm);
    f_w[w][g] = p.splits == 1 ? e / fmaxf(ll, 1e-30f) : e;
    if (p.splits > 1 && w == 0) {
      float* ml = p.part_ml + ((bh * p.splits + split) * G + g) * 2;
      ml[0] = mm;
      ml[1] = ll;
    }
  }
  __syncthreads();
  // the weighted sum of the warps' O, 4 dims a thread
  const int hd4 = hd / 4;
  for (int it = threadIdx.x; it < G * hd4; it += kWideThreads) {
    const int g = it / hd4, d = (it - g * hd4) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWideWarps; ++w) {
      const float f = f_w[w][g];
      const float4 x =
          *reinterpret_cast<const float4*>(red + (w * G + g) * kLD + d);
      a.x += f * x.x;
      a.y += f * x.y;
      a.z += f * x.z;
      a.w += f * x.w;
    }
    if (p.splits == 1) {
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(
          static_cast<bf16*>(p.o) + (bh * G + g) * hd + d);
      o2[0] = __floats2bfloat162_rn(a.x, a.y);
      o2[1] = __floats2bfloat162_rn(a.z, a.w);
    } else {
      *reinterpret_cast<float4*>(
          p.part_acc + ((bh * p.splits + split) * G + g) * hd + d) = a;
    }
  }
}

// Merge the splits of one (kv head, batch row, query head): the
// weights exp2(m_s - M) and the denominator by block reductions (each
// thread holds its splits' (m, l) pairs, read once), then each float4
// column of the partial sums, the splits divided among thread groups
// whose loads are independent. Its time is two round trips to the L2,
// where the partials were just written.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
flash_decode_combine_kernel(const Args p) {
  constexpr int kWarpsC = kCombineThreads / 32;
  constexpr int kPer = kMaxSplits / kCombineThreads;   // splits a thread
  __shared__ float w[kMaxSplits];
  __shared__ float part[kWarpsC];
  __shared__ float4 red[kCombineThreads];
  const int kvh = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = p.G, hd = p.hd, S = p.splits;
  const long long row0 = ((long long)b * p.Kv + kvh) * S * G + g;  // split 0
  const float2* ml = reinterpret_cast<const float2*>(p.part_ml);

  float2 v[kPer];
  float mx = kNegInf;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int s = threadIdx.x + i * kCombineThreads;
    v[i] = s < S ? ml[row0 + (long long)s * G] : make_float2(kNegInf, 0.f);
    mx = fmaxf(mx, v[i].x);
  }
  mx = warp_max(mx);
  if (lane == 0) part[warp] = mx;
  __syncthreads();
  float M = kNegInf;
#pragma unroll
  for (int k = 0; k < kWarpsC; ++k) M = fmaxf(M, part[k]);
  float l = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int s = threadIdx.x + i * kCombineThreads;
    if (s < S) {
      const float ws = exp2f(v[i].x - M);
      w[s] = ws;
      l += ws * v[i].y;
    }
  }
  l = warp_sum(l);
  __syncthreads();                 // every thread has read part[] as M
  if (lane == 0) part[warp] = l;
  __syncthreads();
  float L = 0.f;
#pragma unroll
  for (int k = 0; k < kWarpsC; ++k) L += part[k];

  const int items = hd / 4;                      // float4 columns
  const int groups = kCombineThreads / items;    // >= 5: hd <= 192
  const int item = threadIdx.x % items, grp = threadIdx.x / items;
  const float4* acc4 = reinterpret_cast<const float4*>(p.part_acc);
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (grp < groups) {
#pragma unroll 4
    for (int s = grp; s < S; s += groups) {
      const float ws = w[s];
      const float4 x = acc4[(row0 + (long long)s * G) * items + item];
      a.x += ws * x.x;
      a.y += ws * x.y;
      a.z += ws * x.z;
      a.w += ws * x.w;
    }
  }
  red[threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.x < items) {
    for (int k = 1; k < groups; ++k) {
      const float4 x = red[k * items + threadIdx.x];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    const float inv_l = 1.f / fmaxf(L, 1e-30f);
    T* ob = static_cast<T*>(p.o) +
            (((long long)b * p.Kv + kvh) * G + g) * hd + item * 4;
    ob[0] = from_f<T>(a.x * inv_l);
    ob[1] = from_f<T>(a.y * inv_l);
    ob[2] = from_f<T>(a.z * inv_l);
    ob[3] = from_f<T>(a.w * inv_l);
  }
}

template <typename T, int kHD, int kG>
cudaError_t launch_split(const Args& a, int B, cudaStream_t stream) {
  using S = Shape<T, kHD, kG>;
  constexpr int kTk = S::kTk;
  constexpr int kQBytes = S::kQShared ? kG * kHD * 4 : 0;
  const int rowb = a.hd * static_cast<int>(sizeof(T));
  // the ring, or the merge of the warps' partials if that is larger;
  // then the query rows where they stay in shared memory
  const int smem =
      std::max(kStages * 2 * kTk * rowb,
               kWarps * a.G * a.hd * static_cast<int>(sizeof(float))) +
      kQBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_decode_kernel<T, kHD, kG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      std::max(kStages * 2 * kTk * kHD * static_cast<int>(sizeof(T)),
               kWarps * kG * kHD * static_cast<int>(sizeof(float))) +
          kQBytes);
  if (attr != cudaSuccess) return attr;
  flash_decode_kernel<T, kHD, kG>
      <<<dim3(a.splits, a.Kv, B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int kHD>
cudaError_t launch_g(const Args& a, int B, cudaStream_t stream) {
  if (a.G <= 2) return launch_split<T, kHD, 2>(a, B, stream);
  if (a.G == 3) return launch_split<T, kHD, 3>(a, B, stream);
  if (a.G == 4) return launch_split<T, kHD, 4>(a, B, stream);
  if (a.G <= 8) return launch_split<T, kHD, 8>(a, B, stream);
  return launch_split<T, kHD, 12>(a, B, stream);
}

cudaError_t launch_mma(const Args& a, int B, cudaStream_t stream) {
  constexpr int kSmem =
      kStages * 2 * kMmaTk * kMmaLD * static_cast<int>(sizeof(bf16));
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_decode_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return attr;
  flash_decode_mma_kernel<<<dim3(a.splits, a.Kv, B), kMmaThreads, kSmem,
                            stream>>>(a);
  return cudaGetLastError();
}

template <int kHD>
cudaError_t launch_wide(const Args& a, int B, cudaStream_t stream) {
  constexpr int kSmem = Wide<kHD>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_decode_wide_kernel<kHD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  flash_decode_wide_kernel<kHD>
      <<<dim3(a.splits, a.Kv, B), kWideThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_combine(const Args& a, int B, cudaStream_t stream) {
  flash_decode_combine_kernel<T>
      <<<dim3(a.Kv, B, a.G), kCombineThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// bf16 on the tensor cores: hd <= 64 and G <= 8 (the serving path) on
// the kernel whose warps split the dims, every other call on the one
// whose warps split the keys; f32 on the CUDA cores; then the combine.
// `kernel_for` in decode_attention/flash_decode.py mirrors this.
cudaError_t launch_all(int dtype, const Args& a, int B, cudaStream_t stream) {
  cudaError_t err;
  if (dtype == 1) {
    err = a.hd <= kMmaD && a.G <= 8 ? launch_mma(a, B, stream)
          : a.hd <= 128             ? launch_wide<128>(a, B, stream)
                                    : launch_wide<192>(a, B, stream);
  } else if (a.hd <= 32) {
    err = launch_g<float, 32>(a, B, stream);
  } else if (a.hd <= 64) {
    err = launch_g<float, 64>(a, B, stream);
  } else if (a.hd <= 128) {
    err = launch_g<float, 128>(a, B, stream);
  } else {
    err = launch_g<float, 192>(a, B, stream);
  }
  if (err != cudaSuccess || a.splits == 1) return err;
  return dtype == 1 ? launch_combine<bf16>(a, B, stream)
                    : launch_combine<float>(a, B, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, o: contiguous (B, Kv*G, hd).
// strides: (b, c, h) element strides of the K cache, then of the V cache;
// the head dim of both caches is contiguous, rows 16-byte aligned.
// kvl: (B,) int32 valid slot counts, or null to use kvl_s for every row.
// splits in [1, 512]; with splits > 1, scratch holds B*Kv*splits*G*(hd+2)
// floats, 16-byte aligned. G <= 12, hd <= 192, hd % (16 / elem) == 0, and
// a multiple of 24 above 128 (the f32 kernel's whole lanes of P·V: 6
// dims a lane).
cudaError_t launch_flash_decode(int dtype, const void* q, const void* k,
                                const void* v, const int* kvl, int kvl_s,
                                void* o, float* scratch,
                                const long long* strides, int B, int C,
                                int Kv, int G, int hd, int splits, float scale,
                                cudaStream_t stream) {
  if (B == 0 || Kv == 0) return cudaSuccess;
  if (splits < 1 || splits > kMaxSplits || G > kMaxG || hd > kMaxD ||
      (hd > 128 && hd % 24 != 0))
    return cudaErrorInvalidValue;
  // the slots the splits divide: every row's valid slots, the whole
  // cache for a kv_length of 0 (the mean of V)
  const int span = (kvl == nullptr && kvl_s > 0) ? std::min(kvl_s, C) : C;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.kvl = kvl;
  a.kvl_s = kvl_s;
  a.o = o;
  a.part_acc = scratch;
  a.part_ml = splits > 1 ? scratch + (long long)B * Kv * splits * G * hd
                         : nullptr;
  a.sk = CacheStrides{strides[0], strides[1], strides[2]};
  a.sv = CacheStrides{strides[3], strides[4], strides[5]};
  a.C = C;
  a.Kv = Kv;
  a.G = G;
  a.hd = hd;
  a.splits = splits;
  a.per_split = (span + splits - 1) / splits;
  a.scale2 = scale * kLog2e;
  return launch_all(dtype, a, B, stream);
}
