// K9: the Mamba2 SSD intra-chunk compute. For each (batch b, head h,
// chunk c) of Q tokens, with cum the inclusive cumulative sum of the
// log-decay steps a over the chunk:
//   y[i, p] = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xdt[j, p]
//   S[n, p] = sum_j B[j, n] exp(cum_{Q-1} - cum_j) xdt[j, p]
// over xdt (B, nh, L, hp), a (B, nh, L), Bm / Cm (B, L, N), all float32,
// into y (B, nh, L, hp) and S (B, nh, nc, N, hp), float32. Every operand
// but S is addressed through its own strides, so the models' (B, L, nh,
// hp) activations are read and y is written in place, with no transpose
// copies. Any 1 <= Q, N, hp <= 128.
//
// Replaces: src/repro/kernels/ssd/ssd_scan.py, `ssd_intra_chunk_pallas`
//   (`_ssd_chunk_kernel`).
//
// Bound on the H100: operations at the large grids (Q = N = 128, hp = 64:
// 2Q^2 N for C B^T once per (b, c), 2Q^2 hp + 2QN hp per (b, h, c), on
// ~160 KB of operands); at the adaptation's and the round's grids (B =
// 2-4, one chunk) latency: short chains of loads and products.
//
// Design, two kernels on the caller's stream:
// 1. ssd_state_kernel, over a flat grid: first the C B^T tiles, which
//    compute C B^T once per (b, c), shared by every head (once per head
//    it would be half of all flops), into a (B, nc, Q, Q4) scratch (rows
//    padded to a multiple of 4 floats, so every row is 16-byte aligned):
//    one block a 64 x 64 tile of the lower triangle, C and B rows (64 x N
//    each) in one round of cp.async, 16 rows x 32 columns a warp. Then
//    the S blocks, which do not need C B^T: ceil(N/64) a (b, h, c), 64
//    state rows each. One launch for both lets the few C B^T blocks run
//    beside the S blocks; as a kernel of their own they cost 3-4 us a call
//    at the paths' shapes (PERF.md).
// 2. ssd_y_kernel runs ceil(Q/64) blocks a (b, h, c), 64 query rows each
//    (the later rows first since they see more keys), reading their
//    C B^T rows from the scratch. Tiles, chunks and heads share the
//    grid's x axis (up to 2^31 - 1 blocks; on y they stopped at 65,535
//    head-chunks, 65,536 tokens of jamba's 128 heads), batch rows its z.
//    y and S blocks have 8 warps: warp w takes 16 rows (w % 4) and half
//    of their keys (w / 4), so the longest chain is half a row's keys;
//    the two halves add their partial sums through shared memory at the
//    end, into a tile that all 8 warps then store, 16 bytes a store. At
//    most 80 registers a thread and ~70 KB of shared memory keep three
//    blocks on an SM (hp <= 64). A y block stages its C B^T rows,
//    xdt and the chunk's cumsum; an S block its B slice, xdt and cumsum.
//    Tiles arrive by cp.async (16-byte where the rows are contiguous and
//    aligned, as the models' views are; 4-byte otherwise), all in flight
//    at once. Rows are padded (C B^T to 132 words, xdt to hp + 4, the B
//    slice to 68), so the fragment loads below hit 32 distinct banks.
// Tensor cores, 3xTF32: all three products (C B^T, P xdt, (B sd)^T xdt)
// run on mma.sync m16n8k8 with f32 accumulators; each f32 operand is
// split into hi = tf32(x) (to nearest) and lo = x - hi (truncated to
// tf32), by integer ops, and three MMAs add lo·hi, hi·lo and hi·hi, each
// pass over 8 (or 4) accumulators so consecutive MMAs do not wait on one
// another. The dropped lo·lo and lo's truncation leave at most 5·2^-22
// (20u) relative error per product. P's A fragment is read in a permuted
// k order (k-column t holds key 2t, t + 4 holds key 2t + 1), and xdt's
// rows in the same order, so each thread reads two adjacent keys.
// The decay is a select: above the diagonal cum_i - cum_j can pass 88.7
// and overflow exp, so there the kernel takes exp(0) and multiplies by
// nothing (P = 0), and never forms exp(cum_i - cum_j) for j > i, as the
// plain version masks the exponent. P = (C B^T) ⊙ D is rounded once, and
// so is the S operand B ⊙ exp(cum_last - cum), as the reference forms it.
//
// Accuracy against the float64 bound of chip_smoke.py's check_k9:
// ((1 + (Q + N + 2)u)(1 + eps_D) - 1) (|C||B|^T ⊙ D) @ |xdt| for y. The
// cumsum (warp 0, four steps a lane and a warp scan, in f32) and the
// exps (expf) round as that derivation assumes, so its eps_D term holds.
// Each product's 20u operand error is a per-term relative error, inside
// the bound's per-term allowance ((Q + N + 2)u >= 258u at Q = N = 128).
// The tensor cores do not round their f32 sums to nearest (the MMA
// accumulates with truncation), so a sum of n terms can be off by up to
// 2nu rather than nu in the worst case: the derivation's accumulation
// term holds to within that factor 2 only, and the check measures how
// much of the bound each case uses. The backward pass is recomputation
// through the plain version (`ssd_scan.py`).
#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;       // 8 warps: 4 row groups x 2 halves
constexpr int kTile = 64;           // rows a block
constexpr int kMax = 128;           // largest Q, N and hp
constexpr int kLdC = kMax + 4;      // row stride of C B^T rows, C and B rows
constexpr int kLdB = kTile + 4;     // row stride of the S block's B slice

struct SsdStrides {
  long long xb, xh, xl, xp;         // xdt (B, nh, L, hp)
  long long ab, ah, al;             // a (B, nh, L)
  long long bb, bl, bn;             // Bm (B, L, N)
  long long cb, cl, cn;             // Cm (B, L, N)
  long long yb, yh, yl, yp;         // y (B, nh, L, hp)
};

static_assert(kMax <= 2 * kTile, "C B^T has at most 2 x 2 tiles");

// shared floats of each kernel: the larger of a C B^T tile's C and B rows
// and an S block's B slice, xdt and cum (ssd_state_kernel); the C B^T
// rows, xdt and cum (ssd_y_kernel)
constexpr int state_floats(int hpt) {
  return 2 * kTile * kLdC > kMax * kLdB + kMax * (hpt + 4) + kMax
             ? 2 * kTile * kLdC
             : kMax * kLdB + kMax * (hpt + 4) + kMax;
}
constexpr int y_floats(int hpt) {
  return kTile * kLdC + kMax * (hpt + 4) + kMax;
}

// x = hi + lo in tf32: hi rounds x to nearest, ties away from zero (what
// cvt.rna.tf32.f32 gives, in two integer ops instead of a conversion);
// lo = x - hi is exact in f32 and truncated to tf32 (its low 13 bits
// cleared, which is how the tensor cores read an f32 pattern)
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void split4(const float (&x)[4], unsigned (&hi)[4],
                                       unsigned (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(x[e], hi[e], lo[e]);
}

// c (16x8) += a (16x8, row) · b (8x8, col), tf32 operands, f32 sums (not
// volatile: it touches no memory, so the compiler may interleave MMAs on
// different accumulators)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 over NB n tiles: a · b_i, each b_i = (b[i][0], b[i][1]) split
// here; lo·hi and hi·lo go into small[i], hi·hi into big[i] (the same
// accumulators, or a second set that lengthens the distance between
// dependent MMAs). Each pass walks the NB accumulators, so consecutive
// MMAs never wait on one another.
template <int NB>
__device__ __forceinline__ void mma3(float (*big)[4], float (*small)[4],
                                     const unsigned (&ah)[4],
                                     const unsigned (&al)[4],
                                     const float (&b)[NB][2]) {
  unsigned bh[NB][2], bl[NB][2];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    split(b[i][0], bh[i][0], bl[i][0]);
    split(b[i][1], bh[i][1], bl[i][1]);
  }
#pragma unroll
  for (int i = 0; i < NB; ++i) mma_tf32(small[i], al, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < NB; ++i) mma_tf32(small[i], ah, bl[i][0], bl[i][1]);
#pragma unroll
  for (int i = 0; i < NB; ++i) mma_tf32(big[i], ah, bh[i][0], bh[i][1]);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Start copying dst[r][cc] (row stride ld, a multiple of 4) for r < rows,
// cc < cols (a multiple of 4): src's element at r * rs + cc * cs where
// r < rv and cc < cv, else 0. Asynchronous (cp.async, zero-filled
// outside): 16 bytes a copy where cs == 1 and the rows are 16-byte
// aligned, else 4. cp_async_wait_all and a barrier make them visible.
__device__ __forceinline__ void load_tile(float* dst, int ld, int rows,
                                          int cols, int rv, int cv,
                                          const float* src, long long rs,
                                          long long cs) {
  const bool vec = cs == 1 && rs % 4 == 0 &&
                   reinterpret_cast<std::uintptr_t>(src) % 16 == 0;
  if (vec) {
    const int c4 = cols / 4;
    for (int idx = threadIdx.x; idx < rows * c4; idx += kThreads) {
      const int r = idx / c4, cc = (idx - r * c4) * 4;
      float* d = dst + r * ld + cc;
      if (r < rv && cc + 4 <= cv) {
        cp_async16(d, src + r * rs + cc, 16);
      } else if (r >= rv || cc >= cv) {
        cp_async16(d, src, 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp_async4(d + e, cc + e < cv ? src + r * rs + cc + e : src,
                    cc + e < cv ? 4 : 0);
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int r = idx / cols, cc = idx - r * cols;
    const bool ok = r < rv && cc < cv;
    cp_async4(dst + r * ld + cc, ok ? src + r * rs + cc * cs : src,
              ok ? 4 : 0);
  }
}

// warp 0: the inclusive cumsum of a over the chunk into cum[0, Q), zeros
// in [Q, kMax). Lane l sums steps 4l .. 4l+3 in order, then a warp scan
// of the lane totals gives each lane its offset.
__device__ __forceinline__ void chunk_cumsum(float* cum, const float* ap,
                                             long long al, int Q) {
  const int lane = threadIdx.x;
  float part[4];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = lane * 4 + k;
    run += (i < Q) ? ap[i * al] : 0.f;
    part[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(kFullMask, incl, o);
    if (lane >= o) incl += t;
  }
  float off = __shfl_up_sync(kFullMask, incl, 1);
  if (lane == 0) off = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = lane * 4 + k;
    cum[i] = i < Q ? off + part[k] : 0.f;
  }
}


// C B^T once per (b, c): tile k of the lower triangle, row by row ((0, 0),
// (1, 0), (1, 1)), a block of 8 warps (16 rows x 32 columns each), into
// cbuf (B, nc, Q, Q4)
__device__ __forceinline__ void cb_tile(float* smem, const float* Bm,
                                        const float* Cm, float* cbuf,
                                        const SsdStrides& st, int b, int c,
                                        int k, int nc, int Q, int N, int Q4) {
  const int ti = k > 0, tj = k - ti;
  float* Cs = smem;                 // C rows [i0, i0 + 64), [i][n]
  float* Bs = Cs + kTile * kLdC;    // B rows [j0, j0 + 64), [j][n]
  const int i0 = ti * kTile, j0 = tj * kTile;
  const long long l0 = static_cast<long long>(c) * Q;
  load_tile(Cs, kLdC, kTile, kMax, min(kTile, Q - i0), N,
            Cm + b * st.cb + (l0 + i0) * st.cl, st.cl, st.cn);
  load_tile(Bs, kLdC, kTile, kMax, min(kTile, Q - j0), N,
            Bm + b * st.bb + (l0 + j0) * st.bl, st.bl, st.bn);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rg = warp % 4, ch = warp / 4;   // 16 rows, 32 columns
  float acc[4][4], acc_lo[4][4];    // hi·hi, and the cross terms
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = acc_lo[i][e] = 0.f;
#pragma unroll 4
  for (int k0 = 0; k0 < N; k0 += 8) {
    const float* cr = Cs + (rg * 16 + g) * kLdC + k0 + t4;
    const float af[4] = {cr[0], cr[8 * kLdC], cr[4], cr[8 * kLdC + 4]};
    unsigned ah[4], al[4];
    split4(af, ah, al);
    float bf[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* br = Bs + (ch * 32 + u * 8 + g) * kLdC + k0 + t4;
      bf[u][0] = br[0];
      bf[u][1] = br[4];
    }
    mma3<4>(acc, acc_lo, ah, al, bf);
  }
  float* out = cbuf + (static_cast<long long>(b) * nc + c) * Q * Q4;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int i = i0 + rg * 16 + g + 8 * h2;
    if (i >= Q) continue;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + ch * 32 + u * 8 + 2 * t4 + e;
        if (j < Q) out[i * Q4 + j] = acc[u][2 * h2 + e] + acc_lo[u][2 * h2 + e];
      }
  }
}

// The two key halves of a row group meet: warps 4..7 hand their partial
// sums acc to warps 0..3 through xch ([value][row group][lane], so the
// lanes hit 32 banks), which add them and write the block's 64 rows into
// tile (row stride ld). The caller has passed a barrier after its last
// read of the shared memory under xch and tile; tile is complete after
// the barrier this ends with.
template <int PT>
__device__ __forceinline__ void sum_halves(float (&acc)[PT][4], float* xch,
                                           float* tile, int ld) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  float* mine = xch + (warp % 4) * 32 + lane;
  if (warp >= 4) {
#pragma unroll
    for (int pt = 0; pt < PT; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(pt * 4 + e) * 128] = acc[pt][e];
  }
  __syncthreads();
  if (warp < 4) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float* row = tile + (warp * 16 + g + 8 * h2) * ld + 2 * t4;
#pragma unroll
      for (int pt = 0; pt < PT; ++pt)
        *reinterpret_cast<float2*>(row + pt * 8) = make_float2(
            acc[pt][2 * h2] + mine[(pt * 4 + 2 * h2) * 128],
            acc[pt][2 * h2 + 1] + mine[(pt * 4 + 2 * h2 + 1) * 128]);
    }
  }
  __syncthreads();
}

// dst's element at r * rs + c * cs = tile[r][c] (row stride ld, a
// multiple of 4) for r < rows, c < cols: 16 bytes a store where cs == 1
// and the rows are 16-byte aligned, else 4.
__device__ __forceinline__ void store_tile(const float* tile, int ld,
                                           int rows, int cols, float* dst,
                                           long long rs, long long cs) {
  if (cs == 1 && rs % 4 == 0 && cols % 4 == 0 &&
      reinterpret_cast<std::uintptr_t>(dst) % 16 == 0) {
    const int c4 = cols / 4;
    for (int idx = threadIdx.x; idx < rows * c4; idx += kThreads) {
      const int r = idx / c4, c = (idx - r * c4) * 4;
      *reinterpret_cast<float4*>(dst + r * rs + c) =
          *reinterpret_cast<const float4*>(tile + r * ld + c);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int r = idx / cols, c = idx - r * cols;
    dst[r * rs + c * cs] = tile[r * ld + c];
  }
}

// y, grid (ytiles·nc·nh, 1, B): x = (h·nc + c)·ytiles + tile. HPT: hp
// rounded up to 64 or 128.
template <int HPT>
__global__ void __launch_bounds__(kThreads, HPT == 64 ? 3 : 1)
ssd_y_kernel(const float* __restrict__ xdt, const float* __restrict__ a,
             const float* __restrict__ cbuf, float* __restrict__ y,
             SsdStrides st, int nc, int Q, int hp, int Q4) {
  constexpr int LDX = HPT + 4;
  constexpr int PT = HPT / 8;       // 8-wide n tiles over p
  static_assert(PT * 4 * 128 <= kTile * kLdC, "the halves' exchange fits");
  extern __shared__ __align__(16) float smem[];
  float* cbs = smem;                // C B^T rows, [i - i0][j]
  float* X = cbs + kTile * kLdC;    // xdt of the head, [j][p]
  float* cum = X + kMax * LDX;

  const int ytiles = (Q + kTile - 1) / kTile;
  const int bh = blockIdx.x / ytiles, tile = blockIdx.x - bh * ytiles;
  const int b = blockIdx.z, c = bh % nc, h = bh / nc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rg = warp % 4, kh = warp / 4;
  const long long l0 = static_cast<long long>(c) * Q;
  const int qrows = (Q + 7) / 8 * 8;
  const float* ap = a + b * st.ab + h * st.ah + l0 * st.al;
  const float* xp = xdt + b * st.xb + h * st.xh + l0 * st.xl;

  // query rows [i0, i0 + 64), keys j < min(Q, i0 + 64)
  const int i0 = (ytiles - 1 - tile) * kTile;
  const int ilast = min(Q, i0 + kTile);
  const int jrows = (ilast + 7) / 8 * 8;
  load_tile(X, LDX, jrows, HPT, ilast, hp, xp, st.xl, st.xp);
  if (warp == 0) chunk_cumsum(cum, ap, st.al, Q);
  load_tile(cbs, kLdC, kTile, kMax, ilast - i0, ilast,
            cbuf + ((static_cast<long long>(b) * nc + c) * Q + i0) * Q4, Q4,
            1);
  cp_async_wait_all();
  __syncthreads();

  // this warp: rows wr0 .. wr0 + 15, key chunks [jlo, jhi)
  const int wr0 = i0 + rg * 16;
  const int jt_n = min((wr0 + 15) / 8 + 1, qrows / 8);
  const int half = (jt_n + 1) / 2;
  const int jlo = kh == 0 ? 0 : half, jhi = kh == 0 ? half : jt_n;
  float yacc[PT][4];
#pragma unroll
  for (int pt = 0; pt < PT; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[pt][e] = 0.f;
  const float ci[2] = {cum[wr0 + g], cum[wr0 + g + 8]};
  const float* cr = cbs + (rg * 16 + g) * kLdC + 2 * t4;
#pragma unroll 2
  for (int jt = jlo; jt < jhi; ++jt) {
    // P = (C B^T) ⊙ D for rows g, g + 8 and keys 2t4, 2t4 + 1 of this
    // 8-key chunk, as the A fragment in the permuted k order. Where
    // j > i the exponent is replaced by 0 before the exp and the
    // product by 0 after it: no branch, and no overflowed exp.
    float pf[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = wr0 + g + 8 * (e / 2);
      const int j = jt * 8 + 2 * t4 + (e & 1);
      const bool in = j <= row && row < Q;
      const float dec = expf(in ? ci[e / 2] - cum[j] : 0.f);
      pf[(e & 1) * 2 + e / 2] =
          in ? cr[(e / 2) * 8 * kLdC + jt * 8 + (e & 1)] * dec : 0.f;
    }
    unsigned ah[4], al[4];
    split4(pf, ah, al);
    const float* x0 = X + (jt * 8 + 2 * t4) * LDX + g;
#pragma unroll
    for (int pc = 0; pc < PT / 8; ++pc) {
      float bf[8][2];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        bf[u][0] = x0[(pc * 8 + u) * 8];
        bf[u][1] = x0[LDX + (pc * 8 + u) * 8];
      }
      mma3<8>(yacc + pc * 8, yacc + pc * 8, ah, al, bf);
    }
  }
  __syncthreads();                  // C B^T rows and xdt read
  sum_halves(yacc, cbs, X, LDX);
  store_tile(X, LDX, ilast - i0, hp,
             y + b * st.yb + h * st.yh + (l0 + i0) * st.yl, st.yl, st.yp);
}

// S for (b, h, c): state rows [n0, n0 + 64) a block.
template <int HPT>
__device__ __forceinline__ void state_block(float* smem, const float* xdt,
                                            const float* a, const float* Bm,
                                            float* S, const SsdStrides& st,
                                            int b, int h, int c, int n0,
                                            int nh, int nc, int Q, int N,
                                            int hp) {
  constexpr int LDX = HPT + 4;
  constexpr int PT = HPT / 8;       // 8-wide n tiles over p
  static_assert(PT * 4 * 128 <= kMax * kLdB, "the halves' exchange fits");
  float* Bsl = smem;                // B slice, [j][n - n0]
  float* X = Bsl + kMax * kLdB;     // xdt of the head, [j][p]
  float* cum = X + kMax * LDX;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rg = warp % 4, kh = warp / 4;
  const long long l0 = static_cast<long long>(c) * Q;
  const int qrows = (Q + 7) / 8 * 8;
  const float* ap = a + b * st.ab + h * st.ah + l0 * st.al;
  const float* xp = xdt + b * st.xb + h * st.xh + l0 * st.xl;

  load_tile(Bsl, kLdB, qrows, kTile, Q, min(kTile, N - n0),
            Bm + b * st.bb + l0 * st.bl + n0 * st.bn, st.bl, st.bn);
  load_tile(X, LDX, qrows, HPT, Q, hp, xp, st.xl, st.xp);
  if (warp == 0) chunk_cumsum(cum, ap, st.al, Q);
  cp_async_wait_all();
  __syncthreads();

  // this warp: state rows n0 + nw .. + 15, key chunks [jlo, jhi)
  const int nw = rg * 16;
  const int nj = qrows / 8, half = (nj + 1) / 2;
  const int jlo = kh == 0 ? 0 : half, jhi = kh == 0 ? half : nj;
  float sacc[PT][4];
#pragma unroll
  for (int pt = 0; pt < PT; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[pt][e] = 0.f;
#pragma unroll 2
  for (int jt = jlo; jt < jhi; ++jt) {
    // A = (B ⊙ sd)^T: rows n, k-column t4 holds key 2t4, t4 + 4 holds
    // key 2t4 + 1, as xdt's rows are read below
    const int j0 = jt * 8 + 2 * t4;
    const float* b0 = Bsl + j0 * kLdB + nw + g;
    // exp(cum_{Q-1} - cum_j), 0 for the padding rows past Q
    const float sd0 = j0 < Q ? expf(cum[Q - 1] - cum[j0]) : 0.f;
    const float sd1 = j0 + 1 < Q ? expf(cum[Q - 1] - cum[j0 + 1]) : 0.f;
    const float af[4] = {b0[0] * sd0, b0[8] * sd0, b0[kLdB] * sd1,
                         b0[kLdB + 8] * sd1};
    unsigned ah[4], al[4];
    split4(af, ah, al);
    const float* x0 = X + j0 * LDX + g;
#pragma unroll
    for (int pc = 0; pc < PT / 8; ++pc) {
      float bf[8][2];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        bf[u][0] = x0[(pc * 8 + u) * 8];
        bf[u][1] = x0[LDX + (pc * 8 + u) * 8];
      }
      mma3<8>(sacc + pc * 8, sacc + pc * 8, ah, al, bf);
    }
  }
  __syncthreads();                  // the B slice and xdt read
  sum_halves(sacc, Bsl, X, LDX);
  store_tile(X, LDX, min(kTile, N - n0), hp,
             S + (((static_cast<long long>(b) * nh + h) * nc + c) * N + n0) *
                     hp,
             hp, 1);
}

// C B^T tiles and S blocks, over the grid (nc·ntri + stiles·nc·nh, B):
// the C B^T tiles first, then the S blocks.
template <int HPT>
__global__ void __launch_bounds__(kThreads, HPT == 64 ? 3 : 1)
ssd_state_kernel(const float* __restrict__ xdt, const float* __restrict__ a,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 float* __restrict__ cbuf, float* __restrict__ S,
                 SsdStrides st, int nh, int nc, int Q, int N, int hp, int Q4,
                 int ntri) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int x = blockIdx.x, ncb = nc * ntri;
  if (x < ncb) {
    cb_tile(smem, Bm, Cm, cbuf, st, b, x / ntri, x % ntri, nc, Q, N, Q4);
    return;
  }
  const int stiles = (N + kTile - 1) / kTile;
  const int bh = (x - ncb) / stiles, n0 = (x - ncb) % stiles * kTile;
  state_block<HPT>(smem, xdt, a, Bm, S, st, b, bh / nc, bh % nc, n0, nh, nc,
                   Q, N, hp);
}

template <int HPT>
cudaError_t launch_hpt(const float* xdt, const float* a, const float* Bm,
                       const float* Cm, float* y, float* S, float* cbuf,
                       const SsdStrides& st, int B, int nh, int nc, int Q,
                       int N, int hp, cudaStream_t stream) {
  const size_t s_smem = state_floats(HPT) * sizeof(float);
  const size_t y_smem = y_floats(HPT) * sizeof(float);
  static bool configured = false;   // once per instantiation
  if (!configured) {
    const std::pair<const void*, size_t> opt_in[] = {
        {reinterpret_cast<const void*>(&ssd_state_kernel<HPT>), s_smem},
        {reinterpret_cast<const void*>(&ssd_y_kernel<HPT>), y_smem}};
    for (const auto& [k, bytes] : opt_in) {
      const cudaError_t e = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (e != cudaSuccess) return e;
    }
    configured = true;
  }
  const int Q4 = (Q + 3) / 4 * 4;
  const int T = (Q + kTile - 1) / kTile;
  const int ntri = T * (T + 1) / 2;
  const int stiles = (N + kTile - 1) / kTile;
  ssd_state_kernel<HPT>
      <<<dim3(nc * ntri + stiles * nc * nh, B), kThreads, s_smem, stream>>>(
          xdt, a, Bm, Cm, cbuf, S, st, nh, nc, Q, N, hp, Q4, ntri);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_y_kernel<HPT><<<dim3(T * nc * nh, 1, B), kThreads, y_smem, stream>>>(
      xdt, a, cbuf, y, st, nc, Q, hp, Q4);
  return cudaGetLastError();
}

}  // namespace

// strides: xdt (4), a (3), Bm (3), Cm (3), y (4), in that order; S is
// contiguous (B, nh, nc, N, hp); cbuf is scratch of (B, nc, Q, Q4) floats,
// Q4 = Q rounded up to a multiple of 4, 16-byte aligned. 1 <= Q, N, hp <=
// 128, B <= 65535 and each kernel's grid x up to 2^31 - 1 (checked by the
// binding).
cudaError_t launch_ssd_chunk(const float* xdt, const float* a, const float* Bm,
                             const float* Cm, float* y, float* S, float* cbuf,
                             const long long* strides, int B, int nh, int L,
                             int Q, int N, int hp, cudaStream_t stream) {
  if (B == 0 || nh == 0 || L == 0) return cudaSuccess;
  const SsdStrides st{strides[0],  strides[1],  strides[2],  strides[3],
                      strides[4],  strides[5],  strides[6],  strides[7],
                      strides[8],  strides[9],  strides[10], strides[11],
                      strides[12], strides[13], strides[14], strides[15],
                      strides[16]};
  const int nc = L / Q;
  if (hp <= 64)
    return launch_hpt<64>(xdt, a, Bm, Cm, y, S, cbuf, st, B, nh, nc, Q, N,
                          hp, stream);
  return launch_hpt<128>(xdt, a, Bm, Cm, y, S, cbuf, st, B, nh, nc, Q, N, hp,
                         stream);
}
