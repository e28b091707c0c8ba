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
// Bound on the H100: operations. At Mamba2-370M's shapes (Q = N = 128,
// hp = 64) one (b, h, c) does 2Q^2 N + 2Q^2 hp + 2QN hp flops on about
// 160 KB of operands; this first version does them on the f32 CUDA
// cores, not the tensor cores.
//
// Design: one block of 256 threads (a 16 x 16 grid) per (c, h, b). The
// block stages C and B transposed ([n][i], rows padded by one word so a
// transposing store and the strided reads below hit distinct banks), its
// xdt chunk ([j][p]) and the chunk's cumsum (warp 0: four steps per lane
// in order, then a warp scan) in dynamic shared memory, 166 KB at
// hp <= 64. Each thread owns an 8 x 8 register tile of C B^T at rows
// ty + 16r, columns tx + 16s; the decay is applied as a select — exp is
// evaluated only where j <= i, since above the diagonal cum_i - cum_j can
// exceed 88.7 and overflow — and the masked scores P overwrite the C
// tile. Then each thread computes an 8 x (hp / 16) tile of y = P xdt and
// of S = (B exp(cum_last - cum))^T xdt. wgmma, TMA and a C B^T shared
// across heads are later work.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kT = 16;              // the block is a kT x kT thread grid
constexpr int kMax = 128;           // largest Q, N and hp
constexpr int kR = kMax / kT;       // rows of a thread's tile
constexpr int kLd = kMax + 1;       // row stride of the [n][i] tiles and P

struct SsdStrides {
  long long xb, xh, xl, xp;         // xdt (B, nh, L, hp)
  long long ab, ah, al;             // a (B, nh, L)
  long long bb, bl, bn;             // Bm (B, L, N)
  long long cb, cl, cn;             // Cm (B, L, N)
  long long yb, yh, yl, yp;         // y (B, nh, L, hp)
};

constexpr size_t smem_floats(int hp_pad) {
  return 2 * kMax * kLd + kMax * hp_pad + 2 * kMax;
}

// RH: hp rounded up to a multiple of 16, over 16 (4 for hp <= 64, else 8)
template <int RH>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ xdt, const float* __restrict__ a,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 float* __restrict__ y, float* __restrict__ S, SsdStrides st,
                 int nh, int nc, int Q, int N, int hp) {
  constexpr int HP = RH * kT;
  extern __shared__ float smem[];
  float* Ct = smem;                 // C^T [n][i]; then P [i][j]
  float* Bt = Ct + kMax * kLd;      // B^T [n][j]
  float* X = Bt + kMax * kLd;       // xdt [j][p]
  float* cum = X + kMax * HP;       // inclusive cumsum of a
  float* sd = cum + kMax;           // exp(cum_{Q-1} - cum_j)

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % kT, ty = tid / kT;
  const long long l0 = static_cast<long long>(c) * Q;

  const float* Cp = Cm + b * st.cb + l0 * st.cl;
  const float* Bp = Bm + b * st.bb + l0 * st.bl;
  for (int idx = tid; idx < Q * N; idx += kThreads) {
    const int i = idx / N, n = idx - i * N;
    Ct[n * kLd + i] = Cp[i * st.cl + n * st.cn];
    Bt[n * kLd + i] = Bp[i * st.bl + n * st.bn];
  }
  const float* Xp = xdt + b * st.xb + h * st.xh + l0 * st.xl;
  for (int idx = tid; idx < Q * hp; idx += kThreads) {
    const int j = idx / hp, p = idx - j * hp;
    X[j * HP + p] = Xp[j * st.xl + p * st.xp];
  }
  if (tid < 32) {
    // lane l sums steps 4l .. 4l+3 in order, then a warp scan of the
    // lane totals gives each lane its offset
    const float* ap = a + b * st.ab + h * st.ah + l0 * st.al;
    float part[4];
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = tid * 4 + k;
      run += (i < Q) ? ap[i * st.al] : 0.f;
      part[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(kFullMask, incl, o);
      if (tid >= o) incl += t;
    }
    float off = __shfl_up_sync(kFullMask, incl, 1);
    if (tid == 0) off = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = tid * 4 + k;
      if (i < Q) cum[i] = off + part[k];
    }
  }
  __syncthreads();
  if (tid < Q) sd[tid] = expf(cum[Q - 1] - cum[tid]);

  // scores C B^T, 8 x 8 per thread (rows and columns past Q are never
  // stored nor read below)
  float acc[kR][kR];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int s = 0; s < kR; ++s) acc[r][s] = 0.f;
  for (int n = 0; n < N; ++n) {
    float cv[kR], bv[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) cv[r] = Ct[n * kLd + ty + kT * r];
#pragma unroll
    for (int s = 0; s < kR; ++s) bv[s] = Bt[n * kLd + tx + kT * s];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int s = 0; s < kR; ++s) acc[r][s] = fmaf(cv[r], bv[s], acc[r][s]);
  }
  __syncthreads();                  // C^T fully read: P takes its place
  float* P = Ct;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = ty + kT * r;
#pragma unroll
    for (int s = 0; s < kR; ++s) {
      const int j = tx + kT * s;
      P[i * kLd + j] = (j <= i) ? acc[r][s] * expf(cum[i] - cum[j]) : 0.f;
    }
  }
  __syncthreads();

  // y = P xdt
  float ya[kR][RH];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int s = 0; s < RH; ++s) ya[r][s] = 0.f;
  for (int j = 0; j < Q; ++j) {
    float pv[kR], xv[RH];
#pragma unroll
    for (int r = 0; r < kR; ++r) pv[r] = P[(ty + kT * r) * kLd + j];
#pragma unroll
    for (int s = 0; s < RH; ++s) xv[s] = X[j * HP + tx + kT * s];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int s = 0; s < RH; ++s) ya[r][s] = fmaf(pv[r], xv[s], ya[r][s]);
  }
  float* Yp = y + b * st.yb + h * st.yh + l0 * st.yl;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = ty + kT * r;
#pragma unroll
    for (int s = 0; s < RH; ++s) {
      const int p = tx + kT * s;
      if (i < Q && p < hp) Yp[i * st.yl + p * st.yp] = ya[r][s];
    }
  }

  // S = (B exp(cum_last - cum))^T xdt, the product B exp(.) rounded
  // first, as the reference forms it
  float sa[kR][RH];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int s = 0; s < RH; ++s) sa[r][s] = 0.f;
  for (int j = 0; j < Q; ++j) {
    const float d = sd[j];
    float bv[kR], xv[RH];
#pragma unroll
    for (int r = 0; r < kR; ++r) bv[r] = Bt[(ty + kT * r) * kLd + j] * d;
#pragma unroll
    for (int s = 0; s < RH; ++s) xv[s] = X[j * HP + tx + kT * s];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int s = 0; s < RH; ++s) sa[r][s] = fmaf(bv[r], xv[s], sa[r][s]);
  }
  float* Sp = S + ((static_cast<long long>(b) * nh + h) * nc + c) * N * hp;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int n = ty + kT * r;
#pragma unroll
    for (int s = 0; s < RH; ++s) {
      const int p = tx + kT * s;
      if (n < N && p < hp) Sp[n * hp + p] = sa[r][s];
    }
  }
}

template <int RH>
cudaError_t launch_rh(const float* xdt, const float* a, const float* Bm,
                      const float* Cm, float* y, float* S,
                      const SsdStrides& st, int B, int nh, int nc, int Q,
                      int N, int hp, cudaStream_t stream) {
  const size_t smem = smem_floats(RH * kT) * sizeof(float);
  static bool configured = false;   // once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel<RH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(nc, nh, B);
  ssd_chunk_kernel<RH><<<grid, kThreads, smem, stream>>>(
      xdt, a, Bm, Cm, y, S, st, nh, nc, Q, N, hp);
  return cudaGetLastError();
}

}  // namespace

// strides: xdt (4), a (3), Bm (3), Cm (3), y (4), in that order; S is
// contiguous (B, nh, nc, N, hp). 1 <= Q, N, hp <= 128 (checked by the
// binding).
cudaError_t launch_ssd_chunk(const float* xdt, const float* a, const float* Bm,
                             const float* Cm, float* y, float* S,
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
    return launch_rh<4>(xdt, a, Bm, Cm, y, S, st, B, nh, nc, Q, N, hp, stream);
  return launch_rh<8>(xdt, a, Bm, Cm, y, S, st, B, nh, nc, Q, N, hp, stream);
}
