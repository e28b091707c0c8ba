// PyTorch bindings for the port's CUDA kernels. This is the only source
// that includes the PyTorch headers; the kernels (*.cu) expose plain C++
// launchers over raw pointers, so nvcc compiles them in seconds.
//
// Each binding checks device, dtype, shape and layout, launches on
// PyTorch's current stream, and raises if the launch was refused: each
// launcher returns its own cudaGetLastError(), which also clears the
// error, so the binding checks that code (C10_CUDA_CHECK) before
// C10_CUDA_KERNEL_LAUNCH_CHECK(). Outputs are
// allocated by the Python wrappers (`kernels/*/*.py`).
#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <vector>

cudaError_t launch_inner_update(const float* theta, float* out,
                                const float* alpha, float alpha_s,
                                int alpha_mode, const float* g, long long C,
                                long long N, cudaStream_t stream);
cudaError_t launch_flash_attention(int dtype, const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* strides, int B, int H,
                                   int Kv, int Lq, int Lk, int hd, int hdv,
                                   float scale, int causal, int window,
                                   int q_offset, cudaStream_t stream);
cudaError_t launch_flash_decode(int dtype, const void* q, const void* k,
                                const void* v, const int* kvl, int kvl_s,
                                void* o, float* scratch,
                                const long long* strides, int B, int C,
                                int Kv, int G, int hd, int splits, float scale,
                                cudaStream_t stream);
cudaError_t launch_weighted_aggregate(int dtype, const void* G,
                                      const float* w, float* out, int m,
                                      long long N, cudaStream_t stream);
cudaError_t launch_adam_flat(int state_dtype, float* p, const float* g,
                             void* m, void* v, const float* scales,
                             long long N, float lr, float b1, float c1,
                             float b2, float c2, float eps, float wd,
                             cudaStream_t stream);
cudaError_t launch_int8_encode(const float* G, const float* scales, int8_t* q,
                               float* resid, int m, long long N,
                               cudaStream_t stream);
cudaError_t launch_trimmed_mean(int dtype, const void* G, const float* live,
                                float* out, int m, int trim, long long N,
                                cudaStream_t stream);
cudaError_t launch_ssd_chunk(const float* xdt, const float* a, const float* Bm,
                             const float* Cm, float* y, float* S, float* cbuf,
                             const long long* strides, int B, int nh, int L,
                             int Q, int N, int hp, cudaStream_t stream);

namespace {

int dtype_code(const torch::Tensor& t) {
  if (t.scalar_type() == torch::kFloat) return 0;
  if (t.scalar_type() == torch::kBFloat16) return 1;
  TORCH_CHECK(false, "kernel takes float32 or bfloat16, got ", t.scalar_type());
  return -1;
}

void check_cuda(const torch::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
}

void check_aligned16(const torch::Tensor& t, const char* name) {
  TORCH_CHECK(reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0, name,
              " must be 16-byte aligned");
}

// theta, out, g: (C, N) float32 contiguous; alpha: empty (scalar alpha_s),
// (N,) shared or (C, N) per-client float32. out may be theta itself.
void inner_update(torch::Tensor theta, torch::Tensor out, torch::Tensor alpha,
                  double alpha_s, torch::Tensor g) {
  check_cuda(theta, "theta");
  check_cuda(out, "out");
  check_cuda(g, "g");
  TORCH_CHECK(theta.dim() == 2, "theta must be (C, N)");
  TORCH_CHECK(theta.scalar_type() == torch::kFloat &&
                  g.scalar_type() == torch::kFloat &&
                  out.scalar_type() == torch::kFloat,
              "theta, g and out must be float32");
  TORCH_CHECK(theta.is_contiguous() && g.is_contiguous() && out.is_contiguous(),
              "theta, g and out must be contiguous");
  TORCH_CHECK(g.sizes() == theta.sizes() && out.sizes() == theta.sizes(),
              "g and out must match theta's shape");
  const long long C = theta.size(0), N = theta.size(1);
  TORCH_CHECK(N % 4 == 0, "N must be a multiple of 4");
  TORCH_CHECK(C <= 65535, "at most 65535 client rows");
  check_aligned16(theta, "theta");
  check_aligned16(g, "g");
  check_aligned16(out, "out");
  int mode = 0;
  const float* a = nullptr;
  if (alpha.numel() > 0) {
    check_cuda(alpha, "alpha");
    TORCH_CHECK(alpha.scalar_type() == torch::kFloat && alpha.is_contiguous(),
                "alpha must be contiguous float32");
    check_aligned16(alpha, "alpha");
    if (alpha.dim() == 1) {
      TORCH_CHECK(alpha.size(0) == N, "shared alpha must be (N,)");
      mode = 1;
    } else {
      TORCH_CHECK(alpha.sizes() == theta.sizes(), "alpha must be (C, N)");
      mode = 2;
    }
    a = alpha.data_ptr<float>();
  }
  const at::cuda::CUDAGuard guard(theta.device());
  C10_CUDA_CHECK(launch_inner_update(theta.data_ptr<float>(), out.data_ptr<float>(), a,
                                     static_cast<float>(alpha_s), mode, g.data_ptr<float>(),
                                     C, N, at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// q: (B, H, Lq, hd), k: (B, Kv, Lk, hd), v: (B, Kv, Lk, hd_v), o: (B, H,
// Lq, hd_v); any strides. window <= 0: no sliding window.
void flash_attention(torch::Tensor q, torch::Tensor k, torch::Tensor v,
                     torch::Tensor o, bool causal, int64_t window,
                     int64_t q_offset, double scale) {
  check_cuda(q, "q");
  check_cuda(k, "k");
  check_cuda(v, "v");
  check_cuda(o, "o");
  TORCH_CHECK(q.dim() == 4 && k.dim() == 4 && v.dim() == 4 && o.dim() == 4,
              "q, k, v, o must be 4-D");
  const int dt = dtype_code(q);
  TORCH_CHECK(k.scalar_type() == q.scalar_type() &&
                  v.scalar_type() == q.scalar_type() &&
                  o.scalar_type() == q.scalar_type(),
              "q, k, v, o must share a dtype");
  const int B = q.size(0), H = q.size(1), Lq = q.size(2), hd = q.size(3);
  const int Kv = k.size(1), Lk = k.size(2), hdv = v.size(3);
  TORCH_CHECK(k.size(0) == B && v.size(0) == B && v.size(1) == Kv &&
                  v.size(2) == Lk && k.size(3) == hd,
              "k, v shapes do not match q");
  TORCH_CHECK(Kv > 0 && H % Kv == 0, "num heads must be a multiple of kv heads");
  TORCH_CHECK(o.size(0) == B && o.size(1) == H && o.size(2) == Lq &&
                  o.size(3) == hdv,
              "o must be (B, H, Lq, hd_v)");
  TORCH_CHECK(dt == 1 ? hd <= 192 && hdv <= 128 : hd <= 192 && hdv <= 192,
              "head dims: bfloat16 hd <= 192 with hd_v <= 128, float32 both "
              "<= 192; got hd ", hd, ", hd_v ", hdv);
  TORCH_CHECK(B <= 65535 && H <= 65535, "B and H up to 65535");
  std::vector<long long> st;
  for (const auto* t : {&q, &k, &v, &o})
    for (int d = 0; d < 4; ++d) st.push_back(t->stride(d));
  const at::cuda::CUDAGuard guard(q.device());
  C10_CUDA_CHECK(launch_flash_attention(dt, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        o.data_ptr(), st.data(), B, H, Kv, Lq, Lk, hd, hdv,
                                        static_cast<float>(scale), causal ? 1 : 0,
                                        static_cast<int>(window), static_cast<int>(q_offset),
                                        at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// q, o: contiguous (B, H, hd); caches (B, C, Kv, hd) with a contiguous head
// dim; kv_length: (B,) int32, or None to use kv_length_s for every row (the
// decode path's Python int, passed as a kernel argument). splits: blocks
// along the cache axis; with splits > 1, scratch is float32 of at least
// B * Kv * splits * G * (hd + 2) elements for the partials.
void flash_decode(torch::Tensor q, torch::Tensor k_cache,
                  torch::Tensor v_cache, c10::optional<torch::Tensor> kv_length,
                  int64_t kv_length_s, torch::Tensor o, torch::Tensor scratch,
                  int64_t splits, double scale) {
  check_cuda(q, "q");
  check_cuda(k_cache, "k_cache");
  check_cuda(v_cache, "v_cache");
  check_cuda(o, "o");
  const int dt = dtype_code(q);
  TORCH_CHECK(k_cache.scalar_type() == q.scalar_type() &&
                  v_cache.scalar_type() == q.scalar_type() &&
                  o.scalar_type() == q.scalar_type(),
              "q, caches and o must share a dtype");
  TORCH_CHECK(q.dim() == 3 && q.is_contiguous() && o.is_contiguous() &&
                  o.sizes() == q.sizes(),
              "q and o must be contiguous (B, H, hd)");
  check_aligned16(q, "q");
  TORCH_CHECK(k_cache.dim() == 4 && v_cache.sizes() == k_cache.sizes(),
              "caches must be (B, C, Kv, hd)");
  const int B = q.size(0), H = q.size(1), hd = q.size(2);
  const int C = k_cache.size(1), Kv = k_cache.size(2);
  TORCH_CHECK(C >= 1, "the cache must hold at least one slot");
  TORCH_CHECK(k_cache.size(0) == B && k_cache.size(3) == hd,
              "cache shape does not match q");
  TORCH_CHECK(Kv > 0 && H % Kv == 0, "num heads must be a multiple of kv heads");
  const int G = H / Kv;
  TORCH_CHECK(G <= 8 && hd <= 128, "at most 8 query heads per kv head, hd <= 128");
  const int vec = 16 / static_cast<int>(q.element_size());
  TORCH_CHECK(hd % vec == 0, "hd must be a multiple of ", vec);
  const int* kvl = nullptr;
  if (kv_length.has_value()) {
    const torch::Tensor& t = *kv_length;
    check_cuda(t, "kv_length");
    TORCH_CHECK(t.scalar_type() == torch::kInt && t.is_contiguous() &&
                    t.numel() == B,
                "kv_length must be (B,) int32");
    kvl = t.data_ptr<int>();
  }
  TORCH_CHECK(splits >= 1 && splits <= 512, "splits must be in [1, 512], got ",
              splits);
  float* part = nullptr;
  if (splits > 1) {
    check_cuda(scratch, "scratch");
    TORCH_CHECK(scratch.scalar_type() == torch::kFloat &&
                    scratch.is_contiguous() &&
                    scratch.numel() >= static_cast<int64_t>(B) * Kv * splits *
                                           G * (hd + 2),
                "scratch must be contiguous float32 of B * Kv * splits * G * "
                "(hd + 2) elements");
    check_aligned16(scratch, "scratch");
    part = scratch.data_ptr<float>();
  }
  std::vector<long long> st;
  for (const auto* t : {&k_cache, &v_cache}) {
    TORCH_CHECK(t->stride(3) == 1, "cache head dim must be contiguous");
    check_aligned16(*t, "cache");
    for (int d = 0; d < 3; ++d) {
      TORCH_CHECK(t->stride(d) % vec == 0, "cache rows must be 16-byte aligned");
      st.push_back(t->stride(d));
    }
  }
  TORCH_CHECK(B <= 65535 && Kv <= 65535, "B and Kv up to 65535");
  TORCH_CHECK(kv_length_s >= INT32_MIN && kv_length_s <= INT32_MAX,
              "kv_length out of the int32 range");
  const at::cuda::CUDAGuard guard(q.device());
  C10_CUDA_CHECK(launch_flash_decode(dt, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                                     kvl, static_cast<int>(kv_length_s), o.data_ptr(), part,
                                     st.data(), B, C, Kv, G, hd, static_cast<int>(splits),
                                     static_cast<float>(scale),
                                     at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// G: (m, N) f32, bf16 or int8, contiguous; w: (m,) f32; out: (N,) f32.
void weighted_aggregate(torch::Tensor G, torch::Tensor w, torch::Tensor out) {
  check_cuda(G, "G");
  check_cuda(w, "w");
  check_cuda(out, "out");
  TORCH_CHECK(G.dim() == 2 && G.is_contiguous(), "G must be contiguous (m, N)");
  int dt = 0;
  if (G.scalar_type() == torch::kBFloat16) {
    dt = 1;
  } else if (G.scalar_type() == torch::kChar) {
    dt = 2;
  } else {
    TORCH_CHECK(G.scalar_type() == torch::kFloat,
                "G must be float32, bfloat16 or int8, got ", G.scalar_type());
  }
  const long long m = G.size(0), N = G.size(1);
  TORCH_CHECK(m >= 1 && m <= 12288, "1 <= m <= 12288 client rows");
  TORCH_CHECK(N % 4 == 0, "N must be a multiple of 4");
  TORCH_CHECK(w.scalar_type() == torch::kFloat && w.is_contiguous() &&
                  w.dim() == 1 && w.size(0) == m,
              "w must be contiguous (m,) float32");
  TORCH_CHECK(out.scalar_type() == torch::kFloat && out.is_contiguous() &&
                  out.dim() == 1 && out.size(0) == N,
              "out must be contiguous (N,) float32");
  check_aligned16(G, "G");
  check_aligned16(out, "out");
  const at::cuda::CUDAGuard guard(G.device());
  C10_CUDA_CHECK(launch_weighted_aggregate(dt, G.data_ptr(), w.data_ptr<float>(),
                                           out.data_ptr<float>(), static_cast<int>(m), N,
                                           at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// p, g: (N,) f32; m, v: (N,) f32 or bf16; scales: (2,) f32. In place.
void adam_flat(torch::Tensor p, torch::Tensor g, torch::Tensor m,
               torch::Tensor v, torch::Tensor scales, double lr, double b1,
               double c1, double b2, double c2, double eps, double wd) {
  for (const auto* t : {&p, &g, &m, &v, &scales}) check_cuda(*t, "adam input");
  TORCH_CHECK(p.scalar_type() == torch::kFloat &&
                  g.scalar_type() == torch::kFloat,
              "phi and g must be float32");
  TORCH_CHECK(m.scalar_type() == v.scalar_type() &&
                  (m.scalar_type() == torch::kFloat ||
                   m.scalar_type() == torch::kBFloat16),
              "m and v must share a dtype, float32 or bfloat16");
  const long long N = p.numel();
  for (const auto* t : {&p, &g, &m, &v}) {
    TORCH_CHECK(t->dim() == 1 && t->numel() == N && t->is_contiguous(),
                "phi, g, m, v must be contiguous (N,)");
    check_aligned16(*t, "adam input");
  }
  TORCH_CHECK(N % 4 == 0, "N must be a multiple of 4");
  TORCH_CHECK(scales.scalar_type() == torch::kFloat && scales.numel() == 2 &&
                  scales.is_contiguous(),
              "scales must be contiguous (2,) float32");
  const at::cuda::CUDAGuard guard(p.device());
  C10_CUDA_CHECK(launch_adam_flat(m.scalar_type() == torch::kFloat ? 0 : 1,
                                  p.data_ptr<float>(), g.data_ptr<float>(), m.data_ptr(),
                                  v.data_ptr(), scales.data_ptr<float>(), N,
                                  static_cast<float>(lr), static_cast<float>(b1),
                                  static_cast<float>(c1), static_cast<float>(b2),
                                  static_cast<float>(c2), static_cast<float>(eps),
                                  static_cast<float>(wd), at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// G, resid: (m, N) f32 contiguous (resid may be G itself); scales: (m,)
// f32; q: (m, N) int8.
void int8_encode(torch::Tensor G, torch::Tensor scales, torch::Tensor q,
                 torch::Tensor resid) {
  for (const auto* t : {&G, &scales, &q, &resid}) check_cuda(*t, "int8_encode input");
  TORCH_CHECK(G.dim() == 2 && G.is_contiguous() &&
                  G.scalar_type() == torch::kFloat,
              "G must be contiguous (m, N) float32");
  const long long m = G.size(0), N = G.size(1);
  TORCH_CHECK(m >= 1 && m <= 65535, "1 <= m <= 65535 client rows");
  TORCH_CHECK(N % 4 == 0, "N must be a multiple of 4");
  TORCH_CHECK(scales.scalar_type() == torch::kFloat && scales.dim() == 1 &&
                  scales.size(0) == m && scales.is_contiguous(),
              "scales must be contiguous (m,) float32");
  TORCH_CHECK(q.scalar_type() == torch::kChar && q.sizes() == G.sizes() &&
                  q.is_contiguous(),
              "q must be contiguous (m, N) int8");
  TORCH_CHECK(resid.scalar_type() == torch::kFloat &&
                  resid.sizes() == G.sizes() && resid.is_contiguous(),
              "resid must be contiguous (m, N) float32");
  check_aligned16(G, "G");
  check_aligned16(resid, "resid");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(q.data_ptr()) % 4 == 0,
              "q must be 4-byte aligned");
  const at::cuda::CUDAGuard guard(G.device());
  C10_CUDA_CHECK(launch_int8_encode(G.data_ptr<float>(), scales.data_ptr<float>(),
                                    reinterpret_cast<int8_t*>(q.data_ptr()),
                                    resid.data_ptr<float>(), static_cast<int>(m), N,
                                    at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// G: (m, N) f32 or bf16, contiguous; live: (m,) f32; out: (N,) f32;
// 0 <= 2 trim < m.
void trimmed_mean(torch::Tensor G, torch::Tensor live, torch::Tensor out,
                  int64_t trim) {
  for (const auto* t : {&G, &live, &out}) check_cuda(*t, "trimmed_mean input");
  TORCH_CHECK(G.dim() == 2 && G.is_contiguous(), "G must be contiguous (m, N)");
  const int dt = dtype_code(G);
  const long long m = G.size(0), N = G.size(1);
  TORCH_CHECK(m >= 1 && m <= 49152, "1 <= m <= 49152 client rows");
  TORCH_CHECK(trim >= 0 && 2 * trim < m, "0 <= 2 trim < m, got trim ", trim,
              " and m ", m);
  TORCH_CHECK(N % 4 == 0, "N must be a multiple of 4");
  TORCH_CHECK(live.scalar_type() == torch::kFloat && live.is_contiguous() &&
                  live.dim() == 1 && live.size(0) == m,
              "live must be contiguous (m,) float32");
  TORCH_CHECK(out.scalar_type() == torch::kFloat && out.is_contiguous() &&
                  out.dim() == 1 && out.size(0) == N,
              "out must be contiguous (N,) float32");
  check_aligned16(G, "G");
  check_aligned16(out, "out");
  const at::cuda::CUDAGuard guard(G.device());
  C10_CUDA_CHECK(launch_trimmed_mean(dt, G.data_ptr(), live.data_ptr<float>(),
                                     out.data_ptr<float>(), static_cast<int>(m),
                                     static_cast<int>(trim), N,
                                     at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// xdt, y: (B, nh, L, hp); a: (B, nh, L); Bm, Cm: (B, L, N); all float32,
// any strides. S: contiguous (B, nh, L / chunk, N, hp) float32. cbuf:
// contiguous float32 scratch (B, L / chunk, chunk, chunk rounded up to a
// multiple of 4) for C B^T.
void ssd_chunk(torch::Tensor xdt, torch::Tensor a, torch::Tensor Bm,
               torch::Tensor Cm, torch::Tensor y, torch::Tensor S,
               torch::Tensor cbuf, int64_t chunk) {
  for (const auto* t : {&xdt, &a, &Bm, &Cm, &y, &S, &cbuf}) {
    check_cuda(*t, "ssd_chunk operand");
    TORCH_CHECK(t->scalar_type() == torch::kFloat,
                "ssd_chunk operands must be float32, got ", t->scalar_type());
  }
  TORCH_CHECK(xdt.dim() == 4 && a.dim() == 3 && Bm.dim() == 3 &&
                  Cm.dim() == 3 && y.dim() == 4 && S.dim() == 5,
              "xdt, y (B, nh, L, hp); a (B, nh, L); Bm, Cm (B, L, N); S 5-D");
  const long long B = xdt.size(0), nh = xdt.size(1), L = xdt.size(2),
                  hp = xdt.size(3), N = Bm.size(2);
  TORCH_CHECK(chunk >= 1 && chunk <= 128, "chunk must be in [1, 128], got ",
              chunk);
  TORCH_CHECK(N >= 1 && N <= 128 && hp >= 1 && hp <= 128,
              "state N and head dim hp must be in [1, 128], got ", N, " and ",
              hp);
  TORCH_CHECK(L % chunk == 0, "L (", L, ") must be a multiple of chunk (",
              chunk, ")");
  TORCH_CHECK(a.size(0) == B && a.size(1) == nh && a.size(2) == L,
              "a must be (B, nh, L)");
  TORCH_CHECK(Bm.size(0) == B && Bm.size(1) == L && Cm.sizes() == Bm.sizes(),
              "Bm and Cm must be (B, L, N)");
  TORCH_CHECK(y.sizes() == xdt.sizes(), "y must be (B, nh, L, hp)");
  TORCH_CHECK(S.is_contiguous() && S.size(0) == B && S.size(1) == nh &&
                  S.size(2) == L / chunk && S.size(3) == N && S.size(4) == hp,
              "S must be contiguous (B, nh, L / chunk, N, hp)");
  TORCH_CHECK(B <= 65535 && nh * (L / chunk) <= 65535,
              "B and nh * (L / chunk) up to 65535");
  TORCH_CHECK(cbuf.is_contiguous() && cbuf.dim() == 4 && cbuf.size(0) == B &&
                  cbuf.size(1) == L / chunk && cbuf.size(2) == chunk &&
                  cbuf.size(3) == (chunk + 3) / 4 * 4,
              "cbuf must be contiguous (B, L / chunk, chunk, chunk rounded "
              "up to a multiple of 4)");
  check_aligned16(cbuf, "cbuf");
  std::vector<long long> st;
  for (const auto* t : {&xdt, &a, &Bm, &Cm, &y})
    for (int d = 0; d < t->dim(); ++d) st.push_back(t->stride(d));
  const at::cuda::CUDAGuard guard(xdt.device());
  C10_CUDA_CHECK(launch_ssd_chunk(
      xdt.data_ptr<float>(), a.data_ptr<float>(), Bm.data_ptr<float>(),
      Cm.data_ptr<float>(), y.data_ptr<float>(), S.data_ptr<float>(),
      cbuf.data_ptr<float>(), st.data(), static_cast<int>(B),
      static_cast<int>(nh),
      static_cast<int>(L), static_cast<int>(chunk), static_cast<int>(N),
      static_cast<int>(hp), at::cuda::getCurrentCUDAStream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("inner_update", &inner_update, "K1: theta <- theta - alpha * g");
  m.def("flash_attention", &flash_attention, "K7: flash-attention forward");
  m.def("flash_decode", &flash_decode, "K8: one-token decode attention");
  m.def("weighted_aggregate", &weighted_aggregate,
        "K2: out = sum_u w[u] * G[u]");
  m.def("adam_flat", &adam_flat, "K3: one fused Adam step, in place");
  m.def("int8_encode", &int8_encode,
        "K6: int8 quantization with the residual in one pass");
  m.def("trimmed_mean", &trimmed_mean,
        "K5: coordinate-wise trimmed mean over the live rows");
  m.def("ssd_chunk", &ssd_chunk,
        "K9: Mamba2 SSD intra-chunk outputs and chunk states");
}
