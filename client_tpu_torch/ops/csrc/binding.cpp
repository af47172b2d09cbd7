// PyTorch binding of the package's CUDA kernels: the int8 dequant-matmul
// (int8_matmul.cu), the flash-attention forward, dQ and dK/dV kernels
// (flash_attention.cu for f32; bf16 in flash_fwd_bf16.cu and
// flash_bwd_bf16.cu) and paged attention (paged_attention.cu).
//
// The only source that includes PyTorch's headers: it checks the tensors,
// allocates the outputs with torch::empty, launches on the current stream
// and raises on a launch the runtime refused.

#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <string>
#include <tuple>

cudaError_t ctpu_int8_matmul_f32(const void* x, const int8_t* q,
                                 const float* s, void* out, int m, int k,
                                 int n, cudaStream_t stream);
cudaError_t ctpu_int8_matmul_bf16(const void* x, const int8_t* q,
                                  const float* s, void* out, int m, int k,
                                  int n, cudaStream_t stream);
cudaError_t ctpu_flash_fwd(bool bf16, const void* q, const void* k,
                           const void* v, void* out, float* lse, int bh,
                           int t, int d, float scale, bool causal,
                           cudaStream_t stream);
cudaError_t ctpu_flash_bwd_dq(bool bf16, const void* q, const void* k,
                              const void* v, const void* dout,
                              const float* lse, const float* delta,
                              const float* glse, void* dq, int bh, int t,
                              int d, float scale, bool causal,
                              cudaStream_t stream);
cudaError_t ctpu_flash_bwd_dkv(bool bf16, const void* q, const void* k,
                               const void* v, const void* dout,
                               const float* lse, const float* delta,
                               const float* glse, void* dk, void* dv, int bh,
                               int t, int d, float scale, bool causal,
                               cudaStream_t stream);
cudaError_t ctpu_paged_attention(bool bf16, const void* q, const void* pool_k,
                                 const void* pool_v, const int32_t* tables,
                                 const int32_t* pos, void* out, int batch,
                                 int t_len, int n_heads, int n_kv,
                                 int head_dim, int n_pool_blocks,
                                 int block_size, int table_width, float scale,
                                 cudaStream_t stream);

namespace {

// Check messages stream C strings only.  Streaming an integer (or an
// IntArrayRef, which streams its integers) instantiates
// std::ostream::_M_insert<long> in this library, and where the system's
// libstdc++ differs from the one PyTorch was built with, that crashes the
// process when a check fails (seen on the H100 machine) instead of
// raising.  Numbers go through std::to_string.
std::string num(int64_t v) { return std::to_string(v); }

std::string shape_of(const torch::Tensor& x) {
  std::string s = "[";
  for (int64_t i = 0; i < x.dim(); ++i) {
    if (i) s += ", ";
    s += num(x.size(i));
  }
  return s + "]";
}

// The launchers return cudaGetLastError() of their launch, which also
// clears it: the error is checked here or never.
void check_launch(const char* name, cudaError_t err) {
  TORCH_CHECK(err == cudaSuccess, name, ": kernel launch failed: ",
              cudaGetErrorString(err));
}

torch::Tensor int8_matmul(const torch::Tensor& x, const torch::Tensor& q,
                          const torch::Tensor& s) {
  TORCH_CHECK(x.is_cuda() && q.is_cuda() && s.is_cuda(),
              "int8_matmul: x, q and s must be CUDA tensors");
  TORCH_CHECK(x.device() == q.device() && x.device() == s.device(),
              "int8_matmul: x, q and s must be on one device");
  TORCH_CHECK(x.dim() == 2 && q.dim() == 2 && s.dim() == 1,
              "int8_matmul: expected x [M,K], q [K,N], s [N]");
  TORCH_CHECK(x.size(1) == q.size(0) && s.size(0) == q.size(1),
              "int8_matmul: shapes do not agree: x ", shape_of(x).c_str(),
              ", q ", shape_of(q).c_str(), ", s ", shape_of(s).c_str());
  TORCH_CHECK(q.scalar_type() == torch::kInt8, "int8_matmul: q must be int8");
  TORCH_CHECK(s.scalar_type() == torch::kFloat32,
              "int8_matmul: s must be float32");
  TORCH_CHECK(x.scalar_type() == torch::kFloat32 ||
                  x.scalar_type() == torch::kBFloat16,
              "int8_matmul: x must be float32 or bfloat16, got ",
              x.scalar_type());
  TORCH_CHECK(x.is_contiguous() && q.is_contiguous() && s.is_contiguous(),
              "int8_matmul: x, q and s must be contiguous");
  const int64_t m = x.size(0), k = x.size(1), n = q.size(1);
  TORCH_CHECK(m < INT32_MAX && k < INT32_MAX && n < INT32_MAX,
              "int8_matmul: dimension too large");

  const c10::cuda::CUDAGuard guard(x.device());
  auto out = torch::empty({m, n}, x.options());
  if (m == 0 || n == 0) return out;
  const cudaStream_t stream = at::cuda::getCurrentCUDAStream();
  const auto fn = x.scalar_type() == torch::kFloat32 ? ctpu_int8_matmul_f32
                                                     : ctpu_int8_matmul_bf16;
  check_launch("int8_matmul",
               fn(x.data_ptr(), q.data_ptr<int8_t>(), s.data_ptr<float>(),
                  out.data_ptr(), static_cast<int>(m), static_cast<int>(k),
                  static_cast<int>(n), stream));
  return out;
}

// q, k, v (and dout): contiguous [BH, T, D] of one shape, one device and
// one dtype, f32 or bf16, with D in {32, 64, 128}.
void check_qkv(const char* name, const std::vector<torch::Tensor>& xs) {
  const auto& q = xs[0];
  for (const auto& x : xs) {
    TORCH_CHECK(x.is_cuda(), name, ": q, k, v and dO must be CUDA tensors");
    TORCH_CHECK(x.device() == q.device(), name,
                ": q, k, v and dO must be on one device");
    TORCH_CHECK(x.dim() == 3 && x.sizes() == q.sizes(), name,
                ": expected q, k, v and dO of one shape [BH,T,D], got ",
                shape_of(x).c_str(), " and ", shape_of(q).c_str());
    TORCH_CHECK(x.scalar_type() == q.scalar_type(), name,
                ": q, k, v and dO must have one dtype");
    TORCH_CHECK(x.is_contiguous(), name, ": q, k, v and dO must be contiguous");
  }
  TORCH_CHECK(q.scalar_type() == torch::kFloat32 ||
                  q.scalar_type() == torch::kBFloat16,
              name, ": q must be float32 or bfloat16, got ", q.scalar_type());
  const int64_t d = q.size(2);
  TORCH_CHECK(d == 32 || d == 64 || d == 128, name,
              ": head dim must be 32, 64 or 128, got ", num(d).c_str());
  TORCH_CHECK(q.size(0) < INT32_MAX && q.size(1) < INT32_MAX, name,
              ": dimension too large");
}

// lse, delta, g_lse: contiguous [BH, T, 1] f32 beside q.
void check_rows(const char* name, const torch::Tensor& x,
                const torch::Tensor& q) {
  TORCH_CHECK(x.is_cuda() && x.device() == q.device(), name,
              ": lse, delta and g_lse must be on q's device");
  TORCH_CHECK(x.scalar_type() == torch::kFloat32, name,
              ": lse, delta and g_lse must be float32");
  TORCH_CHECK(x.dim() == 3 && x.size(0) == q.size(0) &&
                  x.size(1) == q.size(1) && x.size(2) == 1,
              name, ": expected lse, delta and g_lse of shape [BH,T,1], got ",
              shape_of(x).c_str());
  TORCH_CHECK(x.is_contiguous(), name,
              ": lse, delta and g_lse must be contiguous");
}

std::tuple<torch::Tensor, torch::Tensor> flash_fwd(const torch::Tensor& q,
                                                   const torch::Tensor& k,
                                                   const torch::Tensor& v,
                                                   double scale, bool causal) {
  check_qkv("flash_fwd", {q, k, v});
  const c10::cuda::CUDAGuard guard(q.device());
  const int64_t bh = q.size(0), t = q.size(1), d = q.size(2);
  auto out = torch::empty_like(q);
  auto lse = torch::empty({bh, t, 1}, q.options().dtype(torch::kFloat32));
  if (bh == 0 || t == 0) return {out, lse};
  check_launch("flash_fwd",
               ctpu_flash_fwd(q.scalar_type() == torch::kBFloat16,
                              q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), lse.data_ptr<float>(),
                              static_cast<int>(bh), static_cast<int>(t),
                              static_cast<int>(d), static_cast<float>(scale),
                              causal, at::cuda::getCurrentCUDAStream()));
  return {out, lse};
}

torch::Tensor flash_bwd_dq(const torch::Tensor& q, const torch::Tensor& k,
                           const torch::Tensor& v, const torch::Tensor& dout,
                           const torch::Tensor& lse,
                           const torch::Tensor& delta,
                           const torch::Tensor& glse, double scale,
                           bool causal) {
  check_qkv("flash_bwd_dq", {q, k, v, dout});
  for (const auto& x : {lse, delta, glse}) check_rows("flash_bwd_dq", x, q);
  const c10::cuda::CUDAGuard guard(q.device());
  const int64_t bh = q.size(0), t = q.size(1), d = q.size(2);
  auto dq = torch::empty_like(q);
  if (bh == 0 || t == 0) return dq;
  check_launch("flash_bwd_dq",
               ctpu_flash_bwd_dq(
                   q.scalar_type() == torch::kBFloat16, q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                   lse.data_ptr<float>(), delta.data_ptr<float>(),
                   glse.data_ptr<float>(), dq.data_ptr(),
                   static_cast<int>(bh), static_cast<int>(t),
                   static_cast<int>(d), static_cast<float>(scale), causal,
                   at::cuda::getCurrentCUDAStream()));
  return dq;
}

std::tuple<torch::Tensor, torch::Tensor> flash_bwd_dkv(
    const torch::Tensor& q, const torch::Tensor& k, const torch::Tensor& v,
    const torch::Tensor& dout, const torch::Tensor& lse,
    const torch::Tensor& delta, const torch::Tensor& glse, double scale,
    bool causal) {
  check_qkv("flash_bwd_dkv", {q, k, v, dout});
  for (const auto& x : {lse, delta, glse}) check_rows("flash_bwd_dkv", x, q);
  const c10::cuda::CUDAGuard guard(q.device());
  const int64_t bh = q.size(0), t = q.size(1), d = q.size(2);
  auto dk = torch::empty_like(k);
  auto dv = torch::empty_like(v);
  if (bh == 0 || t == 0) return {dk, dv};
  check_launch("flash_bwd_dkv",
               ctpu_flash_bwd_dkv(
                   q.scalar_type() == torch::kBFloat16, q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                   lse.data_ptr<float>(), delta.data_ptr<float>(),
                   glse.data_ptr<float>(), dk.data_ptr(), dv.data_ptr(),
                   static_cast<int>(bh), static_cast<int>(t),
                   static_cast<int>(d), static_cast<float>(scale), causal,
                   at::cuda::getCurrentCUDAStream()));
  return {dk, dv};
}

// q [B,T,H,hd] roped queries; pool_k, pool_v [n_blocks+1, block_size, KV,
// hd] one layer's pools; tables [B,W] int32; pos [B,T] int32.  q and the
// pools share one dtype (f32 or bf16), hd is 16, 32, 64 or 128, and every
// tensor is contiguous: anything else is refused, nothing is copied.
torch::Tensor paged_attention(const torch::Tensor& q,
                              const torch::Tensor& pool_k,
                              const torch::Tensor& pool_v,
                              const torch::Tensor& tables,
                              const torch::Tensor& pos, int64_t block_size) {
  const char* name = "paged_attention";
  for (const auto& x : {q, pool_k, pool_v, tables, pos}) {
    TORCH_CHECK(x.is_cuda(), name,
                ": q, pool_k, pool_v, tables and pos must be CUDA tensors");
    TORCH_CHECK(x.device() == q.device(), name,
                ": q, pool_k, pool_v, tables and pos must be on one device");
    TORCH_CHECK(x.is_contiguous(), name,
                ": q, pool_k, pool_v, tables and pos must be contiguous");
  }
  TORCH_CHECK(q.dim() == 4 && pool_k.dim() == 4 && tables.dim() == 2 &&
                  pos.dim() == 2,
              name, ": expected q [B,T,H,hd], pools [N,bs,KV,hd], tables "
              "[B,W] and pos [B,T], got q ", shape_of(q).c_str(), ", pool ",
              shape_of(pool_k).c_str(), ", tables ", shape_of(tables).c_str(),
              ", pos ", shape_of(pos).c_str());
  TORCH_CHECK(pool_v.sizes() == pool_k.sizes(), name,
              ": pool_k and pool_v differ in shape: ",
              shape_of(pool_k).c_str(), " and ", shape_of(pool_v).c_str());
  const int64_t b = q.size(0), t = q.size(1), h = q.size(2), hd = q.size(3);
  const int64_t n_blocks = pool_k.size(0), kv = pool_k.size(2);
  TORCH_CHECK(pool_k.size(1) == block_size && block_size > 0, name,
              ": the pools' block size is ", num(pool_k.size(1)).c_str(),
              ", block_size is ", num(block_size).c_str());
  TORCH_CHECK(pool_k.size(3) == hd, name, ": q's head dim ",
              num(hd).c_str(), " differs from the pools' ",
              num(pool_k.size(3)).c_str());
  TORCH_CHECK(kv > 0 && h % kv == 0, name, ": ", num(h).c_str(),
              " query heads do not group over ", num(kv).c_str(),
              " KV heads");
  TORCH_CHECK(tables.size(0) == b && pos.size(0) == b && pos.size(1) == t,
              name, ": tables ", shape_of(tables).c_str(), " and pos ",
              shape_of(pos).c_str(), " do not match q ", shape_of(q).c_str());
  TORCH_CHECK(hd == 16 || hd == 32 || hd == 64 || hd == 128, name,
              ": head dim must be 16, 32, 64 or 128, got ", num(hd).c_str());
  TORCH_CHECK(q.scalar_type() == torch::kFloat32 ||
                  q.scalar_type() == torch::kBFloat16,
              name, ": q must be float32 or bfloat16, got ", q.scalar_type());
  TORCH_CHECK(pool_k.scalar_type() == q.scalar_type() &&
                  pool_v.scalar_type() == q.scalar_type(),
              name, ": q, pool_k and pool_v must have one dtype");
  TORCH_CHECK(tables.scalar_type() == torch::kInt32 &&
                  pos.scalar_type() == torch::kInt32,
              name, ": tables and pos must be int32");
  TORCH_CHECK(b < 65536 && t < 65536 && n_blocks < INT32_MAX &&
                  tables.size(1) * block_size < INT32_MAX,
              name, ": dimension too large");
  const c10::cuda::CUDAGuard guard(q.device());
  auto out = torch::empty_like(q);
  if (b == 0 || t == 0 || h == 0) return out;
  check_launch(name, ctpu_paged_attention(
                         q.scalar_type() == torch::kBFloat16, q.data_ptr(),
                         pool_k.data_ptr(), pool_v.data_ptr(),
                         tables.data_ptr<int32_t>(), pos.data_ptr<int32_t>(),
                         out.data_ptr(), static_cast<int>(b),
                         static_cast<int>(t), static_cast<int>(h),
                         static_cast<int>(kv), static_cast<int>(hd),
                         static_cast<int>(n_blocks),
                         static_cast<int>(block_size),
                         static_cast<int>(tables.size(1)),
                         static_cast<float>(std::pow(static_cast<double>(hd), -0.5)),
                         at::cuda::getCurrentCUDAStream()));
  return out;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, module) {
  module.def("int8_matmul", &int8_matmul,
             "(x [M,K] f32|bf16, q [K,N] int8, s [N] f32) -> x @ q * s");
  module.def("flash_fwd", &flash_fwd,
             "(q, k, v [BH,T,D], scale, causal) -> (out [BH,T,D], "
             "lse [BH,T,1] f32)");
  module.def("flash_bwd_dq", &flash_bwd_dq,
             "(q, k, v, dO [BH,T,D], lse, delta, g_lse [BH,T,1] f32, scale, "
             "causal) -> dq");
  module.def("flash_bwd_dkv", &flash_bwd_dkv,
             "(q, k, v, dO [BH,T,D], lse, delta, g_lse [BH,T,1] f32, scale, "
             "causal) -> (dk, dv)");
  module.def("paged_attention", &paged_attention,
             "(q [B,T,H,hd], pool_k, pool_v [N,bs,KV,hd], tables [B,W] int32, "
             "pos [B,T] int32, block_size) -> out [B,T,H,hd]");
}
