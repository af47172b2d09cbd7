// Int8 weight-only dequant-matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernel client_tpu/ops/quant.py:_int8_mm_kernel
// (pallas_call in int8_matmul): out[M,N] = (x[M,K] @ q[K,N]) * s[N], with
// q int8, s f32 per output channel, x and out in bf16 or f32.
//
// What bounds it on this card: at the served shapes (K = 256..768,
// N = 128..768, M = 1 at decode, M = prompt length at prefill) the work is
// a GEMV or a thin GEMM of 32-196 KB of int8 weights, far below the card's
// ~295 operations per byte, so it is bound by bytes: 0.01-0.14 us.  This
// version does not come near that: measured on an H100 it takes ~11 us a
// launch at every served shape, bound by the latency of its serial rounds
// of scalar byte loads on few blocks (PERF.md).  The design keeps what the
// TPU kernel kept out of
// device memory: the int8 weight is read once per output tile and widened
// to float in shared memory (exact: every int8 value is a float), the sum
// over K lives in f32 registers, and the channel scale is applied once,
// after the K loop, in the store.  A loop over K inside the block replaces
// the TPU's sequential K grid axis.  Rows and columns beyond M and N are
// masked, so the caller pads nothing.  This is the simple first version:
// no tensor cores (wgmma), no TMA, no split-K for the M = 1 case.
//
// Plain C interface (no PyTorch headers here, so nvcc stays fast); the
// binding in binding.cpp checks the tensors, allocates the
// output and launches on PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 16;        // output rows per block
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 64;        // K depth staged per shared-memory round
constexpr int kThreads = 256;  // 4 row groups x 64 columns
constexpr int kRowsPerThread = kBM / (kThreads / kBN);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);  // round to nearest even, as astype does
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_mm_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ s, T* __restrict__ out, int m, int k,
               int n) {
  __shared__ float xs[kBM][kBK];
  __shared__ float ws[kBK][kBN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int col = tid % kBN;
  const int row0 = (tid / kBN) * kRowsPerThread;

  float acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // x tile [kBM, kBK]: neighbouring threads read neighbouring K
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gm = m0 + r, gk = k0 + c;
      xs[r][c] = (gm < m && gk < k) ? to_f32(x[(size_t)gm * k + gk]) : 0.f;
    }
    // int8 weight tile [kBK, kBN]: neighbouring threads read neighbouring N
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < k && gn < n)
                     ? static_cast<float>(q[(size_t)gk * n + gn])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float w = ws[kk][col];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        acc[r] = fmaf(xs[row0 + r][kk], w, acc[r]);
      }
    }
    __syncthreads();
  }

  const int gn = n0 + col;
  if (gn >= n) return;
  const float scale = s[gn];  // channel scale, once, after the K loop
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int gm = m0 + row0 + r;
    if (gm < m) store_out(&out[(size_t)gm * n + gn], acc[r] * scale);
  }
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* q, const float* s, void* out,
                   int m, int k, int n, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int8_mm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), q, s, static_cast<T*>(out), m, k, n);
  return cudaGetLastError();
}

}  // namespace

// x [m, k] f32, q [k, n] int8, s [n] f32 -> out [m, n] f32; all contiguous.
cudaError_t ctpu_int8_matmul_f32(const void* x, const int8_t* q,
                                 const float* s, void* out, int m, int k,
                                 int n, cudaStream_t stream) {
  return launch<float>(x, q, s, out, m, k, n, stream);
}

// The same with x and out in bf16.
cudaError_t ctpu_int8_matmul_bf16(const void* x, const int8_t* q,
                                  const float* s, void* out, int m, int k,
                                  int n, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, q, s, out, m, k, n, stream);
}
