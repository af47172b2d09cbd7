// Int8 weight-only dequant-matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernel client_tpu/ops/quant.py:_int8_mm_kernel
// (pallas_call in int8_matmul): out[M,N] = (x[M,K] @ q[K,N]) * s[N], with
// q int8, s f32 per output channel, x and out in bf16 or f32.
//
// What bounds it on this card: at the served shapes (K = 256, N = 128..768,
// M = 1 at decode, M = prompt length at prefill) the work is a GEMV or a
// thin GEMM of 32-196 KB of int8 weights, far below the card's ~295
// operations per byte, so it is bound by bytes: 0.01-0.14 us.  At that size
// what a launch costs is latency: how many dependent rounds of memory
// traffic and barriers it waits through.  Two routes, chosen by shape in
// launch() below; both are this file's kernels, and neither falls back.
// - int8_gemv_kernel, for decode (M <= 8, N a multiple of 16, x within
//   48 KB of shared memory): each thread owns 16 consecutive output columns
//   and loads them as one 16-byte vector of q per K row, issuing all the
//   loads of its K slice before its FMAs (the first of them before x is
//   staged in shared memory as f32, so the two latencies overlap); the
//   block's 128 K slices reduce once (lanes by shuffle, warps through
//   shared memory), and the channel scale is applied once, after the
//   reduction.  One wave of loads and two barriers; no masked rows beyond
//   M.  What is left at M = 1 is the launch's own latency, as for cuBLAS.
// - int8_mm_kernel, the tiled route for the other shapes (prefill): a
//   16 x 64 output tile a block, K walked in rounds 64 deep through shared
//   memory with scalar loads, the weight widened to f32 there (exact: every
//   int8 value is a float).  It is latency-bound by its serial rounds
//   (PERF.md); mma.sync with the int8 widened in registers is later work.
// Both sum over K in f32 registers and scale once at the end, as the TPU
// kernel does; a loop inside the block replaces the TPU's sequential K grid
// axis.  Rows and columns beyond M and N are masked, so the caller pads
// nothing.
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

// Decode route: out[M, N] for M <= 8 (a template parameter, so every row
// is real).  Grid: one block per kBlockCols output columns.  Thread
// (slice, cg) owns the block's columns [cg * 16, cg * 16 + 16) and the K
// rows slice, slice + 128, slice + 256, ...: 2 rows each at K = 256.  At
// M = 1 a block is 256 threads over 32 columns; at M >= 2, where the FMAs
// and the reduction grow with M, 128 threads over 16 columns, twice the
// blocks (the faster of the shapes tried on an H100, PERF.md).
constexpr int kGemvCols = 16;     // columns a thread owns: one 16-byte load
constexpr int kGemvSlices = 128;  // K slices a block
constexpr int kGemvBatch = 8;     // 16-byte loads in flight before their FMAs
constexpr size_t kGemvMaxSmem = 48 * 1024;  // no opt-in limit to raise

template <int M>
struct Gemv {
  static constexpr int kColThreads = M == 1 ? 2 : 1;  // threads across
  static constexpr int kThreads = kGemvSlices * kColThreads;
  static constexpr int kBlockCols = kGemvCols * kColThreads;
  static constexpr int kWarps = kThreads / 32;
  // x [M][k] as f32, then the warps' partial sums [kWarps][M][kBlockCols]
  static size_t smem_bytes(int k) {
    return ((size_t)M * k + (size_t)kWarps * M * kBlockCols) * sizeof(float);
  }
};

// 4 int8 (one 32-bit word) -> 4 exact floats: flipping the sign bit gives
// b + 128 as a byte, which ORed under 2^23's exponent is the float
// 2^23 + b + 128.
__device__ __forceinline__ void widen4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// kGemvBatch rows of the thread's 16 columns of q, from K row k0 in steps
// of kGemvSlices, as 16-byte loads; rows at or past k read as zeros
__device__ __forceinline__ void load_batch(uint4 (&w)[kGemvBatch],
                                           const int8_t* qc, int k0, int k,
                                           int n) {
#pragma unroll
  for (int j = 0; j < kGemvBatch; ++j) {
    const int kk = k0 + j * kGemvSlices;
    w[j] = kk < k ? __ldg(reinterpret_cast<const uint4*>(qc + (size_t)kk * n))
                  : make_uint4(0, 0, 0, 0);
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(Gemv<M>::kThreads)
int8_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ s, T* __restrict__ out, int k,
                 int n) {
  using G = Gemv<M>;
  extern __shared__ float gemv_smem[];
  float* xs = gemv_smem;          // [M][k]
  float* red = gemv_smem + M * k;  // [G::kWarps][M][G::kBlockCols]

  const int tid = threadIdx.x;
  const int cg = tid % G::kColThreads;
  const int slice = tid / G::kColThreads;
  const int col0 = blockIdx.x * G::kBlockCols + cg * kGemvCols;
  const bool live = col0 < n;  // n is a multiple of 16: a live group is whole
  const int8_t* qc = q + (live ? col0 : 0);

  // the first batch of q is in flight while x is staged
  uint4 w[kGemvBatch];
  if (live) load_batch(w, qc, slice, k, n);
  for (int i = tid; i < M * k; i += G::kThreads) xs[i] = to_f32(x[i]);
  __syncthreads();

  float acc[M][kGemvCols];
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) acc[r][c] = 0.f;

  for (int k0 = slice; live && k0 < k; k0 += kGemvSlices * kGemvBatch) {
    if (k0 != slice) load_batch(w, qc, k0, k, n);
#pragma unroll
    for (int j = 0; j < kGemvBatch; ++j) {
      const int kk = k0 + j * kGemvSlices;
      if (kk < k) {
        float wf[kGemvCols];
        widen4(w[j].x, wf);
        widen4(w[j].y, wf + 4);
        widen4(w[j].z, wf + 8);
        widen4(w[j].w, wf + 12);
#pragma unroll
        for (int r = 0; r < M; ++r) {
          const float xv = xs[r * k + kk];
#pragma unroll
          for (int c = 0; c < kGemvCols; ++c)
            acc[r][c] = fmaf(xv, wf[c], acc[r][c]);
        }
      }
    }
  }

  // sum the warp's slices of each column group (lanes cg + kColThreads * i)
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c)
#pragma unroll
      for (int o = G::kColThreads; o < 32; o <<= 1)
        acc[r][c] += __shfl_xor_sync(~0u, acc[r][c], o);
  const int warp = tid / 32, lane = tid % 32;
  if (lane < G::kColThreads) {
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int c = 0; c < kGemvCols; ++c)
        red[(warp * M + r) * G::kBlockCols + lane * kGemvCols + c] =
            acc[r][c];
  }
  __syncthreads();
  // then the warps' sums, and the channel scale, once
  for (int i = tid; i < M * G::kBlockCols; i += G::kThreads) {
    const int r = i / G::kBlockCols, c = i % G::kBlockCols;
    const int gn = blockIdx.x * G::kBlockCols + c;
    if (gn >= n) continue;
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < G::kWarps; ++wp)
      sum += red[(wp * M + r) * G::kBlockCols + c];
    store_out(&out[(size_t)r * n + gn], sum * s[gn]);
  }
}

template <typename T>
cudaError_t launch_tiled(const T* x, const int8_t* q, const float* s, T* out,
                         int m, int k, int n, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int8_mm_kernel<T><<<grid, kThreads, 0, stream>>>(x, q, s, out, m, k, n);
  return cudaGetLastError();
}

// The GEMV kernel where x fits the shared memory a block has without
// opting in (every M <= 8 at K <= 1024), else the tiled one.
template <typename T, int M>
cudaError_t launch_gemv(const T* x, const int8_t* q, const float* s, T* out,
                        int k, int n, cudaStream_t stream) {
  using G = Gemv<M>;
  const size_t smem = G::smem_bytes(k);
  if (smem > kGemvMaxSmem) return launch_tiled(x, q, s, out, M, k, n, stream);
  const dim3 grid((n + G::kBlockCols - 1) / G::kBlockCols);
  int8_gemv_kernel<T, M><<<grid, G::kThreads, smem, stream>>>(x, q, s, out,
                                                              k, n);
  return cudaGetLastError();
}

// The route by shape: decode shapes whose q rows the 16-byte loads can take
// go to the GEMV kernel, the rest to the tiled kernel.
template <typename T>
cudaError_t launch(const void* x_, const int8_t* q, const float* s,
                   void* out_, int m, int k, int n, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  T* out = static_cast<T*>(out_);
  if (n % kGemvCols == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0) {
    switch (m) {
      case 1: return launch_gemv<T, 1>(x, q, s, out, k, n, stream);
      case 2: return launch_gemv<T, 2>(x, q, s, out, k, n, stream);
      case 3: return launch_gemv<T, 3>(x, q, s, out, k, n, stream);
      case 4: return launch_gemv<T, 4>(x, q, s, out, k, n, stream);
      case 5: return launch_gemv<T, 5>(x, q, s, out, k, n, stream);
      case 6: return launch_gemv<T, 6>(x, q, s, out, k, n, stream);
      case 7: return launch_gemv<T, 7>(x, q, s, out, k, n, stream);
      case 8: return launch_gemv<T, 8>(x, q, s, out, k, n, stream);
    }
  }
  return launch_tiled(x, q, s, out, m, k, n, stream);
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
