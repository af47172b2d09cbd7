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
// traffic and barriers it waits through.  Three routes, chosen by dtype and
// shape in launch() below; all are this file's kernels, and none falls back
// to another after a failure.
// - int8_gemv_kernel, for decode (M <= 4 in bf16, M <= 8 in f32, N a
//   multiple of 16, x within 48 KB of shared memory): each thread owns 16 consecutive output columns
//   and loads them as one 16-byte vector of q per K row, issuing all the
//   loads of its K slice before its FMAs (the first of them before x is
//   staged in shared memory as f32, so the two latencies overlap); the
//   block's 128 K slices reduce once (lanes by shuffle, warps through
//   shared memory), and the channel scale is applied once, after the
//   reduction.  One wave of loads and two barriers; no masked rows beyond
//   M.  What is left at M = 1 is the launch's own latency, as for cuBLAS.
// - int8_mma_kernel, for bf16 x from M = 5 (decode at 8 lanes, prefill
//   chunks, verify ticks) where K and N are multiples of 16 and x, q, out
//   are 16-byte aligned:
//   the Pallas kernel's own arithmetic, a bf16 product with f32
//   accumulation, on the tensor cores (mma.sync.m16n8k16).  A block owns a
//   16 x 32 output tile, each of its 4 warps 8 columns over the whole of
//   K, in four independent mma chains.
//   The channel scales are loaded with the first wave.  The x slab (bf16)
//   comes by 16-byte cp.async and the q
//   slab (int8) by 16-byte loads into registers, in one wave: q is widened
//   to bf16 in registers (exact: |q| <= 127 has 7 significant bits) and
//   stored as the B operand tile, then one barrier, and the fragments load
//   by ldmatrix (q's with .trans, as V's in the flash forward).  K = 256 is
//   one pass; a larger K walks 256-deep chunks through a two-stage ring.
//   Small tiles give the engine's shapes blocks enough: M = 63 at N = 768
//   is 96 blocks.  What is left at the engine's shapes is the launch's own
//   latency and one round of loads, as for cuBLAS.
// - int8_mm_kernel, the CUDA-core tiled route for the rest: f32 x (a bf16
//   product would round x), and shapes the mma route cannot take.  A 16 x
//   64 output tile a block, K walked in rounds 64 deep through shared
//   memory with scalar loads, the weight widened to f32 there (exact: every
//   int8 value is a float); latency-bound by its serial rounds (PERF.md).
// All sum over K in f32 registers and scale once at the end, as the TPU
// kernel does; a loop inside the block replaces the TPU's sequential K grid
// axis.  Rows and columns beyond M and N are masked, so the caller pads
// nothing.
//
// Plain C interface (no PyTorch headers here, so nvcc stays fast); the
// binding in binding.cpp checks the tensors, allocates the
// output and launches on PyTorch's current stream.

#include "flash_bf16.cuh"

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

template <typename T, int M>
cudaError_t launch_gemv(const T* x, const int8_t* q, const float* s, T* out,
                        int k, int n, cudaStream_t stream) {
  using G = Gemv<M>;
  const dim3 grid((n + G::kBlockCols - 1) / G::kBlockCols);
  int8_gemv_kernel<T, M><<<grid, G::kThreads, G::smem_bytes(k), stream>>>(
      x, q, s, out, k, n);
  return cudaGetLastError();
}

// The tensor-core route (bf16 x).  A block of 4 warps owns a 16 x 32
// output tile, a warp 8 of its columns; shared memory a stage: the x slab
// [16][kMmaKC] and the widened q slab [kMmaKC][32], both bf16, rows padded
// by 16 bytes so every ldmatrix phase reads eight distinct 16-byte bank
// groups.
constexpr int kMmaBM = 16;         // output rows a block
constexpr int kMmaBN = 32;         // output columns a block
constexpr int kMmaKC = 256;        // K depth a stage
constexpr int kMmaThreads = 128;   // 4 warps
constexpr int kXStride = kMmaKC + flash_bf16::kPad;
constexpr int kQStride = kMmaBN + flash_bf16::kPad;
constexpr int kXPieces = kMmaBM * kMmaKC / 8 / kMmaThreads;
constexpr int kQPieces = kMmaKC * kMmaBN / 16 / kMmaThreads;
constexpr int kXElems = kMmaBM * kXStride;
constexpr size_t kStageBytes =
    (size_t)(kXElems + kMmaKC * kQStride) * sizeof(__nv_bfloat16);

// Chunk [k0, k0 + kMmaKC) of the x slab into a stage by cp.async; rows past
// m and columns past k are zero-filled (the address stays x's first row).
__device__ __forceinline__ void mma_load_x(__nv_bfloat16* xs,
                                           const __nv_bfloat16* x, int m0,
                                           int k0, int m, int k) {
#pragma unroll
  for (int it = 0; it < kXPieces; ++it) {
    const int p = threadIdx.x + it * kMmaThreads;
    const int r = p / (kMmaKC / 8), c = (p % (kMmaKC / 8)) * 8;
    const bool in = m0 + r < m && k0 + c < k;
    const __nv_bfloat16* from = in ? x + (size_t)(m0 + r) * k + k0 + c : x;
    flash_bf16::cp_async16(xs + r * kXStride + c, from, in ? 16 : 0);
  }
}

// The same chunk of q's column slab [n0, n0 + kMmaBN) into registers as
// 16-byte loads; pieces past k or n read as zeros.
__device__ __forceinline__ void mma_load_q(uint4 (&w)[kQPieces],
                                           const int8_t* q, int n0, int k0,
                                           int k, int n) {
#pragma unroll
  for (int it = 0; it < kQPieces; ++it) {
    const int p = threadIdx.x + it * kMmaThreads;
    const int r = p / (kMmaBN / 16), c = (p % (kMmaBN / 16)) * 16;
    w[it] = k0 + r < k && n0 + c < n
                ? __ldg(reinterpret_cast<const uint4*>(
                      q + (size_t)(k0 + r) * n + n0 + c))
                : make_uint4(0, 0, 0, 0);
  }
}

// Widen the registers' int8 to bf16 (exact) and store them as the B tile.
__device__ __forceinline__ void mma_store_q(__nv_bfloat16* qs,
                                            const uint4 (&w)[kQPieces]) {
#pragma unroll
  for (int it = 0; it < kQPieces; ++it) {
    const int p = threadIdx.x + it * kMmaThreads;
    const int r = p / (kMmaBN / 16), c = (p % (kMmaBN / 16)) * 16;
    float f[16];
    widen4(w[it].x, f);
    widen4(w[it].y, f + 4);
    widen4(w[it].z, f + 8);
    widen4(w[it].w, f + 12);
    uint4* dst = reinterpret_cast<uint4*>(qs + r * kQStride + c);
    using flash_bf16::pack_bf16;
    dst[0] = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                        pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
    dst[1] = make_uint4(pack_bf16(f[8], f[9]), pack_bf16(f[10], f[11]),
                        pack_bf16(f[12], f[13]), pack_bf16(f[14], f[15]));
  }
}

// Four k-steps (64 of K) from k-step st of a stage: the 16 rows against the
// warp's 8 columns, one accumulator a step, so the mma chains are a quarter
// of the steps long.
__device__ __forceinline__ void mma_steps4(float (&acc)[4][4],
                                           const __nv_bfloat16* xs,
                                           const __nv_bfloat16* qs, int st) {
  using namespace flash_bf16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mi = lane >> 3;
  uint32_t b[2][4];  // b0, b1 of steps st, st + 1; then of st + 2, st + 3
#pragma unroll
  for (int h = 0; h < 2; ++h)
    ldmatrix_x4_trans(
        b[h], qs + ((st + 2 * h) * 16 + mi * 8 + (lane & 7)) * kQStride +
                  warp * 8);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t a[4];
    ldmatrix_x4(a, xs + (lane & 15) * kXStride + (st + j) * 16 +
                       (lane >> 4) * 8);
    mma_bf16(acc[j], a, b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
  }
}

__global__ void __launch_bounds__(kMmaThreads)
int8_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ q, const float* __restrict__ s,
                __nv_bfloat16* __restrict__ out, int m, int k, int n) {
  using namespace flash_bf16;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* stage[2] = {
      reinterpret_cast<__nv_bfloat16*>(mma_smem),
      reinterpret_cast<__nv_bfloat16*>(mma_smem + kStageBytes)};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * kMmaBN, m0 = blockIdx.y * kMmaBM;
  const int chunks = (k + kMmaKC - 1) / kMmaKC;

  // chunk 0 (x by cp.async, q by 16-byte loads) and the channel scales, all
  // in flight at once
  uint4 w[kQPieces];
  mma_load_x(stage[0], x, m0, 0, m, k);
  cp_async_commit();
  mma_load_q(w, q, n0, 0, k, n);
  const int col = n0 + warp * 8 + tq * 2;
  const float2 scale = col < n
                           ? make_float2(__ldg(s + col), __ldg(s + col + 1))
                           : make_float2(0.f, 0.f);
  mma_store_q(stage[0] + kXElems, w);

  float acc[4][4] = {};
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c is in its stage; chunk c - 1 is done with
    const int k0 = c * kMmaKC;
    const bool next = c + 1 < chunks;
    const __nv_bfloat16* xs = stage[c & 1];
    const __nv_bfloat16* qs = xs + kXElems;
    if (next) {  // chunk c + 1 into the other stage while c computes
      mma_load_x(stage[(c + 1) & 1], x, m0, k0 + kMmaKC, m, k);
      cp_async_commit();
      mma_load_q(w, q, n0, k0 + kMmaKC, k, n);
    }
    const int kc = min(kMmaKC, k - k0);
    if (kc == kMmaKC) {  // a whole chunk: unrolled
#pragma unroll
      for (int st = 0; st < kMmaKC / 16; st += 4)
        mma_steps4(acc, xs, qs, st);
    } else {  // the ragged last chunk: steps past k are zero-filled
      for (int st = 0; st < kc / 16; st += 4) mma_steps4(acc, xs, qs, st);
    }
    if (next) mma_store_q(stage[(c + 1) & 1] + kXElems, w);
  }

  // the channel scale once, after the K loop; rows past m, columns past n
  // left out
  if (col >= n) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + g + h * 8;
    const float v0 = (acc[0][2 * h] + acc[1][2 * h]) +
                     (acc[2][2 * h] + acc[3][2 * h]);
    const float v1 = (acc[0][2 * h + 1] + acc[1][2 * h + 1]) +
                     (acc[2][2 * h + 1] + acc[3][2 * h + 1]);
    if (row < m)
      *reinterpret_cast<uint32_t*>(out + (size_t)row * n + col) =
          pack_bf16(v0 * scale.x, v1 * scale.y);
  }
}

// True where the tensor-core route takes the shape: K and N whole 16-wide
// steps (so every 16-byte piece is all in or all out) and 16-byte aligned
// x, q and out.
bool mma_takes(const void* x, const int8_t* q, const void* out, int k,
               int n) {
  return k % 16 == 0 && n % 16 == 0 && flash_bf16::aligned16({x, q, out});
}

// One 16 x 32 tile for every shape: the engine's (M <= 64, N <= 768) are
// at most 96 blocks, one wave on the card's 132 SMs.
cudaError_t launch_mma(const __nv_bfloat16* x, const int8_t* q,
                       const float* s, __nv_bfloat16* out, int m, int k, int n,
                       cudaStream_t stream) {
  const size_t smem = (k > kMmaKC ? 2 : 1) * kStageBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + kMmaBN - 1) / kMmaBN, (m + kMmaBM - 1) / kMmaBM);
  int8_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(x, q, s, out, m, k, n);
  return cudaGetLastError();
}

template <int M>
size_t gemv_smem_bytes(int k) { return Gemv<M>::smem_bytes(k); }

// True where the GEMV route takes the shape: M <= 8, q rows the 16-byte
// loads can take, and x within the shared memory a block has without
// opting in (every M <= 8 at K <= 1024).
bool gemv_takes(const int8_t* q, int m, int k, int n) {
  if (m < 1 || m > 8 || n % kGemvCols || reinterpret_cast<uintptr_t>(q) % 16)
    return false;
  static size_t (*const smem[])(int) = {
      gemv_smem_bytes<1>, gemv_smem_bytes<2>, gemv_smem_bytes<3>,
      gemv_smem_bytes<4>, gemv_smem_bytes<5>, gemv_smem_bytes<6>,
      gemv_smem_bytes<7>, gemv_smem_bytes<8>};
  return smem[m - 1](k) <= kGemvMaxSmem;
}

template <typename T>
cudaError_t launch_gemv_m(const T* x, const int8_t* q, const float* s, T* out,
                          int m, int k, int n, cudaStream_t stream) {
  switch (m) {
    case 1: return launch_gemv<T, 1>(x, q, s, out, k, n, stream);
    case 2: return launch_gemv<T, 2>(x, q, s, out, k, n, stream);
    case 3: return launch_gemv<T, 3>(x, q, s, out, k, n, stream);
    case 4: return launch_gemv<T, 4>(x, q, s, out, k, n, stream);
    case 5: return launch_gemv<T, 5>(x, q, s, out, k, n, stream);
    case 6: return launch_gemv<T, 6>(x, q, s, out, k, n, stream);
    case 7: return launch_gemv<T, 7>(x, q, s, out, k, n, stream);
    default: return launch_gemv<T, 8>(x, q, s, out, k, n, stream);
  }
}

// The route by dtype and shape (not a fallback: each shape has one route):
// - bf16 x that the tensor-core route takes, from M = kMmaFromM: mma (at
//   M = 8 it took 2.24-2.30 us against the GEMV's 4.37-4.53 on an H100,
//   PERF.md);
// - decode shapes below that (and f32 x up to M = 8) whose q rows the
//   16-byte loads can take: GEMV;
// - the rest (f32 x above M = 8, K or N not a multiple of 16, a misaligned
//   tensor): the CUDA-core tiled kernel.
// Route kRouteAuto is this rule; the others force one route (for timing and
// the card tests) and refuse a shape it does not take.  The route launched
// goes to *taken, so the caller can count launches by route.
constexpr int kRouteAuto = 0, kRouteGemv = 1, kRouteTiled = 2, kRouteMma = 3;
constexpr int kMmaFromM = 5;

template <typename T>
cudaError_t launch(const void* x_, const int8_t* q, const float* s,
                   void* out_, int m, int k, int n, int route, int* taken,
                   cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  T* out = static_cast<T*>(out_);
  constexpr bool bf16 = sizeof(T) == 2;
  const bool mma = bf16 && mma_takes(x_, q, out_, k, n);
  if (route == kRouteAuto)
    route = mma && m >= kMmaFromM   ? kRouteMma
            : gemv_takes(q, m, k, n) ? kRouteGemv
            : mma                    ? kRouteMma
                                     : kRouteTiled;
  *taken = route;
  switch (route) {
    case kRouteGemv:
      if (!gemv_takes(q, m, k, n)) return cudaErrorInvalidValue;
      return launch_gemv_m<T>(x, q, s, out, m, k, n, stream);
    case kRouteMma:
      if (!mma) return cudaErrorInvalidValue;
      if constexpr (bf16)
        return launch_mma(x, q, s, out, m, k, n, stream);
      return cudaErrorInvalidValue;
    case kRouteTiled:
      return launch_tiled(x, q, s, out, m, k, n, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [m, k] f32, q [k, n] int8, s [n] f32 -> out [m, n] f32; all contiguous.
// *route: the route launched (1 GEMV, 2 CUDA-core tiled, 3 tensor cores).
cudaError_t ctpu_int8_matmul_f32(const void* x, const int8_t* q,
                                 const float* s, void* out, int m, int k,
                                 int n, int* route, cudaStream_t stream) {
  return launch<float>(x, q, s, out, m, k, n, kRouteAuto, route, stream);
}

// The same with x and out in bf16.
cudaError_t ctpu_int8_matmul_bf16(const void* x, const int8_t* q,
                                  const float* s, void* out, int m, int k,
                                  int n, int* route, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, q, s, out, m, k, n, kRouteAuto, route,
                               stream);
}

// One route forced (1 GEMV, 2 CUDA-core tiled, 3 tensor cores), for timing
// the routes against each other and for the card tests; a shape the route
// does not take is refused (cudaErrorInvalidValue).
cudaError_t ctpu_int8_matmul_route(bool bf16, int route, const void* x,
                                   const int8_t* q, const float* s, void* out,
                                   int m, int k, int n, cudaStream_t stream) {
  if (route < kRouteGemv || route > kRouteMma) return cudaErrorInvalidValue;
  int taken;
  return bf16 ? launch<__nv_bfloat16>(x, q, s, out, m, k, n, route, &taken,
                                      stream)
              : launch<float>(x, q, s, out, m, k, n, route, &taken, stream);
}
