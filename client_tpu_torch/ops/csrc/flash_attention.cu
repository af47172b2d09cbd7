// Flash attention forward, dQ and dK/dV in f32 on Hopper (sm_90a).
//
// Replaces the three Pallas kernels of client_tpu/ops/flash_attention.py
// for f32 inputs:
//   fa_fwd_kernel     <- _fa_kernel  (pallas_call in _fa_forward)
//   fa_bwd_dq_kernel  <- _dq_kernel  (first pallas_call in _fa_backward)
//   fa_bwd_dkv_kernel <- _dkv_kernel (second pallas_call in _fa_backward)
// on q, k, v, dO [BH, T, D] f32 (D in {32, 64, 128}) with lse,
// delta = rowsum(dO * O) and the lse cotangent g_lse as [BH, T] f32 rows:
//   forward: out = softmax(q k^T * scale) v, lse = logsumexp of the scores;
//   dQ:      dq = sum_k ds k;
//   dK/dV:   dv = sum_q p^T dO, dk = sum_q ds^T q;
// with p = exp(s - lse) recomputed from lse and
// ds = p * (dO v^T - delta + g_lse) * scale (the Pallas _block_dscores).
// bf16 inputs, the training path's, take the tensor-core kernels instead:
// the forward in flash_fwd_bf16.cu, dQ and dK/dV in flash_bwd_bf16.cu.
// These are kept for f32 only, where a tensor-core product would be TF32,
// outside the f32 tolerance.
//
// What bounds them on this card: every product is taken in f32 on the CUDA
// cores, as the Pallas kernels take them, so they cannot beat the f32 FMA
// rate: at [64, 512, 64] causal the forward's 2.15 GFLOP and the
// backward's 3.2-4.3 GFLOP take 32-64 us at 67 TFLOP/s, where the bytes
// (34-51 MB in f32) take 10-15 us.  In practice they sit below that too,
// bound by shared-memory loads: a 4x4 register micro-tile issues one shared
// load for every two FMAs.
//
// The design keeps what the TPU kernels kept out of device memory:
// - The sequential KV grid axis ("arbitrary" in Pallas) becomes a loop
//   inside the block: a block owns (bh, one 64-row Q tile) and walks the KV
//   tiles from 0 upward, with the running max, denominator and f32
//   accumulator in registers; the [T, T] scores never leave the SM.
//   Walking from tile 0 keeps _NEG = -1e30 safe: every row's first key is
//   key 0, so its running max is finite before it meets a masked tile.
// - Tiles strictly past the diagonal are skipped, as diag_ok does.
// - The backward is the FA-2 two-kernel scheme: the dQ kernel owns a Q tile
//   and walks KV tiles; the dK/dV kernel owns a KV tile and walks the Q
//   tiles from the first one that touches the diagonal.  No atomics, so
//   the result is the same on every run.
// - Tiles live in shared memory transposed ([D][65]): the odd row stride
//   makes both the row-wise and the column-wise reads of a tile free of bank
//   conflicts.  That is 33 KB a tile at D = 128, 116-167 KB a block, so the
//   launch raises the block's dynamic shared-memory limit.
// - Rows at or past T are masked here (keys to _NEG, loads to 0), so T need
//   not be a multiple of the tile.
//
// Plain C interface (no PyTorch headers here, so nvcc stays fast); the
// binding in binding.cpp checks the tensors, allocates the outputs and
// launches on PyTorch's current stream.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 64;           // rows of a Q tile and of a KV tile
constexpr int kStride = kTile + 1;  // row stride of a transposed tile
constexpr int kThreads = 256;       // a 16 x 16 grid of threads
constexpr int kRows = 4;            // tile rows a thread owns: ty * 4 + i
constexpr int kCols = 4;            // tile columns a thread owns: tx + 16 * j
constexpr float kNeg = -1e30f;      // the Pallas _NEG: -inf without NaNs

// Rows [r0, r0 + kTile) of one [t, D] matrix into the transposed tile
// dst[d * kStride + r]; rows at or past t read as 0.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int t) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int gr = r0 + r;
    dst[d * kStride + r] = gr < t ? src[(size_t)gr * D + d] : 0.f;
  }
}

// Sum and max over the 16 threads of one tile row (tx = 0..15, which lie
// in one half of a warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// a[i][j] = sum_d x[d][row i] * y[d][col j] over two transposed tiles: the
// thread's 4 x 4 block of a tile product.
template <int D>
__device__ __forceinline__ void tile_dot(float (&a)[kRows][kCols],
                                         const float* x, const float* y,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) a[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float xa[kRows], yb[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) xa[i] = x[d * kStride + ty * kRows + i];
#pragma unroll
    for (int j = 0; j < kCols; ++j) yb[j] = y[d * kStride + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) a[i][j] = fmaf(xa[i], yb[j], a[i][j]);
  }
}

// True where score (query qi, key kj) is masked out.
__device__ __forceinline__ bool masked(int qi, int kj, int t, bool causal) {
  return qi >= t || kj >= t || (causal && kj > qi);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int t, float scale, bool causal) {
  extern __shared__ float smem[];
  float* qs = smem;              // [D][kStride]
  float* ks = qs + D * kStride;  // [D][kStride]
  float* vs = ks + D * kStride;  // [D][kStride]
  float* ps = vs + D * kStride;  // [kTile][kStride]: p[q row][key]
  constexpr int kDc = D / 16;    // output columns a thread owns

  const int bh = blockIdx.x;
  // the last Q tiles have the most KV tiles under the diagonal: start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const size_t base = (size_t)bh * t * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<D>(qs, q + base, q0, t);

  float m[kRows], l[kRows], acc[kRows][kDc];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDc; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(t, q0 + kTile) : t;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the previous tile's reads of ks, vs and ps are done
    load_tile<D>(ks, k + base, k0, t);
    load_tile<D>(vs, v + base, k0, t);
    __syncthreads();

    float s[kRows][kCols];
    tile_dot<D>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty * kRows + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        s[i][j] = masked(qi, kj, t, causal) ? kNeg : s[i][j] * scale;
        mx = fmaxf(mx, s[i][j]);
      }
      const float new_m = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - new_m);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - new_m);
        rs += s[i][j];
      }
      l[i] = l[i] * corr + row_sum(rs);
#pragma unroll
      for (int c = 0; c < kDc; ++c) acc[i][c] *= corr;
      m[i] = new_m;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        ps[(ty * kRows + i) * kStride + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = ps[(ty * kRows + i) * kStride + c];
#pragma unroll
      for (int dc = 0; dc < kDc; ++dc) {
        const float vv = vs[(tx + 16 * dc) * kStride + c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][dc] = fmaf(p[i], vv, acc[i][dc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    if (qi >= t) continue;
    // every real row saw its own diagonal key, so l > 0; the guard is the
    // Pallas kernel's
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dc = 0; dc < kDc; ++dc)
      out[base + (size_t)qi * D + tx + 16 * dc] = acc[i][dc] / li;
    if (tx == 0) lse[(size_t)bh * t + qi] = m[i] + logf(li);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ glse, float* __restrict__ dq,
                 int t, float scale, bool causal) {
  extern __shared__ float smem[];
  float* qs = smem;                // [D][kStride]
  float* dos = qs + D * kStride;   // [D][kStride]
  float* ks = dos + D * kStride;   // [D][kStride]
  float* vs = ks + D * kStride;    // [D][kStride]
  float* dss = vs + D * kStride;   // [kTile][kStride]: ds[q row][key]
  constexpr int kDc = D / 16;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const size_t base = (size_t)bh * t * D;
  const size_t rbase = (size_t)bh * t;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<D>(qs, q + base, q0, t);
  load_tile<D>(dos, dout + base, q0, t);
  float lse_r[kRows], delta_r[kRows], glse_r[kRows], acc[kRows][kDc];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    lse_r[i] = qi < t ? lse[rbase + qi] : 0.f;
    delta_r[i] = qi < t ? delta[rbase + qi] : 0.f;
    glse_r[i] = qi < t ? glse[rbase + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < kDc; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(t, q0 + kTile) : t;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();
    load_tile<D>(ks, k + base, k0, t);
    load_tile<D>(vs, v + base, k0, t);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
    tile_dot<D>(s, qs, ks, ty, tx);
    tile_dot<D>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        const float x = masked(qi, kj, t, causal) ? kNeg : s[i][j] * scale;
        const float p = expf(x - lse_r[i]);
        const float row = dp[i][j] - delta_r[i] + glse_r[i];
        dss[(ty * kRows + i) * kStride + tx + 16 * j] = p * row * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float ds[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        ds[i] = dss[(ty * kRows + i) * kStride + c];
#pragma unroll
      for (int dc = 0; dc < kDc; ++dc) {
        const float kv = ks[(tx + 16 * dc) * kStride + c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][dc] = fmaf(ds[i], kv, acc[i][dc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    if (qi >= t) continue;
#pragma unroll
    for (int dc = 0; dc < kDc; ++dc)
      dq[base + (size_t)qi * D + tx + 16 * dc] = acc[i][dc];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const float* __restrict__ glse, float* __restrict__ dk,
                  float* __restrict__ dv, int t, float scale, bool causal) {
  extern __shared__ float smem[];
  float* ks = smem;                 // [D][kStride], this block's KV tile
  float* vs = ks + D * kStride;     // [D][kStride]
  float* qs = vs + D * kStride;     // [D][kStride], the Q tile of the walk
  float* dos = qs + D * kStride;    // [D][kStride]
  float* ps = dos + D * kStride;    // [kTile][kStride]: p[key][q row]
  float* dss = ps + kTile * kStride;   // [kTile][kStride]: ds[key][q row]
  float* lse_s = dss + kTile * kStride;  // [kTile] per Q row of the walk
  float* delta_s = lse_s + kTile;
  float* glse_s = delta_s + kTile;
  constexpr int kDc = D / 16;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;  // the first KV tiles walk the most
  const size_t base = (size_t)bh * t * D;
  const size_t rbase = (size_t)bh * t;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<D>(ks, k + base, k0, t);
  load_tile<D>(vs, v + base, k0, t);
  float dk_acc[kRows][kDc], dv_acc[kRows][kDc];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kDc; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // Q tiles wholly before this KV tile see none of its keys
  for (int q0 = causal ? k0 : 0; q0 < t; q0 += kTile) {
    __syncthreads();  // the previous Q tile's reads are done
    load_tile<D>(qs, q + base, q0, t);
    load_tile<D>(dos, dout + base, q0, t);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const int qi = q0 + r;
      lse_s[r] = qi < t ? lse[rbase + qi] : 0.f;
      delta_s[r] = qi < t ? delta[rbase + qi] : 0.f;
      glse_s[r] = qi < t ? glse[rbase + qi] : 0.f;
    }
    __syncthreads();

    // transposed blocks: this thread's keys are rows, its Q rows columns
    float s[kRows][kCols], dp[kRows][kCols];
    tile_dot<D>(s, ks, qs, ty, tx);
    tile_dot<D>(dp, vs, dos, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int kj = k0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int r = tx + 16 * j;
        const float x = masked(q0 + r, kj, t, causal) ? kNeg : s[i][j] * scale;
        const float p = expf(x - lse_s[r]);
        const float row = dp[i][j] - delta_s[r] + glse_s[r];
        ps[(ty * kRows + i) * kStride + r] = p;
        dss[(ty * kRows + i) * kStride + r] = p * row * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float p[kRows], ds[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        p[i] = ps[(ty * kRows + i) * kStride + c];
        ds[i] = dss[(ty * kRows + i) * kStride + c];
      }
#pragma unroll
      for (int dc = 0; dc < kDc; ++dc) {
        const float dov = dos[(tx + 16 * dc) * kStride + c];
        const float qv = qs[(tx + 16 * dc) * kStride + c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          dv_acc[i][dc] = fmaf(p[i], dov, dv_acc[i][dc]);
          dk_acc[i][dc] = fmaf(ds[i], qv, dk_acc[i][dc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kj = k0 + ty * kRows + i;
    if (kj >= t) continue;
#pragma unroll
    for (int dc = 0; dc < kDc; ++dc) {
      const size_t at = base + (size_t)kj * D + tx + 16 * dc;
      dk[at] = dk_acc[i][dc];
      dv[at] = dv_acc[i][dc];
    }
  }
}

constexpr size_t tile_bytes(int rows) {
  return (size_t)rows * kStride * sizeof(float);
}

// Raise the kernel's dynamic shared-memory limit, then launch it on
// grid (bh, tiles of t): a launch refused for its shared memory never runs,
// so the error is returned, not dropped.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, int bh, int t,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd_f32(const void* q, const void* k, const void* v, void* out,
                    float* lse, int bh, int t, float scale, bool causal,
                    cudaStream_t stream) {
  return launch(fa_fwd_kernel<D>, 3 * tile_bytes(D) + tile_bytes(kTile),
                bh, t, stream, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<float*>(out), lse, t, scale, causal);
}

template <int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const float* glse, void* dq, int bh, int t, float scale,
                   bool causal, cudaStream_t stream) {
  return launch(fa_bwd_dq_kernel<D>, 4 * tile_bytes(D) + tile_bytes(kTile),
                bh, t, stream, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<const float*>(dout), lse, delta, glse,
                static_cast<float*>(dq), t, scale, causal);
}

template <int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    const float* glse, void* dk, void* dv, int bh, int t,
                    float scale, bool causal, cudaStream_t stream) {
  return launch(fa_bwd_dkv_kernel<D>,
                4 * tile_bytes(D) + 2 * tile_bytes(kTile) +
                    3 * kTile * sizeof(float),
                bh, t, stream, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<const float*>(dout), lse, delta, glse,
                static_cast<float*>(dk), static_cast<float*>(dv), t, scale,
                causal);
}

// One instantiation per D; D outside {32, 64, 128} is refused.
#define CTPU_FLASH_BY_D(D_, FN, ...)          \
  do {                                        \
    switch (D_) {                             \
      case 32:                                \
        return FN<32>(__VA_ARGS__);           \
      case 64:                                \
        return FN<64>(__VA_ARGS__);           \
      case 128:                               \
        return FN<128>(__VA_ARGS__);          \
      default:                                \
        return cudaErrorInvalidValue;         \
    }                                         \
  } while (0)

}  // namespace

cudaError_t ctpu_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                void* out, float* lse, int bh, int t, int d,
                                float scale, bool causal, cudaStream_t stream);
cudaError_t ctpu_flash_bwd_dq_bf16(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   const float* glse, void* dq, int bh, int t,
                                   int d, float scale, bool causal,
                                   cudaStream_t stream);
cudaError_t ctpu_flash_bwd_dkv_bf16(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    const float* glse, void* dk, void* dv,
                                    int bh, int t, int d, float scale,
                                    bool causal, cudaStream_t stream);

// q, k, v [bh, t, d] (f32, or bf16 when bf16 is true), all contiguous ->
// out [bh, t, d] in their dtype and lse [bh, t] f32.  bf16 takes the
// tensor-core kernel of flash_fwd_bf16.cu, f32 fa_fwd_kernel.
cudaError_t ctpu_flash_fwd(bool bf16, const void* q, const void* k,
                           const void* v, void* out, float* lse, int bh,
                           int t, int d, float scale, bool causal,
                           cudaStream_t stream) {
  if (bf16)
    return ctpu_flash_fwd_bf16(q, k, v, out, lse, bh, t, d, scale, causal,
                               stream);
  CTPU_FLASH_BY_D(d, fwd_f32, q, k, v, out, lse, bh, t, scale, causal,
                  stream);
}

// The same q, k, v and dout [bh, t, d]; lse, delta, glse [bh, t] f32 ->
// dq [bh, t, d].  bf16 takes the tensor-core kernel of flash_bwd_bf16.cu,
// f32 fa_bwd_dq_kernel.
cudaError_t ctpu_flash_bwd_dq(bool bf16, const void* q, const void* k,
                              const void* v, const void* dout,
                              const float* lse, const float* delta,
                              const float* glse, void* dq, int bh, int t,
                              int d, float scale, bool causal,
                              cudaStream_t stream) {
  if (bf16)
    return ctpu_flash_bwd_dq_bf16(q, k, v, dout, lse, delta, glse, dq, bh, t,
                                  d, scale, causal, stream);
  CTPU_FLASH_BY_D(d, bwd_dq, q, k, v, dout, lse, delta, glse, dq, bh, t,
                  scale, causal, stream);
}

// The same inputs -> dk, dv [bh, t, d]: bf16 by flash_bwd_bf16.cu, f32 by
// fa_bwd_dkv_kernel.
cudaError_t ctpu_flash_bwd_dkv(bool bf16, const void* q, const void* k,
                               const void* v, const void* dout,
                               const float* lse, const float* delta,
                               const float* glse, void* dk, void* dv, int bh,
                               int t, int d, float scale, bool causal,
                               cudaStream_t stream) {
  if (bf16)
    return ctpu_flash_bwd_dkv_bf16(q, k, v, dout, lse, delta, glse, dk, dv,
                                   bh, t, d, scale, causal, stream);
  CTPU_FLASH_BY_D(d, bwd_dkv, q, k, v, dout, lse, delta, glse, dk, dv, bh, t,
                  scale, causal, stream);
}
