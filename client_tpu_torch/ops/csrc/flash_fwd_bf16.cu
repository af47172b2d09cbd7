// Flash attention forward in bf16 on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas kernel client_tpu/ops/flash_attention.py:_fa_kernel
// (pallas_call in _fa_forward) for bf16 q, k, v [BH, T, D], D in
// {32, 64, 128}: out = softmax(q k^T * scale) v in bf16 and
// lse = logsumexp of the scaled scores, [BH, T] f32, causal or not, masked
// scores at _NEG = -1e30 as the Pallas kernel sets them.  f32 inputs keep
// fa_fwd_kernel in flash_attention.cu: a tensor-core f32 product would be
// TF32, outside the f32 tolerance.
//
// What bounds it on this card: at the training shape (BH = 64, T = 512,
// D = 64, causal) it moves 16.9 MB and does 2.15 GFLOP, so the least time is
// the bytes over 3.35 TB/s, 5.05 us; the products at even 30% of the 989
// TFLOP/s bf16 rate take 7 us.  So what counts is to keep the tensor cores
// fed and the copies hidden: latency and issue slots, not the mma rate.
// The design (FA-2):
// - One block of 4 warps per (bh, 64-row Q tile); each warp owns 16 Q rows.
//   Q tiles with the most KV tiles below the diagonal start first, and the
//   walk over KV tiles starts at tile 0 (so every row's running max is
//   finite before it meets a masked score) and stops at the diagonal.
// - S = Q K^T and O += P V by mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//   Fragments load with ldmatrix (V with ldmatrix.trans); the Q fragments
//   stay in registers for the whole walk.
// - K and V tiles [64, D] bf16 arrive by 16-byte cp.async (zero-filled past
//   T) through a two-stage ring: the next tile is in flight while this one
//   computes.  Rows are padded by 16 bytes, so every ldmatrix phase reads
//   eight distinct 16-byte bank groups.  85 KB a block at D = 128 (5 tiles),
//   so the launch raises the dynamic shared-memory limit.
// - The softmax works on the accumulator fragments in registers: row max
//   over the 4 lanes of a quad by __shfl_xor_sync, the scale folded into
//   each exp2 by one FMA on the raw score (ex2.approx.ftz: one SFU op), the
//   mask applied only on the diagonal tile and the ragged edge.  The C
//   layout of two m16n8 S tiles is the A layout of one m16n8k16, so P goes
//   to the P V product without leaving registers.
// - The output goes back through the warp's own Q rows in shared memory, so
//   the global stores are 16-byte rows.
// Tried on an H100 and dropped (PERF.md): two 16-row blocks a warp (fewer
// ldmatrix loads, but near the register limit), skipping the masked half
// of the diagonal tile (a runtime bound on the unrolled loops cost more
// than it saved), and a 4-blocks-a-SM register cap (spills at D = 64 and
// 128).
// Precision: bf16 x bf16 products are exact in f32, so S differs from the
// plain version only in the order of its f32 sum.  l sums the f32 p; p is
// rounded to bf16 only as the A operand of P V, as plain_attention rounds
// it (client_tpu_torch/parallel/ring_attention.py): within one bf16 ulp of
// the output.  Flushing a p below 2^-126 to 0 is far below any tolerance:
// every row's largest p is 1.
//
// Plain C interface; ctpu_flash_fwd in flash_attention.cu sends bf16 here.
// The fragment helpers are in flash_bf16.cuh, shared with the backward.

#include "flash_bf16.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using namespace flash_bf16;

constexpr float kNeg = -1e30f;  // the Pallas _NEG: -inf without NaNs
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   int t, float scale_log2, bool causal) {
  constexpr int kStride = D + kPad;
  constexpr int kTileElems = kTile * kStride;
  constexpr int kSteps = D / 16;       // k-steps of Q K^T
  constexpr int kOBlocks = D / 8;      // n-blocks of the O accumulator
  constexpr int kSBlocks = kTile / 8;  // n-blocks of S (keys)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kTileElems;      // two stages
  __nv_bfloat16* vs = ks + 2 * kTileElems;  // two stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;  // fragment row, column pair
  const int mi = lane >> 3;                // the 8x8 matrix this lane addresses
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const size_t base = (size_t)bh * t * D;
  const int kv_end = causal ? min(t, q0 + kTile) : t;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  // S is taken unscaled, and the scale folded into each exp2 by one FMA; a
  // negative scale flips the sign of q instead (exact in bf16), so the raw
  // row maximum is always the scaled one's
  const uint32_t q_sign = scale_log2 < 0.f ? 0x80008000u : 0u;
  const float c = fabsf(scale_log2);

  load_tile<D>(qs, q + base, q0, t);
  load_tile<D>(ks, k + base, 0, t);
  load_tile<D>(vs, v + base, 0, t);
  cp_async_commit();

  uint32_t qf[kSteps][4];
  float o[kOBlocks][4];
#pragma unroll
  for (int b = 0; b < kOBlocks; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[b][e] = 0.f;
  // running max (scaled, in log2 units) and this lane's part of the
  // denominator, for rows row0 and row0 + 8
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    const __nv_bfloat16* kt = ks + (j & 1) * kTileElems;
    const __nv_bfloat16* vt = vs + (j & 1) * kTileElems;
    if (j + 1 < n_tiles) {
      // the other stage was last read in iteration j - 1, which ended in a
      // barrier
      load_tile<D>(ks + ((j + 1) & 1) * kTileElems, k + base, k0 + kTile, t);
      load_tile<D>(vs + ((j + 1) & 1) * kTileElems, v + base, k0 + kTile, t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        ldmatrix_x4(qf[s], qs + (warp * 16 + (lane & 15)) * kStride + s * 16 +
                               (lane >> 4) * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[s][e] ^= q_sign;
      }
    }
    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float sc[kSBlocks][4];
#pragma unroll
    for (int b = 0; b < kSBlocks; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[b][e] = 0.f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int b = 0; b < kSBlocks; b += 2) {
        uint32_t kb[4];  // b0, b1 of key block b, then of key block b + 1
        ldmatrix_x4(kb, kt + (b * 8 + (mi >> 1) * 8 + (lane & 7)) * kStride +
                            s * 16 + (mi & 1) * 8);
        mma_bf16(sc[b], qf[s], kb[0], kb[1]);
        mma_bf16(sc[b + 1], qf[s], kb[2], kb[3]);
      }

    // mask on the diagonal tile and the ragged edge only
    if ((causal && k0 == q0) || k0 + kTile > t) {
#pragma unroll
      for (int b = 0; b < kSBlocks; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e >> 1) * 8;
          const int key = k0 + b * 8 + tq * 2 + (e & 1);
          if (key >= t || (causal && key > row)) sc[b][e] = kNeg;
        }
    }

    // online softmax: row h's values are sc[*][2h] and sc[*][2h + 1]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNeg;
#pragma unroll
      for (int b = 0; b < kSBlocks; ++b)
        mx = fmaxf(mx, fmaxf(sc[b][2 * h], sc[b][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
      const float m_new = fmaxf(m[h], mx * c);
      const float corr = exp2_ftz(m[h] - m_new);
      m[h] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int b = 0; b < kSBlocks; ++b) {
        sc[b][2 * h] = exp2_ftz(fmaf(sc[b][2 * h], c, -m_new));
        sc[b][2 * h + 1] = exp2_ftz(fmaf(sc[b][2 * h + 1], c, -m_new));
        rs += sc[b][2 * h] + sc[b][2 * h + 1];
      }
      l[h] = l[h] * corr + rs;
#pragma unroll
      for (int b = 0; b < kOBlocks; ++b) {
        o[b][2 * h] *= corr;
        o[b][2 * h + 1] *= corr;
      }
    }

    // O += P V: key step s takes S blocks 2s and 2s + 1 as its A fragment
#pragma unroll
    for (int s = 0; s < kTile / 16; ++s) {
      uint32_t pa[4];
      c_to_a(pa, sc[2 * s], sc[2 * s + 1]);
#pragma unroll
      for (int b = 0; b < kOBlocks; b += 2) {
        uint32_t vb[4];  // b0, b1 of column block b, then of block b + 1
        ldmatrix_x4_trans(vb, vt + (s * 16 + (mi & 1) * 8 + (lane & 7)) *
                                       kStride +
                                   (b + (mi >> 1)) * 8);
        mma_bf16(o[b], pa, vb[0], vb[1]);
        mma_bf16(o[b + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // the quad's lanes hold parts of the row's denominator; every real row
    // saw its own diagonal key, so l >= 1 (the guard is the Pallas kernel's)
    float lr = l[h];
    lr += __shfl_xor_sync(~0u, lr, 1);
    lr += __shfl_xor_sync(~0u, lr, 2);
    const float inv = 1.f / fmaxf(lr, 1e-30f);
#pragma unroll
    for (int b = 0; b < kOBlocks; ++b) {
      o[b][2 * h] *= inv;
      o[b][2 * h + 1] *= inv;
    }
    const int qi = row0 + h * 8;
    if (tq == 0 && qi < t) lse[(size_t)bh * t + qi] = m[h] * kLn2 + logf(lr);
  }
  // the output goes through the warp's own Q rows for 16-byte stores
  store_rows<D>(qs + warp * 16 * kStride, o, out + base, q0 + warp * 16, t);
}

template <int D>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* out,
                     float* lse, int bh, int t, float scale, bool causal,
                     cudaStream_t stream) {
  const size_t smem = 5 * (size_t)kTile * (D + kPad) * sizeof(__nv_bfloat16);
  return launch(fa_fwd_bf16_kernel<D>, smem, bh, t, stream,
                static_cast<const __nv_bfloat16*>(q),
                static_cast<const __nv_bfloat16*>(k),
                static_cast<const __nv_bfloat16*>(v),
                static_cast<__nv_bfloat16*>(out), lse, t, scale * kLog2e,
                causal);
}

}  // namespace

// q, k, v [bh, t, d] bf16, contiguous, each 16-byte aligned -> out [bh, t, d]
// bf16 and lse [bh, t] f32.  d outside {32, 64, 128} is refused, and so is
// a pointer the 16-byte copies cannot take.
cudaError_t ctpu_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                void* out, float* lse, int bh, int t, int d,
                                float scale, bool causal,
                                cudaStream_t stream) {
  if (!aligned16({q, k, v, out})) return cudaErrorMisalignedAddress;
  switch (d) {
    case 32:
      return fwd_bf16<32>(q, k, v, out, lse, bh, t, scale, causal, stream);
    case 64:
      return fwd_bf16<64>(q, k, v, out, lse, bh, t, scale, causal, stream);
    case 128:
      return fwd_bf16<128>(q, k, v, out, lse, bh, t, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
