// Flash attention backward in bf16 on Hopper's tensor cores (sm_90a): the
// dQ kernel and the dK/dV kernel.
//
// Replaces the Pallas kernels of client_tpu/ops/flash_attention.py, with
// their shared _block_dscores (:67), for bf16 inputs:
//   fa_bwd_dq_bf16_kernel  <- _dq_kernel  (:185; pallas_call at :268)
//   fa_bwd_dkv_bf16_kernel <- _dkv_kernel (:215; pallas_call at :289)
// on q, k, v, dO [BH, T, D] bf16, D in {32, 64, 128}, causal or not, T
// ragged or not, and the rows lse, delta = rowsum(dO * O) and the lse
// cotangent g_lse, [BH, T] f32:
//   p = exp(s * scale - lse) with s = q k^T (0 where masked),
//   ds = p * (dO v^T - delta + g_lse) * scale,
//   dq = sum_k ds k,  dv = sum_q p^T dO,  dk = sum_q ds^T q.
// f32 inputs keep fa_bwd_dq_kernel and fa_bwd_dkv_kernel in
// flash_attention.cu: a tensor-core f32 product would be TF32, outside the
// f32 tolerance.
//
// What bounds them on this card: at the training shape (BH = 64, T = 512,
// D = 64, causal) dQ moves 21.4 MB and does 3.2 GFLOP, dK/dV 25.6 MB and
// 4.3 GFLOP, so the least times are the bytes over 3.35 TB/s, 6.38 and
// 7.63 us (the products alone at the 989 TFLOP/s bf16 peak: 3.3 and 4.4 us).
// Like the forward (flash_fwd_bf16.cu) they are held back by latency and
// issue slots long before either: the design keeps the tensor cores fed,
// the copies hidden and every intermediate in registers.
// The design (FA-2's two-kernel backward, no atomics, so the result is the
// same on every run):
// - dQ: one block of 4 warps per (bh, 64-row Q tile), each warp 16 Q rows,
//   heaviest tiles first.  The Q and dO fragments are loaded once and held
//   in registers; K and V tiles arrive through a two-stage ring of 16-byte
//   cp.async copies into padded rows (as in the forward), and the walk runs
//   from KV tile 0 to the diagonal.  Per tile, S = Q K^T and dP = dO V^T
//   (K and V by ldmatrix), p and ds on the accumulator fragments with the
//   row's lse and g_lse - delta in registers, then dQ += dS K (K by
//   ldmatrix.trans) with dS going from C fragments to A fragments in
//   registers.
// - dK/dV: one block of 4 warps per (bh, 64-key tile), each warp 16 keys;
//   the first KV tiles walk the most Q tiles, so they start first.  Q, dO
//   and the tile's 64 lse, delta and g_lse values come through the ring;
//   the walk starts at the first Q tile that reaches the diagonal.  The
//   products are taken transposed, S^T = K Q^T and dP^T = V dO^T, so that a
//   key is a fragment row and a query a column: the query terms are read
//   per column from shared memory.  dV += P^T dO and dK += dS^T Q take P^T
//   and dS^T from C to A fragments in registers, dO and Q by ldmatrix.trans.
//   At D = 128 the dK and dV accumulators take 128 registers a thread, so K
//   and V are read from shared memory at each use instead of held.
// - Both take the scores 32 keys (dQ) or 32 queries (dK/dV) at a time, so
//   S and dP take 32 registers, not 64.  The scale is folded into each exp2
//   by one FMA; a masked p is set to 0 after the exp2 (with a negative scale
//   the masked raw score would overflow), on the diagonal tile and the
//   ragged edge only: a zero-filled row past T still gives p = exp(-lse).
// - The outputs go back through the warp's own shared rows, so the global
//   stores are 16-byte rows.  6 padded tiles a block: 55 KB at D = 64,
//   104 KB at D = 128, so the launch raises the dynamic shared-memory limit.
// Precision: S^T and dP^T are exact bf16 products summed in f32.  p and ds
// are rounded to bf16 only as the A operands of the dV, dK and dQ products
// (the plain version keeps them in f32; plain autograd rounds them too).
//
// Plain C interface; ctpu_flash_bwd_dq and ctpu_flash_bwd_dkv in
// flash_attention.cu send bf16 here.  The fragment helpers are in
// flash_bf16.cuh, shared with the forward.

#include "flash_bf16.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using namespace flash_bf16;

constexpr int kChunk = 32;  // keys (dQ) or queries (dK/dV) of one S slice
constexpr int kCBlocks = kChunk / 8;  // its n-blocks of 8

// 4 bytes global -> shared; src_bytes = 0 writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// The kTile lse, delta and g_lse values of the rows [r0, r0 + kTile) of one
// head into dst[3][kTile] by 4-byte cp.async (a head's rows need not be 16
// bytes aligned); rows at or past t are zero-filled.
__device__ __forceinline__ void load_rows(float* dst, const float* lse,
                                          const float* delta,
                                          const float* glse, int r0, int t) {
  for (int i = threadIdx.x; i < 3 * kTile; i += kThreads) {
    const int a = i / kTile, r = i % kTile;
    const float* src = a == 0 ? lse : a == 1 ? delta : glse;
    const int gr = r0 + r;
    const bool in = gr < t;
    cp_async4(dst + i, src + (in ? gr : r0), in ? 4 : 0);
  }
}

// True where score (query qi, key kj) is masked out.
__device__ __forceinline__ bool masked(int qi, int kj, int t, bool causal) {
  return qi >= t || kj >= t || (causal && kj > qi);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ glse,
                      __nv_bfloat16* __restrict__ dq, int t, float scale,
                      bool causal) {
  constexpr int kStride = D + kPad;
  constexpr int kTileElems = kTile * kStride;
  constexpr int kSteps = D / 16;    // k-steps of Q K^T and dO V^T
  constexpr int kDBlocks = D / 8;   // n-blocks of the dQ accumulator
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kTileElems;
  __nv_bfloat16* ks = dos + kTileElems;     // two stages
  __nv_bfloat16* vs = ks + 2 * kTileElems;  // two stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;  // fragment row, column pair
  const int mi = lane >> 3;                // the 8x8 matrix this lane addresses
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const size_t base = (size_t)bh * t * D;
  const size_t rbase = (size_t)bh * t;
  const int kv_end = causal ? min(t, q0 + kTile) : t;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const float c = scale * kLog2e;

  load_tile<D>(qs, q + base, q0, t);
  load_tile<D>(dos, dout + base, q0, t);
  load_tile<D>(ks, k + base, 0, t);
  load_tile<D>(vs, v + base, 0, t);
  cp_async_commit();

  // the row terms of rows row0 and row0 + 8: lse in log2 units, and
  // g_lse - delta
  float lse2[2], rterm[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = row0 + h * 8;
    const bool in = qi < t;
    lse2[h] = in ? lse[rbase + qi] * kLog2e : 0.f;
    rterm[h] = in ? glse[rbase + qi] - delta[rbase + qi] : 0.f;
  }

  uint32_t qf[kSteps][4], dof[kSteps][4];
  float acc[kDBlocks][4];
#pragma unroll
  for (int b = 0; b < kDBlocks; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[b][e] = 0.f;

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
        const int off = (warp * 16 + (lane & 15)) * kStride + s * 16 +
                        (lane >> 4) * 8;
        ldmatrix_x4(qf[s], qs + off);
        ldmatrix_x4(dof[s], dos + off);
      }
    }
    const bool edge = (causal && k0 == q0) || k0 + kTile > t || q0 + kTile > t;

#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += kChunk) {
      // S = Q K^T and dP = dO V^T for this warp's 16 rows and 32 keys
      float sc[kCBlocks][4], dp[kCBlocks][4];
#pragma unroll
      for (int b = 0; b < kCBlocks; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[b][e] = dp[b][e] = 0.f;
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
#pragma unroll
        for (int b = 0; b < kCBlocks; b += 2) {
          // b0, b1 of key block b, then of key block b + 1
          const int off = (c0 + b * 8 + (mi >> 1) * 8 + (lane & 7)) * kStride +
                          s * 16 + (mi & 1) * 8;
          uint32_t kb[4], vb[4];
          ldmatrix_x4(kb, kt + off);
          ldmatrix_x4(vb, vt + off);
          mma_bf16(sc[b], qf[s], kb[0], kb[1]);
          mma_bf16(sc[b + 1], qf[s], kb[2], kb[3]);
          mma_bf16(dp[b], dof[s], vb[0], vb[1]);
          mma_bf16(dp[b + 1], dof[s], vb[2], vb[3]);
        }

      // ds in place of dP: row h's values are [2h] and [2h + 1]
#pragma unroll
      for (int b = 0; b < kCBlocks; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float p = exp2_ftz(fmaf(sc[b][e], c, -lse2[h]));
          if (edge && masked(row0 + h * 8, k0 + c0 + b * 8 + tq * 2 + (e & 1),
                             t, causal))
            p = 0.f;
          dp[b][e] = p * (dp[b][e] + rterm[h]) * scale;
        }

      // dQ += dS K: key step s takes dS blocks 2s and 2s + 1 as its A
      // fragment
#pragma unroll
      for (int s = 0; s < kChunk / 16; ++s) {
        uint32_t da[4];
        c_to_a(da, dp[2 * s], dp[2 * s + 1]);
#pragma unroll
        for (int b = 0; b < kDBlocks; b += 2) {
          uint32_t kb[4];  // b0, b1 of column block b, then of block b + 1
          ldmatrix_x4_trans(kb, kt + (c0 + s * 16 + (mi & 1) * 8 + (lane & 7)) *
                                         kStride +
                                     (b + (mi >> 1)) * 8);
          mma_bf16(acc[b], da, kb[0], kb[1]);
          mma_bf16(acc[b + 1], da, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  // the warp's own Q rows were read only at j == 0
  store_rows<D>(qs + warp * 16 * kStride, acc, dq + base, q0 + warp * 16, t);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const float* __restrict__ glse,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int t, float scale,
                       bool causal) {
  // hold the K and V fragments in registers up to D = 64; at D = 128 they
  // would join 128 accumulator registers and spill
  constexpr bool kHoldKV = D <= 64;
  constexpr int kStride = D + kPad;
  constexpr int kTileElems = kTile * kStride;
  constexpr int kSteps = D / 16;    // k-steps of K Q^T and V dO^T
  constexpr int kDBlocks = D / 8;   // n-blocks of the dK and dV accumulators
  constexpr int kRowElems = 3 * kTile;  // lse, delta, g_lse of one Q tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kTileElems;
  __nv_bfloat16* qs = vs + kTileElems;       // two stages
  __nv_bfloat16* dos = qs + 2 * kTileElems;  // two stages
  float* rows = reinterpret_cast<float*>(dos + 2 * kTileElems);  // two stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;  // fragment row, column pair
  const int mi = lane >> 3;                // the 8x8 matrix this lane addresses
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;  // the first KV tiles walk the most
  const size_t base = (size_t)bh * t * D;
  const size_t rbase = (size_t)bh * t;
  // Q tiles wholly before this KV tile see none of its keys
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = (t - q_begin + kTile - 1) / kTile;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const float c = scale * kLog2e;

  load_tile<D>(ks, k + base, k0, t);
  load_tile<D>(vs, v + base, k0, t);
  load_tile<D>(qs, q + base, q_begin, t);
  load_tile<D>(dos, dout + base, q_begin, t);
  load_rows(rows, lse + rbase, delta + rbase, glse + rbase, q_begin, t);
  cp_async_commit();

  uint32_t kf[kHoldKV ? kSteps : 1][4], vf[kHoldKV ? kSteps : 1][4];
  float dka[kDBlocks][4], dva[kDBlocks][4];
#pragma unroll
  for (int b = 0; b < kDBlocks; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[b][e] = dva[b][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = q_begin + j * kTile;
    const __nv_bfloat16* qt = qs + (j & 1) * kTileElems;
    const __nv_bfloat16* dt = dos + (j & 1) * kTileElems;
    const float* rt = rows + (j & 1) * kRowElems;
    if (j + 1 < n_tiles) {
      // the other stage was last read in iteration j - 1, which ended in a
      // barrier
      const int nxt = (j + 1) & 1;
      load_tile<D>(qs + nxt * kTileElems, q + base, q0 + kTile, t);
      load_tile<D>(dos + nxt * kTileElems, dout + base, q0 + kTile, t);
      load_rows(rows + nxt * kRowElems, lse + rbase, delta + rbase,
                glse + rbase, q0 + kTile, t);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // the A fragments of the warp's 16 keys
    const int a_off =
        (warp * 16 + (lane & 15)) * kStride + (lane >> 4) * 8;
    if constexpr (kHoldKV) {
      if (j == 0) {
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          ldmatrix_x4(kf[s], ks + a_off + s * 16);
          ldmatrix_x4(vf[s], vs + a_off + s * 16);
        }
      }
    }
    const bool edge = (causal && q0 == k0) || q0 + kTile > t || k0 + kTile > t;

#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += kChunk) {
      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys and 32 queries
      float st[kCBlocks][4], dpt[kCBlocks][4];
#pragma unroll
      for (int b = 0; b < kCBlocks; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[b][e] = dpt[b][e] = 0.f;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        uint32_t ka[4], va[4];
        if constexpr (kHoldKV) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[s][e];
            va[e] = vf[s][e];
          }
        } else {
          ldmatrix_x4(ka, ks + a_off + s * 16);
          ldmatrix_x4(va, vs + a_off + s * 16);
        }
#pragma unroll
        for (int b = 0; b < kCBlocks; b += 2) {
          // b0, b1 of query block b, then of query block b + 1
          const int off = (c0 + b * 8 + (mi >> 1) * 8 + (lane & 7)) * kStride +
                          s * 16 + (mi & 1) * 8;
          uint32_t qb[4], db[4];
          ldmatrix_x4(qb, qt + off);
          ldmatrix_x4(db, dt + off);
          mma_bf16(st[b], ka, qb[0], qb[1]);
          mma_bf16(st[b + 1], ka, qb[2], qb[3]);
          mma_bf16(dpt[b], va, db[0], db[1]);
          mma_bf16(dpt[b + 1], va, db[2], db[3]);
        }
      }

      // p^T in place of S^T and ds^T in place of dP^T: a column is a query,
      // [e & 1] picks it, and [e >> 1] picks the key (key0 or key0 + 8)
#pragma unroll
      for (int b = 0; b < kCBlocks; ++b) {
        const int r = c0 + b * 8 + tq * 2;  // this thread's queries: r, r + 1
        const float2 l = *reinterpret_cast<const float2*>(rt + r);
        const float2 dl = *reinterpret_cast<const float2*>(rt + kTile + r);
        const float2 gl = *reinterpret_cast<const float2*>(rt + 2 * kTile + r);
        const float lse2[2] = {l.x * kLog2e, l.y * kLog2e};
        const float rterm[2] = {gl.x - dl.x, gl.y - dl.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = e & 1;
          float p = exp2_ftz(fmaf(st[b][e], c, -lse2[col]));
          if (edge && masked(q0 + r + col, key0 + (e >> 1) * 8, t, causal))
            p = 0.f;
          st[b][e] = p;
          dpt[b][e] = p * (dpt[b][e] + rterm[col]) * scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q: query step s takes blocks 2s and
      // 2s + 1 as its A fragment
#pragma unroll
      for (int s = 0; s < kChunk / 16; ++s) {
        uint32_t pa[4], da[4];
        c_to_a(pa, st[2 * s], st[2 * s + 1]);
        c_to_a(da, dpt[2 * s], dpt[2 * s + 1]);
#pragma unroll
        for (int b = 0; b < kDBlocks; b += 2) {
          // b0, b1 of column block b, then of block b + 1
          const int off = (c0 + s * 16 + (mi & 1) * 8 + (lane & 7)) * kStride +
                          (b + (mi >> 1)) * 8;
          uint32_t ob[4], qb[4];
          ldmatrix_x4_trans(ob, dt + off);
          ldmatrix_x4_trans(qb, qt + off);
          mma_bf16(dva[b], pa, ob[0], ob[1]);
          mma_bf16(dva[b + 1], pa, ob[2], ob[3]);
          mma_bf16(dka[b], da, qb[0], qb[1]);
          mma_bf16(dka[b + 1], da, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  // the warp's own K and V rows are read by no other warp
  store_rows<D>(ks + warp * 16 * kStride, dka, dk + base, k0 + warp * 16, t);
  store_rows<D>(vs + warp * 16 * kStride, dva, dv + base, k0 + warp * 16, t);
}

// 6 padded bf16 tiles a block: Q, dO and the K/V ring, or K, V and the
// Q/dO ring
template <int D>
constexpr size_t tiles_bytes() {
  return 6 * (size_t)kTile * (D + kPad) * sizeof(__nv_bfloat16);
}

template <int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const float* glse, void* dq, int bh, int t, float scale,
                   bool causal, cudaStream_t stream) {
  return launch(fa_bwd_dq_bf16_kernel<D>, tiles_bytes<D>(), bh, t, stream,
                static_cast<const __nv_bfloat16*>(q),
                static_cast<const __nv_bfloat16*>(k),
                static_cast<const __nv_bfloat16*>(v),
                static_cast<const __nv_bfloat16*>(dout), lse, delta, glse,
                static_cast<__nv_bfloat16*>(dq), t, scale, causal);
}

template <int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    const float* glse, void* dk, void* dv, int bh, int t,
                    float scale, bool causal, cudaStream_t stream) {
  // plus two stages of the Q tile's lse, delta and g_lse
  return launch(fa_bwd_dkv_bf16_kernel<D>,
                tiles_bytes<D>() + 2 * 3 * kTile * sizeof(float), bh, t,
                stream, static_cast<const __nv_bfloat16*>(q),
                static_cast<const __nv_bfloat16*>(k),
                static_cast<const __nv_bfloat16*>(v),
                static_cast<const __nv_bfloat16*>(dout), lse, delta, glse,
                static_cast<__nv_bfloat16*>(dk),
                static_cast<__nv_bfloat16*>(dv), t, scale, causal);
}

}  // namespace

// q, k, v, dout [bh, t, d] bf16, contiguous, each 16-byte aligned; lse,
// delta, glse [bh, t] f32 -> dq [bh, t, d] bf16.  d outside {32, 64, 128}
// is refused.
cudaError_t ctpu_flash_bwd_dq_bf16(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   const float* glse, void* dq, int bh, int t,
                                   int d, float scale, bool causal,
                                   cudaStream_t stream) {
  if (!aligned16({q, k, v, dout, dq})) return cudaErrorMisalignedAddress;
  switch (d) {
    case 32:
      return bwd_dq<32>(q, k, v, dout, lse, delta, glse, dq, bh, t, scale,
                        causal, stream);
    case 64:
      return bwd_dq<64>(q, k, v, dout, lse, delta, glse, dq, bh, t, scale,
                        causal, stream);
    case 128:
      return bwd_dq<128>(q, k, v, dout, lse, delta, glse, dq, bh, t, scale,
                         causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The same inputs -> dk, dv [bh, t, d] bf16, each 16-byte aligned.
cudaError_t ctpu_flash_bwd_dkv_bf16(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    const float* glse, void* dk, void* dv,
                                    int bh, int t, int d, float scale,
                                    bool causal, cudaStream_t stream) {
  if (!aligned16({q, k, v, dout, dk, dv})) return cudaErrorMisalignedAddress;
  switch (d) {
    case 32:
      return bwd_dkv<32>(q, k, v, dout, lse, delta, glse, dk, dv, bh, t,
                         scale, causal, stream);
    case 64:
      return bwd_dkv<64>(q, k, v, dout, lse, delta, glse, dk, dv, bh, t,
                         scale, causal, stream);
    case 128:
      return bwd_dkv<128>(q, k, v, dout, lse, delta, glse, dk, dv, bh, t,
                          scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
