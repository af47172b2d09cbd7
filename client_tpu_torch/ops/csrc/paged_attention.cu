// Paged attention for Hopper (sm_90a).
//
// Replaces client_tpu/serve/models/transformer.py:paged_attention, the one
// attention every step of the continuous-batching engine runs (decode at
// T = 1 over the lanes, speculative verify at T = width, chunked prefill at
// B = 1, T = chunk).  In the reference it is plain jnp, not Pallas: a gather
// of the lane's WHOLE block table, then a dense masked softmax, so it reads
// table_width x block_size keys for every lane and layer whatever the
// lane's length.  This kernel computes the same function:
//   out[b,t,h,:] = softmax_j(q[b,t,h,:] . k_j * hd^-0.5, j <= pos[b,t]) V
// where key j of lane b lies in pool row (tables[b, j / bs], j % bs), KV
// head h / (H / KV) (GQA), scores and softmax in f32, and p rounded to the
// pools' dtype before P.V as the reference's p.astype(vv.dtype) does.  A
// query with pos < 0 attends no key in the reference: every score is the
// mask value, so its softmax is uniform over the whole gathered table and
// its output the mean of those V rows.  The kernel gives the same: such a
// row takes every key of the table with a score of 0, and only such a row
// reads past its mask bound.
//
// What bounds it on this card: it reads each attended K/V row once and q,
// out once, a few hundred KB at the engine's shapes, far below the card's
// operations-per-byte line: it is bound by bytes (0.08-0.63 us at decode),
// and in practice by the latency of its dependent rounds of loads.  So the
// design gives every block one round (flash-decoding):
// - Split-K over the keys.  The grid is (split, KV head x row chunk, lane),
//   a fixed function of B, T, H, KV and the table width, never of pos,
//   which lives on the device: a CUDA graph captured at one context
//   replays at any other.  A split holds kSplitKeys = 64 logical keys
//   (4 pool blocks at the served block size 16); a split whose keys all
//   lie past every row's bound exits at once, writing m = -inf and l = 0.
// - One block serves every query row (query position x query head) that
//   shares its KV head, so those rows share every staged K/V row.  It loads
//   its rows' positions, its table entries and q in one wave, then its K/V
//   rows (only those at or below the block's bound) by 16-byte cp.async
//   into padded shared rows, zero-filling the rest, in a second: two
//   dependent rounds of loads and no loop.
// - Each split writes its rows' unnormalised f32 partials (m, l, acc) to a
//   workspace the binding allocates with torch.empty, and a second kernel
//   combines them in a fixed order over the splits, with no atomics, so a
//   relaunch is bit-equal.
// Two routes for the split kernel, by dtype and T in launch():
// - paged_split_kernel, on the CUDA cores: decode (T = 1), verify
//   (T = width) and f32 at any T.  16 query rows a block; a warp takes a
//   row's scores, one key in 32 a lane, dot products in f32 from 16-byte
//   shared reads; the row's max, exp and sum by shuffles; P.V with a
//   thread per (row, dim).
// - paged_mma_kernel, on the tensor cores (bf16, T >= 16: prefill chunks):
//   64 query rows a block, 16 a warp; S = Q K^T and O = P V by
//   mma.sync.m16n8k16 with the flash_bf16.cuh fragment helpers, the
//   softmax on the accumulator fragments in registers.
// Rounding points: scores, max, exp and the row sums l in f32; p rounded to
// the pools' dtype (round to nearest even) as the A operand or factor of
// P.V, before the division by l, where the reference rounds the normalised
// p: within one bf16 ulp of the output.  The combine rescales each split's
// acc and l by exp(m_split - m) in f32 and divides once; the output is
// rounded once.
//
// Plain C++ interface (no PyTorch headers here, so nvcc stays fast); the
// binding in binding.cpp checks the tensors, allocates the output and the
// workspace and launches on PyTorch's current stream.

#include "flash_bf16.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplitKeys = 64;  // logical keys a split: two a warp lane
constexpr int kRows = 16;       // query rows a CUDA-core block
constexpr int kMmaRows = 64;    // query rows a tensor-core block: 16 a warp
constexpr int kRouteSplit = 1, kRouteMma = 2;  // the split kernel's routes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// p in the pools' dtype, widened back to f32 (exact) for the product
__device__ __forceinline__ float round_p(float v, const float*) { return v; }
__device__ __forceinline__ float round_p(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);  // round to nearest even, as astype does
}
// 8 consecutive values of a shared row, widened to f32
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The shape of one call, as every kernel here reads it.
struct Shape {
  int t_len, n_heads, n_kv, n_pool_blocks, block_size, table_width;
  int n_splits;  // splits of the table's keys: ceil(W * bs / kSplitKeys)
  float scale;
};

// A query row's last attended key, and whether it attends uniformly: pos
// past the table's end attends to its end; pos < 0 attends every key of
// the table with one score (the reference's all-masked row).
struct RowBound {
  int last;
  bool uniform;
};
__device__ __forceinline__ RowBound row_bound(int pos, int n_keys) {
  if (pos < 0) return {n_keys - 1, true};
  return {min(pos, n_keys - 1), false};
}

// The block's table entries for keys [k0, k0 + kSplitKeys): entry i is
// table[k0 / bs + i], clamped into the pool as JAX's gather clamps it.
__device__ __forceinline__ void load_entries(int* tab, const int32_t* table,
                                             int k0, const Shape& sh) {
  const int e0 = k0 / sh.block_size;
  const int n_ent =
      min((k0 + kSplitKeys - 1) / sh.block_size + 1, sh.table_width) - e0;
  for (int i = threadIdx.x; i < n_ent; i += blockDim.x)
    tab[i] = min(max(table[e0 + i], 0), sh.n_pool_blocks - 1);
}

// K and V rows of keys k0 .. k0 + kSplitKeys - 1 of KV head kvh into
// padded shared rows by 16-byte cp.async: keys past `last` are zero-filled
// and never loaded.  Rows of the pool are HD values, `stride` elements
// apart in shared memory.
template <typename T, int HD>
__device__ __forceinline__ void load_kv(T* ks, T* vs, const T* pool_k,
                                        const T* pool_v, const int* tab,
                                        int k0, int last, int kvh, int stride,
                                        const Shape& sh) {
  constexpr int kChunks = HD * sizeof(T) / 16;  // 16-byte pieces a row
  constexpr int kElems = 16 / sizeof(T);
  const int e0 = k0 / sh.block_size;
  for (int i = threadIdx.x; i < kSplitKeys * kChunks; i += blockDim.x) {
    const int j = i / kChunks, c = i % kChunks;
    const int key = k0 + j;
    const bool in = key <= last;
    int64_t off = 0;
    if (in) {
      const int blk = tab[key / sh.block_size - e0];
      off = ((static_cast<int64_t>(blk) * sh.block_size +
              key % sh.block_size) * sh.n_kv + kvh) * HD + c * kElems;
    }
    flash_bf16::cp_async16(ks + j * stride + c * kElems, pool_k + off,
                           in ? 16 : 0);
    flash_bf16::cp_async16(vs + j * stride + c * kElems, pool_v + off,
                           in ? 16 : 0);
  }
}

// Index of query row r (= t * rep + i) of KV head kvh of lane b among the
// [B, T, H] rows of q, out and the workspace.
__device__ __forceinline__ int64_t out_row(int b, int r, int kvh, int rep,
                                           const Shape& sh) {
  const int t = r / rep, i = r % rep;
  return (static_cast<int64_t>(b) * sh.t_len + t) * sh.n_heads + kvh * rep + i;
}

// Shared memory of a CUDA-core block, in bytes: K and V [kSplitKeys] rows
// padded by 16 bytes, q [kRows][HD] f32, p [kRows][kSplitKeys] f32, the
// rows' bounds and the block's table entries.
template <typename T, int HD>
constexpr int split_stride() { return HD + 16 / sizeof(T); }
template <typename T, int HD>
constexpr size_t split_smem() {
  return 2 * kSplitKeys * split_stride<T, HD>() * sizeof(T) +
         (size_t)kRows * HD * 4 + (size_t)kRows * kSplitKeys * 4 +
         kRows * 8 + kSplitKeys * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                   const T* __restrict__ pool_v,
                   const int32_t* __restrict__ tables,
                   const int32_t* __restrict__ pos, float* __restrict__ part_o,
                   float2* __restrict__ part_ml, Shape sh) {
  constexpr int kStride = split_stride<T, HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kSplitKeys * kStride;
  float* qs = reinterpret_cast<float*>(vs + kSplitKeys * kStride);  // [kRows][HD]
  float* ps = qs + kRows * HD;               // [kRows][kSplitKeys]
  int* last_s = reinterpret_cast<int*>(ps + kRows * kSplitKeys);  // [kRows]
  int* uni_s = last_s + kRows;               // [kRows]
  int* tab = uni_s + kRows;                  // [kSplitKeys]

  const int split = blockIdx.x, b = blockIdx.z;
  const int rep = sh.n_heads / sh.n_kv;
  const int n_rows = sh.t_len * rep;
  const int chunks = (n_rows + kRows - 1) / kRows;
  const int kvh = blockIdx.y / chunks, r0 = (blockIdx.y % chunks) * kRows;
  const int rows = min(kRows, n_rows - r0);
  const int n_keys = sh.table_width * sh.block_size;
  const int k0 = split * kSplitKeys;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // one wave: the rows' bounds, the table entries and q (as f32)
  if (tid < kRows) {
    RowBound rb{-1, false};
    if (tid < rows)
      rb = row_bound(pos[static_cast<int64_t>(b) * sh.t_len + (r0 + tid) / rep],
                     n_keys);
    last_s[tid] = rb.last;
    uni_s[tid] = rb.uniform;
  }
  load_entries(tab, tables + static_cast<int64_t>(b) * sh.table_width, k0, sh);
  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    qs[i] = to_f32(q[out_row(b, r0 + r, kvh, rep, sh) * HD + d]);
  }
  __syncthreads();
  int last = -1;
  for (int r = 0; r < rows; ++r) last = max(last, last_s[r]);
  if (k0 > last) {  // no row attends a key of this split
    for (int r = tid; r < rows; r += kThreads)
      part_ml[out_row(b, r0 + r, kvh, rep, sh) * sh.n_splits + split] =
          make_float2(-INFINITY, 0.f);
    return;
  }
  // the second wave: K and V rows up to the block's bound
  load_kv<T, HD>(ks, vs, pool_k, pool_v, tab, k0, last, kvh, kStride, sh);
  flash_bf16::cp_async_commit();
  flash_bf16::cp_async_wait<0>();
  __syncthreads();

  // scores and the split's softmax terms: a warp a row, keys lane, lane + 32
  for (int r = warp; r < rows; r += kWarps) {
    const int row_last = last_s[r];
    const bool uniform = uni_s[r];
    float sc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 8) {
        float kf[8], qf[8];
        load8(ks + j * kStride + d, kf);
        load8(qs + r * HD + d, qf);
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qf[e], kf[e], dot);
      }
      sc[h] = k0 + j > row_last ? -INFINITY : uniform ? 0.f : dot * sh.scale;
    }
    float mx = fmaxf(sc[0], sc[1]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, o));
    // a row with no key here (another row of the block has some) adds 0
    const float e0 = mx == -INFINITY ? 0.f : expf(sc[0] - mx);
    const float e1 = mx == -INFINITY ? 0.f : expf(sc[1] - mx);
    float sum = e0 + e1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
    ps[r * kSplitKeys + lane] = round_p(e0, q);
    ps[r * kSplitKeys + lane + 32] = round_p(e1, q);
    if (lane == 0)
      part_ml[out_row(b, r0 + r, kvh, rep, sh) * sh.n_splits + split] =
          make_float2(mx, sum);
  }
  __syncthreads();
  // P.V of the keys at or below the bound, a thread a (row, dim)
  const int kn = min(kSplitKeys, last - k0 + 1);
  for (int i = tid; i < rows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float a = 0.f;
    for (int j = 0; j < kn; ++j)
      a = fmaf(ps[r * kSplitKeys + j], to_f32(vs[j * kStride + d]), a);
    part_o[(out_row(b, r0 + r, kvh, rep, sh) * sh.n_splits + split) * HD + d] =
        a;
  }
}

// Shared memory of a tensor-core block: Q [kMmaRows], K and V [kSplitKeys]
// bf16 rows padded by 16 bytes, the rows' bounds and the table entries.
template <int HD>
constexpr size_t mma_smem() {
  return (size_t)(kMmaRows + 2 * kSplitKeys) * (HD + flash_bf16::kPad) * 2 +
         kMmaRows * 8 + kSplitKeys * 4;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ pool_k,
                 const __nv_bfloat16* __restrict__ pool_v,
                 const int32_t* __restrict__ tables,
                 const int32_t* __restrict__ pos, float* __restrict__ part_o,
                 float2* __restrict__ part_ml, Shape sh) {
  using namespace flash_bf16;
  static_assert(kSplitKeys == kTile, "a split is one 64-key tile");
  constexpr int kStride = HD + kPad;
  constexpr int kSteps = HD / 16;          // k-steps of Q K^T
  constexpr int kOBlocks = HD / 8;         // n-blocks of O
  constexpr int kSBlocks = kSplitKeys / 8; // n-blocks of S
  constexpr int kChunks = HD / 8;          // 16-byte pieces a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kMmaRows * kStride;
  __nv_bfloat16* vs = ks + kSplitKeys * kStride;
  int* last_s = reinterpret_cast<int*>(vs + kSplitKeys * kStride);
  int* uni_s = last_s + kMmaRows;
  int* tab = uni_s + kMmaRows;

  const int split = blockIdx.x, b = blockIdx.z;
  const int rep = sh.n_heads / sh.n_kv;
  const int n_rows = sh.t_len * rep;
  const int tiles = (n_rows + kMmaRows - 1) / kMmaRows;
  const int kvh = blockIdx.y / tiles, r0 = (blockIdx.y % tiles) * kMmaRows;
  const int n_keys = sh.table_width * sh.block_size;
  const int k0 = split * kSplitKeys;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3, mi = lane >> 3;

  // one wave: the rows' bounds, the table entries and the Q tile
  if (tid < kMmaRows) {
    RowBound rb{-1, false};  // rows past the last one attend nothing
    if (r0 + tid < n_rows)
      rb = row_bound(pos[static_cast<int64_t>(b) * sh.t_len + (r0 + tid) / rep],
                     n_keys);
    last_s[tid] = rb.last;
    uni_s[tid] = rb.uniform;
  }
  load_entries(tab, tables + static_cast<int64_t>(b) * sh.table_width, k0, sh);
  for (int i = tid; i < kMmaRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r0 + r < n_rows;
    const __nv_bfloat16* from =
        q + (in ? out_row(b, r0 + r, kvh, rep, sh) * HD + c * 8 : 0);
    cp_async16(qs + r * kStride + c * 8, from, in ? 16 : 0);
  }
  cp_async_commit();
  __syncthreads();
  int last = -1;
  for (int r = 0; r < kMmaRows; ++r) last = max(last, last_s[r]);
  if (k0 > last) {
    for (int r = tid; r < min(kMmaRows, n_rows - r0); r += kThreads)
      part_ml[out_row(b, r0 + r, kvh, rep, sh) * sh.n_splits + split] =
          make_float2(-INFINITY, 0.f);
    cp_async_wait<0>();
    return;
  }
  load_kv<__nv_bfloat16, HD>(ks, vs, pool_k, pool_v, tab, k0, last, kvh,
                             kStride, sh);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // S = Q K^T for this warp's 16 rows and the split's 64 keys
  float sc[kSBlocks][4];
#pragma unroll
  for (int bb = 0; bb < kSBlocks; ++bb)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[bb][e] = 0.f;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    uint32_t qf[4];
    ldmatrix_x4(qf, qs + (warp * 16 + (lane & 15)) * kStride + s * 16 +
                        (lane >> 4) * 8);
#pragma unroll
    for (int bb = 0; bb < kSBlocks; bb += 2) {
      uint32_t kb[4];
      ldmatrix_x4(kb, ks + (bb * 8 + (mi >> 1) * 8 + (lane & 7)) * kStride +
                          s * 16 + (mi & 1) * 8);
      mma_bf16(sc[bb], qf, kb[0], kb[1]);
      mma_bf16(sc[bb + 1], qf, kb[2], kb[3]);
    }
  }

  // the split's softmax terms: row h's values are sc[*][2h], sc[*][2h + 1]
  float o[kOBlocks][4];
#pragma unroll
  for (int bb = 0; bb < kOBlocks; ++bb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[bb][e] = 0.f;
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = warp * 16 + g + h * 8;
    const int row_last = last_s[row];
    const bool uniform = uni_s[row];
    float mx = -INFINITY;
#pragma unroll
    for (int bb = 0; bb < kSBlocks; ++bb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + bb * 8 + tq * 2 + e;
        float& v = sc[bb][2 * h + e];
        v = key > row_last ? -INFINITY : uniform ? 0.f : v * sh.scale;
        mx = fmaxf(mx, v);
      }
    mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
    float rs = 0.f;
#pragma unroll
    for (int bb = 0; bb < kSBlocks; ++bb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = sc[bb][2 * h + e];
        v = mx == -INFINITY ? 0.f : __expf(v - mx);
        rs += v;
      }
    rs += __shfl_xor_sync(~0u, rs, 1);
    rs += __shfl_xor_sync(~0u, rs, 2);
    m[h] = mx;
    l[h] = rs;
  }

  // O = P V: key step s takes S blocks 2s and 2s + 1 as its A fragment (p
  // rounded to bf16 there)
#pragma unroll
  for (int s = 0; s < kSplitKeys / 16; ++s) {
    uint32_t pa[4];
    c_to_a(pa, sc[2 * s], sc[2 * s + 1]);
#pragma unroll
    for (int bb = 0; bb < kOBlocks; bb += 2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vs + (s * 16 + (mi & 1) * 8 + (lane & 7)) *
                                     kStride +
                                 (bb + (mi >> 1)) * 8);
      mma_bf16(o[bb], pa, vb[0], vb[1]);
      mma_bf16(o[bb + 1], pa, vb[2], vb[3]);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + h * 8;
    if (r0 + r >= n_rows) continue;
    const int64_t at = out_row(b, r0 + r, kvh, rep, sh) * sh.n_splits + split;
    if (tq == 0) part_ml[at] = make_float2(m[h], l[h]);
#pragma unroll
    for (int bb = 0; bb < kOBlocks; ++bb)
      *reinterpret_cast<float2*>(part_o + at * HD + bb * 8 + tq * 2) =
          make_float2(o[bb][2 * h], o[bb][2 * h + 1]);
  }
}

// The combine: a warp a [B, T, H] row; the splits in order, each scaled by
// exp(m_split - m) in f32, then one division and one rounding.  A split
// with m = -inf (no key) is skipped, its acc never read.  Every real row
// has a key in split 0, so m is finite and l >= 1.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part_o,
                     const float2* __restrict__ part_ml, T* __restrict__ out,
                     int64_t n_out_rows, int n_splits) {
  constexpr int kPer = (HD + 31) / 32;  // dims a lane
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_out_rows) return;
  const float2* ml = part_ml + row * n_splits;
  float mx = -INFINITY;
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, ml[s].x);
  float l = 0.f, acc[kPer] = {};
  for (int s = 0; s < n_splits; ++s) {
    const float2 v = ml[s];
    if (v.x == -INFINITY) continue;
    const float w = expf(v.x - mx);
    l = fmaf(v.y, w, l);
    const float* po = part_o + (row * n_splits + s) * HD;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) acc[i] = fmaf(po[d], w, acc[i]);
    }
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = lane + 32 * i;
    if (d < HD) store_out(out + row * HD + d, acc[i] * inv);
  }
}

template <typename Kernel, typename T>
cudaError_t launch_split(Kernel kernel, size_t smem, int rows_a_block,
                         const T* q, const T* pool_k, const T* pool_v,
                         const int32_t* tables, const int32_t* pos,
                         float* part_o, float* part_ml, int batch,
                         const Shape& sh, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int n_rows = sh.t_len * (sh.n_heads / sh.n_kv);
  const dim3 grid(sh.n_splits,
                  sh.n_kv * ((n_rows + rows_a_block - 1) / rows_a_block),
                  batch);
  kernel<<<grid, kThreads, smem, stream>>>(q, pool_k, pool_v, tables, pos,
                                           part_o,
                                           reinterpret_cast<float2*>(part_ml),
                                           sh);
  return cudaGetLastError();
}

// The route by dtype and T: bf16 with T >= 16 (prefill chunks) on the
// tensor cores, the rest (decode, verify, f32) on the CUDA cores.  Both
// write the same partials, which one combine reads.
template <typename T, int HD>
cudaError_t launch(const void* q_, const void* pool_k_, const void* pool_v_,
                   const int32_t* tables, const int32_t* pos, void* out,
                   float* part_o, float* part_ml, int batch, const Shape& sh,
                   int* route, cudaStream_t stream) {
  const T* q = static_cast<const T*>(q_);
  const T* pool_k = static_cast<const T*>(pool_k_);
  const T* pool_v = static_cast<const T*>(pool_v_);
  cudaError_t err;
  *route = sizeof(T) == 2 && sh.t_len >= 16 ? kRouteMma : kRouteSplit;
  if constexpr (sizeof(T) == 2) {
    err = *route == kRouteMma
              ? launch_split(paged_mma_kernel<HD>, mma_smem<HD>(), kMmaRows,
                             q, pool_k, pool_v, tables, pos, part_o, part_ml,
                             batch, sh, stream)
              : launch_split(paged_split_kernel<T, HD>, split_smem<T, HD>(),
                             kRows, q, pool_k, pool_v, tables, pos, part_o,
                             part_ml, batch, sh, stream);
  } else {
    err = launch_split(paged_split_kernel<T, HD>, split_smem<T, HD>(), kRows,
                       q, pool_k, pool_v, tables, pos, part_o, part_ml, batch,
                       sh, stream);
  }
  if (err != cudaSuccess) return err;
  const int64_t n_out_rows =
      static_cast<int64_t>(batch) * sh.t_len * sh.n_heads;
  paged_combine_kernel<T, HD>
      <<<(n_out_rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
          part_o, reinterpret_cast<const float2*>(part_ml),
          static_cast<T*>(out), n_out_rows, sh.n_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int head_dim, const void* q, const void* pool_k,
                     const void* pool_v, const int32_t* tables,
                     const int32_t* pos, void* out, float* part_o,
                     float* part_ml, int batch, const Shape& sh, int* route,
                     cudaStream_t stream) {
#define CTPU_PAGED_CASE(D)                                                 \
  case D:                                                                  \
    return launch<T, D>(q, pool_k, pool_v, tables, pos, out, part_o,       \
                        part_ml, batch, sh, route, stream);
  switch (head_dim) {
    CTPU_PAGED_CASE(16)
    CTPU_PAGED_CASE(32)
    CTPU_PAGED_CASE(64)
    CTPU_PAGED_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef CTPU_PAGED_CASE
}

}  // namespace

// Splits of a table of table_width blocks of block_size keys: the size of
// the workspace's split axis.
int ctpu_paged_splits(int table_width, int block_size) {
  return (table_width * block_size + kSplitKeys - 1) / kSplitKeys;
}

// q [B, T, H, hd]; pool_k, pool_v [n_pool_blocks, block_size, KV, hd];
// tables [B, table_width] int32; pos [B, T] int32; out [B, T, H, hd]; all
// contiguous, one dtype for q, the pools and out (f32 or bf16).  part_o
// [B * T * H, splits, hd] and part_ml [B * T * H, splits, 2], f32, are the
// workspace (splits from ctpu_paged_splits).  q, the pools and out must be
// 16-byte aligned (the 16-byte copies), else cudaErrorMisalignedAddress.
// *route: the split kernel launched (1 CUDA cores, 2 tensor cores).
cudaError_t ctpu_paged_attention(bool bf16, const void* q, const void* pool_k,
                                 const void* pool_v, const int32_t* tables,
                                 const int32_t* pos, void* out, float* part_o,
                                 float* part_ml, int batch, int t_len,
                                 int n_heads, int n_kv, int head_dim,
                                 int n_pool_blocks, int block_size,
                                 int table_width, float scale, int* route,
                                 cudaStream_t stream) {
  if (!flash_bf16::aligned16({q, pool_k, pool_v, out, part_o, part_ml}))
    return cudaErrorMisalignedAddress;
  const Shape sh{t_len,      n_heads,     n_kv,
                 n_pool_blocks, block_size, table_width,
                 ctpu_paged_splits(table_width, block_size), scale};
  return bf16 ? dispatch<__nv_bfloat16>(head_dim, q, pool_k, pool_v, tables,
                                        pos, out, part_o, part_ml, batch, sh,
                                        route, stream)
              : dispatch<float>(head_dim, q, pool_k, pool_v, tables, pos, out,
                                part_o, part_ml, batch, sh, route, stream);
}
