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
// pools' dtype before P.V as the reference's p.astype(vv.dtype) does.
//
// What bounds it on this card: it reads each attended K/V row once and q,
// out once, a few hundred KB at the engine's shapes, far below the card's
// operations-per-byte line: it is bound by bytes, and at decode by the
// latency of its dependent rounds.  The design is the simple one, right
// first:
// - one block per (lane, query position, KV head); the H / KV query heads
//   that share a KV head share every K/V row the block stages;
// - the block walks the lane's table only over logical keys 0 .. pos[b,t]
//   (and never past the table's end), 32 keys a round through shared
//   memory, so it never loads a table entry or a pool row past the mask
//   bound: not the trash block's rows, not a row another lane owns;
// - an f32 online softmax (running max, denominator and accumulator), as
//   in the flash forward, one warp per query head for the row terms.
// Split-K over long contexts (flash-decoding) and the tensor cores are
// later kernel work.
//
// Plain C++ interface (no PyTorch headers here, so nvcc stays fast); the
// binding in binding.cpp checks the tensors, allocates the output and
// launches on PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileKeys = 32;  // keys a round: one per lane of a warp

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

// Shared memory of one block, in floats.
__host__ __device__ constexpr int smem_floats(int rep, int hd) {
  return 2 * rep * hd                  // q, accumulator
         + kTileKeys * (hd + 1)        // K tile, rows padded a bank
         + kTileKeys * hd              // V tile
         + rep * kTileKeys             // scores, then p
         + 3 * rep;                    // running max, denominator, rescale
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                       const T* __restrict__ pool_v,
                       const int32_t* __restrict__ tables,
                       const int32_t* __restrict__ pos, T* __restrict__ out,
                       int t_len, int n_heads, int n_kv, int n_pool_blocks,
                       int block_size, int table_width, float scale) {
  static_assert(kTileKeys == 32, "the row terms take one key per warp lane");
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  const int rep = n_heads / n_kv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  float* qs = smem;                       // [rep][HD]
  float* acc = qs + rep * HD;             // [rep][HD]
  float* ks = acc + rep * HD;             // [kTileKeys][HD + 1]
  float* vs = ks + kTileKeys * (HD + 1);  // [kTileKeys][HD]
  float* ps = vs + kTileKeys * HD;        // [rep][kTileKeys]
  float* m_run = ps + rep * kTileKeys;    // [rep]
  float* l_run = m_run + rep;             // [rep]
  float* corr = l_run + rep;              // [rep]

  // the rep query heads of this KV head are contiguous in q and out
  const int64_t row = static_cast<int64_t>(b) * t_len + t;
  const int64_t head0 = (row * n_heads + static_cast<int64_t>(kvh) * rep) * HD;
  for (int i = tid; i < rep * HD; i += kThreads) {
    qs[i] = to_f32(q[head0 + i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }
  // the mask bound: keys 0 .. pos are attended, none past the table's end
  const int n_keys = min(pos[row] + 1, table_width * block_size);
  const int32_t* table = tables + static_cast<int64_t>(b) * table_width;
  __syncthreads();

  for (int k0 = 0; k0 < n_keys; k0 += kTileKeys) {
    const int kn = min(kTileKeys, n_keys - k0);
    // stage keys k0 .. k0 + kn - 1; the rest of the tile is zero and no
    // pool row past the bound is loaded
    for (int i = tid; i < kTileKeys * HD; i += kThreads) {
      const int j = i / HD, d = i % HD;
      float kval = 0.f, vval = 0.f;
      if (j < kn) {
        const int key = k0 + j;
        // an entry outside the pool is clamped, as JAX's gather clamps it
        const int blk = min(max(table[key / block_size], 0), n_pool_blocks - 1);
        const int64_t off =
            ((static_cast<int64_t>(blk) * block_size + key % block_size) * n_kv +
             kvh) * HD + d;
        kval = to_f32(pool_k[off]);
        vval = to_f32(pool_v[off]);
      }
      ks[j * (HD + 1) + d] = kval;
      vs[j * HD + d] = vval;
    }
    __syncthreads();
    // scores of every (query head, key) pair of the round, in f32
    for (int i = tid; i < rep * kTileKeys; i += kThreads) {
      const int r = i / kTileKeys, j = i % kTileKeys;
      float s = -INFINITY;
      if (j < kn) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot = fmaf(qs[r * HD + d], ks[j * (HD + 1) + d], dot);
        s = dot * scale;
      }
      ps[i] = s;
    }
    __syncthreads();
    // online softmax row terms: one warp per query head, one key a lane
    for (int r = warp; r < rep; r += kWarps) {
      const float s = ps[r * kTileKeys + lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_run[r];
      const float m_new = fmaxf(m_old, mx);  // finite: kn >= 1
      const float e = lane < kn ? expf(s - m_new) : 0.f;
      float sum = e;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[r * kTileKeys + lane] = round_p(e, q);
      if (lane == 0) {
        const float c = expf(m_old - m_new);  // 0 on the first round
        corr[r] = c;
        l_run[r] = l_run[r] * c + sum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();
    // P.V into the f32 accumulator, rescaled to the new running max
    for (int i = tid; i < rep * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      float a = acc[i] * corr[r];
      for (int j = 0; j < kn; ++j)
        a = fmaf(ps[r * kTileKeys + j], vs[j * HD + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }
  for (int i = tid; i < rep * HD; i += kThreads) {
    const float l = l_run[i / HD];
    store_out(out + head0 + i, l > 0.f ? acc[i] / l : 0.f);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const int32_t* tables, const int32_t* pos, void* out,
                   int batch, int t_len, int n_heads, int n_kv,
                   int n_pool_blocks, int block_size, int table_width,
                   float scale, cudaStream_t stream) {
  const auto kernel = paged_attention_kernel<T, HD>;
  const size_t smem = sizeof(float) * smem_floats(n_heads / n_kv, HD);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_kv, t_len, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), tables, pos, static_cast<T*>(out), t_len,
      n_heads, n_kv, n_pool_blocks, block_size, table_width, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int head_dim, const void* q, const void* pool_k,
                     const void* pool_v, const int32_t* tables,
                     const int32_t* pos, void* out, int batch, int t_len,
                     int n_heads, int n_kv, int n_pool_blocks, int block_size,
                     int table_width, float scale, cudaStream_t stream) {
#define CTPU_PAGED_CASE(D)                                                    \
  case D:                                                                     \
    return launch<T, D>(q, pool_k, pool_v, tables, pos, out, batch, t_len,    \
                        n_heads, n_kv, n_pool_blocks, block_size, table_width, \
                        scale, stream);
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

// q [B, T, H, hd]; pool_k, pool_v [n_pool_blocks, block_size, KV, hd];
// tables [B, table_width] int32; pos [B, T] int32; out [B, T, H, hd]; all
// contiguous, one dtype for q, the pools and out (f32 or bf16).
cudaError_t ctpu_paged_attention(bool bf16, const void* q, const void* pool_k,
                                 const void* pool_v, const int32_t* tables,
                                 const int32_t* pos, void* out, int batch,
                                 int t_len, int n_heads, int n_kv,
                                 int head_dim, int n_pool_blocks,
                                 int block_size, int table_width, float scale,
                                 cudaStream_t stream) {
  return bf16 ? dispatch<__nv_bfloat16>(head_dim, q, pool_k, pool_v, tables,
                                        pos, out, batch, t_len, n_heads, n_kv,
                                        n_pool_blocks, block_size, table_width,
                                        scale, stream)
              : dispatch<float>(head_dim, q, pool_k, pool_v, tables, pos, out,
                                batch, t_len, n_heads, n_kv, n_pool_blocks,
                                block_size, table_width, scale, stream);
}
