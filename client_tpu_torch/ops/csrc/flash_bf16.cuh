// Pieces shared by the bf16 flash-attention kernels on Hopper's tensor
// cores (flash_fwd_bf16.cu, flash_bwd_bf16.cu): 16-byte cp.async copies,
// ldmatrix, mma.sync.m16n8k16 (bf16 in, f32 accumulate), the bf16 pack,
// the SFU exp2, the loader of a padded 64-row bf16 tile, the staged
// 16-byte row store, the alignment check and the launcher.  Every kernel
// that includes it runs blocks of 4 warps over 64-row tiles.
//
// torch.utils.cpp_extension.load lists only the .cu sources, but its ninja
// rules keep nvcc's dependency files, so an edit here rebuilds both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace flash_bf16 {

constexpr int kTile = 64;       // rows of a Q tile and of a KV tile
constexpr int kThreads = 128;   // 4 warps of 16 rows
constexpr int kPad = 8;         // bf16 elements of padding a shared row
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one bf16x2 register, lo in the low half (round to nearest even)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The A fragment of one m16n8k16 from the C fragments of two m16n8 tiles
// (columns 0-7 and 8-15 of the same 16 rows): the C layout of a product is
// the A layout of the next, so P and dS never leave registers.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 2^x on the SFU, flushing results below 2^-126 to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [r0, r0 + kTile) of one [t, D] bf16 matrix into a padded shared tile
// by 16-byte cp.async; rows at or past t are zero-filled.  Rows are padded
// by 16 bytes, so every ldmatrix phase reads eight distinct 16-byte bank
// groups.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int t) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  constexpr int kStride = D + kPad;
  static_assert(kTile * kChunks % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < kTile * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const int gr = r0 + r;
    const bool in = gr < t;
    // a zero-filled row still names a valid address: the tile's first row
    const __nv_bfloat16* from = src + (size_t)(in ? gr : r0) * D + c * 8;
    cp_async16(dst + r * kStride + c * 8, from, in ? 16 : 0);
  }
}

// A warp's 16 rows of f32 C fragments (acc[b] covers columns 8b..8b+7) to
// bf16 in its own 16 padded shared rows, then to rows [r0, r0 + 16) of a
// [t, D] bf16 matrix as 16-byte stores, rows at or past t left out.  Only
// this warp may read or write those shared rows meanwhile.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* stage,
                                           const float (&acc)[D / 8][4],
                                           __nv_bfloat16* dst, int r0,
                                           int t) {
  constexpr int kStride = D + kPad;
  constexpr int kChunks = D / 8;
  const int lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int b = 0; b < kChunks; ++b)
      *reinterpret_cast<uint32_t*>(stage + (h * 8 + g) * kStride + b * 8 +
                                   tq * 2) =
          pack_bf16(acc[b][2 * h], acc[b][2 * h + 1]);
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / kChunks, ch = i % kChunks;
    if (r0 + r < t)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * D + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + r * kStride + ch * 8);
  }
}

// False where a pointer is not 16-byte aligned: the 16-byte copies and
// stores cannot take it, so the launcher refuses it.
inline bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// Raise the kernel's dynamic shared-memory limit, then launch it on
// grid (bh, 64-row tiles of t): a launch refused for its shared memory
// never runs, so the error is returned, not dropped.
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

}  // namespace flash_bf16
