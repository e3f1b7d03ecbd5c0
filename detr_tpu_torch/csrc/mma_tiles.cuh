// mma.sync tile helpers shared by the bf16 attention kernels (forward and
// backward), for Hopper (sm_90a).
//
// One head of a (B, N, H, D) bf16 tensor is read as rows of D = 32 values
// (64 bytes).  A warp keeps 16 of its own rows in registers as the A
// fragments of mma.sync.m16n8k16 (two k-steps of 16 over D).  The other
// side streams through shared memory in tiles of 64 rows: cp.async copies
// 16-byte chunks into a staged tile (4 KB, the chunk index XORed with bits
// 1-2 of the row so that ldmatrix on the 64-byte rows is free of bank
// conflicts), and ldmatrix reads it back as B fragments, either with the
// staged rows as the n side (s = q.k^T: ldmatrix_rows) or as the k side
// (O += P.V: ldmatrix_cols, transposed).  The m16n8 C layout of two n-tiles
// is the m16n8k16 A layout, so a product's fp32 result, packed to bf16,
// feeds the next product straight from registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kD = 32;                      // head size of every DETR configuration
constexpr int kTile = 64;                   // rows per staged tile
constexpr int kTileBytes = kTile * kD * 2;  // one staged bf16 tile: 64 rows of 64 bytes

// Byte offset of 16-byte chunk c (0-3) of row r in a staged tile.  The chunk
// index is XORed with bits 1-2 of the row: the 8 rows one ldmatrix phase
// reads then fall on 8 different groups of 4 banks.
__device__ __forceinline__ uint32_t swizzle(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled where !valid (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one group of this thread's copies is in flight.
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b: a 16x16 (A fragment), b 16x8 (B fragment), d 16x8 fp32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (to nearest even) in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float low_bf16(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float high_bf16(uint32_t x) { return __uint_as_float(x & 0xFFFF0000u); }

// The A fragments (two k-steps of 16 over D) of rows [r0, r0 + 16) of one
// head of a (B, N, H, D) tensor, read from device memory; rows past n are 0.
__device__ __forceinline__ void load_a(const bf16* __restrict__ base, long long row_stride,
                                       int r0, int n, uint32_t (&a)[2][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a[i]: row +8 for odd i, column +8 for i >= 2
      const int row = r0 + (lane >> 2) + 8 * (i & 1);
      const int col = 16 * ks + 8 * (i >> 1) + 2 * (lane & 3);
      a[ks][i] = row < n ? *reinterpret_cast<const uint32_t*>(base + row * row_stride + col) : 0u;
    }
  }
}

// Start copying rows [r0, r0 + 64) of one head of a (B, N, H, D) tensor into
// a staged tile, the block's kThreads threads sharing the chunks; rows past
// n are zero-filled.
template <int kThreads>
__device__ __forceinline__ void stage_rows(uint32_t tile, const bf16* __restrict__ base,
                                           long long row_stride, int r0, int n) {
  for (int i = threadIdx.x; i < kTile * 4; i += kThreads) {
    const int r = i >> 2, c = i & 3;
    const bool valid = r0 + r < n;
    cp_async16(tile + swizzle(r, c), base + (valid ? r0 + r : 0) * row_stride + 8 * c, valid);
  }
}

// B fragments of the product with the staged rows r0..r0+7 as the n side and
// D as the k side: b[0], b[1] for d 0-15, b[2], b[3] for d 16-31.
__device__ __forceinline__ void ldmatrix_rows(uint32_t (&b)[4], uint32_t tile, int r0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, tile + swizzle(r0 + (lane & 7), lane >> 3));
}

// B fragments of the product with the staged rows r0..r0+15 as the k side
// and D columns 8*c0 .. 8*c0+15 as the n side: b[0], b[1] for the first 8
// columns, b[2], b[3] for the next 8.
__device__ __forceinline__ void ldmatrix_cols(uint32_t (&b)[4], uint32_t tile, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, tile + swizzle(r0 + (lane & 15), c0 + (lane >> 4)));
}

}  // namespace
