// Tensor-core building blocks for the port's attention kernels (sm_90a):
// the warp-level bf16 product mma.sync.m16n8k16 and its fragments, ldmatrix
// loads from tiles of 128-byte rows (64 bf16: head dim 64) or 64-byte rows
// (32 bf16: head dim 32) whose 16-byte pieces are XOR-swizzled, and a ring
// of shared-memory slots filled by cp.async. Every tile helper takes the
// row width RB in bytes as a template argument, 128 by default.
//
// Fragments of mma.sync.m16n8k16 (lane = 4 * g + t, g in 0..7, t in 0..3):
//   A (16 x 16, row major), 4 registers of 2 bf16:
//     a[0] = (row g, cols 2t, 2t+1)       a[1] = (row g+8, cols 2t, 2t+1)
//     a[2] = (row g, cols 2t+8, 2t+9)     a[3] = (row g+8, cols 2t+8, 2t+9)
//   B (16 x 8, k x n), 2 registers:
//     b[0] = (k 2t, 2t+1; col g)          b[1] = (k 2t+8, 2t+9; col g)
//   C/D (16 x 8) fp32, 4 floats:
//     c[0], c[1] = (row g, cols 2t, 2t+1) c[2], c[3] = (row g+8, same cols)
// So the C fragments of two neighbouring 8-column tiles, rounded to bf16 and
// packed in pairs, are the A fragment of the next product over those 16
// columns, with no trip through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hmma {

constexpr int kRowBytes = 128;  // the default tile row: 64 bf16 (head dim 64)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte piece `piece` of tile row `row`, in a tile of RB-byte
// rows. One ldmatrix matrix reads 8 consecutive rows (the first a multiple of
// 8) at one piece column; the XOR puts those 8 pieces in 8 different groups
// of 4 banks. RB 128 (8 pieces a row, each row on all 32 banks): piece
// ^ (row & 7). RB 64 (4 pieces, two rows share the 32 banks, rows r and
// r + 1 on different halves): piece ^ ((row >> 1) & 3).
template <int RB = kRowBytes>
__device__ __forceinline__ uint32_t swz(int row, int piece) {
  static_assert(RB == 128 || RB == 64, "tile rows are 64 or 128 bytes");
  if constexpr (RB == 128) return row * RB + ((piece ^ (row & 7)) << 4);
  else return row * RB + ((piece ^ ((row >> 1) & 3)) << 4);
}

// 16 bytes from global to shared memory without passing through registers;
// when !valid nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 4 bytes from global to shared memory, zeroed when !valid (src need only be
// 4-byte aligned).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// ROWS rows of RB / 2 bf16 from `src` (row stride RB / 2) into the swizzled
// tile at `dst`, by the block's NT threads; rows at or past `valid_rows` are
// zeroed.
template <int ROWS, int NT, int RB = kRowBytes>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          int valid_rows, int tid) {
  constexpr int kLogPieces = RB == 128 ? 3 : 2;  // 16-byte pieces a row: 8 or 4
#pragma unroll
  for (int i = tid; i < (ROWS << kLogPieces); i += NT) {
    const int r = i >> kLogPieces, c = i & ((1 << kLogPieces) - 1);
    const bool ok = r < valid_rows;
    cp_async16(dst + swz<RB>(r, c), src + (ok ? r * (RB / 2) + c * 8 : 0), ok);
  }
}

// A ring of NS slots of SLOT bytes. Fill i goes to slot i % NS as one
// cp.async commit group; with NS - 1 fills issued ahead, wait() returns once
// the oldest outstanding fill has landed (a __syncthreads then makes every
// thread's copies visible and frees the slot read in the step before).
template <int NS, int SLOT>
struct CpAsyncRing {
  static_assert(NS >= 2, "a ring needs two slots");
  uint32_t base;
  __device__ __forceinline__ uint32_t slot(int i) const { return base + (i % NS) * SLOT; }
  __device__ __forceinline__ static void wait() { cp_async_wait<NS - 2>(); }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d += a . b, bf16 in, fp32 sums.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (to nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit (-inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ldmatrix lane addresses, for a warp's 16 rows (A) or 16 keys (B), in a
// tile of RB-byte rows.
//   A fragment of rows r0..r0+15, columns 16 kk..16 kk+15:
template <int RB = kRowBytes>
__device__ __forceinline__ uint32_t a_frag_addr(uint32_t tile, int r0, int kk, int lane) {
  return tile + swz<RB>(r0 + (lane & 7) + (((lane >> 3) & 1) << 3), 2 * kk + (lane >> 4));
}
//   B fragments of two 8-column tiles (rows n0..n0+15 of a row-major N x K
//   tile, e.g. keys of K), k columns 16 kk..: r[0], r[1] for rows n0..n0+7,
//   r[2], r[3] for rows n0+8..n0+15:
template <int RB = kRowBytes>
__device__ __forceinline__ uint32_t b_frag_addr(uint32_t tile, int n0, int kk, int lane) {
  return tile + swz<RB>(n0 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1));
}
//   B fragments, through ldmatrix .trans, of a row-major K x N tile (keys x
//   head dim of V): k rows 16 kk.., columns 16 np..16 np+15; r[0], r[1] for
//   columns 16 np..+7, r[2], r[3] for 16 np+8..+15:
template <int RB = kRowBytes>
__device__ __forceinline__ uint32_t bt_frag_addr(uint32_t tile, int kk, int np, int lane) {
  return tile + swz<RB>(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3), 2 * np + (lane >> 4));
}

}  // namespace hmma
