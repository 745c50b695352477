// Tensor-core building blocks for the port's attention kernels (sm_90a):
// the warp-level bf16 product mma.sync.m16n8k16 and its fragments, ldmatrix
// loads from tiles of 256-byte rows (128 bf16: head dim 128), 128-byte rows
// (64 bf16: head dim 64) or 64-byte rows (32 bf16: head dim 32) whose
// 16-byte pieces are XOR-swizzled, and a ring of shared-memory slots
// filled by cp.async. Every tile helper takes the row width RB in bytes as
// a template argument, 128 by default; fp32 tiles have 512-byte (head dim
// 128), 256-byte (head dim 64) or 128-byte (head dim 32) rows. Tiles of
// padded rows (an odd count of 16-byte pieces, no swizzle) take any width:
// the *_frag_addr_pad helpers.
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
//
// The fp32 kernels (flash_fwd_tf32x3.cu, flash_bwd_tf32x3.cu) run
// mma.sync.m16n8k8 on tf32 operands, three products for one (3xTF32, the
// scheme of CUTLASS's OpMultiplyAddFastF32): x = big + small with
// big = tf32(x) and small = tf32(x - big), both rounded to nearest as
// cvt.rna does (split_tf32), and a.b = a_small.b_big + a_big.b_small +
// a_big.b_big summed in fp32, the small products first; the dropped a_small.b_small and the two
// roundings leave about 2^-21 of |a||b| a product, where one tf32 product
// leaves 2^-11. Its fragments, one fp32 (tf32) value a register:
//   A (16 x 8): a[0] = (row g, k t)   a[1] = (row g+8, k t)
//               a[2] = (row g, k t+4) a[3] = (row g+8, k t+4)
//   B (8 x 8):  b[0] = (k t, col g)   b[1] = (k t+4, col g)
//   C/D: as above (the m16n8k16 C fragment).
// ldmatrix (b16) reads an 8 x 4 fp32 tile as it reads an 8 x 8 bf16 one, so
// the A and B address helpers below serve fp32 tiles too, with k-step kk
// covering 8 fp32 columns (32 bytes) instead of 16 bf16. A C fragment is
// not an A fragment here: a lane holds keys 2t, 2t+1 of a tile, where A
// wants k t and t+4. The sum over the 8 keys of a k-step does not care
// about their order, so product_t_3x reads c[0], c[1] as k t and t + 4 and
// loads the B fragment in the same order (b[0] from key 2t, b[1] from key
// 2t + 1), with ld.shared from the swizzled tile: no ldmatrix.trans exists
// for 32-bit elements.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace hmma {

constexpr int kRowBytes = 128;  // the default tile row: 64 bf16 (head dim 64)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte piece `piece` of tile row `row`, in a tile of RB-byte
// rows. One ldmatrix matrix reads 8 consecutive rows (the first a multiple of
// 8) at one piece column; the XOR puts those 8 pieces in 8 different groups
// of 4 banks. RB 128, 256 or 512 (8, 16 or 32 pieces a row, each 128 bytes
// of a row on all 32 banks; the XOR moves a piece within its 128 bytes):
// piece ^ (row & 7). RB 64 (4 pieces, two rows share the 32 banks, rows r
// and r + 1 on different halves): piece ^ ((row >> 1) & 3).
template <int RB = kRowBytes>
__device__ __forceinline__ uint32_t swz(int row, int piece) {
  static_assert(RB == 512 || RB == 256 || RB == 128 || RB == 64, "tile rows are 64, 128, 256 or 512 bytes");
  if constexpr (RB >= 128) return row * RB + ((piece ^ (row & 7)) << 4);
  else return row * RB + ((piece ^ ((row >> 1) & 3)) << 4);
}

// The first n of 16 bytes (0 <= n <= 16) from global to shared memory
// without passing through registers, the rest zeroed (the bytes past n are
// not read).
__device__ __forceinline__ void cp_async16_first(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}
// 16 bytes from global to shared memory without passing through registers;
// when !valid nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  cp_async16_first(dst, src, valid ? 16 : 0);
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

// ROWS rows of RB bytes of T (bf16 or fp32) from `src` (row stride RB bytes)
// into the swizzled tile at `dst`, by the block's NT threads; rows at or past
// `valid_rows` are zeroed.
template <int ROWS, int NT, int RB = kRowBytes, typename T = __nv_bfloat16>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src, int valid_rows, int tid) {
  constexpr int kLogPieces = RB == 512 ? 5 : RB == 256 ? 4 : RB == 128 ? 3 : 2;  // 16-byte pieces a row: 32..4
  constexpr int kRow = RB / static_cast<int>(sizeof(T));  // elements a row
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements a piece
#pragma unroll
  for (int i = tid; i < (ROWS << kLogPieces); i += NT) {
    const int r = i >> kLogPieces, c = i & ((1 << kLogPieces) - 1);
    const bool ok = r < valid_rows;
    cp_async16(dst + swz<RB>(r, c), src + (ok ? r * kRow + c * kPer : 0), ok);
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

// The same three lane addresses in a padded tile: rows of `stride` bytes, a
// multiple of 16 with an odd count of 16-byte pieces, so the 8 rows one
// ldmatrix matrix reads land on 8 different groups of 4 banks without a
// swizzle, at any row width (the dynamic convolution's window, g and band
// tiles, bf16 or fp32, dynamic_conv_tc.cu). Any first row r0, n0 or k0.
__device__ __forceinline__ uint32_t a_frag_addr_pad(uint32_t tile, int stride, int r0, int kk, int lane) {
  return tile + (r0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * stride + ((2 * kk + (lane >> 4)) << 4);
}
__device__ __forceinline__ uint32_t b_frag_addr_pad(uint32_t tile, int stride, int n0, int kk, int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * stride + ((2 * kk + ((lane >> 3) & 1)) << 4);
}
__device__ __forceinline__ uint32_t bt_frag_addr_pad(uint32_t tile, int stride, int k0, int np, int lane) {
  return tile + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * stride + ((2 * np + (lane >> 4)) << 4);
}

// Products over tiles of 64 rows of D bf16 (rows of 2 D bytes), for the
// attention kernels (flash_fwd_tc.cu, flash_bwd_tc.cu, flash_bwd_tc128.cu,
// flash_fwd_single.cu).
//
// c[n] = A . B^T for the warp's 16 rows of A (fragments af over the head
// dim) against the 64 rows of the row-major tile `t` (64 x D): C tile n
// holds rows 8 n..8 n+7 of `t`.
template <int D>
__device__ __forceinline__ void product_nt(float (&c)[8][4], const uint32_t (&af)[D / 16][4],
                                           uint32_t t, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, b_frag_addr<2 * D>(t, 16 * np, kk, lane));
      mma_16816(c[2 * np], af[kk], b[0], b[1]);
      mma_16816(c[2 * np + 1], af[kk], b[2], b[3]);
    }
}

// The same product with the warp's A rows read from shared memory at each
// k-step (ldmatrix, rows a0..a0+15 of the row-major tile `at` of D bf16
// columns) instead of held in registers, against the NT * 8 rows of the
// row-major tile `t`: C tile n holds rows 8 n..8 n+7 of `t`. It frees the
// D / 4 registers a lane would hold A in, which the head-dim-128 kernels
// need (flash_bwd_tc128.cu, and flash_fwd_tc.cu at D 128).
template <int D, int NT>
__device__ __forceinline__ void product_nt_smem(float (&c)[NT][4], uint32_t at, int a0, uint32_t t,
                                                int lane) {
  static_assert(NT % 2 == 0, "B fragments come in pairs of 8-row tiles");
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a_frag_addr<2 * D>(at, a0, kk, lane));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, b_frag_addr<2 * D>(t, 16 * np, kk, lane));
      mma_16816(c[2 * np], af, b[0], b[1]);
      mma_16816(c[2 * np + 1], af, b[2], b[3]);
    }
  }
}

// acc[2 np + e] += A . (B fragments of columns 16 np.., through ldmatrix
// .trans of the row-major tile `bt` (64 x D), k rows 16 kk..16 kk+15).
template <int D>
__device__ __forceinline__ void product_t(float (&acc)[D / 8][4], const uint32_t (&af)[4],
                                          uint32_t bt, int kk, int lane) {
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, bt_frag_addr<2 * D>(bt, kk, np, lane));
    mma_16816(acc[2 * np], af, b[0], b[1]);
    mma_16816(acc[2 * np + 1], af, b[2], b[3]);
  }
}

// The A fragment of k-step kk from the C fragments of tiles 2 kk and
// 2 kk + 1 (of NT), rounded to bf16.
template <int NT>
__device__ __forceinline__ void a_from_c(uint32_t (&af)[4], const float (&c)[NT][4], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = 2 * kk + (i >> 1), h = i & 1;
    af[i] = pack_bf16(c[n][2 * h], c[n][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// 3xTF32 products on fp32 tiles (rows of 4 D bytes), for flash_fwd_tf32x3.cu
// and flash_bwd_tf32x3.cu.
// ---------------------------------------------------------------------------

// x = big + small, each x's tf32 rounding as cvt.rna.tf32.f32 gives it (to
// nearest, ties away from zero), by integer adds: half a unit of the 10th
// mantissa bit added to the magnitude's bits, then the low 13 bits dropped
// (big) or left for the tensor core, which reads only a tf32 operand's top
// 19 bits (small). The same split by two cvt.rna.tf32.f32 ran the fp32
// kernels markedly slower in development runs on an H100.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// d += a . b, tf32 in, fp32 sums.
__device__ __forceinline__ void mma_1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32 from the split fragments (ab, as) and (bb, bs).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_1688(d, as, bb[0], bb[1]);
  mma_1688(d, ab, bs[0], bs[1]);
  mma_1688(d, ab, bb[0], bb[1]);
}

// c[n] = A . B^T in 3xTF32 for the 16 rows a0.. of the row-major fp32 tile
// `at` (64 x D; the warp's rows of Q, dO, K or V, which stay in shared
// memory: A fragments read per k-step by ldmatrix, a_frag_addr with k-steps
// of 8 columns, hold no registers across the loop) against the NT * 8 rows
// r0.. of the row-major fp32 tile `t` (64 x D): C tile n holds rows
// r0 + 8 n..r0 + 8 n + 7 of `t`. Each fragment is split where it is used.
template <int D, int NT>
__device__ __forceinline__ void product_nt_3x(float (&c)[NT][4], uint32_t at, int a0, uint32_t t,
                                              int r0, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t a[4], ab[4], as[4];
    ldmatrix_x4(a, a_frag_addr<4 * D>(at, a0, kk, lane));
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), ab[i], as[i]);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4], bb[4], bs[4];
      ldmatrix_x4(b, b_frag_addr<4 * D>(t, r0 + 16 * np, kk, lane));
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(b[i]), bb[i], bs[i]);
      mma_3xtf32(c[2 * np], ab, as, {bb[0], bb[1]}, {bs[0], bs[1]});
      mma_3xtf32(c[2 * np + 1], ab, as, {bb[2], bb[3]}, {bs[2], bs[3]});
    }
  }
}

// acc[n] += A . B in 3xTF32 over KS k-steps of 8: A from the C fragments
// c[kk] (the warp's 16 rows by the 8 keys of k-step kk), a lane's keys 2t
// and 2t + 1 taken as A's k t and t + 4; B from rows r0 + 8 kk.. of the
// row-major fp32 tile at `bt` (a pointer into shared memory, 64 x D) in the
// same order: b[0] = bt[r0 + 8 kk + 2t][8 n + g], b[1] = bt[.. + 1][8 n + g].
// Those two ld.shared of a warp hit 32 different banks: with r0 a multiple
// of 8, row r0 + 8 kk + 2t XORs the pieces with 2t and the two pieces of the
// 8 columns land in 8 different 16-byte groups of a 128-byte line (at every
// row width: the XOR stays within the 128 bytes).
template <int D, int KS>
__device__ __forceinline__ void product_t_3x(float (&acc)[D / 8][4], const float (&c)[KS][4],
                                             const unsigned char* bt, int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t ab[4], as[4];
    const float a[4] = {c[kk][0], c[kk][2], c[kk][1], c[kk][3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], ab[i], as[i]);
    const int r = r0 + 8 * kk + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int piece = 2 * n + (g >> 2), word = (g & 3) << 2;
      uint32_t bb[2], bs[2];
      split_tf32(*reinterpret_cast<const float*>(bt + swz<4 * D>(r, piece) + word), bb[0], bs[0]);
      split_tf32(*reinterpret_cast<const float*>(bt + swz<4 * D>(r + 1, piece) + word), bb[1], bs[1]);
      mma_3xtf32(acc[n], ab, as, bb, bs);
    }
  }
}

// ---------------------------------------------------------------------------
// The per-element steps between the products of the tensor-core attention
// kernels, on C fragments (the same in m16n8k16 and m16n8k8), shared by the
// bf16 kernels (flash_fwd_tc.cu, flash_bwd_tc.cu) and the fp32 ones
// (flash_fwd_tf32x3.cu, flash_bwd_tf32x3.cu). `a` is the kernel's argument
// struct (s_len, t_len, scale, causal, drop_thresh, seed, and inv_keep in
// the backward); rows are queries and keys are keys in both frames.
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// The forward's online-softmax step on the raw scores of NT 8-key tiles
// from key s0 (rows x keys; this thread's rows `rows`, the warp's first w0):
// scale, bias and the causal triangle (NEG_INF; keys past S -inf, weight
// exactly 0); the rows' max over the chunk (the quad's 4 lanes) into m,
// with alpha = exp(m_old - m) applied to l and to the NA O fragments; then
// p = exp(s - m) on the special-function unit (m stays in natural units),
// summed into this lane's l undropped and left in sc where kept, 0 where
// dropped (the bits of flash::row_frame_keep_bits).
template <int NT, int NA, typename Args>
__device__ __forceinline__ void online_softmax_step(float (&sc)[NT][4], float (&m)[2], float (&l)[2],
                                                    float (&acc)[NA][4], const Args& a, const float* biasb,
                                                    int s0, const int (&rows)[2], int w0, uint32_t bh,
                                                    int lane) {
  const int t4 = lane & 3;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int j = s0 + 8 * n + 2 * t4 + cc;
      const bool in = j < a.s_len;
      const float bj = in ? __ldg(biasb + j) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = fmaf(sc[n][2 * h + cc], a.scale, bj);
        if (a.causal && j > rows[h]) x = flash::kNegInf;
        x = in ? x : -INFINITY;  // not a key: weight exactly 0
        sc[n][2 * h + cc] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float alpha = ex2((m[h] - mx[h]) * kLog2e);
    m[h] = mx[h];
    l[h] *= alpha;
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      acc[n][2 * h] *= alpha;
      acc[n][2 * h + 1] *= alpha;
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t kbits[2] = {0xfu, 0xfu};
    if (a.drop_thresh) flash::row_frame_keep_bits(kbits, a.seed, a.drop_thresh, bh, w0, s0 + 8 * n, lane);
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p = ex2((sc[n][2 * h + cc] - m[h]) * kLog2e);
        l[h] += p;  // l sums the undropped p
        const bool keep = (kbits[h] >> (2 * (t4 & 1) + cc)) & 1u;
        sc[n][2 * h + cc] = keep ? p : 0.f;
      }
  }
}

// dq's step on the raw scores sc and dp = dO V^T of NT 8-key tiles from key
// key0 (rows x keys): w = exp(s - lse) (0 for keys past S and rows past T),
// and ds = w (dp keep / (1 - rate) - delta) left in sc, with the keep bits
// the forward drew (flash::row_frame_keep_bits).
template <int NT, typename Args>
__device__ __forceinline__ void dq_ds_step(float (&sc)[NT][4], const float (&dp)[NT][4], const Args& a,
                                           const float* biasb, int key0, const int (&rows)[2],
                                           const bool (&row_ok)[2], const float (&lse)[2],
                                           const float (&delta)[2], int w0, uint32_t bh, int lane) {
  const int t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t kbits[2] = {0xfu, 0xfu};
    if (a.drop_thresh) flash::row_frame_keep_bits(kbits, a.seed, a.drop_thresh, bh, w0, key0 + 8 * n, lane);
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int j = key0 + 8 * n + 2 * t4 + cc;
      const bool in = j < a.s_len;
      const float bj = in ? __ldg(biasb + j) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = fmaf(sc[n][2 * h + cc], a.scale, bj);
        if (a.causal && j > rows[h]) x = flash::kNegInf;
        const float w = (in && row_ok[h]) ? ex2((x - lse[h]) * kLog2e) : 0.f;
        const bool keep = (kbits[h] >> (2 * (t4 & 1) + cc)) & 1u;
        const float dpv = keep ? dp[n][2 * h + cc] * a.inv_keep : 0.f;
        sc[n][2 * h + cc] = w * (dpv - delta[h]);  // ds
      }
    }
  }
}

// dkv's step in the transposed frame on the raw S^T in st and dP^T in dpt
// of NT 8-row tiles from row r0 (keys x rows; this thread's keys `keys`,
// the warp's first k0, their bias bk; the chunk's lse and delta from
// `lses` and `deltas`, row r0 first): w = exp(s - lse) (0 past T and S),
// w_v = w keep / (1 - rate) left in st and ds = w (dp keep / (1 - rate) -
// delta) in dpt, with the keep bits of flash::key_frame_keep_bits.
template <int NT, typename Args>
__device__ __forceinline__ void dkv_wv_ds_step(float (&st)[NT][4], float (&dpt)[NT][4], const Args& a,
                                               const float* lses, const float* deltas, int r0,
                                               const int (&keys)[2], const bool (&key_ok)[2],
                                               const float (&bk)[2], int k0, uint32_t bh, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t kbits[2][2] = {{0xfu, 0xfu}, {0xfu, 0xfu}};
    if (a.drop_thresh) flash::key_frame_keep_bits(kbits, a.seed, a.drop_thresh, bh, r0 + 8 * n, k0, lane);
    const float2 l2 = *reinterpret_cast<const float2*>(lses + 8 * n + 2 * t4);
    const float2 d2 = *reinterpret_cast<const float2*>(deltas + 8 * n + 2 * t4);
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int row = r0 + 8 * n + 2 * t4 + cc;
      const bool row_ok = row < a.t_len;
      const float lse = cc ? l2.y : l2.x, delta = cc ? d2.y : d2.x;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = fmaf(st[n][2 * h + cc], a.scale, bk[h]);
        if (a.causal && keys[h] > row) x = flash::kNegInf;
        const float w = (row_ok && key_ok[h]) ? ex2((x - lse) * kLog2e) : 0.f;
        const bool keep = (kbits[h][cc] >> (g & 3)) & 1u;
        const float dpv = keep ? dpt[n][2 * h + cc] * a.inv_keep : 0.f;
        st[n][2 * h + cc] = keep ? w * a.inv_keep : 0.f;  // w_v
        dpt[n][2 * h + cc] = w * (dpv - delta);           // ds
      }
    }
  }
}

}  // namespace hmma
