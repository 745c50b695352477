// Shared by the flash kernels (flash_fwd.cu, flash_bwd.cu, flash_fwd_tc.cu,
// flash_bwd_tc.cu, flash_bwd_tc128.cu, flash_fwd_tf32x3.cu,
// flash_bwd_tf32x3.cu, flash_fwd_single.cu): tile sizes, type conversions,
// and the attention-dropout bits.
//
// Dropout bits are Philox4x32-10 (Random123 / cuRAND philox4x32_10, written
// out here), keyed per element so that every kernel and the plain PyTorch
// version (ops/kernels/philox.py) draw the same bit for element (bh, i, j)
// whatever the tiling:
//
//   key     = (seed & 0xffffffff, seed >> 32)
//   counter = (j / 4, i, bh, 0)          j key, i query, bh batch*head
//   bits    = philox4x32_10(counter, key)[j % 4]
//   keep    = bits >= thresh,  thresh = min(uint32(rate * 2^32), 2^32 - 1)
//
// One Philox call gives the bits of 4 neighbouring keys, so the masking
// pass walks the score tile in groups of 4 columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kBlockM = 64;    // q rows per tile
constexpr int kBlockN = 64;    // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr float kNegInf = -1e9f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The four keep flags of keys col..col+3 (col a multiple of 4) of query row
// `row` in batch*head `bh`.
__device__ __forceinline__ uint4 dropout_bits(uint64_t seed, uint32_t bh,
                                              int row, int col) {
  return philox4x32_10(make_uint4((uint32_t)col >> 2, (uint32_t)row, bh, 0u),
                       (uint32_t)seed, (uint32_t)(seed >> 32));
}

__device__ __forceinline__ uint32_t word(const uint4& b, int i) {
  return i == 0 ? b.x : i == 1 ? b.y : i == 2 ? b.z : b.w;
}

// The 4 keep flags of keys col..col+3 (col a multiple of 4) of query row
// `row`, as bits 0..3.
__device__ __forceinline__ uint32_t keep_bits(uint64_t seed, uint32_t drop_thresh,
                                              uint32_t bh, int row, int col) {
  const uint4 b = dropout_bits(seed, bh, row, col);
  return (uint32_t)(b.x >= drop_thresh) | ((uint32_t)(b.y >= drop_thresh) << 1) |
         ((uint32_t)(b.z >= drop_thresh) << 2) | ((uint32_t)(b.w >= drop_thresh) << 3);
}

// The keep flags of one m16n8 C tile of mma.sync.m16n8k16 (hopper_mma.cuh)
// in the rows-by-keys frame: rows r0..r0+15, keys c0..c0+7 (c0 a multiple of
// 4). Lane L makes the one Philox call of row r0 + (L & 15), keys
// c0 + 4 (L >> 4)..+3, and two __shfl_sync hand each lane (lane = 4 g + t,
// t in 0..3) its groups: kbits[h] holds at bit 2 (t & 1) + cc the flag of
// row r0 + g + 8 h, key c0 + 2 t + cc. The tensor-core forward
// (flash_fwd_tc.cu, flash_fwd_tf32x3.cu) and dq (flash_bwd_tc.cu,
// flash_bwd_tc128.cu, flash_bwd_tf32x3.cu) all draw through this, so the backward re-draws
// exactly the forward's bits. The C fragment of mma.sync.m16n8k8 is that of
// m16n8k16, so the bf16 and the fp32 kernels share it. Called by the whole
// warp.
__device__ __forceinline__ void row_frame_keep_bits(uint32_t (&kbits)[2], uint64_t seed,
                                                    uint32_t drop_thresh, uint32_t bh,
                                                    int r0, int c0, int lane) {
  const uint32_t mine = keep_bits(seed, drop_thresh, bh, r0 + (lane & 15), c0 + 4 * (lane >> 4));
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) kbits[h] = __shfl_sync(0xffffffffu, mine, (t >> 1) * 16 + g + 8 * h);
}

// The keep flags of one m16n8 C tile in the transposed keys-by-rows frame of
// the dkv kernels (flash_bwd_tc.cu, flash_bwd_tc128.cu, flash_bwd_tf32x3.cu):
// keys k0..k0+15 (k0 a multiple of 4), rows r0..r0+7. Lane L makes the one Philox call of
// row r0 + (L & 7), keys k0 + 4 (L >> 3)..+3, and four __shfl_sync hand each
// lane (lane = 4 g + t) its groups: bit g & 3 of kbits[h][cc] is the flag
// of key k0 + g + 8 h, row r0 + 2 t + cc. Called by the whole warp.
__device__ __forceinline__ void key_frame_keep_bits(uint32_t (&kbits)[2][2], uint64_t seed,
                                                    uint32_t drop_thresh, uint32_t bh,
                                                    int r0, int k0, int lane) {
  const uint32_t mine = keep_bits(seed, drop_thresh, bh, r0 + (lane & 7), k0 + 4 * (lane >> 3));
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)
      kbits[h][cc] = __shfl_sync(0xffffffffu, mine, ((g >> 2) + 2 * h) * 8 + 2 * t + cc);
}

}  // namespace flash
