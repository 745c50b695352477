// Shared by flash_fwd.cu and flash_bwd.cu: tile sizes, type conversions,
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

}  // namespace flash
