// Split flash-attention backward on Hopper's tensor cores (sm_90a), plain
// CUDA C++: bf16 at head dim 128 (the iwslt lightconv presets' 4 heads over
// 512 dims). Two kernels, each a port of a Pallas kernel of
// fbk_fairseq_st_tpu/ops/pallas/attention_kernel.py (via _bwd_impl):
//
//   flash_bwd_dq_tc128   replaces _dq_kernel:  dQ, q-outer;
//   flash_bwd_dkv_tc128  replaces _dkv_kernel: dK and dV, kv-outer.
//
// They compute what flash_bwd_tc.cu computes at head dim 32 and 64, whose
// header gives the math: from dO, the forward's out (through delta =
// rowsum(dO * O), fp32, computed by the wrapper), its lse and its Philox
// keep flags, w = exp(s - lse), w_v = w keep / (1 - rate),
// dp = (dO V^T) keep / (1 - rate), ds = w (dp - delta); dV = bf16(w_v)^T dO,
// dK = bf16(ds)^T Q scale, dQ = bf16(ds) K scale, every product summed in
// fp32, w_v and ds rounded to bf16 before their products as the Pallas
// .astype does. Rows past T and keys past S are zero-filled and get w = 0.
// Each output element is written once by one thread, summed in a fixed
// order: no atomics, so both kernels are bitwise repeatable. The per-element
// steps are hopper_mma.cuh::dq_ds_step and dkv_wv_ds_step, and the keep
// flags come from flash_common.cuh::row_frame_keep_bits (dq) and
// key_frame_keep_bits (dkv): the m16n8 C tile does not depend on D, so the
// draws are those of the D 32/64 pair and of philox.keep_mask.
//
// Design. 4 warps a block, a warp per 16 rows (dq) or 16 keys (dkv);
// mma.sync.m16n8k16 with ldmatrix(.trans) from tiles of 256-byte rows
// (hopper_mma.cuh::swz<256>), loaded by a cp.async ring.
//
// Registers: the split. flash_bwd_tc.cu holds the warp's A operand (Q and
// dO in dq; K and V in dkv) in registers for the whole loop. At D 128 that
// is 32 + 32 registers a lane, and the rest of a dkv lane would be the dK
// and dV accumulators (64 + 64) and the S^T and dP^T C fragments of a
// 64-row chunk (32 + 32): 256, past the 255 a thread may hold, before any
// address or index. This source keeps the A operands in shared memory,
// where the ring's loads put them anyway, and reads their fragments by
// ldmatrix at each k-step (hopper_mma.cuh::product_nt_smem: one
// ldmatrix.x4 a k-step beside the B fragments' NT / 2), and dkv takes Q and
// dO in chunks of 32 rows, so that S^T and dP^T are 16 + 16 registers:
//   * dq: one block per (bh, 64-row q tile). Q and dO sit in shared memory;
//     64-key K and V chunks stream through a 2-slot ring (one chunk in
//     flight while the last is used). Live across the products: dQ (64)
//     and S, dP of the chunk (32 + 32).
//   * dkv: one block per (bh, 64-key tile). K and V sit in shared memory;
//     32-row Q and dO chunks with their lse and delta stream through a
//     3-slot ring. Live: dK and dV (64 + 64), S^T and dP^T (16 + 16).
// ptxas (sm_90a, -O3) gives dq 233 and dkv 241 registers a thread and no
// spill: the rest holds addresses, the rows' or keys' indices, lse, delta
// and bias, and the fragments in flight. The other splits were costlier
// here: two passes over the Q/dO chunks (dV, then dK) repeat S^T, a
// quarter more products, and read Q twice; two warps per 16 keys, each
// owning half of D's columns, must add their partial S^T and dP^T through
// shared memory at every chunk. What the chosen split pays is
// shared-memory traffic, the A fragments read again at every chunk: it is
// not what bounds the calls the presets make (below).
//
// Shared memory: dq 16 + 16 KB (Q, dO) and 2 slots of 32 KB (K, V): 96 KB;
// dkv 16 + 16 KB (K, V) and 3 slots of 16.25 KB (Q, dO, lse, delta): 80.75
// KB. Two blocks of either fit an SM (228 KB), so the iwslt call's 256
// blocks (bh 256, T = S = 56: one tile each) run in one wave on 132 SMs.
//
// What bounds it. At the iwslt call the pair moves 18.4 + 22.0 MB (inputs
// read once, outputs written once): 0.0055 + 0.0066 ms at 3.35 TB/s,
// against 0.0007 + 0.0009 ms of products at 989 TFLOP/s: bytes bound it,
// and one wave of blocks that each load their tiles, compute and write
// leaves the load latency exposed. At a long call (bh 32, T = S = 2048)
// operations bound it: 3 and 4 products of 2 T S D a head, 0.104 and 0.139
// ms at 989 TFLOP/s, which warp-level mma.sync reaches only in part (a
// wgmma design is a later step).

#include <math.h>
#include <stddef.h>

#include "flash_common.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace flash;

constexpr int kD = 128;
constexpr int kRowBytes = 2 * kD;  // a bf16 row of the head dim
constexpr int kTile = 64;          // q rows a dq block, keys a dq chunk, keys a dkv block
constexpr int kRowsDkv = 32;       // q rows a dkv chunk
constexpr int kThreadsTc = 128;
constexpr int kStagesDq = 2;
constexpr int kStagesDkv = 3;

constexpr int kTileBytes = kTile * kRowBytes;      // 16 KB
constexpr int kChunkBytes = kRowsDkv * kRowBytes;  // 8 KB
constexpr int kDqSlot = 2 * kTileBytes;            // K, V
constexpr int kDqSmem = 2 * kTileBytes + kStagesDq * kDqSlot;
constexpr int kDkvSlot = 2 * kChunkBytes + 2 * kRowsDkv * 4;  // Q, dO, then lse and delta
constexpr int kDkvSmem = 2 * kTileBytes + kStagesDkv * kDkvSlot;
static_assert(kDkvSlot % 128 == 0, "ring slots keep the swizzle's 128-byte alignment");

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *bias, *lse, *delta;
  __nv_bfloat16 *dq, *dk, *dv;
  int t_len, s_len;
  float scale;
  int causal;
  uint32_t drop_thresh;  // 0: no dropout
  float inv_keep;        // 1 / (1 - rate)
  uint64_t seed;
};

// ---------------------------------------------------------------------------
// dQ, q-outer
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreadsTc)
flash_bwd_dq_tc128_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = hmma::smem_u32(smem), dos = qs + kTileBytes;
  const hmma::CpAsyncRing<kStagesDq, kDqSlot> ring{dos + kTileBytes};

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int w0 = q0 + warp * 16;  // the warp's first row
  const __nv_bfloat16* kb = a.k + bh * a.s_len * kD;
  const __nv_bfloat16* vb = a.v + bh * a.s_len * kD;
  const float* biasb = a.bias + bh * a.s_len;

  int rows[2];
  bool row_ok[2];
  float lse[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] = w0 + g + 8 * h;
    row_ok[h] = rows[h] < a.t_len;
    lse[h] = row_ok[h] ? a.lse[bh * a.t_len + rows[h]] : 0.f;
    delta[h] = row_ok[h] ? a.delta[bh * a.t_len + rows[h]] : 0.f;
  }

  // causal: chunks that start past the tile's last row add nothing
  const int s_end = a.causal ? min(a.s_len, q0 + kTile) : a.s_len;
  const int n_chunks = (s_end + kTile - 1) / kTile;
  auto fill = [&](int c) {
    if (c < n_chunks) {
      const int s0 = c * kTile;
      const uint32_t slot = ring.slot(c);
      hmma::load_tile<kTile, kThreadsTc, kRowBytes>(slot, kb + (size_t)s0 * kD, a.s_len - s0, tid);
      hmma::load_tile<kTile, kThreadsTc, kRowBytes>(slot + kTileBytes, vb + (size_t)s0 * kD, a.s_len - s0, tid);
    }
    hmma::cp_async_commit();  // an empty group past the end keeps the count
  };
  const size_t qoff = (bh * a.t_len + q0) * kD;
  hmma::load_tile<kTile, kThreadsTc, kRowBytes>(qs, a.q + qoff, a.t_len - q0, tid);
  hmma::load_tile<kTile, kThreadsTc, kRowBytes>(dos, a.dout + qoff, a.t_len - q0, tid);
#pragma unroll
  for (int i = 0; i < kStagesDq - 1; ++i) fill(i);  // Q and dO land with fill 0

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    hmma::CpAsyncRing<kStagesDq, kDqSlot>::wait();
    __syncthreads();  // this chunk is visible; the slot read last step is free
    fill(c + kStagesDq - 1);
    const int s0 = c * kTile;
    const uint32_t kt = ring.slot(c), vt = kt + kTileBytes;

    float sc[8][4], dp[8][4];  // rows x keys: tile n holds keys s0 + 8 n..
    hmma::product_nt_smem<kD, 8>(sc, qs, warp * 16, kt, lane);
    hmma::product_nt_smem<kD, 8>(dp, dos, warp * 16, vt, lane);

    hmma::dq_ds_step(sc, dp, a, biasb, s0, rows, row_ok, lse, delta, w0, (uint32_t)bh, lane);
    // dQ += ds K: ds of keys 16 kk..16 kk+15 is the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t af[4];
      hmma::a_from_c(af, sc, kk);
      hmma::product_t<kD>(acc, af, kt, kk, lane);
    }
  }
  hmma::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(a.dq + (bh * a.t_len + rows[h]) * kD) + t4;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      dst[4 * n] = hmma::pack_bf16(acc[n][2 * h] * a.scale, acc[n][2 * h + 1] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// dK and dV, kv-outer
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreadsTc)
flash_bwd_dkv_tc128_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ks = hmma::smem_u32(smem), vs = ks + kTileBytes;
  const hmma::CpAsyncRing<kStagesDkv, kDkvSlot> ring{vs + kTileBytes};

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t bh = blockIdx.x;
  const int s0 = blockIdx.y * kTile;
  const int k0 = s0 + warp * 16;  // the warp's first key
  const __nv_bfloat16* qb = a.q + bh * a.t_len * kD;
  const __nv_bfloat16* dob = a.dout + bh * a.t_len * kD;
  const float* lseb = a.lse + bh * a.t_len;
  const float* deltab = a.delta + bh * a.t_len;

  int keys[2];
  bool key_ok[2];
  float bk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    keys[h] = k0 + g + 8 * h;
    key_ok[h] = keys[h] < a.s_len;
    bk[h] = key_ok[h] ? a.bias[bh * a.s_len + keys[h]] : 0.f;
  }

  // causal: q chunks that end before this key tile starts add nothing
  const int r_begin = a.causal ? s0 : 0;
  const int n_chunks = a.t_len > r_begin ? (a.t_len - r_begin + kRowsDkv - 1) / kRowsDkv : 0;
  auto fill = [&](int c) {
    if (c < n_chunks) {
      const int r0 = r_begin + c * kRowsDkv;
      const uint32_t slot = ring.slot(c);
      hmma::load_tile<kRowsDkv, kThreadsTc, kRowBytes>(slot, qb + (size_t)r0 * kD, a.t_len - r0, tid);
      hmma::load_tile<kRowsDkv, kThreadsTc, kRowBytes>(slot + kChunkBytes, dob + (size_t)r0 * kD, a.t_len - r0,
                                                       tid);
      if (tid < 2 * kRowsDkv) {  // lse[0..31], then delta[0..31]
        const int r = r0 + (tid & (kRowsDkv - 1));
        const bool ok = r < a.t_len;
        const float* src = (tid < kRowsDkv ? lseb : deltab) + (ok ? r : 0);
        hmma::cp_async4(slot + 2 * kChunkBytes + 4 * tid, src, ok);
      }
    }
    hmma::cp_async_commit();
  };
  const size_t koff = (bh * a.s_len + s0) * kD;
  hmma::load_tile<kTile, kThreadsTc, kRowBytes>(ks, a.k + koff, a.s_len - s0, tid);
  hmma::load_tile<kTile, kThreadsTc, kRowBytes>(vs, a.v + koff, a.s_len - s0, tid);
#pragma unroll
  for (int i = 0; i < kStagesDkv - 1; ++i) fill(i);  // K and V land with fill 0

  float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    hmma::CpAsyncRing<kStagesDkv, kDkvSlot>::wait();
    __syncthreads();
    fill(c + kStagesDkv - 1);
    const int r0 = r_begin + c * kRowsDkv;
    const uint32_t qt = ring.slot(c), dot = qt + kChunkBytes;
    const float* lses = reinterpret_cast<const float*>(smem + (qt - ks) + 2 * kChunkBytes);
    const float* deltas = lses + kRowsDkv;

    float st[kRowsDkv / 8][4], dpt[kRowsDkv / 8][4];  // keys x rows: tile n holds rows r0 + 8 n..
    hmma::product_nt_smem<kD, kRowsDkv / 8>(st, ks, warp * 16, qt, lane);
    hmma::product_nt_smem<kD, kRowsDkv / 8>(dpt, vs, warp * 16, dot, lane);

    hmma::dkv_wv_ds_step(st, dpt, a, lses, deltas, r0, keys, key_ok, bk, k0, (uint32_t)bh, lane);
    // dV += w_v^T dO and dK += ds^T Q: rows 16 kk..16 kk+15 are k-step kk
#pragma unroll
    for (int kk = 0; kk < kRowsDkv / 16; ++kk) {
      uint32_t af[4];
      hmma::a_from_c(af, st, kk);
      hmma::product_t<kD>(dv, af, dot, kk, lane);
      hmma::a_from_c(af, dpt, kk);
      hmma::product_t<kD>(dk, af, qt, kk, lane);
    }
  }
  hmma::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!key_ok[h]) continue;
    const size_t off = (bh * a.s_len + keys[h]) * kD;
    uint32_t* dkd = reinterpret_cast<uint32_t*>(a.dk + off) + t4;
    uint32_t* dvd = reinterpret_cast<uint32_t*>(a.dv + off) + t4;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      dkd[4 * n] = hmma::pack_bf16(dk[n][2 * h] * a.scale, dk[n][2 * h + 1] * a.scale);
      dvd[4 * n] = hmma::pack_bf16(dv[n][2 * h], dv[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------

cudaError_t launch(bool dq, const Args& a, int bh, cudaStream_t stream) {
  const int bytes = dq ? kDqSmem : kDkvSmem;
  const void* fn = dq ? reinterpret_cast<const void*>(flash_bwd_dq_tc128_kernel)
                      : reinterpret_cast<const void*>(flash_bwd_dkv_tc128_kernel);
  // above 48 KB of dynamic shared memory a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, ((dq ? a.t_len : a.s_len) + kTile - 1) / kTile);
  if (dq)
    flash_bwd_dq_tc128_kernel<<<grid, kThreadsTc, bytes, stream>>>(a);
  else
    flash_bwd_dkv_tc128_kernel<<<grid, kThreadsTc, bytes, stream>>>(a);
  return cudaGetLastError();
}

int run(bool dq, const void* q, const void* k, const void* v, const void* bias,
        const void* dout, const void* lse, const void* delta, void* dqp, void* dk,
        void* dv, int bh, int t_len, int s_len, int head_dim, float scale,
        int causal, uint32_t drop_thresh, float keep_prob, uint64_t seed,
        void* stream) {
  // bh on gridDim.x (up to 2^31 - 1); the 64-row or 64-key tiles on gridDim.y
  if (head_dim != kD || bh <= 0 || t_len <= 0 || s_len <= 0 || (t_len + kTile - 1) / kTile > 65535 ||
      (s_len + kTile - 1) / kTile > 65535 || !(keep_prob > 0.f))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
               static_cast<const float*>(bias), static_cast<const float*>(lse),
               static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dqp),
               static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
               t_len, s_len, scale, causal, drop_thresh, 1.f / keep_prob, seed};
  return (int)launch(dq, a, bh, static_cast<cudaStream_t>(stream));
}

}  // namespace

// The arguments of flash_bwd_tc.cu's functions: q, dout: (bh, t_len, 128);
// k, v: (bh, s_len, 128); bf16, contiguous, 16-byte aligned; head_dim must
// be 128; bias: (bh, s_len) fp32; lse, delta: (bh, t_len) fp32;
// drop_thresh = 0 turns dropout off, keep_prob is 1 - rate, seed the
// forward's. Each launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for what it does not take).

// dq: (bh, t_len, 128) bf16.
extern "C" int flash_bwd_dq_tc128(const void* q, const void* k, const void* v,
                                  const void* bias, const void* dout, const void* lse,
                                  const void* delta, void* dq, int bh, int t_len,
                                  int s_len, int head_dim, float scale, int causal,
                                  uint32_t drop_thresh, float keep_prob, uint64_t seed,
                                  void* stream) {
  return run(true, q, k, v, bias, dout, lse, delta, dq, nullptr, nullptr, bh, t_len,
             s_len, head_dim, scale, causal, drop_thresh, keep_prob, seed, stream);
}

// dk, dv: (bh, s_len, 128) bf16.
extern "C" int flash_bwd_dkv_tc128(const void* q, const void* k, const void* v,
                                   const void* bias, const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv, int bh,
                                   int t_len, int s_len, int head_dim, float scale,
                                   int causal, uint32_t drop_thresh, float keep_prob,
                                   uint64_t seed, void* stream) {
  return run(false, q, k, v, bias, dout, lse, delta, nullptr, dk, dv, bh, t_len, s_len,
             head_dim, scale, causal, drop_thresh, keep_prob, seed, stream);
}

extern "C" const char* flash_bwd_tc128_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
