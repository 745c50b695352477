// Split flash-attention backward on Hopper's tensor cores (sm_90a), plain
// CUDA C++: bf16 at head dim 32 or 64. Two kernels, each a port of a Pallas
// kernel of fbk_fairseq_st_tpu/ops/pallas/attention_kernel.py (via _bwd_impl):
//
//   flash_bwd_dq_tc   replaces _dq_kernel:  dQ, q-outer;
//   flash_bwd_dkv_tc  replaces _dkv_kernel: dK and dV, kv-outer.
//
// The math is the Pallas kernels' (and flash_bwd.cu's), from the forward's
// scores s (bias added, causal entries replaced by NEG_INF = -1e9), its
// per-row lse, delta = rowsum(dO * O) (fp32, computed by the wrapper) and
// the forward's Philox keep flags (flash_common.cuh), all 1 at rate 0:
//
//   w   = exp(s - lse)                      (ex2 with log2 e folded in)
//   w_v = w * keep / (1 - rate)             dV += bf16(w_v)^T dO
//   dp  = (dO V^T) * keep / (1 - rate)
//   ds  = w * (dp - delta)                  dK += bf16(ds)^T q, times scale
//                                           dQ += bf16(ds) k,   times scale
//
// w_v and ds are rounded to bf16 before their products, as the Pallas
// kernels' .astype(...) does (flash_bwd.cu keeps them in fp32); every
// product sums in fp32. Rows past T and keys past S are zero-filled by the
// copies and get w = 0 explicitly (a zero q row with a zero lse would give
// w = exp(bias) and pollute dV). Each output element is written once by one
// thread, summed in a fixed order: no atomics, so both are deterministic.
//
// Design. 4 warps a block; mma.sync.m16n8k16 with ldmatrix(.trans) and a
// 3-slot cp.async ring, as flash_fwd_single.cu (hopper_mma.cuh), on tiles of
// 64 rows of D bf16 (128- or 64-byte rows, XOR-swizzled). bh is gridDim.x.
//   * dq: one block per (bh, 64-row q tile), a warp per 16 rows. Q and dO
//     sit in registers as A fragments, the rows' lse and delta too; 64-key
//     K and V chunks stream through the ring. Per chunk S = Q K^T and
//     dP = dO V^T (C fragments, rows x keys), ds in fp32, rounded to bf16
//     straight into the A fragments of dQ += ds K (K's B fragments by
//     ldmatrix.trans). A causal tile stops after the chunk holding its last
//     row. dQ is written in bf16 with no fp32 buffer.
//   * dkv: one block per (bh, 64-key tile), a warp per 16 keys. K and V sit
//     in registers as A fragments, the keys' bias too; 64-row Q and dO
//     chunks with their lse and delta stream through the ring. The
//     orientation is transposed: S^T = K Q^T and dP^T = V dO^T, whose C
//     fragments (keys x rows) rounded to bf16 are the A fragments of
//     dV += w_v^T dO and dK += ds^T Q (dO's and Q's B fragments by
//     ldmatrix.trans). A causal tile starts at the chunk of its diagonal.
//   * Dropout: one Philox4x32-10 call a lane per m16n8 C tile covers
//     exactly the tile's 32 (row, 4-key group) pairs; each lane turns its 4
//     words into 4 keep bits and hands them to the lanes that own the
//     elements by __shfl_sync (2 shuffles a tile in the dq orientation, 4 in
//     dkv's), so each group is drawn once a tile. dq draws through
//     flash_common.cuh::row_frame_keep_bits, the tensor-core forward's own
//     code in the same frame (flash_fwd_tc.cu), dkv through
//     key_frame_keep_bits, as the fp32 kernels do (flash_bwd_tf32x3.cu).
//     The per-element steps between the products (ds; w_v and ds) are
//     hopper_mma.cuh::dq_ds_step and dkv_wv_ds_step, which the fp32 pair
//     shares.
//
// What bounds it. At the long-context encoder call (bh 32, T = S = 2048,
// D 64) dq does 3 products of 2 T S D a head (51.5 GFLOP) and dkv 4 (68.7
// GFLOP): 0.052 / 0.070 ms at 989 TFLOP/s, against 17-34 MB of traffic (5-10
// us at 3.35 TB/s), so operations bound both. Warp-level mma.sync runs well
// below that peak (flash_fwd_single.cu reached 168 TFLOP/s issued), and at
// rate > 0 the Philox rounds (about 60 integer operations a 4-key group, in
// each kernel) cost about as much issue time as the products.

#include <math.h>
#include <stddef.h>

#include "flash_common.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace flash;

constexpr int kTile = 64;     // q rows a dq block, keys a dkv block; rows or keys a chunk
constexpr int kThreadsTc = 128;
constexpr int kStages = 3;    // ring slots

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

template <int D> __host__ __device__ constexpr int tile_bytes() { return kTile * 2 * D; }
template <int D> __host__ __device__ constexpr int dq_smem_bytes() {
  return 2 * tile_bytes<D>() + kStages * 2 * tile_bytes<D>();
}
template <int D> __host__ __device__ constexpr int dkv_slot_bytes() { return 2 * tile_bytes<D>() + 2 * kTile * 4; }
template <int D> __host__ __device__ constexpr int dkv_smem_bytes() {
  return 2 * tile_bytes<D>() + kStages * dkv_slot_bytes<D>();
}

// ---------------------------------------------------------------------------
// dQ, q-outer
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreadsTc)
flash_bwd_dq_tc_kernel(Args a) {
  constexpr int RB = 2 * D;
  constexpr int TILE = tile_bytes<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = hmma::smem_u32(smem), dos = qs + TILE;
  const hmma::CpAsyncRing<kStages, 2 * TILE> ring{dos + TILE};

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int w0 = q0 + warp * 16;  // the warp's first row
  const __nv_bfloat16* kb = a.k + bh * a.s_len * D;
  const __nv_bfloat16* vb = a.v + bh * a.s_len * D;
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
      hmma::load_tile<kTile, kThreadsTc, RB>(slot, kb + (size_t)s0 * D, a.s_len - s0, tid);
      hmma::load_tile<kTile, kThreadsTc, RB>(slot + TILE, vb + (size_t)s0 * D, a.s_len - s0, tid);
    }
    hmma::cp_async_commit();  // an empty group past the end keeps the count
  };
  const size_t qoff = (bh * a.t_len + q0) * D;
  hmma::load_tile<kTile, kThreadsTc, RB>(qs, a.q + qoff, a.t_len - q0, tid);
  hmma::load_tile<kTile, kThreadsTc, RB>(dos, a.dout + qoff, a.t_len - q0, tid);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fill(i);  // Q and dO land with fill 0

  uint32_t qf[D / 16][4], df[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    hmma::CpAsyncRing<kStages, 2 * TILE>::wait();
    __syncthreads();  // this chunk is visible; the slot read last step is free
    fill(c + kStages - 1);
    if (c == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        hmma::ldmatrix_x4(qf[kk], hmma::a_frag_addr<RB>(qs, warp * 16, kk, lane));
        hmma::ldmatrix_x4(df[kk], hmma::a_frag_addr<RB>(dos, warp * 16, kk, lane));
      }
    }
    const int s0 = c * kTile;
    const uint32_t kt = ring.slot(c), vt = kt + TILE;

    float sc[8][4], dp[8][4];  // rows x keys: tile n holds keys s0 + 8 n..
    hmma::product_nt<D>(sc, qf, kt, lane);
    hmma::product_nt<D>(dp, df, vt, lane);

    hmma::dq_ds_step(sc, dp, a, biasb, s0, rows, row_ok, lse, delta, w0, (uint32_t)bh, lane);
    // dQ += ds K: ds of keys 16 kk..16 kk+15 is the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t af[4];
      hmma::a_from_c(af, sc, kk);
      hmma::product_t<D>(acc, af, kt, kk, lane);
    }
  }
  hmma::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(a.dq + (bh * a.t_len + rows[h]) * D) + t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      dst[4 * n] = hmma::pack_bf16(acc[n][2 * h] * a.scale, acc[n][2 * h + 1] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// dK and dV, kv-outer
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreadsTc)
flash_bwd_dkv_tc_kernel(Args a) {
  constexpr int RB = 2 * D;
  constexpr int TILE = tile_bytes<D>();
  constexpr int SLOT = dkv_slot_bytes<D>();  // Q, dO, then lse and delta (64 floats each)
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ks = hmma::smem_u32(smem), vs = ks + TILE;
  const hmma::CpAsyncRing<kStages, SLOT> ring{vs + TILE};

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t bh = blockIdx.x;
  const int s0 = blockIdx.y * kTile;
  const int k0 = s0 + warp * 16;  // the warp's first key
  const __nv_bfloat16* qb = a.q + bh * a.t_len * D;
  const __nv_bfloat16* dob = a.dout + bh * a.t_len * D;
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
  const int n_chunks = a.t_len > r_begin ? (a.t_len - r_begin + kTile - 1) / kTile : 0;
  auto fill = [&](int c) {
    if (c < n_chunks) {
      const int r0 = r_begin + c * kTile;
      const uint32_t slot = ring.slot(c);
      hmma::load_tile<kTile, kThreadsTc, RB>(slot, qb + (size_t)r0 * D, a.t_len - r0, tid);
      hmma::load_tile<kTile, kThreadsTc, RB>(slot + TILE, dob + (size_t)r0 * D, a.t_len - r0, tid);
      const int r = r0 + (tid & (kTile - 1));
      const bool ok = r < a.t_len;
      const float* src = (tid < kTile ? lseb : deltab) + (ok ? r : 0);
      hmma::cp_async4(slot + 2 * TILE + 4 * tid, src, ok);  // lse[0..63], then delta[0..63]
    }
    hmma::cp_async_commit();
  };
  const size_t koff = (bh * a.s_len + s0) * D;
  hmma::load_tile<kTile, kThreadsTc, RB>(ks, a.k + koff, a.s_len - s0, tid);
  hmma::load_tile<kTile, kThreadsTc, RB>(vs, a.v + koff, a.s_len - s0, tid);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fill(i);  // K and V land with fill 0

  uint32_t kf[D / 16][4], vf[D / 16][4];
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    hmma::CpAsyncRing<kStages, SLOT>::wait();
    __syncthreads();
    fill(c + kStages - 1);
    if (c == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        hmma::ldmatrix_x4(kf[kk], hmma::a_frag_addr<RB>(ks, warp * 16, kk, lane));
        hmma::ldmatrix_x4(vf[kk], hmma::a_frag_addr<RB>(vs, warp * 16, kk, lane));
      }
    }
    const int r0 = r_begin + c * kTile;
    const uint32_t qt = ring.slot(c), dot = qt + TILE;
    const float* lses = reinterpret_cast<const float*>(smem + (qt - ks) + 2 * TILE);
    const float* deltas = lses + kTile;

    float st[8][4], dpt[8][4];  // keys x rows: tile n holds rows r0 + 8 n..
    hmma::product_nt<D>(st, kf, qt, lane);
    hmma::product_nt<D>(dpt, vf, dot, lane);

    hmma::dkv_wv_ds_step(st, dpt, a, lses, deltas, r0, keys, key_ok, bk, k0, (uint32_t)bh, lane);
    // dV += w_v^T dO and dK += ds^T Q: rows 16 kk..16 kk+15 are k-step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t af[4];
      hmma::a_from_c(af, st, kk);
      hmma::product_t<D>(dv, af, dot, kk, lane);
      hmma::a_from_c(af, dpt, kk);
      hmma::product_t<D>(dk, af, qt, kk, lane);
    }
  }
  hmma::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!key_ok[h]) continue;
    const size_t off = (bh * a.s_len + keys[h]) * D;
    uint32_t* dkd = reinterpret_cast<uint32_t*>(a.dk + off) + t4;
    uint32_t* dvd = reinterpret_cast<uint32_t*>(a.dv + off) + t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      dkd[4 * n] = hmma::pack_bf16(dk[n][2 * h] * a.scale, dk[n][2 * h + 1] * a.scale);
      dvd[4 * n] = hmma::pack_bf16(dv[n][2 * h], dv[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch(bool dq, const Args& a, int bh, cudaStream_t stream) {
  const int bytes = dq ? dq_smem_bytes<D>() : dkv_smem_bytes<D>();
  const void* fn = dq ? reinterpret_cast<const void*>(flash_bwd_dq_tc_kernel<D>)
                      : reinterpret_cast<const void*>(flash_bwd_dkv_tc_kernel<D>);
  // above 48 KB of dynamic shared memory a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, ((dq ? a.t_len : a.s_len) + kTile - 1) / kTile);
  if (dq)
    flash_bwd_dq_tc_kernel<D><<<grid, kThreadsTc, bytes, stream>>>(a);
  else
    flash_bwd_dkv_tc_kernel<D><<<grid, kThreadsTc, bytes, stream>>>(a);
  return cudaGetLastError();
}

int run(bool dq, const void* q, const void* k, const void* v, const void* bias,
        const void* dout, const void* lse, const void* delta, void* dqp, void* dk,
        void* dv, int bh, int t_len, int s_len, int head_dim, float scale,
        int causal, uint32_t drop_thresh, float keep_prob, uint64_t seed,
        void* stream) {
  // bh on gridDim.x (up to 2^31 - 1); the 64-row or 64-key tiles on gridDim.y
  if (bh <= 0 || t_len <= 0 || s_len <= 0 || (t_len + kTile - 1) / kTile > 65535 ||
      (s_len + kTile - 1) / kTile > 65535 || !(keep_prob > 0.f))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
               static_cast<const float*>(bias), static_cast<const float*>(lse),
               static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dqp),
               static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
               t_len, s_len, scale, causal, drop_thresh, 1.f / keep_prob, seed};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return (int)launch<32>(dq, a, bh, s);
    case 64: return (int)launch<64>(dq, a, bh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Common arguments: q, dout: (bh, t_len, head_dim); k, v: (bh, s_len,
// head_dim); bf16, contiguous, 16-byte aligned; head_dim 32 or 64; bias:
// (bh, s_len) fp32; lse, delta: (bh, t_len) fp32; drop_thresh = 0 turns
// dropout off, keep_prob is 1 - rate, seed the forward's. Each launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for what it
// does not take).

// dq: (bh, t_len, head_dim) bf16.
extern "C" int flash_bwd_dq_tc(const void* q, const void* k, const void* v,
                               const void* bias, const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int t_len,
                               int s_len, int head_dim, float scale, int causal,
                               uint32_t drop_thresh, float keep_prob, uint64_t seed,
                               void* stream) {
  return run(true, q, k, v, bias, dout, lse, delta, dq, nullptr, nullptr, bh, t_len,
             s_len, head_dim, scale, causal, drop_thresh, keep_prob, seed, stream);
}

// dk, dv: (bh, s_len, head_dim) bf16.
extern "C" int flash_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                const void* bias, const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int bh,
                                int t_len, int s_len, int head_dim, float scale,
                                int causal, uint32_t drop_thresh, float keep_prob,
                                uint64_t seed, void* stream) {
  return run(false, q, k, v, bias, dout, lse, delta, nullptr, dk, dv, bh, t_len, s_len,
             head_dim, scale, causal, drop_thresh, keep_prob, seed, stream);
}

extern "C" const char* flash_bwd_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
