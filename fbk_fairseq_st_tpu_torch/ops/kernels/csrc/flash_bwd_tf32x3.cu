// Split flash-attention backward for fp32 on Hopper's tensor cores (sm_90a),
// plain CUDA C++: 3xTF32 products at head dim 32, 64 or 128. Two kernels,
// each a port of a Pallas kernel of
// fbk_fairseq_st_tpu/ops/pallas/attention_kernel.py for fp32 calls at kernel
// head dims 32, 64 and 128 (the iwslt lightconv presets' 4 heads over 512
// dims):
//
//   flash_bwd_dq_tf32x3   replaces _dq_kernel:  dQ, q-outer;
//   flash_bwd_dkv_tf32x3  replaces _dkv_kernel: dK and dV, kv-outer;
//
// together they take the place of _bwd_fused_kernel (_bwd_fused_impl) on
// the fp32 route, whose port (flash_bwd.cu::flash_bwd_fused) adds dQ with
// fp32 atomics. The math is flash_bwd_tc.cu's (its note) with nothing
// rounded to a narrower type, as the Pallas kernels' .astype is the
// identity in fp32:
//
//   w   = exp(s - lse)                      (ex2 with log2 e folded in)
//   w_v = w * keep / (1 - rate)             dV += w_v^T dO
//   dp  = (dO V^T) * keep / (1 - rate)
//   ds  = w * (dp - delta)                  dK += ds^T q, times scale
//                                           dQ += ds k,   times scale
//
// Every product is three tf32 products (hopper_mma.cuh, 3xTF32), so the
// split of w_v and ds into tf32 pieces is the whole of the rounding. Rows
// past T and keys past S are zero-filled by the copies and get w = 0
// explicitly. Each output element is written once by one thread, summed in
// a fixed order: no atomics, so both kernels are deterministic. A warp skips
// the chunks in which none of its (row, key) pairs is live: keys past
// S, rows past T, or (causal) every key above every row's diagonal, where
// w = 0 for every row that has a key left; a row whose every key is masked
// (which no real batch has) loses those keys' share, as the chunks past a
// causal tile's diagonal already drop theirs.
//
// Design: flash_bwd_tc.cu's split on fp32 tiles (512-byte rows at D 128,
// 256-byte at D 64, 128-byte at D 32, XOR-swizzled), 4 warps a block, bh on
// gridDim.x, and a cp.async ring of chunks of keys (dq) or rows (dkv), the
// plan of each head dim (Plan<D>). At D 32 and 64: 2 slots of 32-key or
// 32-row chunks, 64 KB of shared memory a block at D 64 and at most 170
// registers a thread, so 3 blocks share an SM; 64-key chunks in 2 slots
// (96 KB, 2 blocks an SM) ran slower in development runs on an H100, most
// at the short causal calls. At D 128 a 64-row Q or dO tile (dq), or K or
// V tile (dkv), is 32 KB: the two take 64 KB, and two slots of 32-key
// chunks 64 KB more, so a block of 128 KB would have an SM to itself (the
// iwslt call's 256 blocks in two waves). Chunks of 16 keys or rows halve
// the ring: 96 KB, two blocks an SM, one wave. The dkv lane holds dK and dV
// (128 fp32 accumulators) beside S^T and dP^T, 8 + 8 at 16 rows. So D 128
// takes chunks of 16 in 2 slots: 3 slots read within 2 % on an H100 for
// 16 KB more, and chunks of 32 (dkv at 255 registers, one block an SM)
// were 1.46x slower at the iwslt call and 1.23x at bh 32, T = S = 2048
// (PERF.md section 6 gives the times). ptxas: dq 167, dkv 237 registers, no spill.
//   * dq: one block per (bh, 64-row q tile), a warp per 16 rows. Q and dO
//     stay in shared memory, their A fragments read by ldmatrix and split
//     where used (held in registers they spilled: 255 registers); K and V
//     chunks of 32 keys stream through the ring. Per chunk
//     S = Q K^T and dP = dO V^T (K's and V's B fragments by ldmatrix), ds in
//     the C fragments, then dQ += ds K with ds's C fragments read as A
//     fragments in the permuted k order and K's B fragments by ld.shared in
//     the same order (product_t_3x).
//   * dkv: one block per (bh, 64-key tile), a warp per 16 keys, in the
//     transposed frame (S^T = K Q^T, dP^T = V dO^T): K and V in shared
//     memory as Q and dO in dq, 32-row Q and dO chunks with their lse and
//     delta through the ring; dV += w_v^T dO and dK += ds^T Q.
//   * Dropout: dq draws through row_frame_keep_bits, the forwards' own
//     function, and dkv through key_frame_keep_bits, flash_bwd_tc.cu's:
//     one Philox4x32-10 call a lane per m16n8 tile in both. The steps
//     between the products are the bf16 pair's own functions
//     (hopper_mma.cuh::dq_ds_step, dkv_wv_ds_step).
//
// What bounds it. At the long-context encoder call (bh 32, T = S = 2048,
// D 64) dq does 3 products of 2 T S D a head (51.5 GFLOP) and dkv 4 (68.7
// GFLOP): 0.31 / 0.42 ms at the 165 TFLOP/s of fp32-faithful products
// (495 TF32 / 3), against 34-67 MB of traffic (10-20 us at 3.35 TB/s), so
// operations bound both; at D 128 twice that, 0.62 / 0.83 ms. At the iwslt
// call (bh 256, T = S = 56, D 128) bytes bound them: 36.9 + 44.2 MB, 0.0110
// + 0.0132 ms, against 0.0023 + 0.0031 ms of products. Each warp splits every K, V (dq) or Q, dO (dkv)
// element it multiplies, and the A fragments once a chunk, with two integer
// operations and a subtraction (split_tf32): about two such instructions
// for each mma.sync issued.

#include <math.h>
#include <stddef.h>

#include "flash_common.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace flash;

constexpr int kTile = 64;     // q rows a dq block, keys a dkv block
constexpr int kThreadsTc = 128;

// Each head dim's chunk (keys or rows a ring slot), ring slots, and the
// blocks an SM its registers are bounded for.
template <int D> struct Plan {
  static constexpr int kChunk = 32, kStages = 2;
  static constexpr int kBlocksPerSm = 3;  // 64 KB of shared memory and <= 170 registers a thread
};
template <> struct Plan<128> {
  static constexpr int kChunk = 16, kStages = 2;  // 96 KB: two blocks share an SM
  static constexpr int kBlocksPerSm = 1;  // registers bounded only by the 255 a thread may hold
};

struct Args {
  const float *q, *k, *v, *dout;
  const float *bias, *lse, *delta;
  float *dq, *dk, *dv;
  int t_len, s_len;
  float scale;
  int causal;
  uint32_t drop_thresh;  // 0: no dropout
  float inv_keep;        // 1 / (1 - rate)
  uint64_t seed;
};

template <int D> __host__ __device__ constexpr int tile_bytes() { return kTile * 4 * D; }
template <int D> __host__ __device__ constexpr int chunk_bytes() { return Plan<D>::kChunk * 4 * D; }
template <int D> __host__ __device__ constexpr int dq_smem_bytes() {
  return 2 * tile_bytes<D>() + Plan<D>::kStages * 2 * chunk_bytes<D>();
}
template <int D> __host__ __device__ constexpr int dkv_slot_bytes() {
  return 2 * chunk_bytes<D>() + 2 * Plan<D>::kChunk * 4;
}
template <int D> __host__ __device__ constexpr int dkv_smem_bytes() {
  return 2 * tile_bytes<D>() + Plan<D>::kStages * dkv_slot_bytes<D>();
}

// ---------------------------------------------------------------------------
// dQ, q-outer
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreadsTc, Plan<D>::kBlocksPerSm)
flash_bwd_dq_tf32x3_kernel(Args a) {
  constexpr int RB = 4 * D;
  constexpr int TILE = tile_bytes<D>(), CH = chunk_bytes<D>();
  constexpr int kChunk = Plan<D>::kChunk, kStages = Plan<D>::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = hmma::smem_u32(smem), dos = qs + TILE;
  const hmma::CpAsyncRing<kStages, 2 * CH> ring{dos + TILE};

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int w0 = q0 + warp * 16;  // the warp's first row
  const float* kb = a.k + bh * a.s_len * D;
  const float* vb = a.v + bh * a.s_len * D;
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
  const int n_chunks = (s_end + kChunk - 1) / kChunk;
  auto fill = [&](int c) {
    if (c < n_chunks) {
      const int s0 = c * kChunk;
      const uint32_t slot = ring.slot(c);
      hmma::load_tile<kChunk, kThreadsTc, RB>(slot, kb + (size_t)s0 * D, a.s_len - s0, tid);
      hmma::load_tile<kChunk, kThreadsTc, RB>(slot + CH, vb + (size_t)s0 * D, a.s_len - s0, tid);
    }
    hmma::cp_async_commit();  // an empty group past the end keeps the count
  };
  const size_t qoff = (bh * a.t_len + q0) * D;
  hmma::load_tile<kTile, kThreadsTc, RB>(qs, a.q + qoff, a.t_len - q0, tid);
  hmma::load_tile<kTile, kThreadsTc, RB>(dos, a.dout + qoff, a.t_len - q0, tid);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fill(i);  // Q and dO land with fill 0

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    hmma::CpAsyncRing<kStages, 2 * CH>::wait();
    __syncthreads();  // this chunk is visible; the slot read last step is free
    fill(c + kStages - 1);
    const uint32_t kt = ring.slot(c), vt = kt + CH;

    // a chunk whose keys lie past S, or above the diagonal of all the
    // warp's rows, or a warp whose rows lie past T, adds nothing
    const int key0 = c * kChunk;
    if (w0 >= a.t_len || key0 >= a.s_len || (a.causal && key0 > w0 + 15)) continue;
    constexpr int NT = kChunk / 8;  // 8-key tiles a chunk
    float sc[NT][4], dp[NT][4];  // rows x keys: tile n holds keys key0 + 8 n..
    hmma::product_nt_3x<D, NT>(sc, qs, warp * 16, kt, 0, lane);
    hmma::product_nt_3x<D, NT>(dp, dos, warp * 16, vt, 0, lane);
    hmma::dq_ds_step(sc, dp, a, biasb, key0, rows, row_ok, lse, delta, w0, (uint32_t)bh, lane);
    // dQ += ds K over the chunk's k-steps of 8 keys
    hmma::product_t_3x<D, NT>(acc, sc, smem + (kt - qs), 0, lane);
  }
  hmma::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    float2* dst = reinterpret_cast<float2*>(a.dq + (bh * a.t_len + rows[h]) * D) + t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      dst[4 * n] = make_float2(acc[n][2 * h] * a.scale, acc[n][2 * h + 1] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// dK and dV, kv-outer
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreadsTc, Plan<D>::kBlocksPerSm)
flash_bwd_dkv_tf32x3_kernel(Args a) {
  constexpr int RB = 4 * D;
  constexpr int TILE = tile_bytes<D>(), CH = chunk_bytes<D>();
  constexpr int kChunk = Plan<D>::kChunk, kStages = Plan<D>::kStages;
  constexpr int SLOT = dkv_slot_bytes<D>();  // Q, dO, then lse and delta (kChunk floats each)
  static_assert(SLOT % 128 == 0, "ring slots keep the swizzle's 128-byte alignment");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ks = hmma::smem_u32(smem), vs = ks + TILE;
  const hmma::CpAsyncRing<kStages, SLOT> ring{vs + TILE};

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t bh = blockIdx.x;
  const int s0 = blockIdx.y * kTile;
  const int k0 = s0 + warp * 16;  // the warp's first key
  const float* qb = a.q + bh * a.t_len * D;
  const float* dob = a.dout + bh * a.t_len * D;
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
  const int n_chunks = a.t_len > r_begin ? (a.t_len - r_begin + kChunk - 1) / kChunk : 0;
  auto fill = [&](int c) {
    if (c < n_chunks) {
      const int r0 = r_begin + c * kChunk;
      const uint32_t slot = ring.slot(c);
      hmma::load_tile<kChunk, kThreadsTc, RB>(slot, qb + (size_t)r0 * D, a.t_len - r0, tid);
      hmma::load_tile<kChunk, kThreadsTc, RB>(slot + CH, dob + (size_t)r0 * D, a.t_len - r0, tid);
      if (tid < 2 * kChunk) {  // lse of the chunk's rows, then their delta
        const int r = r0 + (tid & (kChunk - 1));
        const bool ok = r < a.t_len;
        const float* src = (tid < kChunk ? lseb : deltab) + (ok ? r : 0);
        hmma::cp_async4(slot + 2 * CH + 4 * tid, src, ok);
      }
    }
    hmma::cp_async_commit();
  };
  const size_t koff = (bh * a.s_len + s0) * D;
  hmma::load_tile<kTile, kThreadsTc, RB>(ks, a.k + koff, a.s_len - s0, tid);
  hmma::load_tile<kTile, kThreadsTc, RB>(vs, a.v + koff, a.s_len - s0, tid);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fill(i);  // K and V land with fill 0

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
    const int r0 = r_begin + c * kChunk;
    const uint32_t qt = ring.slot(c), dot = qt + CH;
    const unsigned char* qp = smem + (qt - ks);
    const unsigned char* dop = qp + CH;
    const float* lses = reinterpret_cast<const float*>(qp + 2 * CH);
    const float* deltas = lses + kChunk;

    // a chunk whose rows lie past T, or below the diagonal of all the
    // warp's keys, or a warp whose keys lie past S, adds nothing
    if (k0 >= a.s_len || r0 >= a.t_len || (a.causal && r0 + kChunk - 1 < k0)) continue;
    constexpr int NT = kChunk / 8;  // 8-row tiles a chunk
    float st[NT][4], dpt[NT][4];  // keys x rows: tile n holds rows r0 + 8 n..
    hmma::product_nt_3x<D, NT>(st, ks, warp * 16, qt, 0, lane);
    hmma::product_nt_3x<D, NT>(dpt, vs, warp * 16, dot, 0, lane);
    hmma::dkv_wv_ds_step(st, dpt, a, lses, deltas, r0, keys, key_ok, bk, k0, (uint32_t)bh, lane);
    // dV += w_v^T dO and dK += ds^T Q over the chunk's k-steps of 8 rows
    hmma::product_t_3x<D, NT>(dv, st, dop, 0, lane);
    hmma::product_t_3x<D, NT>(dk, dpt, qp, 0, lane);
  }
  hmma::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!key_ok[h]) continue;
    const size_t off = (bh * a.s_len + keys[h]) * D;
    float2* dkd = reinterpret_cast<float2*>(a.dk + off) + t4;
    float2* dvd = reinterpret_cast<float2*>(a.dv + off) + t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      dkd[4 * n] = make_float2(dk[n][2 * h] * a.scale, dk[n][2 * h + 1] * a.scale);
      dvd[4 * n] = make_float2(dv[n][2 * h], dv[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch(bool dq, const Args& a, int bh, cudaStream_t stream) {
  const int bytes = dq ? dq_smem_bytes<D>() : dkv_smem_bytes<D>();
  const void* fn = dq ? reinterpret_cast<const void*>(flash_bwd_dq_tf32x3_kernel<D>)
                      : reinterpret_cast<const void*>(flash_bwd_dkv_tf32x3_kernel<D>);
  // above 48 KB of dynamic shared memory a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, ((dq ? a.t_len : a.s_len) + kTile - 1) / kTile);
  if (dq)
    flash_bwd_dq_tf32x3_kernel<D><<<grid, kThreadsTc, bytes, stream>>>(a);
  else
    flash_bwd_dkv_tf32x3_kernel<D><<<grid, kThreadsTc, bytes, stream>>>(a);
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
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(dout),
               static_cast<const float*>(bias), static_cast<const float*>(lse),
               static_cast<const float*>(delta), static_cast<float*>(dqp),
               static_cast<float*>(dk), static_cast<float*>(dv),
               t_len, s_len, scale, causal, drop_thresh, 1.f / keep_prob, seed};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return (int)launch<32>(dq, a, bh, s);
    case 64: return (int)launch<64>(dq, a, bh, s);
    case 128: return (int)launch<128>(dq, a, bh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Common arguments: q, dout: (bh, t_len, head_dim); k, v: (bh, s_len,
// head_dim); fp32, contiguous, 16-byte aligned; head_dim 32, 64 or 128;
// bias: (bh, s_len) fp32; lse, delta: (bh, t_len) fp32; drop_thresh = 0 turns
// dropout off, keep_prob is 1 - rate, seed the forward's. Each launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for what it
// does not take).

// dq: (bh, t_len, head_dim) fp32.
extern "C" int flash_bwd_dq_tf32x3(const void* q, const void* k, const void* v,
                                   const void* bias, const void* dout, const void* lse,
                                   const void* delta, void* dq, int bh, int t_len,
                                   int s_len, int head_dim, float scale, int causal,
                                   uint32_t drop_thresh, float keep_prob, uint64_t seed,
                                   void* stream) {
  return run(true, q, k, v, bias, dout, lse, delta, dq, nullptr, nullptr, bh, t_len,
             s_len, head_dim, scale, causal, drop_thresh, keep_prob, seed, stream);
}

// dk, dv: (bh, s_len, head_dim) fp32.
extern "C" int flash_bwd_dkv_tf32x3(const void* q, const void* k, const void* v,
                                    const void* bias, const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv, int bh,
                                    int t_len, int s_len, int head_dim, float scale,
                                    int causal, uint32_t drop_thresh, float keep_prob,
                                    uint64_t seed, void* stream) {
  return run(false, q, k, v, bias, dout, lse, delta, nullptr, dk, dv, bh, t_len, s_len,
             head_dim, scale, causal, drop_thresh, keep_prob, seed, stream);
}

extern "C" const char* flash_bwd_tf32x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
