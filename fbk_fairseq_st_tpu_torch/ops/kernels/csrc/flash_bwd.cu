// Flash-attention backward for Hopper (sm_90a), plain CUDA C++: three
// kernels, each a port of a Pallas kernel of
// fbk_fairseq_st_tpu/ops/pallas/attention_kernel.py:
//
//   flash_bwd_fused  replaces _bwd_fused_kernel (via _bwd_fused_impl):
//                    dQ, dK and dV in one launch;
//   flash_bwd_dq     replaces _dq_kernel  (via _bwd_impl): dQ, q-outer;
//   flash_bwd_dkv    replaces _dkv_kernel (via _bwd_impl): dK, dV, kv-outer.
//
// The math of every tile is that of the Pallas kernels, with the forward's
// scores s (bias added, causal entries replaced by NEG_INF = -1e9), its
// per-row lse, delta = rowsum(dO * O) (computed in fp32 by the wrapper, as
// JAX computes it in XLA outside the kernel) and the forward's Philox keep
// flags (flash_common.cuh), all 1 at rate 0:
//
//   w   = exp(s - lse)
//   w_v = w * keep / (1 - rate)           dV += w_v^T dO
//   dp  = (dO V^T) * keep / (1 - rate)
//   ds  = w * (dp - delta)                dK += ds^T q * scale
//                                         dQ += ds k * scale
//
// Rows past T and keys past S get w = 0; kv tiles wholly above the causal
// diagonal of a q tile are skipped, as in the forward.
//
// Design. 256 threads and 64 x 64 tiles, as the forward. A tile's score
// and dO V^T products give each thread 4 rows x 4 keys; w (or w_v) and ds
// then go through shared memory, where the products with dO, q and k read
// them transposed or not as each needs. At rate > 0 a masking pass walks
// the tile in groups of 4 keys, one Philox call per group, as the forward
// does.
//   * flash_bwd_dkv: one block per (bh, 64-key tile). K and V stay in
//     shared memory; dK and dV accumulate in registers (4 keys x D/16
//     columns a thread) over a loop on the q tiles; deterministic.
//   * flash_bwd_dq: one block per (bh, 64-row q tile). q and dO stay in
//     shared memory; dQ accumulates in registers over a loop on the kv
//     tiles; deterministic.
//   * flash_bwd_fused: the dkv kernel, which for each q tile also forms
//     that tile's share of dQ (ds k) and adds it into an fp32 (BH, T, D)
//     buffer; the wrapper casts it to q's type. The JAX kernel instead
//     wrote dK/dV partials per q block, an fp32 (BH, n_i, S, D) buffer
//     (about 2 GB at S = 8192), which this design does not need. The adds
//     land in a fixed order, so dQ is bitwise repeatable (the ordered
//     accumulation of FlashAttention-3's deterministic backward): an int32
//     counter per (bh, q tile), zeroed by the wrapper before each launch,
//     holds how many kv tiles have added into that q tile. The kv tiles
//     that reach q tile i are a prefix 0..m of the kv tiles (all of them,
//     or under causal masking those with s0 <= the tile's last row), so kv
//     tile j's rank among them is j: it waits until the counter is j, does
//     a plain load-add-store of its share through L2, fences, and one
//     thread releases the counter to j + 1 (see ordered_add_dq).
// Everything is fp32 in registers and shared memory whatever the input
// type (fp32 or bf16), on the CUDA cores. D is a template over
// {16, 32, 64, 128}; the wrapper zero-pads to it.
//
// What bounds it. At the encoder self-attention training shape (bh = 512,
// T = S = 128, D = 64) the fused kernel does 5 products of 2*T*S*D per bh
// (s, dO V^T, dV, dK, dQ) = 5.4 GFLOP, 80 us at 67 TFLOP/s of fp32 without
// tensor cores, against 101 MB moved in fp32 (q, k, v, dO, dQ, dK, dV:
// 30 us at 3.35 TB/s): operations bound it in fp32. In bf16 the bytes
// (half as many) take 15 us and the tensor-core work 5.4 us, so bytes would
// bound a tensor-core kernel. The split pair recomputes s and dO V^T in
// both kernels: 7 products instead of 5. As the forward, this design is
// simple and correct first: no tensor cores, no TMA, no pipelining.

#include <math.h>
#include <stddef.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int PS = kBlockN + 1;      // row stride of the w / ds tiles
constexpr int RPT = kBlockM / 16;    // tile rows per thread
constexpr int CPT = kBlockN / 16;    // tile columns per thread
constexpr int GROUPS = kBlockN / 4;  // Philox groups per tile row

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * kBlockM * (D + 1)      // q, dO, k, v tiles
                          + 2 * kBlockM * PS         // w (w_v), ds
                          + 2 * kBlockM              // lse, delta
                          + kBlockN);                // bias
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *bias, *lse, *delta;
  void *dq, *dk, *dv;  // dq is fp32 for the fused kernel
  int* order;          // fused: one zeroed counter per (bh, q tile)
  int t_len, s_len;
  float scale;
  int causal;
  uint32_t drop_thresh;
  float keep_prob;
  uint64_t seed;
};

// Shared-memory tiles of one block.
template <int D>
struct Tiles {
  static constexpr int RS = D + 1;  // padded row stride
  float *qs, *dos, *ks, *vs, *ws, *dss, *lses, *deltas, *bs;
  __device__ explicit Tiles(float* smem) {
    qs = smem;
    dos = qs + kBlockM * RS;
    ks = dos + kBlockM * RS;
    vs = ks + kBlockN * RS;
    ws = vs + kBlockN * RS;
    dss = ws + kBlockM * PS;
    lses = dss + kBlockM * PS;
    deltas = lses + kBlockM;
    bs = deltas + kBlockM;
  }
};

template <typename T, int D>
__device__ void load_rows(float* dst, const T* src, int r0, int len) {
  constexpr int RS = D + 1;
  for (int i = threadIdx.x; i < kBlockM * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * RS + c] = (r0 + r < len) ? load_f32(src + (size_t)(r0 + r) * D + c) : 0.f;
  }
}

template <typename T, int D>
__device__ void load_q_tile(const Tiles<D>& sm, const Args& a, size_t bh, int q0) {
  load_rows<T, D>(sm.qs, static_cast<const T*>(a.q) + bh * a.t_len * D, q0, a.t_len);
  load_rows<T, D>(sm.dos, static_cast<const T*>(a.dout) + bh * a.t_len * D, q0, a.t_len);
  for (int i = threadIdx.x; i < kBlockM; i += kThreads) {
    const bool ok = q0 + i < a.t_len;
    sm.lses[i] = ok ? a.lse[bh * a.t_len + q0 + i] : 0.f;
    sm.deltas[i] = ok ? a.delta[bh * a.t_len + q0 + i] : 0.f;
  }
}

template <typename T, int D>
__device__ void load_kv_tile(const Tiles<D>& sm, const Args& a, size_t bh, int s0) {
  load_rows<T, D>(sm.ks, static_cast<const T*>(a.k) + bh * a.s_len * D, s0, a.s_len);
  load_rows<T, D>(sm.vs, static_cast<const T*>(a.v) + bh * a.s_len * D, s0, a.s_len);
  for (int i = threadIdx.x; i < kBlockN; i += kThreads)
    sm.bs[i] = (s0 + i < a.s_len) ? a.bias[bh * a.s_len + s0 + i] : 0.f;
}

// w (w_v at rate > 0) and ds of the (q0, s0) tile into sm.ws / sm.dss.
// Called by all threads between barriers; leaves a barrier behind it.
template <int D>
__device__ void tile_w_ds(const Tiles<D>& sm, const Args& a, uint32_t bh, int q0, int s0) {
  constexpr int RS = D + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float sc[RPT][CPT], dp[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) sc[i][j] = dp[i][j] = 0.f;

#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float qv[RPT], dov[RPT], kv[CPT], vv[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      qv[i] = sm.qs[(ty + 16 * i) * RS + d];
      dov[i] = sm.dos[(ty + 16 * i) * RS + d];
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      kv[j] = sm.ks[(tx + 16 * j) * RS + d];
      vv[j] = sm.vs[(tx + 16 * j) * RS + d];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }

  const bool dropout = a.drop_thresh != 0u;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + 16 * j, col = s0 + c;
      float x = sc[i][j] * a.scale + sm.bs[c];
      if (a.causal && col > row) x = kNegInf;
      const float w = (row < a.t_len && col < a.s_len) ? expf(x - sm.lses[r]) : 0.f;
      sm.ws[r * PS + c] = w;
      // at rate > 0 the masking pass below turns dp into ds
      sm.dss[r * PS + c] = dropout ? dp[i][j] : w * (dp[i][j] - sm.deltas[r]);
    }
  }
  __syncthreads();
  if (!dropout) return;

  for (int it = threadIdx.x; it < kBlockM * GROUPS; it += kThreads) {
    const int r = it / GROUPS, g = it % GROUPS;
    float* w = sm.ws + r * PS + 4 * g;
    float* ds = sm.dss + r * PS + 4 * g;
    if (q0 + r >= a.t_len || s0 + 4 * g >= a.s_len) {
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = ds[u] = 0.f;  // w is 0 there
      continue;
    }
    const uint4 bits = dropout_bits(a.seed, bh, q0 + r, s0 + 4 * g);
    const float delta = sm.deltas[r];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool keep = word(bits, u) >= a.drop_thresh;
      const float dpu = keep ? ds[u] / a.keep_prob : 0.f;
      ds[u] = w[u] * (dpu - delta);
      w[u] = keep ? w[u] / a.keep_prob : 0.f;
    }
  }
  __syncthreads();
}

// Adds kv tile `rank`'s share of dQ (rows ty + 16 i of the q tile at q0,
// already summed over the tile's keys) into the fp32 dq buffer, after the
// kv tiles of lower rank and before those of higher rank. Called by all
// threads; leaves a barrier behind it.
//
// Why it cannot deadlock: the grid is (bh, kv tile) with blockIdx.x = bh
// fastest, and blocks are dispatched in linear order, so block (bh, j)
// starts only after every block of a lower linear index has started, the
// block (bh, j - 1) it waits on included. The unfinished block of lowest
// index waits on nothing unfinished (it waits only on (bh, j - 1), of
// lower index, or on nothing at j = 0), so it runs to its end; by
// induction every block does. Within a block the q tiles go in increasing
// order, as in its predecessor, so a counter is never waited on out of turn.
template <int D>
__device__ void ordered_add_dq(const Args& a, const float (&dq)[RPT][D / 16], size_t bh, int q0,
                               int rank) {
  constexpr int DPT = D / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int* counter = a.order + bh * ((a.t_len + kBlockM - 1) / kBlockM) + q0 / kBlockM;
  if (threadIdx.x == 0) {
    int seen;
    do {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(seen) : "l"(counter) : "memory");
    } while (seen != rank);
  }
  __syncthreads();
  float* dqb = static_cast<float*>(a.dq) + bh * a.t_len * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.t_len) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      float* p = dqb + (size_t)row * D + tx + 16 * j;
      __stcg(p, __ldcg(p) + dq[i][j] * a.scale);  // through L2, never a stale L1 line
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;" : : "l"(counter) : "memory");
}

// dK/dV for one (bh, kv tile), looping over q tiles; with FUSED also the dQ
// share of every q tile, added into the fp32 dq buffer in kv-tile order.
template <typename T, int D, bool FUSED>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_kernel(Args a) {
  constexpr int RS = D + 1;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  const Tiles<D> sm(smem);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int s0 = blockIdx.y * kBlockN;
  const size_t bh = blockIdx.x;

  load_kv_tile<T, D>(sm, a, bh, s0);

  float dk[RPT][DPT], dv[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk[i][j] = dv[i][j] = 0.f;

  // causal: q tiles that end before this kv tile starts add nothing
  const int q_begin = a.causal ? (s0 / kBlockM) * kBlockM : 0;
  for (int q0 = q_begin; q0 < a.t_len; q0 += kBlockM) {
    __syncthreads();  // the previous q tile's reads are done
    load_q_tile<T, D>(sm, a, bh, q0);
    __syncthreads();
    tile_w_ds<D>(sm, a, (uint32_t)bh, q0, s0);

    // dV += w_v^T dO, dK += ds^T q: this thread's keys ty + 16 i
#pragma unroll 4
    for (int r = 0; r < kBlockM; ++r) {
      float wv[RPT], dsv[RPT], dov[DPT], qv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        wv[i] = sm.ws[r * PS + ty + 16 * i];
        dsv[i] = sm.dss[r * PS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        dov[j] = sm.dos[r * RS + tx + 16 * j];
        qv[j] = sm.qs[r * RS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          dv[i][j] = fmaf(wv[i], dov[j], dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
        }
    }

    if constexpr (FUSED) {
      // this q tile's share of dQ = ds k * scale: rows ty + 16 i
      float dq[RPT][DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) dq[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < kBlockN; ++c) {
        float dsv[RPT], kv[DPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) dsv[i] = sm.dss[(ty + 16 * i) * PS + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j) kv[j] = sm.ks[c * RS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < DPT; ++j) dq[i][j] = fmaf(dsv[i], kv[j], dq[i][j]);
      }
      ordered_add_dq<D>(a, dq, bh, q0, s0 / kBlockN);
    }
  }

  T* dkb = static_cast<T*>(a.dk) + bh * a.s_len * D;
  T* dvb = static_cast<T*>(a.dv) + bh * a.s_len * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int col = s0 + ty + 16 * i;
    if (col >= a.s_len) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      store_from_f32(dkb + (size_t)col * D + tx + 16 * j, dk[i][j] * a.scale);
      store_from_f32(dvb + (size_t)col * D + tx + 16 * j, dv[i][j]);
    }
  }
}

// dQ for one (bh, q tile), looping over kv tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_q_kernel(Args a) {
  constexpr int RS = D + 1;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  const Tiles<D> sm(smem);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.y * kBlockM;
  const size_t bh = blockIdx.x;

  load_q_tile<T, D>(sm, a, bh, q0);

  float dq[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dq[i][j] = 0.f;

  // causal: kv tiles that start past this q tile's last row add nothing
  const int s_end = a.causal ? min(a.s_len, q0 + kBlockM) : a.s_len;
  for (int s0 = 0; s0 < s_end; s0 += kBlockN) {
    __syncthreads();  // the previous kv tile's reads are done
    load_kv_tile<T, D>(sm, a, bh, s0);
    __syncthreads();
    tile_w_ds<D>(sm, a, (uint32_t)bh, q0, s0);
#pragma unroll 4
    for (int c = 0; c < kBlockN; ++c) {
      float dsv[RPT], kv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = sm.dss[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) kv[j] = sm.ks[c * RS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) dq[i][j] = fmaf(dsv[i], kv[j], dq[i][j]);
    }
  }

  T* dqb = static_cast<T*>(a.dq) + bh * a.t_len * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.t_len) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      store_from_f32(dqb + (size_t)row * D + tx + 16 * j, dq[i][j] * a.scale);
  }
}

enum Which { kFused = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
cudaError_t launch(Which which, const Args& a, int bh, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  // bh on x (up to 2^31 - 1), the tiles on y (at most 65,535)
  const dim3 kv_grid(bh, (a.s_len + kBlockN - 1) / kBlockN);
  const dim3 q_grid(bh, (a.t_len + kBlockM - 1) / kBlockM);
  cudaError_t err;
  // above 48 KB of dynamic shared memory a kernel must opt in
  switch (which) {
    case kFused:
      err = cudaFuncSetAttribute(flash_bwd_kv_kernel<T, D, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return err;
      flash_bwd_kv_kernel<T, D, true><<<kv_grid, kThreads, bytes, stream>>>(a);
      break;
    case kDkv:
      err = cudaFuncSetAttribute(flash_bwd_kv_kernel<T, D, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return err;
      flash_bwd_kv_kernel<T, D, false><<<kv_grid, kThreads, bytes, stream>>>(a);
      break;
    case kDq:
      err = cudaFuncSetAttribute(flash_bwd_q_kernel<T, D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return err;
      flash_bwd_q_kernel<T, D><<<q_grid, kThreads, bytes, stream>>>(a);
      break;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(Which which, const Args& a, int bh, int head_dim,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(which, a, bh, stream);
    case 32: return launch<T, 32>(which, a, bh, stream);
    case 64: return launch<T, 64>(which, a, bh, stream);
    case 128: return launch<T, 128>(which, a, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(Which which, const void* q, const void* k, const void* v,
        const void* bias, const void* dout, const void* lse, const void* delta,
        void* dq, void* dk, void* dv, void* order, int bh, int t_len, int s_len,
        int head_dim, float scale, int causal, uint32_t drop_thresh,
        float keep_prob, uint64_t seed, int is_bf16, void* stream) {
  if (bh <= 0 || t_len <= 0 || s_len <= 0 ||
      (t_len + kBlockM - 1) / kBlockM > 65535 || (s_len + kBlockN - 1) / kBlockN > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout,
               static_cast<const float*>(bias), static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, dk, dv, static_cast<int*>(order), t_len, s_len,
               scale, causal, drop_thresh, keep_prob, seed};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch_d<__nv_bfloat16>(which, a, bh, head_dim, s)
                       : dispatch_d<float>(which, a, bh, head_dim, s));
}

}  // namespace

// Common arguments: q, dout: (bh, t_len, head_dim); k, v: (bh, s_len,
// head_dim), contiguous, all of one type (is_bf16 ? bf16 : fp32); bias:
// (bh, s_len) fp32; lse, delta: (bh, t_len) fp32; drop_thresh = 0 turns
// dropout off, keep_prob is 1 - rate, seed the forward's. dk, dv like k.
// Each launches on `stream` and returns cudaGetLastError().

// dq: (bh, t_len, head_dim) fp32 and order: (bh, ceil(t_len / 64)) int32,
// both zeroed by the caller before each launch (the kv tiles add into dq in
// the order the counters in `order` keep).
extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v,
                               const void* bias, const void* dout,
                               const void* lse, const void* delta, void* dq,
                               void* dk, void* dv, void* order, int bh, int t_len,
                               int s_len, int head_dim, float scale,
                               int causal, uint32_t drop_thresh,
                               float keep_prob, uint64_t seed, int is_bf16,
                               void* stream) {
  return run(kFused, q, k, v, bias, dout, lse, delta, dq, dk, dv, order, bh, t_len,
             s_len, head_dim, scale, causal, drop_thresh, keep_prob, seed,
             is_bf16, stream);
}

// dq: (bh, t_len, head_dim) like q.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* bias, const void* dout,
                            const void* lse, const void* delta, void* dq,
                            int bh, int t_len, int s_len, int head_dim,
                            float scale, int causal, uint32_t drop_thresh,
                            float keep_prob, uint64_t seed, int is_bf16,
                            void* stream) {
  return run(kDq, q, k, v, bias, dout, lse, delta, dq, nullptr, nullptr, nullptr, bh,
             t_len, s_len, head_dim, scale, causal, drop_thresh, keep_prob,
             seed, is_bf16, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* bias, const void* dout,
                             const void* lse, const void* delta, void* dk,
                             void* dv, int bh, int t_len, int s_len,
                             int head_dim, float scale, int causal,
                             uint32_t drop_thresh, float keep_prob,
                             uint64_t seed, int is_bf16, void* stream) {
  return run(kDkv, q, k, v, bias, dout, lse, delta, nullptr, dk, dv, nullptr, bh,
             t_len, s_len, head_dim, scale, causal, drop_thresh, keep_prob,
             seed, is_bf16, stream);
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
