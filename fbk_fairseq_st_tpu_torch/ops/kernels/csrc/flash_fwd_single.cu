// Single-pass attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces fbk_fairseq_st_tpu/scripts/bench_flash_sweep.py::_fwd_single_kernel
// (launched by fwd_single through pl.pallas_call), the flash sweep's
// whole-S candidate: one tile of t_block query rows against ALL S keys, a
// plain softmax with no online rescale:
//
//   s[t, j]  = scale * q[b, t] . k[b, j] + bias[b, j]  (NEG_INF above the
//              diagonal when causal, top-left aligned)
//   m        = max_j s,   p = exp(s - m),   l = sum_j p
//   out[b,t] = round_T(p / max(l, 1e-30)) . v[b]       (P is rounded to the
//              input type T before the P.V product, as the Pallas kernel's
//              .astype(v.dtype); the product sums in fp32)
//   lse[b,t] = m + log(max(l, 1e-30))                   (fp32)
//
// There is no dropout and no seed.
//
// Design. One block of 256 threads per (bh, t_block rows); the rows' fp32
// scores for the whole S sit in shared memory (t_block * S * 4 bytes), so a
// block needs that plus the q tile and one 64-key k/v chunk: at most 227 KB
// (232,448 bytes) on the H100, which allows t_block <= 16 at S = 2048 with
// D = 64 (t_block 16 up to S = 3307, t_block 8 up to S = 6679). The wrapper
// refuses larger shapes before the launch and the C entry returns
// cudaErrorInvalidValue for them; nothing falls back. Three phases:
//   1. a loop over S in 64-key chunks: stage the chunk of k (fp32, rows
//      padded to D + 1 floats), each thread computes t_block / 4 scores of
//      one key column and stores them in the row buffer;
//   2. each warp takes t_block / 8 rows: row max, p = exp(s - m) in place,
//      the sum, then the normalised, type-rounded P; lse from m and l;
//   3. a loop over S in 64-key chunks: stage the chunk of v, each thread
//      accumulates its outputs (row, column) over the chunk's keys.
// Causal tiles stop at the chunk holding their last row's diagonal: later
// keys are NEG_INF for every row of the tile and add exactly 0 to a row that
// has a real key (the online kernel skips the same tiles). Keys past S are
// never stored, so ragged S needs no mask; rows past T are computed on zero
// q and not written. The sweep, its one path, runs D = 64 at S = 2048, so
// only D = 64 with t_block 8 and 16 is built; other shapes are refused.
//
// What bounds it. At the sweep's shape (bh 32, T = S = 2048, D = 64, bf16)
// the function needs 4 * bh * T * S * D = 34.4 GFLOP and moves 33.6 MB: on
// the tensor cores (989 TFLOP/s) 35 us, on the memory (3.35 TB/s) 10 us, so
// operations bound it. This first design runs the products as fp32 FMAs on
// the CUDA cores (67 TFLOP/s: 0.51 ms at best), re-reads k and v from L2
// once per row tile, and holds one block per SM for its shared memory; no
// tensor cores, no TMA, no pipeline. Those belong to the kernel redesigns.

#include <math.h>
#include <stddef.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kChunk = 64;              // keys staged per chunk
constexpr int kMaxSmem = 232448;        // bytes a block can opt into (H100)

__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes(int t_block, int s_len) {
  return sizeof(float) * ((size_t)t_block * s_len   // the rows' scores / P
                          + (size_t)t_block * (D + 1)  // q tile
                          + (size_t)kChunk * (D + 1)); // one k or v chunk
}

template <typename T, int D, int TB>
__global__ void __launch_bounds__(kThreads)
flash_fwd_single_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ bias, T* __restrict__ out,
                        float* __restrict__ lse, int t_len, int s_len,
                        float scale, int causal) {
  constexpr int KS = D + 1;                   // padded k/v/q row stride
  constexpr int ROWS = TB / 4;                // score rows per thread
  constexpr int WROWS = TB / 8;               // rows per warp in phase 2
  constexpr int OUTS = (TB * D + kThreads - 1) / kThreads;  // outputs/thread

  extern __shared__ float smem[];
  float* sc = smem;                           // TB x s_len
  float* qs = sc + (size_t)TB * s_len;        // TB x KS
  float* kv = qs + TB * KS;                   // kChunk x KS

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int q0 = blockIdx.x * TB;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * t_len * D;
  const T* kb = k + bh * s_len * D;
  const T* vb = v + bh * s_len * D;
  const float* biasb = bias + bh * s_len;

  for (int i = tid; i < TB * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * KS + c] = (q0 + r < t_len) ? load_f32(qb + (size_t)(q0 + r) * D + c) : 0.f;
  }
  // causal: keys past the tile's last row are NEG_INF for all its rows
  const int s_end = causal ? min(s_len, q0 + TB) : s_len;

  // 1. scores: thread (col, r0) computes rows r0, r0 + 4, ... of one key
  const int col = tid % kChunk;
  const int r0 = tid / kChunk;  // 0..3
  for (int s0 = 0; s0 < s_end; s0 += kChunk) {
    __syncthreads();  // the previous chunk's reads are done (and qs is ready)
    for (int i = tid; i < kChunk * D; i += kThreads) {
      const int r = i / D, c = i % D;
      kv[r * KS + c] = (s0 + r < s_end) ? load_f32(kb + (size_t)(s0 + r) * D + c) : 0.f;
    }
    __syncthreads();
    const int j = s0 + col;
    if (j < s_end) {
      float acc[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) acc[i] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kd = kv[col * KS + d];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i] = fmaf(qs[(r0 + 4 * i) * KS + d], kd, acc[i]);
      }
      const float bj = biasb[j];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int r = r0 + 4 * i;
        float x = acc[i] * scale + bj;
        if (causal && j > q0 + r) x = kNegInf;
        sc[(size_t)r * s_len + j] = x;
      }
    }
  }
  __syncthreads();

  // 2. softmax of each row over [0, s_end): one warp per row
#pragma unroll 1
  for (int w = 0; w < WROWS; ++w) {
    const int r = warp * WROWS + w;
    float* row = sc + (size_t)r * s_len;
    float m = -INFINITY;
    for (int j = lane; j < s_end; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int j = lane; j < s_end; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      l += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    for (int j = lane; j < s_end; j += 32) row[j] = round_to(row[j] * inv, q);
    if (lane == 0 && q0 + r < t_len) lse[bh * t_len + q0 + r] = m + logf(fmaxf(l, 1e-30f));
  }

  // 3. out = P . V over [0, s_end): output o = tid + kThreads * i is
  //    (row o / D, column o % D)
  float acc[OUTS];
#pragma unroll
  for (int i = 0; i < OUTS; ++i) acc[i] = 0.f;
  for (int s0 = 0; s0 < s_end; s0 += kChunk) {
    __syncthreads();  // phase 2 is done / the previous chunk's reads are done
    for (int i = tid; i < kChunk * D; i += kThreads) {
      const int r = i / D, c = i % D;
      kv[r * KS + c] = (s0 + r < s_end) ? load_f32(vb + (size_t)(s0 + r) * D + c) : 0.f;
    }
    __syncthreads();
    const int n = min(kChunk, s_end - s0);
#pragma unroll
    for (int i = 0; i < OUTS; ++i) {
      const int o = tid + kThreads * i;
      if (o >= TB * D) break;
      const float* prow = sc + (size_t)(o / D) * s_len + s0;
      const float* vcol = kv + o % D;
      float a = acc[i];
#pragma unroll 8
      for (int c = 0; c < n; ++c) a = fmaf(prow[c], vcol[c * KS], a);
      acc[i] = a;
    }
  }
#pragma unroll
  for (int i = 0; i < OUTS; ++i) {
    const int o = tid + kThreads * i;
    if (o >= TB * D) break;
    const int r = o / D;
    if (q0 + r < t_len) store_from_f32(out + (bh * t_len + q0 + r) * D + o % D, acc[i]);
  }
}

struct Args {
  const void *q, *k, *v, *bias;
  void *out, *lse;
  int bh, t_len, s_len;
  float scale;
  int causal;
};

template <typename T, int D, int TB>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(TB, a.s_len);
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_single_kernel<T, D, TB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_len + TB - 1) / TB, a.bh);
  flash_fwd_single_kernel<T, D, TB><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.bias),
      static_cast<T*>(a.out), static_cast<float*>(a.lse), a.t_len, a.s_len,
      a.scale, a.causal);
  return cudaGetLastError();
}

constexpr int kHeadDim = 64;  // the one head dim built

template <typename T>
cudaError_t dispatch(const Args& a, int t_block, cudaStream_t stream) {
  switch (t_block) {
    case 8: return launch<T, kHeadDim, 8>(a, stream);
    case 16: return launch<T, kHeadDim, 16>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (bh, t_len, head_dim), k/v: (bh, s_len, head_dim), contiguous, all of
// one type (is_bf16 ? bf16 : fp32); bias: (bh, s_len) fp32; out like q;
// lse: (bh, t_len) fp32; head_dim 64; t_block 8 or 16 with the block's
// shared memory within 232,448 bytes. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for what it does not take).
extern "C" int flash_fwd_single(const void* q, const void* k, const void* v,
                                const void* bias, void* out, void* lse,
                                int bh, int t_len, int s_len, int head_dim,
                                int t_block, float scale, int causal,
                                int is_bf16, void* stream) {
  if (bh <= 0 || bh > 65535 || t_len <= 0 || s_len <= 0 ||
      head_dim != kHeadDim)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, bias, out, lse, bh, t_len, s_len, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16
      ? dispatch<__nv_bfloat16>(a, t_block, s)
      : dispatch<float>(a, t_block, s);
  return (int)err;
}

extern "C" const char* flash_fwd_single_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
