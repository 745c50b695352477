// Single-pass attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces fbk_fairseq_st_tpu/scripts/bench_flash_sweep.py::_fwd_single_kernel
// (launched by fwd_single through pl.pallas_call), the flash sweep's
// whole-S candidate: one tile of t_block query rows against ALL S keys, a
// plain softmax with no online rescale of the output:
//
//   s[t, j]  = scale * q[b, t] . k[b, j] + bias[b, j]  (NEG_INF above the
//              diagonal when causal, top-left aligned)
//   m        = max_j s,   p = exp(s - m),   l = sum_j p
//   out[b,t] = round_T(p / max(l, 1e-30)) . v[b]       (P is rounded to the
//              input type T before the P.V product, as the Pallas kernel's
//              .astype(v.dtype); the product sums in fp32)
//   lse[b,t] = m + log(max(l, 1e-30))                   (fp32)
//
// There is no dropout and no seed. Two kernels, one per input type:
//
// bf16: flash_fwd_single_kernel_tc, on the tensor cores. One warp per 16
// query rows, TB = 64 rows (4 warps) or 128 (8 warps) a block, D = 64. Two
// passes over S in 64-key chunks and no score buffer:
//   pass 1: S = Q K^T of the chunk by mma.sync.m16n8k16 (Q's fragments held
//     in registers, K's read by ldmatrix), scale, bias and the causal
//     triangle applied, and only the row max m and the row sum l kept (l
//     rescaled when m grows: two scalars a row, never the output);
//   pass 2: the chunk's scores again, P = exp(s - m) * (1 / max(l, 1e-30))
//     rounded to bf16 straight into the A fragments of O += P V (V's B
//     fragments by ldmatrix.trans).
// It does 1.5x the function's products (Q K^T twice). K and V chunks arrive
// by cp.async into a 3-slot ring (hopper_mma.cuh), two chunks ahead of the
// products; the tiles' 128-byte rows are XOR-swizzled so ldmatrix reads
// them without bank conflicts. Shared memory is the Q tile and the ring, 56
// KB (TB 64) or 64 KB (TB 128) whatever S is, so several blocks share an SM
// and any S is taken. Keys past S are zeroed in the ring and take -inf;
// rows past T run on zero q and are not written. A causal tile stops both
// passes at the chunk holding its last row's diagonal.
//
// fp32: flash_fwd_single_kernel, on the CUDA cores (exact against the plain
// version; TF32 would not be). One block of 256 threads per (bh, t_block
// rows) keeps the rows' fp32 scores for the whole S in shared memory
// (t_block * S * 4 bytes) beside the q tile and one 64-key k/v chunk: at
// most 232,448 bytes, so t_block 16 takes S <= 3307 and t_block 8 S <= 6679;
// the wrapper refuses more and the C entry returns cudaErrorInvalidValue.
// Three phases: scores of each 64-key chunk into the row buffer; a warp per
// row for max, exp and sum; P . V over 64-key chunks of v.
//
// What bounds it. At the sweep's shape (bh 32, T = S = 2048, D = 64, bf16)
// the function needs 4 * bh * T * S * D = 34.4 GFLOP and moves 33.6 MB: on
// the tensor cores (989 TFLOP/s) 35 us, on the memory (3.35 TB/s) 10 us, so
// operations bound it. The bf16 kernel issues 51.5 GFLOP of warp-level
// tensor-core products (mma.sync, not wgmma: below the card's full rate)
// and 2 exp a score on the special-function units; the fp32 kernel's
// CUDA-core bound is 0.51 ms.

#include <math.h>
#include <stddef.h>

#include "flash_common.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace flash;

constexpr int kHeadDim = 64;            // the one head dim built
constexpr int kChunk = 64;              // keys staged per chunk
constexpr int kMaxSmem = 232448;        // bytes a block can opt into (H100)

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kStages = 3;                              // ring slots
constexpr int kTileBytes = kChunk * hmma::kRowBytes;    // 64 rows of 64 bf16
constexpr int kSlotBytes = 2 * kTileBytes;              // a K and a V chunk
constexpr float kLog2e = 1.4426950408889634f;

template <int TB>
constexpr int tc_smem_bytes() { return TB * hmma::kRowBytes + kStages * kSlotBytes; }

template <int TB>
__global__ void __launch_bounds__(TB * 2, 512 / (TB * 2))
flash_fwd_single_kernel_tc(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ bias,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int t_len, int s_len,
                           float scale, int causal) {
  constexpr int NT = TB * 2;  // a warp per 16 rows
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = hmma::smem_u32(smem);
  const hmma::CpAsyncRing<kStages, kSlotBytes> ring{qs + TB * hmma::kRowBytes};

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.y * TB;
  const size_t bh = blockIdx.x;
  const __nv_bfloat16* kb = k + bh * s_len * kHeadDim;
  const __nv_bfloat16* vb = v + bh * s_len * kHeadDim;
  const float* biasb = bias + bh * s_len;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};  // this thread's rows

  // causal: keys past the tile's last row are NEG_INF for all its rows
  const int s_end = causal ? min(s_len, q0 + TB) : s_len;
  const int n_chunks = (s_end + kChunk - 1) / kChunk;
  const int steps = 2 * n_chunks;  // pass 1 reads K chunks, pass 2 K and V

  auto fill = [&](int step) {
    if (step < steps) {
      const int s0 = (step < n_chunks ? step : step - n_chunks) * kChunk;
      const uint32_t slot = ring.slot(step);
      hmma::load_tile<kChunk, NT>(slot, kb + (size_t)s0 * kHeadDim, s_len - s0, tid);
      if (step >= n_chunks)
        hmma::load_tile<kChunk, NT>(slot + kTileBytes, vb + (size_t)s0 * kHeadDim, s_len - s0, tid);
    }
    hmma::cp_async_commit();  // an empty group past the end keeps the count
  };
  hmma::load_tile<TB, NT>(qs, q + (bh * t_len + q0) * kHeadDim, t_len - q0, tid);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fill(i);  // Q lands with fill 0

  uint32_t qf[4][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2];
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    ring.wait();
    __syncthreads();  // every copy of this step's fill is visible; last step's slot is free
    fill(step + kStages - 1);
    if (step == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hmma::ldmatrix_x4(qf[kk], hmma::a_frag_addr(qs, warp * 16, kk, lane));
    }
    const bool pass1 = step < n_chunks;
    if (step == n_chunks) {  // pass 1 done: the quad's partial sums, 1 / l, lse
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        inv[h] = 1.f / fmaxf(l[h], 1e-30f);
        if (t4 == 0 && rows[h] < t_len) lse[bh * t_len + rows[h]] = m[h] + logf(fmaxf(l[h], 1e-30f));
      }
    }
    const int s0 = (pass1 ? step : step - n_chunks) * kChunk;
    const uint32_t kt = ring.slot(step);

    float sc[8][4];
    hmma::product_nt<kHeadDim>(sc, qf, kt, lane);  // sc[n]: keys 8 n..8 n+7
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = s0 + 8 * n + 2 * t4 + c;
        const bool in = j < s_len;
        const float bj = in ? __ldg(biasb + j) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x = fmaf(sc[n][2 * h + c], scale, bj);
          if (causal && j > rows[h]) x = kNegInf;
          sc[n][2 * h + c] = in ? x : -INFINITY;
        }
      }

    if (pass1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float cm = m[h];
#pragma unroll
        for (int n = 0; n < 8; ++n) cm = fmaxf(cm, fmaxf(sc[n][2 * h], sc[n][2 * h + 1]));
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          sum += hmma::ex2((sc[n][2 * h] - cm) * kLog2e) + hmma::ex2((sc[n][2 * h + 1] - cm) * kLog2e);
        l[h] = l[h] * hmma::ex2((m[h] - cm) * kLog2e) + sum;
        m[h] = cm;
      }
    } else {
      // P of keys 16kk..16kk+15 is the A fragment of k-step kk
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pf[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = 2 * kk + (i >> 1), h = i & 1;
          pf[i] = hmma::pack_bf16(hmma::ex2((sc[n][2 * h] - m[h]) * kLog2e) * inv[h],
                                  hmma::ex2((sc[n][2 * h + 1] - m[h]) * kLog2e) * inv[h]);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          hmma::ldmatrix_x4_trans(b, hmma::bt_frag_addr(kt + kTileBytes, kk, np, lane));
          hmma::mma_16816(o[2 * np], pf, b[0], b[1]);
          hmma::mma_16816(o[2 * np + 1], pf, b[2], b[3]);
        }
      }
    }
  }
  hmma::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= t_len) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + (bh * t_len + rows[h]) * kHeadDim) + t4;
#pragma unroll
    for (int n = 0; n < 8; ++n) dst[4 * n] = hmma::pack_bf16(o[n][2 * h], o[n][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ float round_to(float x, const float*) { return x; }

template <int D>
__host__ __device__ constexpr size_t smem_bytes(int t_block, int s_len) {
  return sizeof(float) * ((size_t)t_block * s_len   // the rows' scores / P
                          + (size_t)t_block * (D + 1)  // q tile
                          + (size_t)kChunk * (D + 1)); // one k or v chunk
}

// Instantiated for T = float only; bf16 runs flash_fwd_single_kernel_tc.
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

  extern __shared__ float smem_f[];
  float* sc = smem_f;                         // TB x s_len
  float* qs = sc + (size_t)TB * s_len;        // TB x KS
  float* kv = qs + TB * KS;                   // kChunk x KS

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int q0 = blockIdx.y * TB;
  const size_t bh = blockIdx.x;
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

// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *bias;
  void *out, *lse;
  int bh, t_len, s_len;
  float scale;
  int causal;
};

template <int TB>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes<TB>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_single_kernel_tc<TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.t_len + TB - 1) / TB);
  flash_fwd_single_kernel_tc<TB><<<grid, TB * 2, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const float*>(a.bias),
      static_cast<__nv_bfloat16*>(a.out), static_cast<float*>(a.lse), a.t_len, a.s_len,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <int TB>
cudaError_t launch_fp32(const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes<kHeadDim>(TB, a.s_len);
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_single_kernel<float, kHeadDim, TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.t_len + TB - 1) / TB);
  flash_fwd_single_kernel<float, kHeadDim, TB><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.bias),
      static_cast<float*>(a.out), static_cast<float*>(a.lse), a.t_len, a.s_len,
      a.scale, a.causal);
  return cudaGetLastError();
}

}  // namespace

// q: (bh, t_len, head_dim), k/v: (bh, s_len, head_dim), contiguous, all of
// one type (is_bf16 ? bf16 : fp32), bf16 ones 16-byte aligned; bias:
// (bh, s_len) fp32; out like q; lse: (bh, t_len) fp32; head_dim 64. bf16
// takes t_block 64 or 128 at any s_len; fp32 t_block 8 or 16 with the
// block's shared memory within 232,448 bytes. Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for what it does not
// take).
extern "C" int flash_fwd_single(const void* q, const void* k, const void* v,
                                const void* bias, void* out, void* lse,
                                int bh, int t_len, int s_len, int head_dim,
                                int t_block, float scale, int causal,
                                int is_bf16, void* stream) {
  // bh on gridDim.x (any size), the q tiles on gridDim.y (at most 65,535)
  if (bh <= 0 || t_len <= 0 || s_len <= 0 || head_dim != kHeadDim ||
      t_block <= 0 || (t_len + t_block - 1) / t_block > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, bias, out, lse, bh, t_len, s_len, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16) {
    if (t_block == 64) err = launch_tc<64>(a, s);
    if (t_block == 128) err = launch_tc<128>(a, s);
  } else {
    if (t_block == 8) err = launch_fp32<8>(a, s);
    if (t_block == 16) err = launch_fp32<16>(a, s);
  }
  return (int)err;
}

extern "C" const char* flash_fwd_single_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
