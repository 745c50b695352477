// Flash-attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces fbk_fairseq_st_tpu/ops/pallas/attention_kernel.py::_fwd_kernel
// (launched by _fwd_impl through pl.pallas_call), dropout included, for fp32
// calls and bf16 at head dims 16 and 128; bf16 at 32 and 64 runs the
// tensor-core kernel of flash_fwd_tc.cu, which computes the same function:
//
//   p[b, t, s]  = exp(scale * q[b, t] . k[b, s] + bias[b, s] - m)
//   out[b, t]   = sum_s p * keep . v[b, s] / max(l * (1 - rate), 1e-30)
//   lse[b, t]   = m + log(max(l, 1e-30))      (fp32 per-row log-sum-exp)
//
// where m and l are the running max and sum of the UNDROPPED p, keep is the
// Philox keep flag of element (b, t, s) (flash_common.cuh; all 1 at rate 0),
// the causal future mask (cols <= rows, both from 0, top-left aligned also
// when T != S) replaces masked scores by NEG_INF = -1e9, and the running
// max starts at NEG_INF (never -inf), exactly as the Pallas kernel. Keys
// past S get weight exactly 0, so a row whose real keys are all masked
// averages over the S keys it was given, as the dense path does.
//
// Design. One thread block of 256 threads per (bh, 64-row q tile). The q
// tile sits in shared memory as fp32; a loop walks 64-key kv tiles staged
// through shared memory (tiles wholly above the diagonal are skipped when
// causal). Each thread owns 4 rows and 4 score columns of the 64x64 tile,
// then 4 rows and D/16 output columns; the running m and l of its rows live
// in registers, replicated over the 16 threads of a row and reduced with
// warp shuffles. The probabilities go through shared memory to the P.V
// product, rounded to the input type first as the Pallas kernel's
// p.astype(v.dtype) (the identity in fp32; l sums them unrounded); at
// rate > 0 a masking pass between the two walks that tile in
// groups of 4 keys, one Philox call per group, and zeroes the dropped
// entries after l has summed them. Scores, softmax and the accumulator are
// fp32 whatever the input type (fp32 or bf16); the products run on the CUDA
// cores as FMAs. Ragged T and S are masked in the kernel, so the caller
// never pads the sequence axes; the head dim D is a template over
// {16, 32, 64, 128} and the wrapper zero-pads q/k/v up to it.
//
// What bounds it. At the training shapes (encoder self-attention of the
// base conv_transformer at batch 128: bh = 512, T = S = 128, D = 64) the
// function needs 4*bh*T*S*D = 2.15 GFLOP and moves q, k, v, out = 67 MB in
// fp32: 32 us at the H100 SXM's 67 TFLOP/s of fp32 (no tensor cores),
// 20 us at 3.35 TB/s, so operations bound it; in bf16 the 34 MB take 10 us
// and the 2.2 us of tensor-core work is below it, so bytes bound it. The
// dropout pass adds one Philox call (10 rounds, ~60 integer instructions)
// per 4 scores, about a sixth of the tile's FMAs. This first design is
// simple and correct, not fast: it uses no tensor cores (mma.sync /
// wgmma), no TMA and no pipelining, and it re-reads the score tile through
// shared memory. Making it fast is later work.

#include <math.h>
#include <stddef.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

// p as the P.V product takes it: rounded to the input type T
__device__ __forceinline__ float as_input_type(float x, const float*) { return x; }
__device__ __forceinline__ float as_input_type(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockM * (D + 1)         // q tile (padded rows)
                          + kBlockN * (D + 1)       // k tile (padded rows)
                          + kBlockN * D             // v tile
                          + kBlockM * (kBlockN + 1) // probabilities
                          + kBlockN);               // bias tile
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, float* __restrict__ lse, int t_len,
                 int s_len, float scale, int causal, uint32_t drop_thresh,
                 float keep_prob, uint64_t seed) {
  constexpr int QS = D + 1;         // q/k row strides: padding keeps the
  constexpr int KS = D + 1;         // 16 rows a warp reads on 16 banks
  constexpr int PS = kBlockN + 1;
  constexpr int RPT = kBlockM / 16; // rows per thread
  constexpr int CPT = kBlockN / 16; // score columns per thread
  constexpr int DPT = D / 16;       // output columns per thread
  constexpr int GROUPS = kBlockN / 4;

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockM * QS;
  float* vs = ks + kBlockN * KS;
  float* ps = vs + kBlockN * D;
  float* bs = ps + kBlockM * PS;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.y * kBlockM;
  const size_t bh = blockIdx.x;

  const T* qb = q + bh * t_len * D;
  const T* kb = k + bh * s_len * D;
  const T* vb = v + bh * s_len * D;
  const float* biasb = bias + bh * s_len;

  for (int i = tid; i < kBlockM * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * QS + c] =
        (q0 + r < t_len) ? load_f32(qb + (size_t)(q0 + r) * D + c) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  // causal: kv tiles that start past this q tile's last row add nothing
  const int s_end = causal ? min(s_len, q0 + kBlockM) : s_len;
  for (int s0 = 0; s0 < s_end; s0 += kBlockN) {
    __syncthreads();  // the previous tile's reads are done
    for (int i = tid; i < kBlockN * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool ok = s0 + r < s_len;
      const size_t off = (size_t)(s0 + r) * D + c;
      ks[r * KS + c] = ok ? load_f32(kb + off) : 0.f;
      vs[r * D + c] = ok ? load_f32(vb + off) : 0.f;
    }
    for (int i = tid; i < kBlockN; i += kThreads)
      bs[i] = (s0 + i < s_len) ? biasb[s0 + i] : 0.f;
    __syncthreads();

    float sc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = 0.f;

#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = s0 + tx + 16 * j;
        float x = sc[i][j] * scale + bs[tx + 16 * j];
        if (causal && col > row) x = kNegInf;
        if (col >= s_len) x = -INFINITY;  // not a key: weight exactly 0
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 threads of a row are 16 neighbouring lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(sc[i][j] - mx);
        ps[(ty + 16 * i) * PS + tx + 16 * j] = as_input_type(p, q);
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;  // l sums the undropped p
      m[i] = mx;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    if (drop_thresh != 0u) {
      // zero the dropped probabilities, 4 keys per Philox call
      for (int it = tid; it < kBlockM * GROUPS; it += kThreads) {
        const int r = it / GROUPS, g = it % GROUPS;
        if (q0 + r >= t_len || s0 + 4 * g >= s_len) continue;
        const uint4 bits = dropout_bits(seed, (uint32_t)bh, q0 + r, s0 + 4 * g);
        float* p = ps + r * PS + 4 * g;
#pragma unroll
        for (int w = 0; w < 4; ++w)
          if (word(bits, w) < drop_thresh) p[w] = 0.f;
      }
      __syncthreads();
    }

#pragma unroll 8
    for (int c = 0; c < kBlockN; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t_len) continue;
    const float den = fmaxf(l[i] * keep_prob, 1e-30f);
    T* orow = out + (bh * t_len + row) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) store_from_f32(orow + tx + 16 * j, acc[i][j] / den);
    if (tx == 0) lse[bh * t_len + row] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v, *bias;
  void *out, *lse;
  int bh, t_len, s_len;
  float scale;
  int causal;
  uint32_t drop_thresh;
  float keep_prob;
  uint64_t seed;
};

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  // above 48 KB of dynamic shared memory a kernel must opt in (per device,
  // so it is set on every launch rather than cached)
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  // bh on x (up to 2^31 - 1), the q tiles on y (at most 65,535)
  const dim3 grid(a.bh, (a.t_len + kBlockM - 1) / kBlockM);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.bias),
      static_cast<T*>(a.out), static_cast<float*>(a.lse), a.t_len, a.s_len,
      a.scale, a.causal, a.drop_thresh, a.keep_prob, a.seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (bh, t_len, head_dim), k/v: (bh, s_len, head_dim), contiguous, all of
// one type (is_bf16 ? bf16 : fp32); bias: (bh, s_len) fp32; out like q;
// lse: (bh, t_len) fp32. drop_thresh = 0 turns dropout off; keep_prob is
// 1 - rate. Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* bias, void* out, void* lse, int bh,
                         int t_len, int s_len, int head_dim, float scale,
                         int causal, uint32_t drop_thresh, float keep_prob,
                         uint64_t seed, int is_bf16, void* stream) {
  if (bh <= 0 || t_len <= 0 || s_len <= 0 || (t_len + kBlockM - 1) / kBlockM > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, bias, out, lse, bh, t_len, s_len,
               scale, causal, drop_thresh, keep_prob, seed};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? dispatch_d<__nv_bfloat16>(a, head_dim, s)
                            : dispatch_d<float>(a, head_dim, s);
  return (int)err;
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
