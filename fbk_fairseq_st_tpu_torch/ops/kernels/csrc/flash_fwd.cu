// Flash-attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces fbk_fairseq_st_tpu/ops/pallas/attention_kernel.py::_fwd_kernel
// (launched by _fwd_impl through pl.pallas_call) for dropout rate 0:
//
//   out[b, t] = softmax_s(scale * q[b, t] . k[b, s] + bias[b, s]) . v[b, s]
//   lse[b, t] = m + log(l)       (fp32 per-row log-sum-exp)
//
// with the causal future mask (cols <= rows, both from 0, top-left aligned
// also when T != S) replacing masked scores by NEG_INF = -1e9, the running
// max starting at NEG_INF (never -inf), out = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)), exactly as the Pallas kernel. Keys past S
// get weight exactly 0, so a row whose real keys are all masked averages
// over the S keys it was given, as the dense path does.
//
// Design. One thread block of 256 threads per (bh, 64-row q tile). The q
// tile sits in shared memory as fp32; a loop walks 64-key kv tiles staged
// through shared memory (tiles wholly above the diagonal are skipped when
// causal). Each thread owns 4 rows and 4 score columns of the 64x64 tile,
// then 4 rows and D/16 output columns; the running m and l of its rows live
// in registers, replicated over the 16 threads of a row and reduced with
// warp shuffles. Scores, softmax and the accumulator are fp32 whatever the
// input type (fp32 or bf16); the products run on the CUDA cores as FMAs.
// Ragged T and S are masked in the kernel, so the caller never pads the
// sequence axes; the head dim D is a template over {16, 32, 64, 128} and
// the wrapper zero-pads q/k/v up to it.
//
// What bounds it. At the main-path shapes (encoder self-attention of the
// base conv_transformer: bh = 128, T = S = 128, D = 64) the function needs
// 4*bh*T*S*D = 537 MFLOP and moves q, k, v, out = 16.8 MB in fp32: about
// 8 us at the H100 SXM's 67 TFLOP/s of fp32 (no tensor cores), about 5 us
// at 3.35 TB/s, so it is bound by operations; in bf16 the 8.4 MB take
// about 2.5 us and the 0.54 us of tensor-core work is below it, so bytes
// bound it. This first design is simple and correct, not fast: it uses no
// tensor cores (mma.sync / wgmma), no TMA and no pipelining, and it re-reads
// the score tile through shared memory. Making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

constexpr int kBlockM = 64;    // q rows per block
constexpr int kBlockN = 64;    // keys per kv tile
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
                 int s_len, float scale, int causal) {
  constexpr int QS = D + 1;         // q/k row strides: padding keeps the
  constexpr int KS = D + 1;         // 16 rows a warp reads on 16 banks
  constexpr int PS = kBlockN + 1;
  constexpr int RPT = kBlockM / 16; // rows per thread
  constexpr int CPT = kBlockN / 16; // score columns per thread
  constexpr int DPT = D / 16;       // output columns per thread

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockM * QS;
  float* vs = ks + kBlockN * KS;
  float* ps = vs + kBlockN * D;
  float* bs = ps + kBlockM * PS;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBlockM;
  const size_t bh = blockIdx.y;

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
        ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = mx;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

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
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = out + (bh * t_len + row) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) store_from_f32(orow + tx + 16 * j, acc[i][j] / den);
    if (tx == 0) lse[bh * t_len + row] = m[i] + logf(den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, void* lse, int bh, int t_len,
                   int s_len, float scale, int causal, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  // above 48 KB of dynamic shared memory a kernel must opt in (per device,
  // so it is set on every launch rather than cached)
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kBlockM - 1) / kBlockM, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(out), static_cast<float*>(lse), t_len, s_len, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* bias, void* out, void* lse, int bh,
                       int t_len, int s_len, int head_dim, float scale,
                       int causal, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, bias, out, lse, bh, t_len, s_len, scale, causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, bias, out, lse, bh, t_len, s_len, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, bias, out, lse, bh, t_len, s_len, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, bias, out, lse, bh, t_len, s_len, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (bh, t_len, head_dim), k/v: (bh, s_len, head_dim), contiguous, all of
// one type (is_bf16 ? bf16 : fp32); bias: (bh, s_len) fp32; out like q;
// lse: (bh, t_len) fp32. Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* bias, void* out, void* lse, int bh,
                         int t_len, int s_len, int head_dim, float scale,
                         int causal, int is_bf16, void* stream) {
  if (bh <= 0 || bh > 65535 || t_len <= 0 || s_len <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, bias, out, lse, bh, t_len,
                                          s_len, head_dim, scale, causal, s)
              : dispatch_d<float>(q, k, v, bias, out, lse, bh, t_len, s_len,
                                  head_dim, scale, causal, s);
  return (int)err;
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
