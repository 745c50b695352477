// Dynamic convolution forward and backward for Hopper (sm_90a), plain CUDA C++.
//
// The first port of fbk_fairseq_st_tpu/ops/pallas/conv_kernels.py::_dynamic_conv_kernel
// (launched by _dynamic_conv_fwd_impl through pl.pallas_call), and writes the
// backward that the JAX package leaves to XLA (jax.vjp of _xla_reference):
//
//   out[b,t,c]  = sum_k w[b,t,h(c),k] * x[b, t+k-pad_l, c]
//   dx[b,s,c]   = sum_k w[b,s-k+pad_l,h(c),k] * g[b, s-k+pad_l, c]
//   dw[b,t,h,k] = sum_{c of head h} g[b,t,c] * x[b, t+k-pad_l, c]
//
// with x (B, T, C), w (B, T, H, K), h(c) = c / (C/H), and zeros outside
// [0, T). Sums are fp32; results are written in the inputs' type (fp32 or
// bf16). pad_l is a runtime argument (centred K/2 in the encoder, causal K-1
// in the decoder). Ragged T and any C with C % H == 0 are masked here: there
// is no C % 128 or T-block gate and no fallback, since that gate was the
// TPU's (8, 128) tiling.
//
// Design. The forward and dx are the same band product, dx with the band
// transposed. One block of 128 threads takes 16 positions (fewer when shared
// memory is short) and a slab of 128 channels, one channel a thread. It
// stages the slab's x (or g) rows of its positions plus the K-1 halo rows in
// shared memory as fp32, loaded along C so a warp reads consecutive
// addresses, and beside them the w of the heads the slab touches: for the
// forward the tile's rows (t_tile x heads x K; K = 31 makes a row 31
// elements long, so w is staged element by element and never read as
// vectors), for dx only the diagonal band of the t_tile + K - 1 rows it
// reads, t_tile taps a row (else a slab of many narrow heads would need
// (t_tile + K - 1) x heads x K floats). Each thread then sums its
// outputs over the K taps in an fp32 register; the threads of one head read
// the same w element (a broadcast) and neighbouring x elements. dw is a
// reduction over a head's C/H channels (64 in the big preset, 128 in
// iwslt): a dw block takes 16 positions of one head, walks the head's
// channels in chunks of 64 staged in shared memory (rows padded to 65
// floats, so the taps of a warp fall on distinct banks) and keeps up to 4 of
// the 16 x K outputs a thread in registers. The backward is ONE launch: its
// grid holds the dx blocks first and the dw blocks after them, so the two
// halves share the card instead of running one after the other. The batch
// is the grid's x dimension (any size), a batch row's blocks its y (at most
// 65,535).
//
// What bounds it. At the training shape of dynamicconv_wmt_en_de_big (B 64,
// T 56, C 1024, H 16, K 31, bf16) the forward moves x, w and out, 18.2 MB:
// 5.4 us at 3.35 TB/s, while its 0.23 GFLOP of fp32 FMAs take 3.4 us at
// 67 TFLOP/s; the backward moves x, w, g, dx and dw, 29 MB (8.7 us) for
// 0.46 GFLOP. Both are bound by bytes, and the design keeps every input
// element's global read to once a block (the halo rows are read again by the
// neighbouring tile, K-1 of 16+K-1 rows). This first version is simple and
// correct: no vector loads, no cp.async or TMA pipeline, and shared memory
// sized for the worst slab; it issues two shared-memory loads a multiply-add,
// which bound it at 9-13x its byte bound on an H100. The tensor cores do have
// work here: per head the convolution is a product with a banded left
// factor, which csrc/dynamic_conv_tc.cu runs as mma.sync tiles. Every model
// path takes that kernel; this one is reached only by a direct call
// (dynamic_conv.py, route="cuda_core"), to compare the two.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kSlab = kThreads;  // channels a band block, one a thread
constexpr int kMaxTile = 16;     // positions a block
constexpr int kChunk = 64;       // channels a dw step
constexpr int kLd = kChunk + 1;  // padded row of a dw step
constexpr int kMaxOut = 4;       // dw outputs a thread
constexpr size_t kSmemBudget = 96 * 1024;  // two or more blocks an SM

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Shape {
  int b, t, c, h, k, pad_l;
  int r;  // channels a head, c / h
};

// One band block: positions [t0, t0 + tt) of batch row b, channels
// [c0, c0 + kSlab). kTransposed false is the forward,
//   out[t] = sum_k w[t, k] * x[t + k - pad_l];
// true is dx, with x := g,
//   out[s] = sum_k w[s - k + pad_l, k] * g[s - k + pad_l].
template <typename T, bool kTransposed>
__device__ void band_block(const T* __restrict__ x, const T* __restrict__ w,
                           T* __restrict__ out, const Shape& s, int b, int t0,
                           int c0, int tt, float* smem) {
  const int K = s.k;
  const int xrows = tt + K - 1;
  const int xbase = kTransposed ? t0 - (K - 1) + s.pad_l : t0 - s.pad_l;
  const int c_end = min(c0 + kSlab, s.c);
  const int h_lo = c0 / s.r;
  const int heads = (c_end - 1) / s.r - h_lo + 1;
  // the forward stages w rows t0.. as ws[t][head][k]; dx needs, of the
  // xrows rows it reads, only the band k = s + K - 1 - r of row r for its
  // outputs s, staged as ws[r][head][s] (tt taps a row instead of K)
  const int wrows = kTransposed ? xrows : tt;
  const int wcols = kTransposed ? tt : K;
  const int wrow = heads * wcols;
  float* xs = smem;                // xrows x kSlab
  float* ws = xs + xrows * kSlab;  // wrows x heads x wcols
  const int tid = threadIdx.x;
  const int c = c0 + tid;

  const T* xb = x + (size_t)b * s.t * s.c;
  for (int r = 0; r < xrows; ++r) {
    const int tg = xbase + r;
    xs[r * kSlab + tid] = (c < s.c && tg >= 0 && tg < s.t)
                              ? to_f32(xb[(size_t)tg * s.c + c])
                              : 0.f;
  }
  const size_t hk = (size_t)s.h * K;
  const T* wb = w + (size_t)b * s.t * hk + (size_t)h_lo * K;
  for (int i = tid; i < wrows * wrow; i += kThreads) {
    const int r = i / wrow;
    const int hh = (i - r * wrow) / wcols;
    const int j = i - r * wrow - hh * wcols;
    const int tg = (kTransposed ? xbase : t0) + r;
    const int k = kTransposed ? j + K - 1 - r : j;
    ws[i] = (tg >= 0 && tg < s.t && k >= 0 && k < K)
                ? to_f32(wb[(size_t)tg * hk + hh * K + k])
                : 0.f;
  }
  __syncthreads();
  if (c >= s.c) return;

  const float* wh = ws + (c / s.r - h_lo) * wcols;
  const float* xc = xs + tid;
  T* oc = out + (size_t)b * s.t * s.c + c;
  const int t_end = min(tt, s.t - t0);
  for (int t = 0; t < t_end; ++t) {
    float acc = 0.f;
    if (kTransposed) {
      for (int k = 0; k < K; ++k) {
        const int r = t - k + K - 1;
        acc = fmaf(wh[r * wrow + t], xc[r * kSlab], acc);
      }
    } else {
      const float* wt = wh + t * wrow;
      for (int k = 0; k < K; ++k) acc = fmaf(wt[k], xc[(t + k) * kSlab], acc);
    }
    store(oc + (size_t)(t0 + t) * s.c, acc);
  }
}

// One dw block: positions [t0, t0 + tt) of batch row b, head h. Output o =
// t * K + k of the tt x K tile belongs to thread o % kThreads, which sums
// g[t, c] * x[t + k - pad_l, c] over the head's channels, kChunk at a time.
template <typename T>
__device__ void dw_block(const T* __restrict__ x, const T* __restrict__ g,
                         T* __restrict__ dw, const Shape& s, int b, int t0,
                         int h, int tt, float* smem) {
  const int K = s.k;
  const int xrows = tt + K - 1;
  const int xbase = t0 - s.pad_l;
  const int n_out = tt * K;
  float* gs = smem;           // tt x kLd
  float* xs = gs + tt * kLd;  // xrows x kLd
  const int tid = threadIdx.x;
  const T* xb = x + (size_t)b * s.t * s.c;
  const T* gb = g + (size_t)b * s.t * s.c;

  float acc[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.f;

  for (int cc = 0; cc < s.r; cc += kChunk) {
    const int width = min(kChunk, s.r - cc);
    const int cbase = h * s.r + cc;
    __syncthreads();  // the previous chunk has been read
    for (int i = tid; i < xrows * kChunk; i += kThreads) {
      const int r = i / kChunk, j = i - r * kChunk;
      const int tg = xbase + r;
      xs[r * kLd + j] = (j < width && tg >= 0 && tg < s.t)
                            ? to_f32(xb[(size_t)tg * s.c + cbase + j])
                            : 0.f;
    }
    for (int i = tid; i < tt * kChunk; i += kThreads) {
      const int r = i / kChunk, j = i - r * kChunk;
      const int tg = t0 + r;
      gs[r * kLd + j] = (j < width && tg < s.t)
                            ? to_f32(gb[(size_t)tg * s.c + cbase + j])
                            : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int o = tid + i * kThreads;
      if (o < n_out) {
        const int t = o / K, k = o - t * K;
        const float* gr = gs + t * kLd;
        const float* xr = xs + (t + k) * kLd;
        float a = acc[i];
#pragma unroll 8
        for (int j = 0; j < kChunk; ++j) a = fmaf(gr[j], xr[j], a);
        acc[i] = a;
      }
    }
  }

  T* db = dw + (size_t)b * s.t * s.h * K;
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int o = tid + i * kThreads;
    if (o < n_out) {
      const int t = o / K, k = o - t * K;
      if (t0 + t < s.t) store(db + ((size_t)(t0 + t) * s.h + h) * K + k, acc[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dynamic_conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        T* __restrict__ out, Shape s, int tt, int n_t) {
  extern __shared__ float smem[];
  band_block<T, false>(x, w, out, s, blockIdx.x, (blockIdx.y % n_t) * tt,
                       (blockIdx.y / n_t) * kSlab, tt, smem);
}

// Blocks [0, n_dx_t * n_slabs) compute dx, the rest dw.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dynamic_conv_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const T* __restrict__ g, T* __restrict__ dx,
                        T* __restrict__ dw, Shape s, int tt_dx, int n_dx_t,
                        int n_slabs, int tt_dw, int n_dw_t) {
  extern __shared__ float smem[];
  const int n_dx = n_dx_t * n_slabs;
  const int i = blockIdx.y;
  if (i < n_dx) {
    band_block<T, true>(g, w, dx, s, blockIdx.x, (i % n_dx_t) * tt_dx,
                        (i / n_dx_t) * kSlab, tt_dx, smem);
  } else {
    const int j = i - n_dx;
    dw_block<T>(x, g, dw, s, blockIdx.x, (j % n_dw_t) * tt_dw, j / n_dw_t,
                tt_dw, smem);
  }
}

// Shared memory of a band block at tile tt, sized for the most heads a slab
// can touch (a slab that starts inside a head and ends inside another).
size_t band_bytes(const Shape& s, int tt, bool transposed) {
  const int heads = min(s.h, (kSlab - 1) / s.r + 2);
  const int xrows = tt + s.k - 1;
  const size_t w_floats = transposed ? (size_t)xrows * heads * tt
                                     : (size_t)tt * heads * s.k;
  return sizeof(float) * ((size_t)xrows * kSlab + w_floats);
}

size_t dw_bytes(const Shape& s, int tt) {
  return sizeof(float) * (size_t)(2 * tt + s.k - 1) * kLd;
}

// The largest power-of-two tile <= kMaxTile (and not past T) whose shared
// memory fits the budget; 1 if none does (the launch then asks for more,
// up to what the card allows, or fails).
int band_tile(const Shape& s, bool transposed) {
  int tt = kMaxTile;
  while (tt > 1 && (tt / 2 >= s.t || band_bytes(s, tt, transposed) > kSmemBudget))
    tt /= 2;
  return tt;
}

int dw_tile(const Shape& s) {
  int tt = kMaxTile;
  while (tt > 1 && (tt / 2 >= s.t || tt * s.k > kMaxOut * kThreads)) tt /= 2;
  return tt;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  // above 48 KB a kernel must opt in (per device, so set on every launch)
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, void* out, const Shape& s,
                       cudaStream_t stream) {
  const int tt = band_tile(s, false);
  const int n_t = (s.t + tt - 1) / tt;
  const int n_slabs = (s.c + kSlab - 1) / kSlab;
  const size_t bytes = band_bytes(s, tt, false);
  cudaError_t err = set_smem(dynamic_conv_fwd_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  if (n_t * n_slabs > 65535) return cudaErrorInvalidValue;
  dynamic_conv_fwd_kernel<T><<<dim3(s.b, n_t * n_slabs), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), s,
      tt, n_t);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* g, void* dx,
                       void* dw, const Shape& s, cudaStream_t stream) {
  if (s.k > kMaxOut * kThreads) return cudaErrorInvalidValue;
  const int tt_dx = band_tile(s, true);
  const int tt_dw = dw_tile(s);
  const int n_dx_t = (s.t + tt_dx - 1) / tt_dx;
  const int n_dw_t = (s.t + tt_dw - 1) / tt_dw;
  const int n_slabs = (s.c + kSlab - 1) / kSlab;
  const size_t bytes = band_bytes(s, tt_dx, true) > dw_bytes(s, tt_dw)
                           ? band_bytes(s, tt_dx, true)
                           : dw_bytes(s, tt_dw);
  cudaError_t err = set_smem(dynamic_conv_bwd_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const int n_blocks = n_dx_t * n_slabs + n_dw_t * s.h;
  if (n_blocks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(s.b, n_blocks);
  dynamic_conv_bwd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(g),
      static_cast<T*>(dx), static_cast<T*>(dw), s, tt_dx, n_dx_t, n_slabs, tt_dw,
      n_dw_t);
  return cudaGetLastError();
}

bool make_shape(int b, int t, int c, int h, int k, int pad_l, Shape* s) {
  if (b <= 0 || t <= 0 || c <= 0 || h <= 0 || k <= 0 || pad_l < 0 ||
      c % h != 0)
    return false;
  *s = Shape{b, t, c, h, k, pad_l, c / h};
  return true;
}

}  // namespace

// x: (b, t, c), w: (b, t, h, k), out like x; contiguous, all of one type
// (is_bf16 ? bf16 : fp32). Launches on `stream`; returns cudaGetLastError().
extern "C" int dynamic_conv_fwd(const void* x, const void* w, void* out, int b,
                                int t, int c, int h, int k, int pad_l,
                                int is_bf16, void* stream) {
  Shape s;
  if (!make_shape(b, t, c, h, k, pad_l, &s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_fwd<__nv_bfloat16>(x, w, out, s, st)
                       : launch_fwd<float>(x, w, out, s, st));
}

// g: the gradient of out, like x; dx like x, dw like w. One launch.
extern "C" int dynamic_conv_bwd(const void* x, const void* w, const void* g,
                                void* dx, void* dw, int b, int t, int c, int h,
                                int k, int pad_l, int is_bf16, void* stream) {
  Shape s;
  if (!make_shape(b, t, c, h, k, pad_l, &s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_bwd<__nv_bfloat16>(x, w, g, dx, dw, s, st)
                       : launch_bwd<float>(x, w, g, dx, dw, s, st));
}

extern "C" const char* dynamic_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
