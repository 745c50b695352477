// Online flash-attention forward for fp32 on Hopper's tensor cores (sm_90a),
// plain CUDA C++: 3xTF32 products at head dim 32, 64 or 128.
//
// Replaces fbk_fairseq_st_tpu/ops/pallas/attention_kernel.py::_fwd_kernel
// (launched by _fwd_impl through pl.pallas_call), dropout included, for fp32
// calls at kernel head dims 32, 64 and 128: serving (fp32, as JAX serves),
// every fp32 train step, and at 128 the iwslt lightconv presets' decoder
// cross-attention (4 heads over 512 dims) in their fp32 steps. JAX's _dot
// asks for Precision.HIGHEST on fp32 operands, which the TPU's MXU ran as
// several bf16 passes; the counterpart here is three tf32 products a product
// (hopper_mma.cuh, 3xTF32), whose error of about 2^-21 of |a||b| keeps the
// kernel within 1e-4 of the fp32 plain version where one tf32 product
// (2^-11) is not. flash_fwd.cu keeps fp32 and bf16 at head dim 16;
// flash_fwd_tc.cu bf16 at 32, 64 and 128. The function is flash_fwd_tc.cu's
// (its note), with no rounding of p (the identity in fp32) and out in fp32:
//
//   s    = scale * q.k + bias[key]   (NEG_INF = -1e9 above the diagonal when
//                                     causal, top-left aligned; -inf for
//                                     keys past S: weight exactly 0)
//   m    = the running row max, from NEG_INF (never -inf)
//   l    = l * exp(m_old - m) + sum exp(s - m)          (fp32, undropped p)
//   acc  = acc * exp(m_old - m) + (exp(s - m) * keep) . V          (fp32)
//   out  = acc / max(l * (1 - rate), 1e-30)
//   lse  = m + log(max(l, 1e-30))                       (fp32, natural log)
//
// Design: flash_fwd_tc.cu's plan on fp32 tiles. One block of 4 warps per
// (bh, 64-row q tile): bh on gridDim.x (no 65,535 cap), the q tiles on
// gridDim.y; a warp owns 16 rows. The Q tile arrives by cp.async into an
// XOR-swizzled tile of 512-byte (D 128), 256-byte (D 64) or 128-byte (D 32)
// rows and stays there: its A fragments are read by ldmatrix and split into
// tf32 pieces where used, 4 values a k-step, so that Q holds no registers
// beside O and the chunk's scores (as pre-split fragments it would hold 64
// at D 64, 128 at D 128). K and V come in chunks of keys through a cp.async
// ring, the plan of each head dim (Plan<D>). Per chunk:
//   * S = Q K^T on mma.sync.m16n8k8.tf32, three products each: K's B
//     fragments by ldmatrix (an 8 x 4 fp32 tile reads as an 8 x 8 b16 one),
//     split into big and small pieces in each warp (split_tf32: the
//     roundings of cvt.rna.tf32.f32 by integer adds);
//   * the online softmax of flash_fwd_tc.cu, its own function
//     (hopper_mma.cuh::online_softmax_step; the m16n8k8 C fragment is the
//     m16n8k16 one): the row max over the chunk, alpha
//     applied once to O and l, p = ex2((s - m) log2 e) on the
//     special-function unit, l summed per lane and reduced once at the end;
//   * at rate > 0 the keep flags drawn by row_frame_keep_bits, the function
//     the bf16 forward and both dq kernels draw with: the same Philox draws
//     as the bf16 kernel, dropped p set to 0 after l has summed it;
//   * O += P V: P stays in the C fragments, a lane's keys 2t and 2t + 1
//     read as A's k t and t + 4, and V's B fragment loaded in that order
//     by ld.shared from the swizzled tile (conflict-free; no 32-bit
//     ldmatrix.trans exists): P never goes through shared memory.
// The plans (shared memory is the Q tile and the ring, whatever T and S
// are): at D 32 and 64 64-key chunks in 3 slots, 112 KB at D 64 (2 blocks
// an SM) and 56 KB at D 32. At D 128 the Q tile alone is 32 KB and a 64-key
// K + V chunk 64 KB, so the D 64 plan would take 224 KB, one block an SM,
// and the iwslt call's 256 blocks would run in two waves on 132 SMs. D 128
// takes 32-key chunks in 2 slots: 96 KB, two blocks an SM, that call in one
// wave; 64-key chunks in 2 slots (160 KB, one block an SM) were timed beside
// it on an H100 (PERF.md section 6). A lane holds O (64 fp32 at D 128) and
// the chunk's scores (16 at 32 keys).
//
// What bounds it. At the long-context encoder call (bh 32, T = S = 2048,
// D 64) the function needs 4 bh T S D = 34.4 GFLOP: 0.208 ms at the 165
// TFLOP/s of fp32-faithful products the tensor cores give (495 TF32 / 3),
// against 67 MB of traffic (0.020 ms at 3.35 TB/s), so operations bound it;
// at D 128 (d128_long) twice that, 0.416 ms. At the iwslt call (bh 256,
// T = S = 56, D 128, fp32) bytes bound it: 29.5 MB, 0.0088 ms, against
// 0.0025 ms of products. The kernel issues three m16n8k8 products for each
// of the function's (six times the bf16 kernel's mma.sync issue for the
// same work), and per element of K and V each warp spends two integer
// operations and a subtraction on the split (each of the 4 warps splits the
// whole chunk: the price of keeping no split planes in shared memory); at
// rate > 0 the Philox rounds of flash_fwd_tc.cu are added unchanged.

#include <math.h>
#include <stddef.h>

#include "flash_common.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace flash;

constexpr int kTile = 64;        // q rows a block
constexpr int kThreadsTc = 128;  // a warp per 16 rows
constexpr unsigned kFull = 0xffffffffu;

// Each head dim's chunk (keys a ring slot) and ring slots.
template <int D> struct Plan {
  static constexpr int kChunk = 64, kStages = 3;  // 112 KB at D 64: two blocks share an SM
};
template <> struct Plan<128> {
  static constexpr int kChunk = 32, kStages = 2;  // 96 KB: two blocks share an SM
};

struct Args {
  const float *q, *k, *v;
  const float* bias;
  float* out;
  float* lse;
  int t_len, s_len;
  float scale;
  int causal;
  uint32_t drop_thresh;  // 0: no dropout
  float keep_prob;       // 1 - rate
  uint64_t seed;
};

template <int D> __host__ __device__ constexpr int tile_bytes() { return kTile * 4 * D; }
template <int D> __host__ __device__ constexpr int chunk_bytes() { return Plan<D>::kChunk * 4 * D; }
template <int D> __host__ __device__ constexpr int smem_bytes() {
  return tile_bytes<D>() + Plan<D>::kStages * 2 * chunk_bytes<D>();  // Q, then the ring of K and V chunks
}

template <int D>
__global__ void __launch_bounds__(kThreadsTc, 2)
flash_fwd_tf32x3_kernel(Args a) {
  constexpr int RB = 4 * D;
  constexpr int TILE = tile_bytes<D>(), CH = chunk_bytes<D>();
  constexpr int kChunk = Plan<D>::kChunk, kStages = Plan<D>::kStages;
  constexpr int NT = kChunk / 8;  // 8-key tiles a chunk
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = hmma::smem_u32(smem);
  const hmma::CpAsyncRing<kStages, 2 * CH> ring{qs + TILE};

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int w0 = q0 + warp * 16;  // the warp's first row
  const int rows[2] = {w0 + g, w0 + g + 8};  // this thread's rows
  const float* kb = a.k + bh * a.s_len * D;
  const float* vb = a.v + bh * a.s_len * D;
  const float* biasb = a.bias + bh * a.s_len;

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
  hmma::load_tile<kTile, kThreadsTc, RB>(qs, a.q + (bh * a.t_len + q0) * D, a.t_len - q0, tid);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fill(i);  // Q lands with fill 0

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // m: the rows' running max; l: this lane's share of the rows' sums (its
  // 2 columns of every 8-key tile), rescaled with m
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    hmma::CpAsyncRing<kStages, 2 * CH>::wait();
    __syncthreads();  // this chunk is visible; the slot read last step is free
    fill(c + kStages - 1);
    const int s0 = c * kChunk;
    const uint32_t kt = ring.slot(c), vt = kt + CH;

    float sc[NT][4];  // rows x keys: tile n holds keys s0 + 8 n..
    hmma::product_nt_3x<D, NT>(sc, qs, warp * 16, kt, 0, lane);

    hmma::online_softmax_step(sc, m, l, acc, a, biasb, s0, rows, w0, (uint32_t)bh, lane);
    // O += P V over the chunk's NT k-steps of 8 keys
    hmma::product_t_3x<D, NT>(acc, sc, smem + (vt - qs), 0, lane);
  }
  hmma::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the quad's sums, on every lane
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= a.t_len) continue;
    const float inv = 1.f / fmaxf(l[h] * a.keep_prob, 1e-30f);
    float2* dst = reinterpret_cast<float2*>(a.out + (bh * a.t_len + rows[h]) * D) + t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) dst[4 * n] = make_float2(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
    if (t4 == 0) a.lse[bh * a.t_len + rows[h]] = m[h] + logf(fmaxf(l[h], 1e-30f));
  }
}

template <int D>
cudaError_t launch(const Args& a, int bh, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  // above 48 KB of dynamic shared memory a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tf32x3_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (a.t_len + kTile - 1) / kTile);
  flash_fwd_tf32x3_kernel<D><<<grid, kThreadsTc, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q: (bh, t_len, head_dim); k, v: (bh, s_len, head_dim); fp32, contiguous,
// 16-byte aligned; head_dim 32, 64 or 128; bias: (bh, s_len) fp32; out like q;
// lse: (bh, t_len) fp32. drop_thresh = 0 turns dropout off; keep_prob is
// 1 - rate. Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for what it does not take).
extern "C" int flash_fwd_tf32x3(const void* q, const void* k, const void* v, const void* bias,
                                void* out, void* lse, int bh, int t_len, int s_len, int head_dim,
                                float scale, int causal, uint32_t drop_thresh, float keep_prob,
                                uint64_t seed, void* stream) {
  // bh on gridDim.x (up to 2^31 - 1); the 64-row q tiles on gridDim.y
  if (bh <= 0 || t_len <= 0 || s_len <= 0 || (t_len + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
               static_cast<const float*>(bias), static_cast<float*>(out), static_cast<float*>(lse),
               t_len, s_len, scale, causal, drop_thresh, keep_prob, seed};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return (int)launch<32>(a, bh, s);
    case 64: return (int)launch<64>(a, bh, s);
    case 128: return (int)launch<128>(a, bh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_fwd_tf32x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
