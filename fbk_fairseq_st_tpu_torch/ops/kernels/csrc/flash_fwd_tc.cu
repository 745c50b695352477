// Online flash-attention forward on Hopper's tensor cores (sm_90a), plain
// CUDA C++: bf16 at head dim 32, 64 or 128.
//
// Replaces fbk_fairseq_st_tpu/ops/pallas/attention_kernel.py::_fwd_kernel
// (launched by _fwd_impl through pl.pallas_call), dropout included, for bf16
// calls at kernel head dims 32, 64 and 128: every model's heads, the time
// attention's F' = 20 padded to 32, and the iwslt lightconv presets' 4 heads
// over 512 dims. flash_fwd_tf32x3.cu takes fp32 at D 32 and 64, and
// flash_fwd.cu keeps bf16 at D 16 and fp32 at D 16 and 128. The
// function is flash_fwd.cu's (its note, :6-16), in one pass over S with an
// online softmax:
//
//   s    = scale * q.k + bias[key]   (NEG_INF = -1e9 above the diagonal when
//                                     causal, top-left aligned; -inf for
//                                     keys past S: weight exactly 0)
//   m    = the running row max, from NEG_INF (never -inf)
//   l    = l * exp(m_old - m) + sum exp(s - m)          (fp32, undropped p)
//   acc  = acc * exp(m_old - m) + bf16(exp(s - m) * keep) . V      (fp32)
//   out  = acc / max(l * (1 - rate), 1e-30)  -> bf16
//   lse  = m + log(max(l, 1e-30))                       (fp32, natural log)
//
// p is rounded to bf16 before P.V, as the Pallas kernel's p.astype(v.dtype)
// (the plain version rounds it at the same point). A row whose real keys are
// all masked averages over the S keys it was given.
//
// Design. One block of 4 warps per (bh, 64-row q tile): bh on gridDim.x (up
// to 2^31 - 1, so no 65,535 cap), the q tiles on gridDim.y; a warp owns 16
// rows. The Q tile arrives by cp.async into an XOR-swizzled tile of 128-byte
// (D 64) or 64-byte (D 32) rows and is read once into A fragments kept in
// registers. K and V come in 64-key chunks through a 3-slot cp.async ring
// (hopper_mma.cuh), two chunks ahead of the products; keys past S are
// zero-filled. Per chunk:
//   * S = Q K^T by mma.sync.m16n8k16 (K's B fragments by ldmatrix), scale,
//     bias and the causal triangle applied in the C fragments;
//   * the row max over the chunk (the 4 lanes of a row: 2 __shfl_xor_sync),
//     alpha = exp(m_old - m) applied once to the D / 8 O fragments and to
//     l, p = ex2((s - m) * log2 e) on the special-function unit (m stays in
//     natural units, so a -1e9 row keeps its exact lse); l sums p in each
//     lane's columns and the quad's sum is taken once at the end;
//   * at rate > 0 the keep flags of flash_common.cuh's mapping, drawn by
//     row_frame_keep_bits (one Philox4x32-10 call a lane per m16n8 tile,
//     handed out by __shfl_sync), the code dq (flash_bwd_tc.cu) re-draws
//     them with; dropped p goes to 0 after l has summed it (these steps
//     are hopper_mma.cuh::online_softmax_step, which flash_fwd_tf32x3.cu
//     shares);
//   * P rounded to bf16 straight into the A fragments of O += P V (V's B
//     fragments by ldmatrix.trans): P never goes through shared memory.
// A causal tile stops at the chunk holding its last row's diagonal; rows
// past T run on zero q and are not written. Shared memory is the Q tile and
// the ring, 56 KB at D 64 and 28 KB at D 32, whatever T and S are.
//
// Head dim 128, the same template with two compile-time changes. Q's A
// fragments would hold 32 registers a lane beside O's 64 and the chunk's 32
// scores, so Q stays in its swizzled tile of 256-byte rows and its fragments
// are read by ldmatrix at each k-step (hopper_mma.cuh::product_nt_smem,
// flash_bwd_tc128.cu's helper). The Q tile is 16 KB and a K + V chunk 32
// KB: the ring of 3 slots, as at D 32/64, takes 112 KB with the Q tile and
// still lets two blocks share an SM, so the iwslt call's 256 blocks (bh
// 256, T 56: one q tile each) run in one wave on 132 SMs. A ring of 2
// slots (80 KB) read within 3 % of it on an H100: slower at the iwslt
// call, which has one chunk a block, and faster at bh 32, T = S = 2048
// (PERF.md section 6 gives both times).
// ptxas gives 142 registers and no spill. The softmax step and the keep
// bits are D 64's (online_softmax_step, row_frame_keep_bits work on the
// m16n8 tile, which does not depend on D), so flash_bwd_dq_tc128 draws
// these bits again.
//
// What bounds it. At the long-context encoder call (bh 32, T = S = 2048,
// D 64) the function needs 4 bh T S D = 34.4 GFLOP (35 us at 989 TFLOP/s)
// and moves 33.6 MB (10 us at 3.35 TB/s): operations bound it. At the base
// step's encoder call (bh 512, T = S = 128) the 2.15 GFLOP take 2.2 us and
// the 33.6 MB 10 us: bytes bound it. The kernel issues exactly the
// function's products, as warp-level mma.sync (not wgmma: below the card's
// full rate; the single pass on the same helpers issued 170 TFLOP/s), plus
// one ex2 a score, and at rate > 0 a Philox call (about 60 integer
// operations) a 4-key group, which cost about as much issue time as the
// products (as in flash_bwd_tc.cu's dq kernel). At D 32 the time attention's
// F' = 20 wastes 37 % of the products on zero columns. At D 128 the iwslt
// call (bh 256, T = S = 56) moves 14.7 MB (4.4 us) for 0.41 GFLOP (0.4 us):
// bytes bound it, and with one chunk a block the load latency is exposed;
// at bh 32, T = S = 2048 its 68.7 GFLOP (69 us) bound it.

#include <math.h>
#include <stddef.h>

#include "flash_common.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace flash;

constexpr int kTile = 64;        // q rows a block, keys a chunk
constexpr int kThreadsTc = 128;  // a warp per 16 rows
constexpr int kStages = 3;       // ring slots
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const __nv_bfloat16 *q, *k, *v;
  const float* bias;
  __nv_bfloat16* out;
  float* lse;
  int t_len, s_len;
  float scale;
  int causal;
  uint32_t drop_thresh;  // 0: no dropout
  float keep_prob;       // 1 - rate
  uint64_t seed;
};

template <int D> __host__ __device__ constexpr int tile_bytes() { return kTile * 2 * D; }
template <int D> __host__ __device__ constexpr int smem_bytes() {
  return tile_bytes<D>() + kStages * 2 * tile_bytes<D>();  // Q, then the ring of K and V chunks
}

template <int D>
__global__ void __launch_bounds__(kThreadsTc)
flash_fwd_tc_kernel(Args a) {
  constexpr int RB = 2 * D;
  constexpr int TILE = tile_bytes<D>();
  constexpr bool kQInSmem = D == 128;  // Q's A fragments read at each k-step, not held
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = hmma::smem_u32(smem);
  const hmma::CpAsyncRing<kStages, 2 * TILE> ring{qs + TILE};

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int w0 = q0 + warp * 16;  // the warp's first row
  const int rows[2] = {w0 + g, w0 + g + 8};  // this thread's rows
  const __nv_bfloat16* kb = a.k + bh * a.s_len * D;
  const __nv_bfloat16* vb = a.v + bh * a.s_len * D;
  const float* biasb = a.bias + bh * a.s_len;

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
  hmma::load_tile<kTile, kThreadsTc, RB>(qs, a.q + (bh * a.t_len + q0) * D, a.t_len - q0, tid);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fill(i);  // Q lands with fill 0

  uint32_t qf[D / 16][4];
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
    hmma::CpAsyncRing<kStages, 2 * TILE>::wait();
    __syncthreads();  // this chunk is visible; the slot read last step is free
    fill(c + kStages - 1);
    if constexpr (!kQInSmem) {
      if (c == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hmma::ldmatrix_x4(qf[kk], hmma::a_frag_addr<RB>(qs, warp * 16, kk, lane));
      }
    }
    const int s0 = c * kTile;
    const uint32_t kt = ring.slot(c), vt = kt + TILE;

    float sc[8][4];  // rows x keys: tile n holds keys s0 + 8 n..
    if constexpr (kQInSmem)
      hmma::product_nt_smem<D, 8>(sc, qs, warp * 16, kt, lane);
    else
      hmma::product_nt<D>(sc, qf, kt, lane);

    hmma::online_softmax_step(sc, m, l, acc, a, biasb, s0, rows, w0, (uint32_t)bh, lane);
    // O += P V: P of keys 16 kk..16 kk+15 is the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t af[4];
      hmma::a_from_c(af, sc, kk);
      hmma::product_t<D>(acc, af, vt, kk, lane);
    }
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
    uint32_t* dst = reinterpret_cast<uint32_t*>(a.out + (bh * a.t_len + rows[h]) * D) + t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) dst[4 * n] = hmma::pack_bf16(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
    if (t4 == 0) a.lse[bh * a.t_len + rows[h]] = m[h] + logf(fmaxf(l[h], 1e-30f));
  }
}

template <int D>
cudaError_t launch(const Args& a, int bh, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  // above 48 KB of dynamic shared memory a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (a.t_len + kTile - 1) / kTile);
  flash_fwd_tc_kernel<D><<<grid, kThreadsTc, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q: (bh, t_len, head_dim); k, v: (bh, s_len, head_dim); bf16, contiguous,
// 16-byte aligned; head_dim 32, 64 or 128; bias: (bh, s_len) fp32; out like
// q; lse: (bh, t_len) fp32. drop_thresh = 0 turns dropout off; keep_prob is
// 1 - rate. Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for what it does not take).
extern "C" int flash_fwd_tc(const void* q, const void* k, const void* v, const void* bias,
                            void* out, void* lse, int bh, int t_len, int s_len, int head_dim,
                            float scale, int causal, uint32_t drop_thresh, float keep_prob,
                            uint64_t seed, void* stream) {
  // bh on gridDim.x (up to 2^31 - 1); the 64-row q tiles on gridDim.y
  if (bh <= 0 || t_len <= 0 || s_len <= 0 || (t_len + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
               static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
               t_len, s_len, scale, causal, drop_thresh, keep_prob, seed};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return (int)launch<32>(a, bh, s);
    case 64: return (int)launch<64>(a, bh, s);
    case 128: return (int)launch<128>(a, bh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_fwd_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
