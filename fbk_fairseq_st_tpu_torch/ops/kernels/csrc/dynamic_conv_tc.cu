// Dynamic convolution forward and backward on Hopper's tensor cores
// (sm_90a), plain CUDA C++: bf16 by mma.sync.m16n8k16, fp32 by 3xTF32
// mma.sync.m16n8k8 (hopper_mma.cuh), both with fp32 sums.
//
// Replaces fbk_fairseq_st_tpu/ops/pallas/conv_kernels.py::_dynamic_conv_kernel
// (launched by _dynamic_conv_fwd_impl through pl.pallas_call), and writes the
// backward that the JAX package leaves to XLA (jax.vjp of _xla_reference):
//
//   out[b,t,c]  = sum_k w[b,t,h(c),k] * x[b, t+k-pad_l, c]
//   dx[b,s,c]   = sum_k w[b,s-k+pad_l,h(c),k] * g[b, s-k+pad_l, c]
//   dw[b,t,h,k] = sum_{c of head h} g[b,t,c] * x[b, t+k-pad_l, c]
//
// with x (B, T, C), w (B, T, H, K), h(c) = c / r, r = C / H, and zeros
// outside [0, T). Results are written in the inputs' type. Any B, T, K >= 1,
// pad_l >= 0 and C with C % H == 0 (no C % 128 or T gate: that was the
// TPU's tiling); csrc/dynamic_conv.cu keeps the first, CUDA-core kernels for a
// direct comparison only.
//
// The band as a matrix. Per (batch row, head) the forward is a product with
// a banded left factor: for 16 positions t0.. of one warp,
//   out[t0 + i] = sum_j A[i][j] X[t0 - pad_l + j],  A[i][j] = w[t0 + i, j - i]
// for 0 <= j - i < K (0 elsewhere), a 16 x (16 + K - 1) tile (67 % dense at
// K 31) against the head's window of x, r channels wide: the P.V product of
// the flash forward with the band as P. dx is the same product with the
// band transposed and g for x: over the window of g from s0 + pad_l - K + 1,
//   D[i][j] = w[s0 + pad_l - K + 1 + j, i - j + K - 1]   (0 <= j - i < K),
// the tap k = s - t + pad_l. dw is the band of the product g . X^T: of the
// 16 x (16 + K - 1) tile P = G_tile . Xwin^T over the head's channels, dw
// keeps the K diagonals, dw[t0 + i, k] = P[i][i + k].
//
// Design. One block of 4 warps per (batch row, head, 64-position tile), all
// on gridDim.x (up to 2^31 - 1 blocks: no cap on B); the tile covers the
// training T = 56 whole, so no x row is read twice there. A warp owns 16
// positions and the 16 ksteps (ceil((K + 15) / 16) 16-row k-steps) window
// rows from 16 warp, so the block's window is 48 + 16 ksteps rows (96 at
// K 31). The head's channels go in chunks of CW = 16, 32 or 64 (bf16; fp32
// takes at most 32, its rows being twice as long); a chunk past r is
// zero-padded. A block's copies are all in flight at once by cp.async: the
// window in 16-byte pieces (rows outside [0, T) and channels past the head
// zero-filled, never read), and the w rows of its band (the tile's, or dx's
// window's) as the 16-byte pieces of w that hold them (a w row is K
// elements, 62 bytes at K 31 in bf16: not aligned, so the piece offset of
// each row's first element is kept and the neighbours' elements around it
// never read). Each warp then builds its 16 x 16 ksteps band tile in shared
// memory once (zeros off the band written too) and runs out = A . Xwin 32
// channels at a time (16 accumulator registers: 6-8 blocks an SM): A by
// ldmatrix from the band tile in either type (an 8 x 4 fp32 tile reads as an
// 8 x 8 b16 one), X by ldmatrix.trans (bf16) or ld.shared (fp32), from rows
// padded to an odd count of 16-byte pieces (bf16; fp32 to 8 words mod 32):
// no bank conflicts without a swizzle, at any width. bf16 runs
// mma.sync.m16n8k16 over its ksteps; fp32 3xTF32 m16n8k8 over the band's
// ceil((K + 15) / 8) nonzero 8-column steps, each operand split into tf32
// big + small where it is used. The C fragments go straight to out, a lane's
// two channels as one 4- or 8-byte store. The backward is ONE launch: its
// grid holds the dx blocks, then the dw blocks; a dw block stages g's 64
// rows and x's window per chunk, runs P = G . Xwin^T over the chunk's
// channels 16 window columns at a time and writes each fragment element to
// a tile of sums at (row i, column j - i + 15), where row i's taps lie side
// by side; every element has one owner lane, no atomics, each output is
// written once, so two launches are bitwise equal. Unaligned tensors (C or
// r not a multiple of 16 bytes, w not 16-byte aligned) are staged and
// stored element by element by the same kernels.
//
// What bounds it. At the training shape of dynamicconv_wmt_en_de_big (B 64,
// T 56, C 1024, H 16, K 31, bf16) the forward moves x, w and out, 18.2 MB:
// 5.4 us at 3.35 TB/s; its 0.23 GFLOP take 0.23 us on the tensor cores (0.46
// issued with the band's zeros and the padded rows). The backward moves x, w,
// g, dx and dw, 29 MB (8.7 us) for 0.46 GFLOP. Both are bound by bytes. The
// design reads each x, g and w element once a block (the window's halo, K - 1
// rows, is read again by the next tile only when T > 64) and keeps the
// instructions a block issues between its copies and its stores few: the
// CUDA-core kernels (dynamic_conv.cu) issued two shared-memory loads a
// multiply-add, and a first version of this one spent most of its time on
// synchronous 2-byte w loads and on building band fragments element by
// element in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;     // positions an item, 16 a warp
constexpr size_t kSmemLimit = 232448;  // bytes a block can opt into

struct Shape {
  int b, t, c, h, k, pad_l;
  int r;        // channels a head, c / h
  int n_tiles;  // position tiles of a (batch row, head): ceil(t / kTile)
  int ksteps;   // 16-row k-steps of a warp's band: ceil((k + 15) / 16)
  int n_items;  // the launch's blocks: (batch row, head, tile), dx's then dw's
  int rw;       // 16-byte pieces a staged w row holds: K elements from any offset
  int vec;      // 16-byte copies: c, r and the x, g, out, dx pointers 16-byte aligned
  int wvec;     // 16-byte copies of w: its pointer 16-byte aligned
};

template <typename T> constexpr bool kIsBf16 = sizeof(T) == 2;

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The shared-memory layout of a block, for a chunk of CW channels in T.
// Every row stride is a multiple of 16 bytes.
template <typename T, int CW>
struct Layout {
  static constexpr bool kBf16 = kIsBf16<T>;
  static constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte piece
  static constexpr int kPieces = CW / kPer;                       // pieces a chunk row
  // band blocks: the window (then the output tile) in rows of CW + 8
  // elements (bf16 an odd count of pieces for ldmatrix; fp32 8 words mod 32,
  // so the B fragment's (k t, col g) reads hit 32 banks); the w rows the band
  // is built from (the tile's, or dx's window's), rw words a row; the 4
  // warps' band tiles, 16 rows of 16 ksteps + 8 bf16 or + 4 floats (an odd
  // count of pieces: ldmatrix reads A from them in either type)
  static constexpr int kLx = static_cast<int>(sizeof(T)) * (CW + 8);
  __host__ __device__ static int window(int ksteps) { return kTile - 16 + 16 * ksteps; }
  __host__ __device__ static int la(int ksteps) { return kBf16 ? 2 * (16 * ksteps + 8) : 4 * (16 * ksteps + 4); }
  __host__ __device__ static size_t ws_offset(int ksteps) { return (size_t)window(ksteps) * kLx; }
  __host__ __device__ static size_t band_offset(int ksteps, int rw) {
    return ws_offset(ksteps) + (size_t)window(ksteps) * 16 * rw;
  }
  __host__ __device__ static size_t band_bytes(int ksteps, int rw) {
    return band_offset(ksteps, rw) + (size_t)kTile * la(ksteps);
  }
  // dw blocks: g's 64 rows and x's window alike, read by rows (A) and by
  // (row g, col t) (B, non-transposed): bf16 odd pieces, fp32 4 words mod 32;
  // then a 64 x (16 ksteps + 16) fp32 tile of sums
  static constexpr int kLg = kBf16 ? 2 * (CW + 8) : 4 * (CW + 4);
  __host__ __device__ static size_t dw_bytes(int ksteps) {
    return (size_t)(kTile + window(ksteps)) * kLg + sizeof(float) * (size_t)kTile * (16 * ksteps + 16);
  }
};

// n_rows rows of a chunk tile at dst (row stride ld bytes): tile row i holds
// positions row0 + i, channels ch0..ch0 + CW of src's batch row b; zeros for
// positions outside [0, T) and channels at or past ch_end (the head's end).
// By 16-byte cp.async when s.vec, else element by element.
template <typename T, int CW>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int ld, const T* __restrict__ src,
                                           const Shape& s, int b, int row0, int n_rows, int ch0,
                                           int ch_end, int tid) {
  using L = Layout<T, CW>;
  const T* base = src + (size_t)b * s.t * s.c;
  if (s.vec) {
    const uint32_t d = hmma::smem_u32(dst);
    for (int i = tid; i < n_rows * L::kPieces; i += kThreads) {
      const int row = i / L::kPieces, p = i - row * L::kPieces;
      const int pos = row0 + row, ch = ch0 + p * L::kPer;
      const bool ok = pos >= 0 && pos < s.t && ch < ch_end;
      hmma::cp_async16(d + row * ld + p * 16, ok ? base + (size_t)pos * s.c + ch : base, ok);
    }
  } else {
    for (int i = tid; i < n_rows * CW; i += kThreads) {
      const int row = i / CW, j = i - row * CW;
      const int pos = row0 + row, ch = ch0 + j;
      const bool ok = pos >= 0 && pos < s.t && ch < ch_end;
      reinterpret_cast<T*>(dst + row * ld)[j] = ok ? base[(size_t)pos * s.c + ch] : zero<T>();
    }
  }
}

// Rows row0..row0 + n_rows of w[b, :, h, :] into ws, rw 16-byte pieces a
// row, zeros for rows outside [0, T). A w row is K elements (62 bytes at
// K 31 in bf16, not 16-byte aligned), so each row is copied as the 16-byte
// pieces of w that hold it, by cp.async: element d of a row at element
// o + d of its pieces, o = e0 % (16 / sizeof(T)) for the row's first
// element e0 in w (a piece past the tensor's end is copied in part; the
// neighbours' elements around the row are never read). Without s.wvec,
// element by element, to the same places.
template <typename T>
__device__ __forceinline__ void stage_w(unsigned char* ws, const T* __restrict__ w, const Shape& s, int b, int h,
                                        int row0, int n_rows, int tid) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const uint32_t d = hmma::smem_u32(ws);
  const long long total = (long long)s.b * s.t * s.h * s.k * sizeof(T);  // w's bytes
  const unsigned char* wb = reinterpret_cast<const unsigned char*>(w);
  for (int i = tid; i < n_rows * s.rw; i += kThreads) {
    const int row = i / s.rw, p = i - row * s.rw;
    const int pos = row0 + row;
    const long long e0 = (((long long)b * s.t + pos) * s.h + h) * s.k;
    const bool ok = pos >= 0 && pos < s.t;
    if (s.wvec) {
      const long long at = (e0 / kPer + p) * 16;  // the piece's first byte in w
      const long long n = ok && at < (e0 + s.k) * (long long)sizeof(T) ? min(16LL, total - at) : 0;
      hmma::cp_async16_first(d + 16 * i, wb + (n ? at : 0), (int)n);
    } else if (p == 0) {
      T* wr = reinterpret_cast<T*>(ws + 16 * i) + (ok ? e0 % kPer : 0);
      for (int k = 0; k < s.k; ++k) wr[k] = ok ? w[e0 + k] : zero<T>();
    }
  }
}

// The warp's 16 x 16 ksteps band tile (row stride la bytes), from the
// staged w rows ws: on the band, d = j - i in [0, K), the forward's
// A[i][j] = w[p0 + i, d] is element d of ws row r0 + i, and dx's
// D[i][j] = w[p0 + j, K - 1 - d] element K - 1 - d of ws row r0 + j (ws
// row r holds position p0 - r0 + r: r0 the warp's first row); 0 off the
// band. Every element is written, zeros too. A staged row's element e sits
// at e0 % kPer + e, e0 = ((b T + pos) H + h) K, which steps by H K a row
// (mod kPer, a power of 2: unsigned products wrap harmlessly).
template <typename T, bool kDx>
__device__ __forceinline__ void build_band(unsigned char* band, int la, const unsigned char* ws, const Shape& s,
                                           int b, int h, int p0, int r0, int lane) {
  T* a = reinterpret_cast<T*>(band);
  const int lda = la / static_cast<int>(sizeof(T)), nj = 16 * s.ksteps, k = s.k;
  constexpr unsigned kMask = 16 / sizeof(T) - 1;
  const unsigned e_row0 = (unsigned)((((long long)b * s.t + p0 - r0) * s.h + h) * k), hk = s.h * k;
  auto put = [&](int i, int j) {
    const int d = j - i, row = r0 + (kDx ? j : i), tap = kDx ? k - 1 - d : d;
    T v = zero<T>();
    if (d >= 0 && d < k)
      v = reinterpret_cast<const T*>(ws + 16 * row * s.rw)[((e_row0 + row * hk) & kMask) + tap];
    a[i * lda + j] = v;
  };
  // a lane a row i and every other column: its ws row (forward) or its tap
  // step (dx) changes by a constant from one element to the next
  for (int j = lane >> 4; j < nj; j += 2) put(lane & 15, j);
}

// acc = A . Xwin for the warp's 16 rows and NT 8-channel tiles from chunk
// column c0: A from the warp's band tile (ldmatrix, row stride la), X from
// window rows x0.. of the tile at xs (row stride lx). bf16: mma.m16n8k16
// over ksteps k-steps of 16, X by ldmatrix.trans. fp32: 3xTF32
// mma.m16n8k8 over ceil((K + 15) / 8) k-steps of 8 (the band's nonzero
// columns), A by ldmatrix (an 8 x 4 fp32 tile reads as an 8 x 8 b16 one)
// and X by ld.shared, each split where it is used.
template <typename T, int NT>
__device__ __forceinline__ void band_product(float (&acc)[NT][4], uint32_t band, int la, const unsigned char* xs,
                                             int lx, int x0, int c0, const Shape& s, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  if constexpr (kIsBf16<T>) {
    const uint32_t xa = hmma::smem_u32(xs) + 2 * c0;
    for (int ks = 0; ks < s.ksteps; ++ks) {
      uint32_t af[4];
      hmma::ldmatrix_x4(af, hmma::a_frag_addr_pad(band, la, 0, ks, lane));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        hmma::ldmatrix_x4_trans(bf, hmma::bt_frag_addr_pad(xa, lx, x0 + 16 * ks, np, lane));
        hmma::mma_16816(acc[2 * np], af, bf[0], bf[1]);
        hmma::mma_16816(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  } else {
    const int g = lane >> 2, t = lane & 3, ldx = lx / 4;
    for (int ks = 0; ks < (s.k + 22) / 8; ++ks) {
      uint32_t a[4], ab[4], as[4];
      hmma::ldmatrix_x4(a, hmma::a_frag_addr_pad(band, la, 0, ks, lane));
#pragma unroll
      for (int q = 0; q < 4; ++q) hmma::split_tf32(__uint_as_float(a[q]), ab[q], as[q]);
      // b[0]: (window row k t, channel 8 n + g), b[1]: k t + 4
      const float* lo = reinterpret_cast<const float*>(xs) + (x0 + 8 * ks + t) * ldx + c0 + g;
      const float* hi = lo + 4 * ldx;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bb[2], bs[2];
        hmma::split_tf32(lo[8 * n], bb[0], bs[0]);
        hmma::split_tf32(hi[8 * n], bb[1], bs[1]);
        hmma::mma_3xtf32(acc[n], ab, as, bb, bs);
      }
    }
  }
}

// The position of window row 0 of a block at t0: x's for the forward and
// dw, g's for dx (the first position whose taps reach t0).
__device__ __forceinline__ int window_base(const Shape& s, bool dx, int t0) {
  return dx ? t0 + s.pad_l - (s.k - 1) : t0 - s.pad_l;
}

// One band block: positions t0..t0 + kTile of batch row b, head h. kDx
// false: out = the forward of x; true: out = dx, with x := g.
template <typename T, int CW, bool kDx>
__device__ void band_block(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                           const Shape& s, int b, int h, int t0, unsigned char* smem) {
  using L = Layout<T, CW>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrows = L::window(s.ksteps), base = window_base(s, kDx, t0), la = L::la(s.ksteps);
  static_assert(CW % 8 == 0, "chunks of 8-channel tiles");
  const int p0 = kDx ? base : t0;  // ws row 0's position
  unsigned char* xs = smem;        // the window
  unsigned char* ws = smem + L::ws_offset(s.ksteps);
  unsigned char* band = smem + L::band_offset(s.ksteps, s.rw) + (size_t)warp * 16 * la;
  const bool live = t0 + 16 * warp < s.t;  // the warp has a position to write
  const int head0 = h * s.r, head_end = head0 + s.r;

  for (int cc = 0; cc < s.r; cc += CW) {
    stage_rows<T, CW>(xs, L::kLx, x, s, b, base, wrows, head0 + cc, head_end, tid);
    if (cc == 0) stage_w<T>(ws, w, s, b, h, p0, kDx ? wrows : kTile, tid);
    hmma::cp_async_commit();
    hmma::cp_async_wait<0>();
    __syncthreads();
    if (cc == 0 && live) {
      build_band<T, kDx>(band, la, ws, s, b, h, p0 + 16 * warp, 16 * warp, lane);
      __syncwarp();
    }
    // 32 channels at a time (acc in 16 registers: 8 blocks fit an SM),
    // the C fragments straight to out: a lane's pair of channels as one
    // 4- or 8-byte store when s.vec
    constexpr int kNT = (CW < 32 ? CW : 32) / 8;
    T* ob = out + (size_t)b * s.t * s.c;
    if (live) {
#pragma unroll 1
      for (int c0 = 0; c0 < CW; c0 += 8 * kNT) {
        float acc[kNT][4];
        band_product<T, kNT>(acc, hmma::smem_u32(band), la, xs, L::kLx, 16 * warp, c0, s, lane);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int pos = t0 + 16 * warp + g + 8 * hh;
          if (pos >= s.t) continue;
          T* orow = ob + (size_t)pos * s.c;
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            const int ch = head0 + cc + c0 + 8 * n + 2 * t4;
            const float v0 = acc[n][2 * hh], v1 = acc[n][2 * hh + 1];
            if (s.vec) {
              if (ch < head_end) {
                if constexpr (L::kBf16) *reinterpret_cast<uint32_t*>(orow + ch) = hmma::pack_bf16(v0, v1);
                else *reinterpret_cast<float2*>(orow + ch) = make_float2(v0, v1);
              }
            } else {
              if (ch < head_end) store(orow + ch, v0);
              if (ch + 1 < head_end) store(orow + ch + 1, v1);
            }
          }
        }
      }
    }
    __syncthreads();  // the window is read before the next chunk's copies
  }
}

// One dw block: positions t0..t0 + kTile of batch row b, head h. P = G .
// Xwin^T over every chunk of the head's channels, 16 window columns at a
// time; each fragment element goes to a tile of sums at (row, column - row),
// which one lane owns, so that row i's taps 0..K - 1 lie side by side; then
// the rows to dw.
template <typename T, int CW>
__device__ void dw_block(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dw, const Shape& s,
                         int b, int h, int t0, unsigned char* smem) {
  using L = Layout<T, CW>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wrows = L::window(s.ksteps);
  unsigned char* gs = smem;                   // kTile rows of g
  unsigned char* xs = smem + kTile * L::kLg;  // the window of x
  // kTile x (16 ksteps + 16) sums: row i, column j - i + 15 for window
  // column j
  float* sdw = reinterpret_cast<float*>(xs + (size_t)wrows * L::kLg);
  const int ld_dw = 16 * s.ksteps + 16;
  const bool live = t0 + 16 * warp < s.t;
  const int head0 = h * s.r, head_end = head0 + s.r;

  for (int cc = 0; cc < s.r; cc += CW) {
    stage_rows<T, CW>(gs, L::kLg, g, s, b, t0, kTile, head0 + cc, head_end, tid);
    stage_rows<T, CW>(xs, L::kLg, x, s, b, window_base(s, false, t0), wrows, head0 + cc, head_end, tid);
    hmma::cp_async_commit();
    hmma::cp_async_wait<0>();
    __syncthreads();
    if (live) {
      for (int cg = 0; cg < s.ksteps; ++cg) {
        const int n0 = 16 * warp + 16 * cg;  // the columns' first window row
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        if constexpr (L::kBf16) {
#pragma unroll
          for (int kk = 0; kk < CW / 16; ++kk) {
            uint32_t af[4], bf[4];
            hmma::ldmatrix_x4(af, hmma::a_frag_addr_pad(hmma::smem_u32(gs), L::kLg, 16 * warp, kk, lane));
            hmma::ldmatrix_x4(bf, hmma::b_frag_addr_pad(hmma::smem_u32(xs), L::kLg, n0, kk, lane));
            hmma::mma_16816(acc[0], af, bf[0], bf[1]);
            hmma::mma_16816(acc[1], af, bf[2], bf[3]);
          }
        } else {
          constexpr int ld = L::kLg / 4;
          const float* xb = reinterpret_cast<const float*>(xs) + n0 * ld;
#pragma unroll
          for (int kk = 0; kk < CW / 8; ++kk) {
            const int c0 = 8 * kk + tq;
            uint32_t a[4], ab[4], as[4];
            hmma::ldmatrix_x4(a, hmma::a_frag_addr_pad(hmma::smem_u32(gs), L::kLg, 16 * warp, kk, lane));
#pragma unroll
            for (int i = 0; i < 4; ++i) hmma::split_tf32(__uint_as_float(a[i]), ab[i], as[i]);
#pragma unroll
            for (int n = 0; n < 2; ++n) {  // b: (channel k t / t + 4, window row 8 n + g)
              uint32_t bb[2], bs[2];
              hmma::split_tf32(xb[(8 * n + gq) * ld + c0], bb[0], bs[0]);
              hmma::split_tf32(xb[(8 * n + gq) * ld + c0 + 4], bb[1], bs[1]);
              hmma::mma_3xtf32(acc[n], ab, as, bb, bs);
            }
          }
        }
        // fragment (row i, window column j) to sums column j - i + 15
        // (tap j - i, kept for 0 <= tap < K), written whole: no test
        float* p = sdw + (16 * warp + gq) * ld_dw + 16 * cg + 2 * tq - gq + 15;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float* q = p + (e >> 1) * 8 * (ld_dw - 1) + 8 * n + (e & 1);
            *q = cc == 0 ? acc[n][e] : *q + acc[n][e];
          }
      }
    }
    __syncthreads();  // the tiles are read; the sums are written
  }
  // dw rows of K taps (not 16-byte aligned): a warp a row, a lane a tap
  T* db = dw + ((size_t)b * s.t * s.h + h) * s.k;
  for (int i = warp; i < kTile && t0 + i < s.t; i += kWarps)
    for (int k = lane; k < s.k; k += 32) store(db + (size_t)(t0 + i) * s.h * s.k + k, sdw[i * ld_dw + k + 15]);
}

template <typename T, int CW>
__global__ void __launch_bounds__(kThreads)
dynamic_conv_fwd_tc_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tile = blockIdx.x % s.n_tiles, bh = blockIdx.x / s.n_tiles;
  band_block<T, CW, false>(x, w, out, s, bh / s.h, bh % s.h, tile * kTile, smem);
}

// Blocks [0, B H n_tiles) compute dx, the rest dw, each (batch row, head,
// tile) in the forward's order.
template <typename T, int CW>
__global__ void __launch_bounds__(kThreads)
dynamic_conv_bwd_tc_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ g,
                           T* __restrict__ dx, T* __restrict__ dw, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = s.b * s.h * s.n_tiles;
  const bool is_dw = (int)blockIdx.x >= n;
  const int i = is_dw ? (int)blockIdx.x - n : (int)blockIdx.x;
  const int tile = i % s.n_tiles, bh = i / s.n_tiles;
  if (is_dw)
    dw_block<T, CW>(x, g, dw, s, bh / s.h, bh % s.h, tile * kTile, smem);
  else
    band_block<T, CW, true>(g, w, dx, s, bh / s.h, bh % s.h, tile * kTile, smem);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  // above 48 KB a kernel must opt in (per device, so set on every launch)
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int CW>
cudaError_t launch_fwd(const void* x, const void* w, void* out, const Shape& s, cudaStream_t stream) {
  const size_t bytes = Layout<T, CW>::band_bytes(s.ksteps, s.rw);
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(dynamic_conv_fwd_tc_kernel<T, CW>, bytes);
  if (err != cudaSuccess) return err;
  dynamic_conv_fwd_tc_kernel<T, CW><<<s.n_items, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), s);
  return cudaGetLastError();
}

template <typename T, int CW>
cudaError_t launch_bwd(const void* x, const void* w, const void* g, void* dx, void* dw, const Shape& s,
                       cudaStream_t stream) {
  using L = Layout<T, CW>;
  const size_t band = L::band_bytes(s.ksteps, s.rw), dwb = L::dw_bytes(s.ksteps);
  const size_t bytes = band > dwb ? band : dwb;
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(dynamic_conv_bwd_tc_kernel<T, CW>, bytes);
  if (err != cudaSuccess) return err;
  dynamic_conv_bwd_tc_kernel<T, CW><<<s.n_items, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<T*>(dw), s);
  return cudaGetLastError();
}

// The chunk width for r channels a head: 16, 32 or 64 in bf16, 16 or 32 in
// fp32 (whose window rows are twice as long).
int chunk_for(int r, bool bf16) { return r <= 16 ? 16 : r <= 32 || !bf16 ? 32 : 64; }

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// Checks the caller's tile plan (n_tiles, ksteps, chunk: the wrapper's
// Python mirror computes the same numbers) against the shape.
bool make_shape(int b, int t, int c, int h, int k, int pad_l, int is_bf16, int n_tiles, int ksteps, int chunk,
                bool bwd, const void* const* ptrs, int n_ptrs, const void* w, Shape* s) {
  if (b <= 0 || t <= 0 || c <= 0 || h <= 0 || k <= 0 || pad_l < 0 || c % h != 0) return false;
  const int r = c / h;
  if (n_tiles != (t + kTile - 1) / kTile || ksteps != (k + 30) / 16 || chunk != chunk_for(r, is_bf16)) return false;
  const long long items = (long long)b * h * n_tiles * (bwd ? 2 : 1);
  if (items > INT_MAX) return false;  // blocks, on gridDim.x
  const int per = is_bf16 ? 8 : 4;
  bool vec = c % per == 0 && r % per == 0;
  for (int i = 0; i < n_ptrs; ++i) vec = vec && aligned(ptrs[i], 16);
  const int rw = (k * (is_bf16 ? 2 : 4) + 15) / 16 + 1;
  *s = Shape{b, t, c, h, k, pad_l, r, n_tiles, ksteps, (int)items, rw, vec ? 1 : 0, aligned(w, 16) ? 1 : 0};
  return true;
}

template <typename T>
cudaError_t dispatch_fwd(const void* x, const void* w, void* out, const Shape& s, int chunk, cudaStream_t st) {
  switch (chunk) {
    case 16: return launch_fwd<T, 16>(x, w, out, s, st);
    case 32: return launch_fwd<T, 32>(x, w, out, s, st);
    default:
      if constexpr (kIsBf16<T>) return launch_fwd<T, 64>(x, w, out, s, st);
      else return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_bwd(const void* x, const void* w, const void* g, void* dx, void* dw, const Shape& s, int chunk,
                         cudaStream_t st) {
  switch (chunk) {
    case 16: return launch_bwd<T, 16>(x, w, g, dx, dw, s, st);
    case 32: return launch_bwd<T, 32>(x, w, g, dx, dw, s, st);
    default:
      if constexpr (kIsBf16<T>) return launch_bwd<T, 64>(x, w, g, dx, dw, s, st);
      else return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (b, t, c), w: (b, t, h, k), out like x; contiguous, all of one type
// (is_bf16 ? bf16 : fp32). n_tiles, ksteps and chunk are the tile plan
// (ops/kernels/dynamic_conv.py::tile_plan); a plan that does not match the
// shape is refused. Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for what it does not take).
extern "C" int dynamic_conv_fwd_tc(const void* x, const void* w, void* out, int b, int t, int c, int h, int k,
                                   int pad_l, int is_bf16, int n_tiles, int ksteps, int chunk, void* stream) {
  Shape s;
  const void* ptrs[] = {x, out};
  if (!make_shape(b, t, c, h, k, pad_l, is_bf16, n_tiles, ksteps, chunk, false, ptrs, 2, w, &s))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch_fwd<__nv_bfloat16>(x, w, out, s, chunk, st)
                       : dispatch_fwd<float>(x, w, out, s, chunk, st));
}

// g: the gradient of out, like x; dx like x, dw like w. One launch.
extern "C" int dynamic_conv_bwd_tc(const void* x, const void* w, const void* g, void* dx, void* dw, int b, int t,
                                   int c, int h, int k, int pad_l, int is_bf16, int n_tiles, int ksteps, int chunk,
                                   void* stream) {
  Shape s;
  const void* ptrs[] = {x, g, dx};
  if (!make_shape(b, t, c, h, k, pad_l, is_bf16, n_tiles, ksteps, chunk, true, ptrs, 3, w, &s))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch_bwd<__nv_bfloat16>(x, w, g, dx, dw, s, chunk, st)
                       : dispatch_bwd<float>(x, w, g, dx, dw, s, chunk, st));
}

extern "C" const char* dynamic_conv_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
