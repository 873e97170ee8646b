// K19 gs_match_template: the SSD template match of gs_match_template
// (grayskull.h:701-723) for a batch of uint8 frames and one uint8 template, for
// Hopper (sm_90a), bound to Python through a plain C interface
// (grayskull_tpu_torch/kernels/_build.py).
//
// Replaces the XLA function _match_template (grayskull_tpu/ops/template.py:30).
// It is not a Pallas kernel: the TPU computes the SSD as a windowed sum of I^2
// from an integral image, minus twice a correlation that it splits into four
// float32 convolutions of 4-bit halves (its matrix unit has no integer
// product), plus the sum of T^2.  The card's int8 tensor cores take the
// correlation's byte products whole.
//
// What it computes.  For each frame and placement (y, x) of an (h, w) frame and
// a (th, tw) template: ssd = sum over i, j of (I[y + i, x + j] - T[i, j])^2 in
// uint32, exact because the caller keeps th * tw <= 66,051, so that
// th * tw * 255^2 <= 2^32 - 1; then out = 255 - ssd / (255 * th * tw) with
// unsigned division (the quotient is at most 255).
//
// What bounds it: operations.  ssd = win(I^2) - 2 corr + sum T^2, exact mod
// 2^32, and the correlation's byte products are the work: 17.9 G at 64 frames
// of 480x640 and a 32x32 template, against 37 MB to move.
//
// The tensor-core design (mma_kernel; templates kMmaMinWidth to kMmaMaxWidth
// wide).  The correlation is an integer matrix product on
// mma.sync.m16n8k32.row.col.s32.u8.u8.s32: for template row i and the 32
// frame columns of chunk u (columns 16 u .. 16 u + 31 of a warp's span),
//   A[m, k] = T[i, 16 (u - q) + k - m]  (zero outside [0, tw)), a Toeplitz
//             tile of the template for output tile q (columns 16 q + m);
//   B[k, n] = I[y + n + i, x + 16 u + k], frame bytes, already K-major;
//   C[m, n] += A B, the correlation of placement row y + n, column x + 16 q + m,
// summed over i and u in s32 without .satfinite, so it wraps mod 2^32 as the
// uint32 SSD does.  A block owns a band of kBandRows x kBandCols placements, a
// warp kMmaR x kMmaQ tiles of it; each chunk's B serves the tiles q with u - q
// in [-1, (tw + 14) / 16].  The block stages, for a chunk of template rows
// at a time (all of them when they fit kMmaStageBytes), each template row in
// 4 copies shifted by 0-3 bytes and zero-padded, and the band's frame rows
// for those template rows, a word a thread from coalesced loads (funnel
// shifts of aligned words, the index clamped to the batch).  A thread's A
// register is 4 consecutive bytes of a template row at an offset fixed by its
// lane: one aligned shared load from the right copy (copy pitch = 8 mod 16
// words: conflict-free); for templates of up to kFixedSmax + 2 tiles a row
// (tw <= 16 kFixedSmax + 1) a row's tiles and B words are all loaded before
// its products, for wider ones chunk u's tiles are chunk u - 2's shifted by
// two column tiles, so a chunk loads two.  A thread's B register is one staged
// word (row pitch = 4 mod 8 words: a read's 8 rows in distinct banks); read
// straight from the frame, each B load would touch 8 rows for 16 bytes each,
// 8 L1 wavefronts a load (PERF.md).
// win(I^2) comes from the same staged rows: each column's squares summed over
// th rows (sliding down the band, chunk by chunk), then each row's column sums
// over tw columns (sliding along a run), exactly in uint32, into shared
// memory (over the staged frame rows, then dead), where the epilogue reads
// them and divides by a multiply-high and shifts.  The blocks are persistent,
// as many as the card holds, each walking bands with a stride.
//
// The INT32 design (int32_kernel; narrower and wider templates).  A thread
// owns a 4 x 4 tile of placements (kRows rows of kCols adjacent columns), a
// warp 4 rows of 128 placements, a block 8 such warps one above the other;
// column tiles ride grid.x, row tiles grid.y and frames grid.z, each walked
// with a stride.  The template is staged in shared memory, each row padded
// with zero bytes to a whole number of 4-byte words; a template of more than
// kStageBytes so padded is staged kStageBytes at a time (a chunk of rows),
// with a __syncthreads around each chunk.  A thread reads each frame row y + i
// once, as aligned 4-byte words through L1, funnel-shifts them to the word at
// its first placement, and per word k forms its other three columns' words
// by funnel shifts of that word and the next; each of them serves the
// thread's 4 rows, row y + j against template row i - j.  So a frame word and
// its shifts serve 64 squared differences: 16 __vabsdiffu4 (|I - T| of 4
// bytes) and 16 __dp4a (their squares added).  The last word of a row masks
// the bytes past tw, and the first and last rows of a chunk, where some of the
// 4 rows have no template row, mask those rows.  Its ceiling is half an INT32
// instruction a difference.
//
// chip_sweep.py --source template times the two designs at the crossover's
// shapes and the tensor-core design's tiles (PERF.md).
//
// Reads past the row.  A word may hold bytes past the row end (the next row's)
// or before the frame's first byte; they feed only masked bytes, zero template
// bytes or placements past the last column, which are not stored.  A word
// index is clamped to the last word that holds a byte of the batch, so no read
// leaves the buffer.
//
// Each entry returns cudaGetLastError().

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kMaxGrid = 65535;
constexpr int kDefaultSmem = 48 * 1024;

// ---- the tensor-core design ----------------------------------------------------------------

constexpr int kMmaMinWidth = 8;    // narrower templates take the INT32 design
constexpr int kMmaMaxWidth = 384;  // wider ones too: the column sums' rows fill shared memory
constexpr int kMmaQ = 4;           // 16-column output tiles a warp
constexpr int kMmaR = 2;           // 8-row output tiles a warp
constexpr int kMmaWarpsX = 2;      // warps a block side by side
constexpr int kMmaWarpsY = 2;      // and one above the other
constexpr int kMmaThreads = 32 * kMmaWarpsX * kMmaWarpsY;
constexpr int kBandCols = 16 * kMmaQ * kMmaWarpsX;  // placements a block's band
constexpr int kBandRows = 8 * kMmaR * kMmaWarpsY;
constexpr int kRuns = kMmaThreads / kBandRows;  // runs of columns a band row
constexpr int kRunCols = kBandCols / kRuns;
constexpr int kPadLeft = 32;                   // zero bytes before a staged template row
constexpr int kMmaStageBytes = 64 * 1024;      // template rows staged at once
static_assert(kMmaThreads % kBandRows == 0 && kBandCols % kRuns == 0, "band runs");
// templates up to this many 16-column A tiles past the first (tw <= 16 kFixedSmax
// + 1) load each template row's A tiles and B words at once
constexpr int kFixedSmax = 4;
// the staged frame words a row: up to the last B register of the band's last
// warp, smax + kMmaQ + 1 chunks of 16 columns past its start
__host__ __device__ constexpr int frame_words(int smax) {
  return 4 * (kMmaQ * (kMmaWarpsX - 1) + kMmaQ + 1 + smax);
}

// The words of one copy of a staged template row: the row's bytes at kPadLeft,
// zeros around them up to the last A register read (word 4 smax + 15 of a
// copy, smax = (tw + 14) / 16), 8 mod 16 words, so that the 4 copies a warp
// reads fall in distinct banks.
__host__ __device__ __forceinline__ int copy_words(int tw) {
  const int need = max(4 * ((tw + 14) / 16) + 16, (kPadLeft + tw + 3) / 4);
  return need + ((8 - need % 16) + 16) % 16;
}

// q = n / d for every 32-bit n, as a multiply-high and shifts: m and shift from
// udiv_magic (d >= 2).
__device__ __forceinline__ unsigned udiv(unsigned n, unsigned m, int shift) {
  const unsigned t = __umulhi(n, m);
  return (t + ((n - t) >> 1)) >> (shift - 1);
}

// The multiplier and shift of udiv for the divisor d >= 2 (Granlund and
// Montgomery): shift = ceil(log2 d), m = 2^32 (2^shift - d) / d + 1.
void udiv_magic(unsigned d, unsigned& m, int& shift) {
  shift = 0;
  while ((1ull << shift) < d) ++shift;
  m = static_cast<unsigned>(((1ull << 32) * ((1ull << shift) - d)) / d + 1);
}

// acc += A B on the tensor cores: the m16n8k32 fragments of a lane, A (16 x 32
// u8, row-major) in a[4], B (32 x 8 u8, column-major) in b[2], C (16 x 8 s32)
// in c[4].  With g = lane / 4 and t = lane % 4: a[0] holds A[g][4t .. 4t + 3],
// a[1] A[g + 8][4t ..], a[2] A[g][16 + 4t ..], a[3] A[g + 8][16 + 4t ..]; b[0]
// B[4t .. 4t + 3][g], b[1] B[16 + 4t ..][g]; c[0], c[1] C[g][2t], C[g][2t + 1],
// c[2], c[3] C[g + 8][2t], C[g + 8][2t + 1].  The sums wrap mod 2^32.
__device__ __forceinline__ void mma_u8(unsigned (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#else
  // the same product from the warp's fragments, 4 bytes of k at a time
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int kk = 0; kk < 8; ++kk) {
    const int src = kk & 3, hi = kk >> 2;
    const unsigned a_lo = __shfl_sync(0xffffffffu, a[hi ? 2 : 0], g * 4 + src);
    const unsigned a_hi = __shfl_sync(0xffffffffu, a[hi ? 3 : 1], g * 4 + src);
    const unsigned b0 = __shfl_sync(0xffffffffu, b[hi], 2 * t * 4 + src);
    const unsigned b1 = __shfl_sync(0xffffffffu, b[hi], (2 * t + 1) * 4 + src);
    c[0] = __dp4a(a_lo, b0, c[0]);
    c[1] = __dp4a(a_lo, b1, c[1]);
    c[2] = __dp4a(a_hi, b0, c[2]);
    c[3] = __dp4a(a_hi, b1, c[3]);
  }
#endif
}

// Template rows [i0, i1) into s, row i at (i - i0) * 4 * cw words: copy c
// (words [c cw, (c + 1) cw)) holds at word x the bytes P[4 x + c .. 4 x + c +
// 3] of the row P padded with kPadLeft zero bytes before it and zeros after.
__device__ void stage_copies(const uint8_t* __restrict__ tmpl, unsigned* s, int i0, int i1, int tw,
                             int cw) {
  const int words = (i1 - i0) * 4 * cw;
  for (int idx = threadIdx.x; idx < words; idx += kMmaThreads) {
    const int i = i0 + idx / (4 * cw);
    const int c = (idx / cw) & 3;
    const int x = idx % cw;
    const uint8_t* row = tmpl + static_cast<size_t>(i) * tw;
    unsigned word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = 4 * x + c + b - kPadLeft;
      if (j >= 0 && j < tw) word |= static_cast<unsigned>(row[j]) << (8 * b);
    }
    s[idx] = word;
  }
}

// The 4 frame bytes at byte address p, any alignment, from two aligned words,
// each index clamped to ``last``, the batch's last word.
__device__ __forceinline__ unsigned frame_word(const uint8_t* p, const unsigned* last) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const unsigned* lo = reinterpret_cast<const unsigned*>(a & ~static_cast<uintptr_t>(3));
  const unsigned* hi = lo + 1 < last ? lo + 1 : last;
  return __funnelshift_r(__ldg(lo < last ? lo : last), __ldg(hi),
                         static_cast<unsigned>(a & 3) * 8);
}

// Frame rows [y, y + rows) of the band, columns x0 .. x0 + 4 fw - 1, into fs
// (row r at r * fp words, fw <= 32 kChunks): a warp kStageRows rows at a
// time, a lane every 32nd word, all of a lane's loads issued before its stores.
template <int kChunks>
__device__ void stage_frame(const uint8_t* frame, const unsigned* last, int w, int y, int x0,
                            int rows, int fw, int fp, unsigned* fs) {
  constexpr int kWarpsAll = kMmaThreads / 32;
  constexpr int kStageRows = 4;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kStageRows * kWarpsAll) {
    unsigned v[kStageRows][kChunks];
#pragma unroll
    for (int k = 0; k < kStageRows; ++k) {
      const uint8_t* row = frame + static_cast<size_t>(y + r + k * kWarpsAll) * w + x0;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int x = lane + 32 * j;
        if (x < fw && r + k * kWarpsAll < rows) v[k][j] = frame_word(row + 4 * x, last);
      }
    }
#pragma unroll
    for (int k = 0; k < kStageRows; ++k) {
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int x = lane + 32 * j;
        if (x < fw && r + k * kWarpsAll < rows) fs[(r + k * kWarpsAll) * fp + x] = v[k][j];
      }
    }
  }
}

// Each column's sums of squares over the staged frame rows of template rows
// [c0, c1) (staged row r: band row r - c0 .. ), for the band's rows, added to
// vs (kBandRows x vp words; a column stays with its thread from chunk to
// chunk): the first row's sum, then sliding down the band.  Exact mod 2^32.
__device__ void column_squares(const unsigned* fs, int fp, int c0, int c1, int rows, int cols,
                               int vp, unsigned* vs) {
  const uint8_t* fb = reinterpret_cast<const uint8_t*>(fs);
  const int pitch = 4 * fp;
  const int n = c1 - c0;
  for (int x = threadIdx.x; x < cols; x += kMmaThreads) {
    unsigned v = 0;
    for (int r = 0; r < n; ++r) {
      const unsigned b = fb[r * pitch + x];
      v += b * b;
    }
    if (c0 == 0) {
      vs[x] = v;
    } else {
      vs[x] += v;
    }
    for (int yy = 1; yy < rows; ++yy) {
      const unsigned in = fb[(yy + n - 1) * pitch + x];
      const unsigned out = fb[(yy - 1) * pitch + x];
      v += in * in - out * out;
      if (c0 == 0) {
        vs[yy * vp + x] = v;
      } else {
        vs[yy * vp + x] += v;
      }
    }
  }
}

// win(I^2) of the band's placements into ws (kBandRows x (kBandCols + 1)
// words) from the column sums in vs: each row's sums over tw columns, sliding
// along a run of kRunCols.
__device__ void row_squares(const unsigned* vs, int vp, int tw, int rows, int cols,
                            unsigned* ws) {
  const int yy = threadIdx.x % kBandRows;
  const int xa = threadIdx.x / kBandRows * kRunCols;
  const int xb = min(xa + kRunCols, cols);
  if (yy < rows && xa < xb) {
    const unsigned* v = vs + yy * vp;
    unsigned sum = 0;
    for (int j = 0; j < tw; ++j) sum += v[xa + j];
    ws[yy * (kBandCols + 1) + xa] = sum;
    for (int x = xa + 1; x < xb; ++x) {
      sum += v[x + tw - 1] - v[x - 1];
      ws[yy * (kBandCols + 1) + x] = sum;
    }
  }
}

// correlate for templates of kSmax + 2 A tiles a row: each template row's
// A tiles and B words loaded at once, then its products.
template <int kSmax>
__device__ __forceinline__ void correlate_fixed(const unsigned* ts, const unsigned* fs, int fp,
                                                int cw, int wy, int wx, int c0, int c1,
                                                unsigned (&acc)[kMmaR][kMmaQ][4]) {
  constexpr int kAWord[4] = {0, -2, 4, 2};  // as in correlate
  constexpr int kLastU = (kMmaQ - 1 + kSmax) / 2 * 2;  // the last chunk
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lane_word = ((kPadLeft - g) & 3) * cw + t + ((kPadLeft - g) >> 2);
  const unsigned* frow = fs + (wy + g) * fp + wx / 4 + t;
#pragma unroll 2
  for (int i = c0; i < c1; ++i) {
    const unsigned* srow = ts + (i - c0) * 4 * cw + lane_word;
    const unsigned* brow = frow + (i - c0) * fp;
    unsigned a[kSmax + 2][4];
#pragma unroll
    for (int sq = -1; sq <= kSmax; ++sq) {
#pragma unroll
      for (int k = 0; k < 4; ++k) a[sq + 1][k] = srow[4 * sq + kAWord[k]];
    }
    unsigned b[kMmaR][kLastU + 2];
#pragma unroll
    for (int r = 0; r < kMmaR; ++r) {
#pragma unroll
      for (int v = 0; v < kLastU + 2; ++v) b[r][v] = brow[8 * r * fp + 4 * v];
    }
#pragma unroll
    for (int u = 0; u <= kLastU; u += 2) {
#pragma unroll
      for (int q = 0; q < kMmaQ; ++q) {
        const int sq = u - q;
        if (sq < -1 || sq > kSmax) continue;
#pragma unroll
        for (int r = 0; r < kMmaR; ++r) {
          const unsigned bb[2] = {b[r][u], b[r][u + 1]};
          mma_u8(acc[r][q], a[sq + 1], bb);
        }
      }
    }
  }
}

// The correlation of a warp's tiles with template rows [c0, c1): ts the staged
// template rows (4 cw words each), fs the staged frame rows (fp words each;
// staged row r is frame row y0 + c0 + r, word 0 column x0); the warp's
// placements start at band row wy, column wx.  acc[r][q] (4 s32 a lane):
// placement rows wy + 8 r .., columns wx + 16 q ...  A chunk u's tiles are
// those of u - 2 shifted by two column tiles, so each chunk loads two A tiles.
__device__ __forceinline__ void correlate(const unsigned* ts, const unsigned* fs, int fp, int tw,
                                          int cw, int wy, int wx, int c0, int c1,
                                          unsigned (&acc)[kMmaR][kMmaQ][4]) {
  // the words of a lane's A registers a[0..3] from its word of a[0]: row m + 8
  // lies 8 bytes back in the template row, column k + 16 16 bytes on
  constexpr int kAWord[4] = {0, -2, 4, 2};
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int smax = (tw + 14) / 16;  // the last nonzero A tile: u - q <= smax
  // this lane's A word of tile s = u - q, register 0, in a staged row:
  // copy (kPadLeft - g) & 3, word t + (kPadLeft - g) / 4 rounded down, + 4 s
  const int lane_word = ((kPadLeft - g) & 3) * cw + t + ((kPadLeft - g) >> 2);
  // this lane's B word of chunk u, row tile r: staged row wy + 8 r + g + i - c0,
  // word wx / 4 + 4 u + t (+ 4 for b[1])
  const unsigned* frow = fs + (wy + g) * fp + wx / 4 + t;
  for (int i = c0; i < c1; ++i) {
    const unsigned* srow = ts + (i - c0) * 4 * cw + lane_word;
    const unsigned* brow = frow + (i - c0) * fp;
    unsigned a[kMmaQ][4];
    for (int u = 0; u <= kMmaQ - 1 + smax; u += 2) {
#pragma unroll
      for (int q = kMmaQ - 1; q >= 2; --q) {
#pragma unroll
        for (int k = 0; k < 4; ++k) a[q][k] = a[q - 2][k];
      }
#pragma unroll
      for (int q = 0; q < 2 && q < kMmaQ; ++q) {
        const int sq = u - q;  // the tile A[m, k] = T[i, 16 sq + k - m]
        if (sq >= -1 && sq <= smax) {
#pragma unroll
          for (int k = 0; k < 4; ++k) a[q][k] = srow[4 * sq + kAWord[k]];
        }
      }
      unsigned b[kMmaR][2];
#pragma unroll
      for (int r = 0; r < kMmaR; ++r) {
        b[r][0] = brow[8 * r * fp + 4 * u];
        b[r][1] = brow[8 * r * fp + 4 * u + 4];
      }
#pragma unroll
      for (int q = 0; q < kMmaQ; ++q) {
        const int sq = u - q;
        if (sq < -1 || sq > smax) continue;
#pragma unroll
        for (int r = 0; r < kMmaR; ++r) mma_u8(acc[r][q], a[q], b[r]);
      }
    }
  }
}

// kSmax: the template's last A tile, (tw + 14) / 16, where it is at most
// kFixedSmax; else -1 (any width)
template <int kSmax>
__global__ void __launch_bounds__(kMmaThreads)
    mma_kernel(const uint8_t* __restrict__ img, const uint8_t* __restrict__ tmpl,
               uint8_t* __restrict__ out, int n, int h, int w, int th, int tw, int chunk_rows,
               int cw, int fw, int fp, int vp, unsigned div_m, int div_shift) {
  extern __shared__ unsigned smem[];
  // the frame rows of a chunk take the frame area; once the band's last chunk
  // is done, its win(I^2) does (kBandRows x (kBandCols + 1) words)
  constexpr int kChunks = (frame_words(kSmax >= 0 ? kSmax : (kMmaMaxWidth + 14) / 16) + 31) / 32;
  unsigned* ts = smem;                                          // chunk_rows template rows
  unsigned* fs = ts + chunk_rows * 4 * cw;                      // their frame rows
  unsigned* ws = fs;                                            // the band's win(I^2)
  unsigned* vs = fs + max((chunk_rows + kBandRows - 1) * fp, kBandRows * (kBandCols + 1));
  __shared__ unsigned sum_t2;
  const int rh = h - th + 1;
  const int rw = w - tw + 1;
  const int col_bands = (rw + kBandCols - 1) / kBandCols;
  const int row_bands = (rh + kBandRows - 1) / kBandRows;
  const long long bands = static_cast<long long>(n) * row_bands * col_bands;
  const uint8_t* end = img + static_cast<size_t>(n) * h * w;
  const unsigned* last = reinterpret_cast<const unsigned*>(
      reinterpret_cast<uintptr_t>(end - 1) & ~static_cast<uintptr_t>(3));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wy = (warp / kMmaWarpsX) * 8 * kMmaR;  // the warp's first placement in the band
  const int wx = (warp % kMmaWarpsX) * 16 * kMmaQ;
  const bool staged_once = chunk_rows >= th;
  // sum T^2, mod 2^32
  if (threadIdx.x == 0) sum_t2 = 0;
  __syncthreads();
  unsigned part = 0;
  for (int k = threadIdx.x; k < th * tw; k += kMmaThreads) part += tmpl[k] * tmpl[k];
  atomicAdd(&sum_t2, part);
  if (staged_once) stage_copies(tmpl, ts, 0, th, tw, cw);
  for (long long band = blockIdx.x; band < bands; band += gridDim.x) {
    const int f = static_cast<int>(band / (static_cast<long long>(row_bands) * col_bands));
    const int rest = static_cast<int>(band % (static_cast<long long>(row_bands) * col_bands));
    const int y0 = rest / col_bands * kBandRows;
    const int x0 = rest % col_bands * kBandCols;
    const uint8_t* frame = img + static_cast<size_t>(f) * h * w;
    const int rows = min(kBandRows, rh - y0);
    const int cols = min(kBandCols + tw - 1, w - x0);  // the columns win(I^2) reads
    unsigned acc[kMmaR][kMmaQ][4] = {};
    for (int c0 = 0; c0 < th; c0 += chunk_rows) {
      const int c1 = min(th, c0 + chunk_rows);
      __syncthreads();  // the previous chunk is no longer read
      if (!staged_once) stage_copies(tmpl, ts, c0, c1, tw, cw);
      stage_frame<kChunks>(frame, last, w, y0 + c0, x0, c1 - c0 + kBandRows - 1, fw, fp, fs);
      __syncthreads();
      column_squares(fs, fp, c0, c1, rows, cols, vp, vs);
      if constexpr (kSmax >= 0) {
        correlate_fixed<kSmax>(ts, fs, fp, cw, wy, wx, c0, c1, acc);
      } else {
        correlate(ts, fs, fp, tw, cw, wy, wx, c0, c1, acc);
      }
    }
    __syncthreads();  // the column sums are in vs; the frame rows are no longer read
    row_squares(vs, vp, tw, rows, min(kBandCols, rw - x0), ws);
    __syncthreads();  // win(I^2) is in ws
#pragma unroll
    for (int r = 0; r < kMmaR; ++r) {
#pragma unroll
      for (int q = 0; q < kMmaQ; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int yy = wy + 8 * r + 2 * t + (e & 1);  // in the band
          const int xx = wx + 16 * q + g + 8 * (e >> 1);
          if (y0 + yy < rh && x0 + xx < rw) {
            const unsigned ssd = ws[yy * (kBandCols + 1) + xx] - 2u * acc[r][q][e] + sum_t2;
            out[(static_cast<size_t>(f) * rh + y0 + yy) * rw + x0 + xx] =
                static_cast<uint8_t>(255u - udiv(ssd, div_m, div_shift));
          }
        }
      }
    }
  }
}

// ---- the INT32 design ----------------------------------------------------------------------

constexpr int kCols = 4;                  // adjacent placements a thread on each of its rows
constexpr int kRows = 4;                  // adjacent placement rows a thread
constexpr int kWarpCols = 32 * kCols;     // placements a warp row
constexpr int kWarps = 8;                 // warps a block, one above the other
constexpr int kThreads = 32 * kWarps;
constexpr int kStageBytes = 96 * 1024;    // template bytes staged at once, rows padded

// Template rows [i0, i1) into s, row i at (i - i0) * kw words, zero-padded.
__device__ __forceinline__ void stage(const uint8_t* __restrict__ tmpl, unsigned* s, int i0,
                                      int i1, int tw, int kw) {
  const int words = (i1 - i0) * kw;
  for (int idx = threadIdx.x; idx < words; idx += kThreads) {
    const int i = i0 + idx / kw;
    const int j = (idx % kw) * 4;
    const uint8_t* row = tmpl + static_cast<size_t>(i) * tw;
    unsigned word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (j + b < tw) word |= static_cast<unsigned>(row[j + b]) << (8 * b);
    }
    s[idx] = word;
  }
}

__device__ __forceinline__ unsigned square_sum(unsigned a, unsigned t, unsigned mask,
                                               unsigned acc) {
  const unsigned d = __vabsdiffu4(a, t) & mask;
  return __dp4a(d, d, acc);
}

// One frame row against kRows template rows: output row y + j of the thread
// takes template row t[j] (kw words).  r: the frame row at the thread's first
// placement; end: one past the batch's last byte.  kEdge: some of the kRows
// pairs do not exist (keep[j] == 0), at the first and last rows of a chunk.
template <bool kEdge>
__device__ __forceinline__ void row_sums(const uint8_t* r, const unsigned* const (&t)[kRows],
                                         const unsigned (&keep)[kRows], int kw, unsigned tail,
                                         const uint8_t* end, unsigned (&acc)[kRows][kCols]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(r);
  const uintptr_t base = a & ~static_cast<uintptr_t>(3);
  const unsigned* wp = reinterpret_cast<const unsigned*>(base);
  const unsigned shift = static_cast<unsigned>(a & 3) * 8;
  const long long last = static_cast<long long>((reinterpret_cast<uintptr_t>(end - 1) - base) >> 2);
  const int kmax = static_cast<int>(last < kw + 1 ? last : kw + 1);  // last word read: kw + 1
  unsigned hi = __ldg(wp + min(1, kmax));
  unsigned cur = __funnelshift_r(__ldg(wp), hi, shift);  // r[0..3]
  auto word = [&](int k, unsigned mask) {
    const unsigned lo = hi;
    hi = __ldg(wp + min(k + 2, kmax));
    const unsigned next = __funnelshift_r(lo, hi, shift);  // r[4k + 4 .. 4k + 7]
    const unsigned v[kCols] = {cur, __funnelshift_r(cur, next, 8), __funnelshift_r(cur, next, 16),
                               __funnelshift_r(cur, next, 24)};
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const unsigned tk = t[j][k];
      const unsigned m = kEdge ? mask & keep[j] : mask;
#pragma unroll
      for (int p = 0; p < kCols; ++p) acc[j][p] = square_sum(v[p], tk, m, acc[j][p]);
    }
    cur = next;
  };
  for (int k = 0; k + 1 < kw; ++k) word(k, 0xffffffffu);
  word(kw - 1, tail);  // the bytes past tw masked
}

__global__ void __launch_bounds__(kThreads)
    int32_kernel(const uint8_t* __restrict__ img, const uint8_t* __restrict__ tmpl,
                 uint8_t* __restrict__ out, int n, int h, int w, int th, int tw, int row_tiles,
                 int chunk_rows) {
  extern __shared__ unsigned tmpl_s[];
  const int kw = (tw + 3) >> 2;
  const int rh = h - th + 1;
  const int rw = w - tw + 1;
  const unsigned tail = (tw & 3) ? (1u << (8 * (tw & 3))) - 1 : 0xffffffffu;
  const unsigned div = 255u * static_cast<unsigned>(th) * static_cast<unsigned>(tw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int x0 = blockIdx.x * kWarpCols + lane * kCols;
  const bool staged_once = chunk_rows >= th;
  const uint8_t* end = img + static_cast<size_t>(n) * h * w;
  if (staged_once) {
    stage(tmpl, tmpl_s, 0, th, tw, kw);
    __syncthreads();
  }
  for (int f = blockIdx.z; f < n; f += gridDim.z) {
    const uint8_t* frame = img + static_cast<size_t>(f) * h * w;
    for (int ty = blockIdx.y; ty < row_tiles; ty += gridDim.y) {
      const int y = (ty * kWarps + warp) * kRows;
      const bool live = y < rh && x0 < rw;
      unsigned acc[kRows][kCols] = {};
      for (int c0 = 0; c0 < th; c0 += chunk_rows) {
        const int c1 = min(th, c0 + chunk_rows);
        if (!staged_once) {
          __syncthreads();  // the previous chunk is no longer read
          stage(tmpl, tmpl_s, c0, c1, tw, kw);
          __syncthreads();
        }
        if (!live) continue;
        // frame row y + i feeds output row y + j with template row i - j
        for (int i = c0; i < c1 + kRows - 1; ++i) {
          const unsigned* t[kRows];
          unsigned keep[kRows];
          bool all = true, any = false;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const bool ok = i - j >= c0 && i - j < c1 && y + j < rh;
            t[j] = tmpl_s + (ok ? i - j - c0 : 0) * kw;
            keep[j] = ok ? 0xffffffffu : 0;
            all = all && ok;
            any = any || ok;
          }
          const uint8_t* r = frame + static_cast<size_t>(y + i) * w + x0;
          if (all) {
            row_sums<false>(r, t, keep, kw, tail, end, acc);
          } else if (any) {  // y + i is a frame row: some y + j <= rh - 1 and i - j <= th - 1
            row_sums<true>(r, t, keep, kw, tail, end, acc);
          }
        }
      }
      if (live) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          if (y + j >= rh) break;
          uint8_t* o = out + (static_cast<size_t>(f) * rh + y + j) * rw + x0;
#pragma unroll
          for (int p = 0; p < kCols; ++p) {
            if (x0 + p < rw) o[p] = static_cast<uint8_t>(255u - acc[j][p] / div);
          }
        }
      }
    }
  }
}

template <int kSmax>
cudaError_t launch_mma(const uint8_t* img, const uint8_t* tmpl, uint8_t* out, int n, int h, int w,
                       int th, int tw, cudaStream_t st) {
  const int cw = copy_words(tw);
  const int vp = (kBandCols + tw - 1) | 1;  // odd: a warp's 32 rows in 32 banks
  // the staged frame words a row: up to the last B register of the last warp
  // of the band, smax + kMmaQ + 1 chunks of 16 columns past it
  const int smax = kSmax >= 0 ? kSmax : (tw + 14) / 16;
  const int fw = frame_words(smax);
  const int fp = fw | 4;  // 4 mod 8: the 8 rows of a B read in distinct banks
  const int chunk_rows = min(th, (kMmaStageBytes / 4 - (kBandRows - 1) * fp) / (4 * cw + fp));
  if (chunk_rows < 1) return cudaErrorInvalidValue;
  const size_t staged = static_cast<size_t>(chunk_rows + kBandRows - 1) * fp;
  const size_t win_words = static_cast<size_t>(kBandRows) * (kBandCols + 1);
  const size_t frame_area = staged > win_words ? staged : win_words;
  const size_t smem =
      4 * (static_cast<size_t>(chunk_rows) * 4 * cw + frame_area + kBandRows * vp);
  unsigned div_m = 0;
  int div_shift = 0;
  udiv_magic(255u * static_cast<unsigned>(th) * static_cast<unsigned>(tw), div_m, div_shift);
  {  // the kernel's static shared memory counts too: opt in whatever the size
    const cudaError_t err = cudaFuncSetAttribute(
        mma_kernel<kSmax>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // persistent blocks, as many as the card holds at once (host lookups, no sync)
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mma_kernel<kSmax>, kMmaThreads, smem);
  if (err != cudaSuccess) return err;
  const int rh = h - th + 1;
  const int rw = w - tw + 1;
  const long long bands = static_cast<long long>(n) * ((rh + kBandRows - 1) / kBandRows) *
                          ((rw + kBandCols - 1) / kBandCols);
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(bands < resident ? bands : resident);
  mma_kernel<kSmax><<<blocks, kMmaThreads, smem, st>>>(img, tmpl, out, n, h, w, th, tw,
                                                       chunk_rows, cw, fw, fp, vp, div_m,
                                                       div_shift);
  return cudaGetLastError();
}

cudaError_t launch_int32(const uint8_t* img, const uint8_t* tmpl, uint8_t* out, int n, int h,
                         int w, int th, int tw, cudaStream_t st) {
  const int kw = (tw + 3) / 4;
  const int rh = h - th + 1;
  const int rw = w - tw + 1;
  const int chunk_rows = min(th, kStageBytes / (4 * kw));
  const size_t smem = static_cast<size_t>(chunk_rows) * kw * 4;
  if (chunk_rows < 1) return cudaErrorInvalidValue;
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        int32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long col_tiles = (static_cast<long long>(rw) + kWarpCols - 1) / kWarpCols;
  const int row_tiles = (rh + kWarps * kRows - 1) / (kWarps * kRows);
  if (col_tiles > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(col_tiles),
                  static_cast<unsigned>(row_tiles) < kMaxGrid ? row_tiles : kMaxGrid,
                  static_cast<unsigned>(n) < kMaxGrid ? n : kMaxGrid);
  int32_kernel<<<grid, kThreads, smem, st>>>(img, tmpl, out, n, h, w, th, tw, row_tiles,
                                             chunk_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// img: (n, h, w) uint8; tmpl: (th, tw) uint8; out: (n, h - th + 1, w - tw + 1)
// uint8.  Requires n >= 1, 1 <= th <= h, 1 <= tw <= w, th * tw <= 66,051.
int gs_match_template(const void* img, const void* tmpl, void* out, int n, int h, int w, int th,
                      int tw, void* stream) {
  const auto* i = static_cast<const uint8_t*>(img);
  const auto* t = static_cast<const uint8_t*>(tmpl);
  auto* o = static_cast<uint8_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (tw < kMmaMinWidth || tw > kMmaMaxWidth) return launch_int32(i, t, o, n, h, w, th, tw, st);
  switch ((tw + 14) / 16) {  // the last A tile
    case 0:
    case 1:
      return launch_mma<1>(i, t, o, n, h, w, th, tw, st);
    case 2:
      return launch_mma<2>(i, t, o, n, h, w, th, tw, st);
    case 3:
      return launch_mma<3>(i, t, o, n, h, w, th, tw, st);
    case kFixedSmax:
      return launch_mma<kFixedSmax>(i, t, o, n, h, w, th, tw, st);
    default:
      return launch_mma<-1>(i, t, o, n, h, w, th, tw, st);
  }
}

}  // extern "C"
