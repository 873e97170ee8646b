// K19 gs_match_template: the SSD template match of gs_match_template
// (grayskull.h:701-723) for a batch of uint8 frames and one uint8 template, for
// Hopper (sm_90a), bound to Python through a plain C interface
// (grayskull_tpu_torch/kernels/_build.py).
//
// Replaces the XLA function _match_template (grayskull_tpu/ops/template.py:30).
// It is not a Pallas kernel: the TPU computes the SSD as a windowed sum of I^2
// from an integral image, minus twice a correlation that it splits into four
// float32 convolutions of 4-bit halves (its matrix unit has no integer
// product), plus the sum of T^2.  None of that is needed here: the card sums
// (I - T)^2 directly, as the reference does, four bytes at a time.
//
// What it computes.  For each frame and placement (y, x) of an (h, w) frame and
// a (th, tw) template: ssd = sum over i, j of (I[y + i, x + j] - T[i, j])^2 in
// uint32, exact because the caller keeps th * tw <= 66,051, so that
// th * tw * 255^2 <= 2^32 - 1; then out = 255 - ssd / (255 * th * tw) with
// unsigned division (the quotient is at most 255).
//
// What bounds it: operations.  At 64 frames of 480x640 and a 32x32 template
// there are 17.9 G squared differences and 37 MB to move.  __vabsdiffu4 gives
// four |I - T| bytes in one instruction and __dp4a adds their four squares to
// the sum in one more: half an INT32 operation a difference, this design's
// ceiling.  The card's is lower: the SSD is sum I^2 - 2 sum I*T + sum T^2,
// exact in integers, and int8 tensor cores take the correlation's byte
// products about 30 times faster than the INT32 pipe takes the differences.
//
// What the design does about it.  A thread owns a 4 x 4 tile of placements
// (kRows rows of kCols adjacent columns), a warp 4 rows of 128 placements, a
// block 8 such warps one above the other; column tiles ride grid.x, row tiles
// grid.y and frames grid.z, each walked with a stride.  The template is staged
// in shared memory, each row padded with zero bytes to a whole number of
// 4-byte words; a template of more than kStageBytes so padded is staged
// kStageBytes at a time (a chunk of rows), with a __syncthreads around each
// chunk.  A thread reads each frame row y + i once, as aligned 4-byte words
// through L1 (the warp's reads are 128 contiguous bytes), funnel-shifts them
// to the word at its first placement, and per word k forms its other three
// columns' words by funnel shifts of that word and the next; each of them
// serves the thread's 4 rows, row y + j against template row i - j (words
// that are the same for the whole block: shared-memory broadcasts).  So a
// frame word and its shifts serve 64 squared differences: 16 __vabsdiffu4
// and 16 __dp4a.  The last word of a row masks the bytes past tw, and the
// first and last rows of a chunk, where some of the 4 rows have no template
// row, mask those rows.  No tensor cores and no TMA: the simple design first.
// chip_sweep.py --source template times 1, 2 and 8 rows a thread and 4 and
// 16 warps a block against these constants (PERF.md).
//
// Reads past the row.  A word may hold bytes past the row end (the next row's)
// or before the frame's first byte; they feed only masked bytes or placements
// past the last column, which are not stored.  A word index is clamped to the
// last word that holds a byte of the batch, so no read leaves the buffer.
//
// Each entry returns cudaGetLastError().

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 4;                  // adjacent placements a thread on each of its rows
constexpr int kRows = 4;                  // adjacent placement rows a thread
constexpr int kWarpCols = 32 * kCols;     // placements a warp row
constexpr int kWarps = 8;                 // warps a block, one above the other
constexpr int kThreads = 32 * kWarps;
constexpr int kStageBytes = 96 * 1024;    // template bytes staged at once, rows padded
constexpr int kDefaultSmem = 48 * 1024;
constexpr unsigned kMaxGrid = 65535;

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
    match_template_kernel(const uint8_t* __restrict__ img, const uint8_t* __restrict__ tmpl,
                          uint8_t* __restrict__ out, int n, int h, int w, int th, int tw,
                          int row_tiles, int chunk_rows) {
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

}  // namespace

extern "C" {

// img: (n, h, w) uint8; tmpl: (th, tw) uint8; out: (n, h - th + 1, w - tw + 1)
// uint8.  Requires n >= 1, 1 <= th <= h, 1 <= tw <= w, th * tw <= 66,051.
int gs_match_template(const void* img, const void* tmpl, void* out, int n, int h, int w, int th,
                      int tw, void* stream) {
  const int kw = (tw + 3) / 4;
  const int rh = h - th + 1;
  const int rw = w - tw + 1;
  const int chunk_rows = min(th, kStageBytes / (4 * kw));
  const size_t smem = static_cast<size_t>(chunk_rows) * kw * 4;
  if (chunk_rows < 1) return cudaErrorInvalidValue;
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        match_template_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long col_tiles = (static_cast<long long>(rw) + kWarpCols - 1) / kWarpCols;
  const int row_tiles = (rh + kWarps * kRows - 1) / (kWarps * kRows);
  if (col_tiles > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(col_tiles),
                  static_cast<unsigned>(row_tiles) < kMaxGrid ? row_tiles : kMaxGrid,
                  static_cast<unsigned>(n) < kMaxGrid ? n : kMaxGrid);
  match_template_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<const uint8_t*>(tmpl),
      static_cast<uint8_t*>(out), n, h, w, th, tw, row_tiles, chunk_rows);
  return cudaGetLastError();
}

}  // extern "C"
