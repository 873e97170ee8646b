// Stencil kernels of the preprocess main path (blur -> Otsu -> threshold -> Sobel)
// and the adaptive threshold, written for Hopper (sm_90a) and bound to Python
// through a plain C interface (grayskull_tpu_torch/kernels/_build.py loads this
// file's library with ctypes).
//
// K1 gs_blur_hist replaces the Pallas kernels fused_blur_hist
//    (grayskull_tpu/kernels/preproc.py:273, body _blur_hist_kernel :198) and
//    blur_pallas (:485, body _blur_only_kernel :400).  It computes gs_blur, the
//    clipped-window box mean with truncating integer division, and with a
//    non-null `hist` also each frame's 256-bin histogram of the blurred pixels.
// K2 gs_threshold_sobel replaces fused_threshold_sobel (:794, body
//    _threshold_sobel_kernel :752) and sobel_pallas (:569, body _sobel_kernel
//    :545).  With a threshold vector it binarizes `p > t[n] ? 255 : 0` (and
//    optionally writes that map), then takes the interior Sobel magnitude
//    min((|gx|+|gy|)/2, 255) with a zero 1-pixel border.
// K11 gs_adaptive replaces adaptive_pallas (:515, body _adaptive_kernel :414),
//    gs_adaptive_threshold: `src > (int)(sum / count) - c ? 255 : 0` with K1's
//    clipped window sum and division, then an int32 subtraction that wraps and
//    a compare.  No radius gate: any radius whose window sum fits int32, as K1.
// K15 gs_blur_hist_window replaces fused_blur_hist_window (:351, body
//    _blur_hist_window_kernel :307): K1 on one H-shard that carries r exchanged
//    halo rows on each side.  The column sums clip to the array's rows; the
//    window's pixel count is taken at global rows y + row0, clipped to
//    [0, h_total); the histogram counts only array rows in [row_lo, row_hi).
// K16 gs_threshold_sobel_window replaces fused_threshold_sobel_window (:865,
//    body _threshold_sobel_window_kernel :829): K2 with thresholds on one
//    H-shard with a 1-row halo; the zero border is decided at global rows
//    y + row0, so shard seams get real edges and only the frame's edge is 0.
//
// K1, K11 and K15 are blur_hist_kernel instantiated in three modes, K2 and K16
// threshold_sobel_kernel with kWindow = false and true, so the shared code
// cannot drift.
//
// What bounds them: by bytes, all are memory-bound: per pixel K1 and K11 read
// 1 B and write 1 B, K2 reads 1 B and writes 1-2 B.  In practice a kernel that
// handles a byte at a time is bound by instructions, shared-memory traffic and
// latency: a serial walk down each column, a branch, a byte load or a 32-bit
// divide per pixel costs more than the pixel's bytes.
//
// What the designs do about it.
// blur_hist_kernel (K1, K11, K15): a block owns a 128 x 64 output tile of one
// frame (fewer rows where shared memory runs short) and stages the tile's rows
// and columns with their halo in shared memory with cp.async copies of 16
// bytes (4 where the width is a multiple of 4 but not of 16, bytes otherwise).  It takes column sums a column a thread (its rows cut
// into segments where the tile has at most half as many columns as threads),
// then makes 16 (K11: 32) consecutive outputs a thread by sliding the row sum
// in registers, and divides exactly by a multiply-high with one correction.
// Interior windows take a path without branches.  K1 and K15 store a thread's
// 16 outputs as one 16-byte vector (four words, or bytes, where the width is
// not a multiple of 16).  K11 writes them back into the band and, after a
// barrier, the block copies its tile to the frame with a warp's lanes on
// consecutive vectors of a row: from the row pass, where each lane owns
// another row, each of a warp's stores touches 32 rows, and K11's 612-wide
// frames take four 4-byte stores per 16 outputs (at 1024 wide, K1's single
// 16-byte stores measured faster than the copy).  K1 and K15 count each
// output in the block's histogram with shared atomics (faster here than
// aggregating a warp's equal bytes with __match_any_sync) and flush one global
// atomic per non-empty bin; integer atomics give the same counts in any
// order.  K11 has no histogram: it reads its 16 source bytes from the staged
// band and writes the compare over them.
// threshold_sobel_kernel (K2, K16): no shared memory.  A warp sweeps a strip of
// up to 64 rows over 512 columns; each lane owns 16 consecutive columns, reads
// each row once as one 16-byte word (the next row's load is in flight while
// the current row is computed), gets the columns just left and right of its
// word from the neighbouring lanes by shuffles (lanes 0 and 31 load theirs),
// and keeps three rows in registers as it slides down.  With thresholds it
// binarizes 4 bytes at a time (__vcmpgtu4) to a 0/1 map.  On that map the
// 0/255 map's magnitude min(255 * (|gx|+|gy|) / 2, 255) is 0 where gx = gy = 0
// and 255 elsewhere: |gx|+|gy| has the parity of gx+gy = 2(i-a) + 2(f+h-b-d)
// (a..i the 3x3 neighbourhood row by row), so it is never 1.  The separable
// Sobel's column and row sums are at most 4, so a word holds four columns
// (__byte_perm for the column shifts) and "gx != 0 or gy != 0" is a non-zero
// byte of two XORs.  Without thresholds (sobel) the lane keeps full integer
// arithmetic.
// Both outputs are written as 16-byte stores; a lane masks its border
// columns with a word mask and the frame's first and last rows per row.
// Where the width is not a multiple of 16 or a pointer is not 16-byte
// aligned, the lanes load and store bytes instead.
//
// Unlike the TPU kernels there is no block-divisibility, lane-width or radius
// gate: every tile or strip masks its own ragged edge and only in-frame pixels
// are counted.
//
// All offsets into frames are size_t.  Each entry returns cudaGetLastError().

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlurTileW = 128;     // output columns a block of K1, K11, K15
constexpr int kBlurTileH = 64;      // output rows a block of K1, K11, K15, at most
constexpr int kAdaptiveItem = 32;   // consecutive outputs a thread of K11 makes (K1/K15: 16)
constexpr int kSobelStrip = 64;     // rows a warp of K2, K16 sweeps, at most
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kBoxSmemBudget = 96 * 1024;  // two blocks an SM at the largest radii

// blur_hist_kernel's three modes.
enum BoxMode { kBlur = 0, kBlurWindow = 1, kAdaptive = 2 };

// The multiplier of div_exact for the divisor d >= 1: floor((2^32 - 1) / d) + 1,
// which is ceil(2^32 / d) but for a power of two, where it is 2^32 / d; for
// d = 1, where that is 2^32, it is 2^32 - 1.
__device__ __forceinline__ unsigned div_magic(unsigned d) {
  return d == 1u ? 0xffffffffu : 0xffffffffu / d + 1u;
}

// Exact truncating s / d for any uint32 s and d >= 1 from m = div_magic(d).
// With e = m*d - 2^32 in [-1, d), q' = floor(s*m / 2^32) differs from s/d by
// s*e / (d*2^32), less than 1 in size, so q' is the quotient or one off it;
// one step each way, without a branch, corrects it (q'*d and (q'+1)*d may
// pass 2^32, so they are compared in 64 bits).
__device__ __forceinline__ unsigned div_exact(unsigned s, unsigned d, unsigned m) {
  const unsigned q = __umulhi(s, m);
  const unsigned long long qd = static_cast<unsigned long long>(q) * d;
  return q - (qd > s) + (qd + d <= s);
}

// The widest of 16, 4 and 1 bytes that divides both the row width and the
// pointer's address: the vector width of the accesses to a frame's rows.
__device__ __forceinline__ int vec_width(const void* p, int w) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p) | static_cast<uintptr_t>(w);
  return (a & 15) == 0 ? 16 : (a & 3) == 0 ? 4 : 1;
}

// The byte pitch of blur_hist_kernel's staged band: its widest row of columns
// (sw_max, widened by up to 15 bytes each side to whole vectors), rounded to
// 16 bytes, then to 16 bytes past a multiple of 128: the row pass's lanes, one
// row each, then reach its 16-byte words in 8 distinct bank groups.
__host__ __device__ __forceinline__ int band_pitch(int sw_max) {
  const int p = (sw_max + 30 + 15) / 16 * 16;
  return p + ((16 - p % 128) + 128) % 128;
}

// Copy 16 (or 4) bytes from global to shared memory without passing through
// registers (cp.async: a thread keeps its copies in flight); both addresses
// are aligned to the size.
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
#else
  *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
#endif
}

__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
#else
  *static_cast<unsigned*>(dst) = *static_cast<const unsigned*>(src);
#endif
}

// Waits for this thread's cp.async copies; a barrier then publishes them.
__device__ __forceinline__ void copy_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
#endif
}

// A frame's bytes at (y, x): from the block's staged rows and columns, or from
// the frame in global memory where the staged band would not fit.
struct StagedBytes {
  const uint8_t* p;  // the staged band; its (0, 0) is frame (y0, x0)
  int pitch, y0, x0;
  __device__ __forceinline__ unsigned operator()(int y, int x) const {
    return p[(y - y0) * pitch + (x - x0)];
  }
};

struct FrameBytes {
  const uint8_t* p;
  int w;
  __device__ __forceinline__ unsigned operator()(int y, int x) const {
    return p[static_cast<size_t>(y) * w + x];
  }
};

// Vertical pass of blur_hist_kernel: the clipped (2r+1)-row window sum of columns
// [cx0, cx0 + sw) at the tile's rows y0 .. y0 + rows - 1, into colsum (pitch
// swp).  Work item (column, segment of rows): a thread sums the window at the
// segment's first row, then slides it down the segment; a column is cut into
// segments only where the tile has at most half as many columns as threads.
// Reads stay within rows [y_first, y_last], the rows the block may read.
template <class Read>
__device__ __forceinline__ void box_columns(const Read& rd, int* colsum, int swp, int sw, int cx0,
                                            int y0, int rows, int h, int r, int y_first,
                                            int y_last) {
  const int want = max(1, min(rows, kThreads / sw));
  const int seg = (rows + want - 1) / want;
  const int nseg = (rows + seg - 1) / seg;  // every segment starts inside the tile
  for (int idx = threadIdx.x; idx < sw * nseg; idx += blockDim.x) {
    const int g = idx / sw;
    const int c = idx - g * sw;
    const int i_lo = g * seg;
    const int i_hi = min(i_lo + seg, rows);
    const int x = cx0 + c;
    const int ys = y0 + i_lo;
    unsigned s = 0;
    for (int y = max(ys - r, 0); y <= min(ys + r, h - 1); ++y) s += rd(y, x);
    int* out = colsum + c;
    if (ys - r >= 0 && y0 + i_hi - 1 + r <= h - 1) {
      // every row the window slides over is in the frame
      int i = i_lo;
      for (; i + 1 < i_hi; ++i) {
        out[i * swp] = static_cast<int>(s);
        s += rd(y0 + i + 1 + r, x) - rd(y0 + i - r, x);
      }
      out[i * swp] = static_cast<int>(s);
    } else {
      // near the frame's top or bottom: the entering and leaving rows are read
      // at clamped rows and dropped where they lie past the frame (or past the
      // segment, where the sum is not used again)
      for (int i = i_lo; i < i_hi; ++i) {
        out[i * swp] = static_cast<int>(s);
        const int y = y0 + i;
        const unsigned in = rd(min(y + 1 + r, y_last), x);
        const unsigned gone = rd(max(y - r, y_first), x);
        s += (y + 1 + r <= h - 1 ? in : 0u) - (y - r >= 0 ? gone : 0u);
      }
    }
  }
}

// The 16 source bytes of K11's outputs at (y, xs .. xs + 15) as four words,
// 0 past the nout outputs of the tile: from the staged band (16-byte or 4-byte
// loads where the band's columns are aligned so) or from the frame.
__device__ __forceinline__ void source_word(const uint8_t* band, int pitch, int ry0, int a0,
                                            int vw, const uint8_t* frame, int w, int staged,
                                            int y, int xs, int nout, unsigned pix[4]) {
  pix[0] = pix[1] = pix[2] = pix[3] = 0u;
  if (staged && vw == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(band + (y - ry0) * pitch + (xs - a0));
    pix[0] = q.x;
    pix[1] = q.y;
    pix[2] = q.z;
    pix[3] = q.w;
  } else if (staged && vw == 4) {
    const unsigned* p = reinterpret_cast<const unsigned*>(band + (y - ry0) * pitch + (xs - a0));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * k < nout) pix[k] = p[k];
    }
  } else {
    const uint8_t* p = staged ? band + (y - ry0) * pitch + (xs - a0)
                              : frame + static_cast<size_t>(y) * w + xs;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < nout) pix[j >> 2] |= static_cast<unsigned>(p[j]) << (8 * (j & 3));
    }
  }
}

// Stores the 16 output bytes `word` (nout of them) at p, in vectors of vw bytes:
// vw = 16 needs nout = 16, vw = 4 a multiple of 4.
__device__ __forceinline__ void store16(uint8_t* p, int vw, int nout, const unsigned word[4]) {
  if (vw == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(word[0], word[1], word[2], word[3]);
  } else if (vw == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * k < nout) reinterpret_cast<unsigned*>(p)[k] = word[k];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < nout) p[j] = static_cast<uint8_t>(word[j >> 2] >> (8 * (j & 3)));
    }
  }
}

// K1 (kBlur), K15 (kBlurWindow) and K11 (kAdaptive).  Grid: one block per
// (frame, tile_y, tile_x), flattened into blockIdx.x; the tile is kBlurTileW x
// tile_h outputs.  Shared memory: 256 histogram bins (not for K11); tile_h rows
// of column sums over the tile's columns widened by r on each side (clipped;
// an odd pitch, so the row pass's lanes, one row each, fall in different
// banks); with `staged`, the frame's rows [y0 - r, y1 + r) of those columns
// (clipped), loaded as 16-byte or 4-byte vectors where the width allows.  The
// row pass: each thread makes kItem consecutive outputs, 16 at a time, by
// sliding the row sum over the column sums, divides exactly (div_exact),
// writes each 16 as one 16-byte word where aligned (K11: into the staged band,
// then copied out a row at a time) and (K1, K15) counts them in the
// block's histogram with shared atomics.  Where every window of a segment (vertical)
// or of the 16 outputs (row) is whole, the pass runs without a branch: one
// count and its multiplier, one correction down.  Near the frame's edges the
// loads go to clamped indices and their values are selected.  K15's counts are
// taken at global rows (row0, h_total) and its histogram counts the stored
// byte of rows [row_lo, row_hi).  K11 writes src > (int)(mean - c) ? 255 : 0,
// the subtraction wrapping as int32 does on the TPU (done in unsigned
// arithmetic: signed overflow is undefined in C++).
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    blur_hist_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                     int* __restrict__ hist, int h, int w, int r, int tile_h, int tiles_x,
                     int tiles_y, int staged, int row0, int h_total, int row_lo, int row_hi,
                     int c) {
  constexpr bool kWindow = kMode == kBlurWindow;
  constexpr int kBins = kMode == kAdaptive ? 0 : 256;
  constexpr int kItem = kMode == kAdaptive ? kAdaptiveItem : 16;  // outputs a row-pass item
  const bool stage_out = kMode == kAdaptive && staged;  // outputs through the band
  extern __shared__ __align__(16) unsigned char gs_smem[];
  const int per_frame = tiles_x * tiles_y;
  const int f = blockIdx.x / per_frame;
  const int k = blockIdx.x - f * per_frame;
  const int ty = k / tiles_x;
  const int x0 = (k - ty * tiles_x) * kBlurTileW;
  const int y0 = ty * tile_h;
  const int x1 = min(x0 + kBlurTileW, w);
  const int y1 = min(y0 + tile_h, h);
  const int rows = y1 - y0;
  const int cx0 = max(x0 - r, 0);
  const int cx1 = min(x1 + r, w);
  const int sw = cx1 - cx0;
  const int swp = sw | 1;
  const int sw_max = min(kBlurTileW + 2 * r, w);
  const size_t frame_off = static_cast<size_t>(f) * h * w;
  const uint8_t* frame = src + frame_off;

  int* shist = reinterpret_cast<int*>(gs_smem);
  int* colsum = shist + kBins;
  uint8_t* band = gs_smem + ((kBins + tile_h * (sw_max | 1)) * sizeof(int) + 15) / 16 * 16;
  const bool with_hist = kBins != 0 && hist != nullptr;
  if (with_hist) {
    for (int b = threadIdx.x; b < 256; b += blockDim.x) shist[b] = 0;
  }
  const int ry0 = max(y0 - r, 0);  // the frame rows the block reads
  const int ry1 = min(y1 + r, h);
  const int pitch = band_pitch(sw_max);
  const int vw = vec_width(src, w);
  const int a0 = cx0 & -vw;  // the staged columns [a0, a1), whole vectors
  if (staged) {
    const int nr = ry1 - ry0;
    const int a1 = min((cx1 + vw - 1) & -vw, w);
    if (vw == 16) {
      const int chunks = (a1 - a0) >> 4;
      for (int idx = threadIdx.x; idx < nr * chunks; idx += blockDim.x) {
        const int row = idx / chunks;
        const int ch = idx - row * chunks;
        copy16_async(band + row * pitch + ch * 16,
                     frame + static_cast<size_t>(ry0 + row) * w + a0 + ch * 16);
      }
    } else if (vw == 4) {
      const int chunks = (a1 - a0) >> 2;
      for (int idx = threadIdx.x; idx < nr * chunks; idx += blockDim.x) {
        const int row = idx / chunks;
        const int ch = idx - row * chunks;
        copy4_async(band + row * pitch + ch * 4,
                    frame + static_cast<size_t>(ry0 + row) * w + a0 + ch * 4);
      }
    } else {
      const int span = a1 - a0;
      for (int idx = threadIdx.x; idx < nr * span; idx += blockDim.x) {
        const int row = idx / span;
        const int col = idx - row * span;
        band[row * pitch + col] = frame[static_cast<size_t>(ry0 + row) * w + a0 + col];
      }
    }
    copy_async_wait();
    __syncthreads();
    box_columns(StagedBytes{band, pitch, ry0, a0}, colsum, swp, sw, cx0, y0, rows, h, r, ry0,
                ry1 - 1);
  } else {
    box_columns(FrameBytes{frame, w}, colsum, swp, sw, cx0, y0, rows, h, r, ry0, ry1 - 1);
  }
  __syncthreads();

  const int groups = (x1 - x0 + kItem - 1) / kItem;
  const int total = rows * groups;
  const int vw_out = vec_width(dst, w);
  const unsigned uc = static_cast<unsigned>(c);
  for (int item = threadIdx.x; item < total; item += blockDim.x) {
    const int g = item / rows;
    const int i = item - g * rows;
    const int xg = x0 + kItem * g;
    const int y = y0 + i;
    const int yg = kWindow ? y + row0 : y;
    const int ht = kWindow ? h_total : h;
    const unsigned cy = static_cast<unsigned>(min(yg + r, ht - 1) - max(yg - r, 0) + 1);
    const int* row = colsum + i * swp - cx0;  // indexed by frame column
    const bool counted = with_hist && (!kWindow || (y >= row_lo && y < row_hi));
    const unsigned d0 = cy * static_cast<unsigned>(2 * r + 1);  // an interior output's count
    unsigned s = 0;
    for (int col = max(xg - r, 0); col <= min(xg + r, w - 1); ++col) {
      s += static_cast<unsigned>(row[col]);
    }
    // the item's outputs, 16 at a time; the window sum slides on from one to the next
    for (int part = 0; part < kItem / 16; ++part) {
      const int xs = xg + 16 * part;
      if (xs >= x1) break;
      const int nout = min(16, x1 - xs);
      unsigned pix[4];  // K11: the source bytes of the 16 outputs
      if (kMode == kAdaptive) {
        source_word(band, pitch, ry0, a0, vw, frame, w, staged, y, xs, nout, pix);
      }
      // the output byte of the j-th mean q: K1/K15 the stored mean (K15 past the
      // frame: its low byte), K11 the compare
      auto out_byte = [&](unsigned q, int j) -> unsigned {
        if (kMode == kAdaptive) {
          const int src_j = static_cast<int>((pix[j >> 2] >> (8 * (j & 3))) & 255u);
          return src_j > static_cast<int>(q - uc) ? 255u : 0u;
        }
        return q & 255u;
      };
      // the window at x + 1: column x+1+r enters, x-r leaves; reads are clamped to
      // the strip (where the sum is not used again) and values past the frame dropped
      auto slide = [&](int x) {
        const unsigned in = static_cast<unsigned>(row[min(x + 1 + r, cx1 - 1)]);
        const unsigned gone = static_cast<unsigned>(row[min(max(x - r, cx0), cx1 - 1)]);
        s += (x + 1 + r <= w - 1 ? in : 0u) - (x - r >= 0 ? gone : 0u);
      };
      unsigned word[4] = {0u, 0u, 0u, 0u};
      if (xs - r >= 0 && xs + 15 + r <= w - 1 && d0 >= 2u) {
        // all 16 windows whole along the row: one count, its magic number, and
        // one correction down (the estimate is never low for d >= 2; q*d < 2^32)
        const unsigned m0 = div_magic(d0);
        const int* enter = row + xs + 1 + r;
        const int* leave = row + xs - r;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          unsigned q = __umulhi(s, m0);
          q -= q * d0 > s;
          const unsigned v = out_byte(q, j);
          word[j >> 2] |= v << (8 * (j & 3));
          if (counted) atomicAdd(&shist[v], 1);
          if (j < 15) s += static_cast<unsigned>(enter[j]) - static_cast<unsigned>(leave[j]);
        }
        if (kItem > 16) slide(xs + 15);  // on to the next part's first window
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int x = xs + j;
          const int xc = min(x, w - 1);  // past the tile's last output the value is not used
          const unsigned d = cy * static_cast<unsigned>(min(xc + r, w - 1) - max(xc - r, 0) + 1);
          const unsigned v = out_byte(div_exact(s, d, div_magic(d)), j);
          word[j >> 2] |= v << (8 * (j & 3));
          if (counted && j < nout) atomicAdd(&shist[v], 1);
          slide(x);
        }
      }
      // K11: into the band, over the source bytes only this thread reads, for
      // the copy below; K1/K15: straight to the frame
      if (stage_out) {
        store16(band + (y - ry0) * pitch + (xs - a0), vw, nout, word);
      } else {
        store16(dst + frame_off + static_cast<size_t>(y) * w + xs, vw_out, nout, word);
      }
    }
  }

  if (stage_out) {
    // the tile's outputs from the band to the frame, a warp's lanes on
    // consecutive vectors of a row (vectors that both sides' alignment allows)
    __syncthreads();
    const int cw = min(vw, vw_out);
    const int chunks = (x1 - x0) / cw;
    for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
      const int i = idx / chunks;
      const int off = (idx - i * chunks) * cw;
      const uint8_t* from = band + (y0 + i - ry0) * pitch + (x0 - a0) + off;
      uint8_t* to = dst + frame_off + static_cast<size_t>(y0 + i) * w + x0 + off;
      if (cw == 16) {
        *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
      } else if (cw == 4) {
        *reinterpret_cast<unsigned*>(to) = *reinterpret_cast<const unsigned*>(from);
      } else {
        *to = *from;
      }
    }
  }

  if (with_hist) {
    __syncthreads();
    for (int b = threadIdx.x; b < 256; b += blockDim.x) {
      if (shist[b] != 0) atomicAdd(&hist[static_cast<size_t>(f) * 256 + b], shist[b]);
    }
  }
}

// One row of a lane's strip as the loads left it: the 16 bytes of its columns
// and, for lanes 0 and 31, the byte just left or right of them.
struct RawRow {
  unsigned v[4];
  unsigned left, right;
};

// Array row y at columns xs .. xs + 15 (and xs - 1 for lane 0, xs + 16 for
// lane 31); 0 outside the array.  `vec`: 16-byte loads (w % 16 == 0 and the
// frames 16-byte aligned).
__device__ __forceinline__ RawRow load_row(const uint8_t* frame, int y, int h, int w, int xs,
                                           int lane, bool vec) {
  RawRow raw = {{0u, 0u, 0u, 0u}, 0u, 0u};
  if (y < 0 || y >= h) return raw;
  const uint8_t* p = frame + static_cast<size_t>(y) * w;
  if (xs < w) {
    if (vec) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + xs);
      raw.v[0] = q.x;
      raw.v[1] = q.y;
      raw.v[2] = q.z;
      raw.v[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (xs + j < w) raw.v[j >> 2] |= static_cast<unsigned>(p[xs + j]) << (8 * (j & 3));
      }
    }
  }
  if (lane == 0 && xs >= 1) raw.left = p[xs - 1];
  if (lane == 31 && xs + 16 < w) raw.right = p[xs + 16];
  return raw;
}

// A loaded row as the Sobel reads it: six words of bytes, v[1..4] the lane's 16
// columns, the byte 3 of v[0] the column just left of them, the byte 0 of v[5]
// the column just right (their other bytes are 0).  kBinary: each byte is 1
// where the pixel is above the threshold (t4: the threshold in every byte),
// else 0.  The neighbouring columns come from the lanes beside; lanes 0 and 31
// take the bytes they loaded.  Every lane of the warp calls it.
template <bool kBinary>
__device__ __forceinline__ void sobel_row(const RawRow& raw, unsigned t4, int lane, unsigned v[6]) {
  unsigned left = raw.left, right = raw.right;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k + 1] = kBinary ? __vcmpgtu4(raw.v[k], t4) & 0x01010101u : raw.v[k];
  }
  if (kBinary) {
    left = __vcmpgtu4(left, t4) & 1u;
    right = __vcmpgtu4(right, t4) & 1u;
  }
  const unsigned up = __shfl_up_sync(kFull, v[4], 1);
  const unsigned down = __shfl_down_sync(kFull, v[1], 1);
  v[0] = lane == 0 ? left << 24 : up & 0xff000000u;
  v[5] = lane == 31 ? right : down & 0xffu;
}

// The horizontal [1, 2, 1] sums of a row's 16 columns: four words of bytes
// (each at most 4) on the 0/1 map, sixteen ints on grey pixels.
template <bool kBinary>
struct HSum;

template <>
struct HSum<true> {
  unsigned v[4];
  __device__ __forceinline__ explicit HSum(const unsigned r[6]) {
#pragma unroll
    for (int k = 1; k <= 4; ++k) {
      v[k - 1] = __byte_perm(r[k - 1], r[k], 0x6543) + 2u * r[k] + __byte_perm(r[k], r[k + 1], 0x4321);
    }
  }
};

// The byte at position i = 0 .. 17 of a sobel_row: i = 0 the column left of the
// lane's 16, 1 .. 16 its own, 17 the column right of them.
__device__ __forceinline__ int row_byte(const unsigned r[6], int i) {
  if (i == 0) return static_cast<int>(r[0] >> 24);
  if (i == 17) return static_cast<int>(r[5] & 0xffu);
  return static_cast<int>((r[1 + ((i - 1) >> 2)] >> (8 * ((i - 1) & 3))) & 0xffu);
}

template <>
struct HSum<false> {
  int v[16];
  __device__ __forceinline__ explicit HSum(const unsigned r[6]) {
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = row_byte(r, j) + 2 * row_byte(r, j + 1) + row_byte(r, j + 2);
  }
};

// Sobel magnitudes of the middle row m (rows a above, b below; ha, hb their
// horizontal sums) at the lane's 16 columns, as four words of bytes.
// On the 0/1 map: gx = V(x+1) - V(x-1) with V the vertical [1, 2, 1] sum and
// gy = hb - ha; V, ha and hb are at most 4 a byte, so V(x+1) ^ V(x-1) and
// hb ^ ha are at most 7 a byte, and adding 0x7f to a byte sets its top bit,
// without a carry, exactly where it is not 0.  The magnitude is then 255
// where gx or gy is not 0, else 0 (the header's parity argument).
__device__ __forceinline__ void sobel_words(const unsigned a[6], const unsigned m[6],
                                            const unsigned b[6], const HSum<true>& ha,
                                            const HSum<true>& hb, unsigned e[4]) {
  unsigned vs[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) vs[k] = a[k] + 2u * m[k] + b[k];
#pragma unroll
  for (int k = 1; k <= 4; ++k) {
    const unsigned dx = __byte_perm(vs[k], vs[k + 1], 0x4321) ^ __byte_perm(vs[k - 1], vs[k], 0x6543);
    const unsigned d = dx | (hb.v[k - 1] ^ ha.v[k - 1]);
    e[k - 1] = (((d + 0x7f7f7f7fu) >> 7) & 0x01010101u) * 0xffu;
  }
}

// The same on grey pixels: min((|gx| + |gy|) / 2, 255) in int arithmetic.
__device__ __forceinline__ void sobel_words(const unsigned a[6], const unsigned m[6],
                                            const unsigned b[6], const HSum<false>& ha,
                                            const HSum<false>& hb, unsigned e[4]) {
  int vs[18];
#pragma unroll
  for (int i = 0; i < 18; ++i) vs[i] = row_byte(a, i) + 2 * row_byte(m, i) + row_byte(b, i);
#pragma unroll
  for (int k = 0; k < 4; ++k) e[k] = 0u;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int gx = vs[j + 2] - vs[j];
    const int gy = hb.v[j] - ha.v[j];
    const int mag = min((abs(gx) + abs(gy)) >> 1, 255);
    e[j >> 2] |= static_cast<unsigned>(mag) << (8 * (j & 3));
  }
}

__device__ __forceinline__ void store_row(uint8_t* p, int xs, int w, bool vec, const unsigned v[4]) {
  if (xs >= w) return;
  if (vec) {
    *reinterpret_cast<uint4*>(p + xs) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (xs + j < w) p[xs + j] = static_cast<uint8_t>(v[j >> 2] >> (8 * (j & 3)));
    }
  }
}

// K2 (kWindow = false) and K16 (kWindow = true); kBinary: with thresholds.
// Grid: one warp per (frame, strip of `strip` rows, group of 32 words of 16
// columns), flattened over the blocks' warps; no shared memory.  The lane's
// rows y - 1, y, y + 1 sit in registers as sobel_rows; the load of row y + 2
// is issued before row y's outputs are made.  K16: array row y is frame row
// y + row0 of a frame of h_total rows, and the zero border uses that row.
template <bool kWindow, bool kBinary>
__global__ void __launch_bounds__(kThreads)
    threshold_sobel_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ thr,
                           uint8_t* __restrict__ binary, uint8_t* __restrict__ edges, int n,
                           int h, int w, int strip, int strips, int groups, int row0,
                           int h_total) {
  const int lane = threadIdx.x & 31;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (warp >= static_cast<long long>(n) * strips * groups) return;  // the whole warp
  const int g = static_cast<int>(warp % groups);
  const long long fs = warp / groups;
  const int sidx = static_cast<int>(fs % strips);
  const int f = static_cast<int>(fs / strips);
  const int xs = (g * 32 + lane) * 16;
  const int y0 = sidx * strip;
  const int y1 = min(y0 + strip, h);
  const size_t frame_off = static_cast<size_t>(f) * h * w;
  const uint8_t* frame = src + frame_off;
  const bool vec = (w & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(edges) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(binary) & 15) == 0;
  const unsigned t4 = kBinary ? static_cast<unsigned>(thr[f]) * 0x01010101u : 0u;
  const int fh = kWindow ? h_total : h;
  unsigned colmask[4] = {0u, 0u, 0u, 0u};  // the lane's columns in [1, w - 2]
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (xs + j >= 1 && xs + j <= w - 2) colmask[j >> 2] |= 0xffu << (8 * (j & 3));
  }

  unsigned a[6], m[6], b[6];
  sobel_row<kBinary>(load_row(frame, y0 - 1, h, w, xs, lane, vec), t4, lane, a);
  sobel_row<kBinary>(load_row(frame, y0, h, w, xs, lane, vec), t4, lane, m);
  sobel_row<kBinary>(load_row(frame, y0 + 1, h, w, xs, lane, vec), t4, lane, b);
  HSum<kBinary> ha(a), hm(m);
  for (int y = y0; y < y1; ++y) {
    // row y + 2 is needed only while it is within the strip's last row + 1
    const RawRow next = load_row(frame, y + 2 <= y1 ? y + 2 : -1, h, w, xs, lane, vec);
    const HSum<kBinary> hb(b);
    unsigned e[4];
    sobel_words(a, m, b, ha, hb, e);
    const int fy = kWindow ? y + row0 : y;
    const unsigned rowmask = fy >= 1 && fy <= fh - 2 ? kFull : 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] &= colmask[k] & rowmask;
    const size_t row_off = frame_off + static_cast<size_t>(y) * w;
    store_row(edges + row_off, xs, w, vec, e);
    if (kBinary && binary != nullptr) {
      const unsigned bin[4] = {m[1] * 0xffu, m[2] * 0xffu, m[3] * 0xffu, m[4] * 0xffu};
      store_row(binary + row_off, xs, w, vec, bin);
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      a[k] = m[k];
      m[k] = b[k];
    }
    ha = hm;
    hm = hb;
    sobel_row<kBinary>(next, t4, lane, b);
  }
}

int tiles(int extent, int tile) { return (extent + tile - 1) / tile; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Tile height, whether the band of frame rows is staged, and the shared-memory
// bytes of blur_hist_kernel's layout (`bins` histogram bins first): the
// tallest of kBlurTileH .. 1 rows whose staged band fits kBoxSmemBudget; past
// that (a radius of hundreds), the column sums read the frame from global
// memory.
void box_geometry(int h, int w, int r, int bins, int* tile_h, int* staged, size_t* smem) {
  const int sw_max = std::min(kBlurTileW + 2 * r, w);
  const size_t colsum_row = static_cast<size_t>(sw_max | 1) * sizeof(int);
  const size_t pitch = static_cast<size_t>(band_pitch(sw_max));
  for (*staged = 1; *staged >= 0; --*staged) {
    for (int th = kBlurTileH; th >= 1; th /= 2) {
      *tile_h = std::min(th, h);
      *smem = (bins * sizeof(int) + *tile_h * colsum_row + 15) / 16 * 16;
      if (*staged) *smem += static_cast<size_t>(std::min(*tile_h + 2 * r, h)) * pitch;
      if (*smem <= static_cast<size_t>(kBoxSmemBudget)) return;
    }
  }
  *staged = 0;  // one row of column sums past the budget; the launch checks kMaxSmem
}

template <int kMode>
int launch_blur_hist(const void* src, void* dst, void* hist, int n, int h, int w, int r, int row0,
                     int h_total, int row_lo, int row_hi, int c, void* stream) {
  int tile_h, staged;
  size_t smem;
  box_geometry(h, w, r, kMode == kAdaptive ? 0 : 256, &tile_h, &staged, &smem);
  const cudaError_t err = allow_smem(blur_hist_kernel<kMode>, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = tiles(w, kBlurTileW);
  const int tiles_y = tiles(h, tile_h);
  const long long blocks = static_cast<long long>(n) * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  blur_hist_kernel<kMode><<<static_cast<unsigned>(blocks), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), static_cast<int*>(hist), h,
      w, r, tile_h, tiles_x, tiles_y, staged, row0, h_total, row_lo, row_hi, c);
  return cudaGetLastError();
}

template <bool kWindow, bool kBinary>
int launch_threshold_sobel(const void* src, const void* thr, void* binary, void* edges, int n,
                           int h, int w, int row0, int h_total, void* stream) {
  const int strips = tiles(h, kSobelStrip);
  const int strip = tiles(h, strips);  // the strips as even as the height allows
  const int groups = tiles(tiles(w, 16), 32);
  const long long warps = static_cast<long long>(n) * strips * groups;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  threshold_sobel_kernel<kWindow, kBinary><<<static_cast<unsigned>(blocks), kThreads, 0,
                                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(thr),
      static_cast<uint8_t*>(binary), static_cast<uint8_t*>(edges), n, h, w, strip, strips,
      groups, row0, h_total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// src, dst: (n, h, w) uint8; hist: (n, 256) int32, zeroed by the caller, or null.
// A radius past the frame gives the same windows as max(h, w), so it is clamped.
int gs_blur_hist(const void* src, void* dst, void* hist, int n, int h, int w, int r,
                 void* stream) {
  r = std::min(r, std::max(h, w));
  return launch_blur_hist<kBlur>(src, dst, hist, n, h, w, r, 0, h, 0, h, 0, stream);
}

// src, dst: (n, h, w) uint8, one H-shard with its halo rows; hist: (n, 256)
// int32, zeroed by the caller.  Array row y is frame row y + row0 of a frame of
// h_total rows; the caller checks that every window's count is >= 1
// (-r <= row0 and row0 + h <= h_total + r), that 0 <= row_lo <= row_hi <= h,
// and clamps r to where every window is whole.
int gs_blur_hist_window(const void* src, void* dst, void* hist, int n, int h, int w, int r,
                        int row0, int h_total, int row_lo, int row_hi, void* stream) {
  return launch_blur_hist<kBlurWindow>(src, dst, hist, n, h, w, r, row0, h_total, row_lo,
                                       row_hi, 0, stream);
}

// src, dst: (n, h, w) uint8; c: the int32 offset.  Radius clamped as in gs_blur_hist.
int gs_adaptive(const void* src, void* dst, int n, int h, int w, int r, int c, void* stream) {
  r = std::min(r, std::max(h, w));
  return launch_blur_hist<kAdaptive>(src, dst, nullptr, n, h, w, r, 0, h, 0, h, c, stream);
}

// src: (n, h, w) uint8; thr: (n,) uint8 or null; binary: (n, h, w) uint8 or null
// (only with thr); edges: (n, h, w) uint8.
int gs_threshold_sobel(const void* src, const void* thr, void* binary, void* edges, int n, int h,
                       int w, void* stream) {
  if (thr == nullptr) {
    return launch_threshold_sobel<false, false>(src, thr, nullptr, edges, n, h, w, 0, h, stream);
  }
  return launch_threshold_sobel<false, true>(src, thr, binary, edges, n, h, w, 0, h, stream);
}

// As gs_threshold_sobel on one H-shard with its 1-row halo: thr is (n,) uint8;
// array row y is frame row y + row0 of a frame of h_total rows.
int gs_threshold_sobel_window(const void* src, const void* thr, void* binary, void* edges, int n,
                              int h, int w, int row0, int h_total, void* stream) {
  return launch_threshold_sobel<true, true>(src, thr, binary, edges, n, h, w, row0, h_total,
                                            stream);
}

}  // extern "C"
