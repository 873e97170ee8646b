// Stencil kernels of the preprocess main path (blur -> Otsu -> threshold -> Sobel),
// written for Hopper (sm_90a) and bound to Python through a plain C interface
// (grayskull_tpu_torch/kernels/_build.py loads this file's library with ctypes).
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
//    gs_adaptive_threshold: `src > (int)(sum / count) - c ? 255 : 0` with the
//    clipped window sum of column_sums/window_mean (a thread walks each column
//    of a 128x64 tile), an unsigned division, then an int32 subtraction and
//    compare.  No radius gate: any radius whose window sum fits int32, as K1.
// K15 gs_blur_hist_window replaces fused_blur_hist_window (:351, body
//    _blur_hist_window_kernel :307): K1 on one H-shard that carries r exchanged
//    halo rows on each side.  The column sums clip to the array's rows; the
//    window's pixel count is taken at global rows y + row0, clipped to
//    [0, h_total); the histogram counts only array rows in [row_lo, row_hi).
// K16 gs_threshold_sobel_window replaces fused_threshold_sobel_window (:865,
//    body _threshold_sobel_window_kernel :829): K2 with thresholds on one
//    H-shard with a 1-row halo; the zero border is decided at global rows
//    y + row0, so shard seams get real edges and only the frame's edge is 0.
//    K15 and K16 are K1's and K2's kernels instantiated with kWindow = true,
//    so the shared code cannot drift and K1/K2 compile as before.
//
// What bounds them: by bytes, all are memory-bound: per pixel K1 reads 1 B and
// writes 1 B, K2 reads 1 B and writes 1-2 B.  In practice they are bound by
// instructions, shared-memory traffic and latency: a serial walk down each
// column, a branch or a byte load per pixel, or a 32-bit divide per output
// costs more than the pixel's bytes.
//
// What the design does about it.  Every block owns one output tile of one
// frame and writes each output byte once; halo rows and columns are re-read by
// the neighbouring tile, mostly from L2.  K1/K15 (blur_hist_kernel) stage the
// tile's rows and columns with their halo in shared memory with 16-byte
// cp.async copies, take column sums a column a thread (its rows cut into segments
// where the tile has at most half as many columns as threads), then make 16
// consecutive outputs a thread by sliding the row sum in registers, divide
// exactly by a multiply-high with one correction, store
// the 16 bytes as one vector and count them with shared atomics (faster here
// than aggregating a warp's equal bytes with __match_any_sync).  Interior
// windows take a path without branches.  K11 keeps column_sums/window_mean,
// K2/K16 a 128x32 tile with a 1-pixel halo.
// Histograms are flushed with one global atomic per non-empty bin per block;
// integer atomics give the same counts in any order.  Unlike the TPU kernels
// there is no block-divisibility, lane-width or radius gate: every tile masks
// its own ragged edge and only in-frame pixels are counted.
//
// All offsets into frames are size_t.  Each entry returns cudaGetLastError().

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlurTileW = 128;  // output columns a block of K1, K11, K15
constexpr int kBlurTileH = 64;   // output rows a block, at most
constexpr int kSobelTileW = 128;
constexpr int kSobelTileH = 32;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kBoxSmemBudget = 96 * 1024;  // K1/K15: two blocks an SM at the largest radii

// One block's tile of a blur-shaped kernel: the frame, its tile_h x kBlurTileW
// output rectangle and the tile's columns widened by r on each side (clipped).
struct BlurTile {
  int f, x0, y0, x1, y1, cx0, sw, rows, tw;
  size_t base;
};

__device__ __forceinline__ BlurTile blur_tile(int h, int w, int r, int tile_h, int tiles_x,
                                              int tiles_y) {
  BlurTile t;
  const int per_frame = tiles_x * tiles_y;
  t.f = blockIdx.x / per_frame;
  const int k = blockIdx.x - t.f * per_frame;
  const int ty = k / tiles_x;
  const int tx = k - ty * tiles_x;
  t.x0 = tx * kBlurTileW;
  t.y0 = ty * tile_h;
  t.x1 = min(t.x0 + kBlurTileW, w);
  t.y1 = min(t.y0 + tile_h, h);
  t.cx0 = max(t.x0 - r, 0);
  t.sw = min(t.x1 + r, w) - t.cx0;
  t.rows = t.y1 - t.y0;
  t.tw = t.x1 - t.x0;
  t.base = static_cast<size_t>(t.f) * h * w;
  return t;
}

// Vertical pass: one thread slides a clipped (2r+1)-row window down a column,
// writing the tile's rows of column sums into shared memory (rows x sw ints).
__device__ __forceinline__ void column_sums(const uint8_t* img, int* colsum, const BlurTile& t,
                                            int h, int w, int r) {
  for (int c = threadIdx.x; c < t.sw; c += blockDim.x) {
    const int x = t.cx0 + c;
    const int lo = max(t.y0 - r, 0);
    const int hi = min(t.y0 + r, h - 1);
    int s = 0;
    for (int y = lo; y <= hi; ++y) s += img[static_cast<size_t>(y) * w + x];
    for (int i = 0; i < t.rows; ++i) {
      colsum[i * t.sw + c] = s;
      const int y = t.y0 + i;
      if (y + 1 + r <= h - 1) s += img[static_cast<size_t>(y + 1 + r) * w + x];
      if (y - r >= 0) s -= img[static_cast<size_t>(y - r) * w + x];
    }
  }
}

// Horizontal pass at (i, x) of the tile: the clipped window sum over the column
// sums, divided (unsigned, truncating) by the clipped window's pixel count.  The
// count's rows are global: array row y is frame row y + row0 of a frame of
// h_total rows (row0 = 0, h_total = h for a whole frame).
__device__ __forceinline__ unsigned window_mean(const int* colsum, const BlurTile& t, int i,
                                                int x, int row0, int h_total, int w, int r) {
  const int y = t.y0 + i + row0;
  const int lo = max(x - r, 0);
  const int hi = min(x + r, w - 1);
  const int* row = colsum + i * t.sw;
  unsigned s = 0;
  for (int c = lo; c <= hi; ++c) s += static_cast<unsigned>(row[c - t.cx0]);
  const unsigned cy = static_cast<unsigned>(min(y + r, h_total - 1) - max(y - r, 0) + 1);
  const unsigned cx = static_cast<unsigned>(hi - lo + 1);
  return s / (cy * cx);
}

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

// Copies 16 bytes from global to shared memory without passing through
// registers (cp.async: a thread keeps its copies in flight); both addresses
// are 16-byte aligned.
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
#else
  *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
#endif
}

// Waits for this thread's copy16_async copies; a barrier then publishes them.
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

// Vertical pass of K1/K15: the clipped (2r+1)-row window sum of columns
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

// K1 (kWindow = false) and K15 (kWindow = true).  Grid: one block per (frame,
// tile_y, tile_x), flattened into blockIdx.x; the tile is kBlurTileW x tile_h
// outputs.  Shared memory: 256 histogram bins; tile_h rows of column sums over
// the tile's columns widened by r on each side (clipped; an odd pitch, so the
// row pass's lanes, one row each, fall in different banks); with `staged`, the
// frame's rows [y0 - r, y1 + r) of those columns (clipped), loaded as 16-byte
// vectors where the width allows.  The row pass: each thread makes 16
// consecutive outputs by sliding the row sum over the column sums, divides
// exactly (div_exact), stores them as one 16-byte word where aligned, and
// counts them in the block's histogram with shared atomics.  Where every
// window of a segment (vertical) or of the 16 outputs (row) is whole, the
// pass runs without a branch: one count and its multiplier, one correction
// down.  Near the frame's edges the loads go to clamped indices and their
// values are selected.  K15's counts are taken at global rows (row0,
// h_total) and its histogram counts the stored byte of rows [row_lo, row_hi).
template <bool kWindow>
__global__ void __launch_bounds__(kThreads)
    blur_hist_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                     int* __restrict__ hist, int h, int w, int r, int tile_h, int tiles_x,
                     int tiles_y, int staged, int row0, int h_total, int row_lo, int row_hi) {
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
  int* colsum = shist + 256;
  uint8_t* band = gs_smem + ((256 + tile_h * (sw_max | 1)) * sizeof(int) + 15) / 16 * 16;
  const bool with_hist = hist != nullptr;
  if (with_hist) {
    for (int b = threadIdx.x; b < 256; b += blockDim.x) shist[b] = 0;
  }
  const int ry0 = max(y0 - r, 0);  // the frame rows the block reads
  const int ry1 = min(y1 + r, h);
  if (staged) {
    const int nr = ry1 - ry0;
    const int pitch = (sw_max + 30 + 15) / 16 * 16;
    const bool vec = (w & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
    const int a0 = vec ? (cx0 & ~15) : cx0;
    const int a1 = vec ? min((cx1 + 15) & ~15, w) : cx1;
    if (vec) {
      const int chunks = (a1 - a0) >> 4;
      for (int idx = threadIdx.x; idx < nr * chunks; idx += blockDim.x) {
        const int row = idx / chunks;
        const int ch = idx - row * chunks;
        copy16_async(band + row * pitch + ch * 16,
                     frame + static_cast<size_t>(ry0 + row) * w + a0 + ch * 16);
      }
    } else {
      const int span = a1 - a0;
      for (int idx = threadIdx.x; idx < nr * span; idx += blockDim.x) {
        const int row = idx / span;
        const int c = idx - row * span;
        band[row * pitch + c] = frame[static_cast<size_t>(ry0 + row) * w + a0 + c];
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

  const int groups = (x1 - x0 + 15) / 16;
  const int total = rows * groups;
  const bool vec_out = (w & 15) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  for (int item = threadIdx.x; item < total; item += blockDim.x) {
    const int g = item / rows;
    const int i = item - g * rows;
    const int xs = x0 + 16 * g;
    const int nout = min(16, x1 - xs);
    const int y = y0 + i;
    const int yg = kWindow ? y + row0 : y;
    const int ht = kWindow ? h_total : h;
    const unsigned cy = static_cast<unsigned>(min(yg + r, ht - 1) - max(yg - r, 0) + 1);
    const int* row = colsum + i * swp - cx0;  // indexed by frame column
    const bool counted = with_hist && (!kWindow || (y >= row_lo && y < row_hi));
    unsigned s = 0;
    for (int c = max(xs - r, 0); c <= min(xs + r, w - 1); ++c) s += static_cast<unsigned>(row[c]);
    const unsigned d0 = cy * static_cast<unsigned>(2 * r + 1);  // an interior output's count
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
        const unsigned v = q & 255u;  // K15 past the frame: the stored byte
        word[j >> 2] |= v << (8 * (j & 3));
        if (counted) atomicAdd(&shist[v], 1);
        if (j < 15) s += static_cast<unsigned>(enter[j]) - static_cast<unsigned>(leave[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int x = xs + j;
        const int xc = min(x, w - 1);  // past the tile's last output the value is not used
        const unsigned d = cy * static_cast<unsigned>(min(xc + r, w - 1) - max(xc - r, 0) + 1);
        const unsigned v = div_exact(s, d, div_magic(d)) & 255u;
        word[j >> 2] |= v << (8 * (j & 3));
        if (counted && j < nout) atomicAdd(&shist[v], 1);
        // the next window: column x+1+r enters, x-r leaves; reads are clamped to
        // the strip (where the sum is not used again) and values past the frame dropped
        const unsigned in = static_cast<unsigned>(row[min(x + 1 + r, cx1 - 1)]);
        const unsigned gone = static_cast<unsigned>(row[min(max(x - r, cx0), cx1 - 1)]);
        s += (x + 1 + r <= w - 1 ? in : 0u) - (x - r >= 0 ? gone : 0u);
      }
    }
    uint8_t* out = dst + frame_off + static_cast<size_t>(y) * w + xs;
    if (nout == 16 && vec_out) {
      *reinterpret_cast<uint4*>(out) = make_uint4(word[0], word[1], word[2], word[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j < nout) out[j] = static_cast<uint8_t>(word[j >> 2] >> (8 * (j & 3)));
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

// K11: K1's tiles and column sums (no histogram bins in shared memory), then
// src > (int)mean - c ? 255 : 0.  The subtraction wraps as int32 does on the
// TPU (done in unsigned arithmetic: signed overflow is undefined in C++).
__global__ void adaptive_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                                int c, int h, int w, int r, int tile_h, int tiles_x,
                                int tiles_y) {
  extern __shared__ __align__(16) unsigned char gs_smem[];
  int* colsum = reinterpret_cast<int*>(gs_smem);
  const BlurTile t = blur_tile(h, w, r, tile_h, tiles_x, tiles_y);
  column_sums(src + t.base, colsum, t, h, w, r);
  __syncthreads();

  for (int idx = threadIdx.x; idx < t.rows * t.tw; idx += blockDim.x) {
    const int i = idx / t.tw;
    const int x = t.x0 + (idx - i * t.tw);
    const int thr = static_cast<int>(window_mean(colsum, t, i, x, 0, h, w, r) -
                                     static_cast<unsigned>(c));
    const size_t off = t.base + static_cast<size_t>(t.y0 + i) * w + x;
    dst[off] = static_cast<int>(src[off]) > thr ? 255 : 0;
  }
}

// Grid: one block per (frame, tile_y, tile_x).  Shared memory: the tile plus a
// 1-pixel halo, zero outside the array, already binarized when `thr` is given.
// K2 is kWindow = false; K16 is kWindow = true: array row y is frame row
// y + row0 of a frame of h_total rows, and the interior test uses that row.
template <bool kWindow>
__global__ void threshold_sobel_kernel(const uint8_t* __restrict__ src,
                                       const uint8_t* __restrict__ thr,
                                       uint8_t* __restrict__ binary, uint8_t* __restrict__ edges,
                                       int h, int w, int tiles_x, int tiles_y, int row0,
                                       int h_total) {
  constexpr int kPitch = kSobelTileW + 2;
  extern __shared__ __align__(16) unsigned char gs_smem[];
  uint8_t* tile = gs_smem;
  const int per_frame = tiles_x * tiles_y;
  const int f = blockIdx.x / per_frame;
  const int t = blockIdx.x - f * per_frame;
  const int ty = t / tiles_x;
  const int tx = t - ty * tiles_x;
  const int x0 = tx * kSobelTileW;
  const int y0 = ty * kSobelTileH;
  const size_t base = static_cast<size_t>(f) * h * w;
  const int tv = thr != nullptr ? static_cast<int>(thr[f]) : 0;

  for (int idx = threadIdx.x; idx < (kSobelTileH + 2) * kPitch; idx += blockDim.x) {
    const int i = idx / kPitch;
    const int y = y0 - 1 + i;
    const int x = x0 - 1 + (idx - i * kPitch);
    int v = 0;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      v = src[base + static_cast<size_t>(y) * w + x];
      if (thr != nullptr) v = v > tv ? 255 : 0;
    }
    tile[idx] = static_cast<uint8_t>(v);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kSobelTileH * kSobelTileW; idx += blockDim.x) {
    const int i = idx / kSobelTileW;
    const int j = idx - i * kSobelTileW;
    const int y = y0 + i;
    const int x = x0 + j;
    if (y >= h || x >= w) continue;
    const uint8_t* c = tile + (i + 1) * kPitch + (j + 1);
    const size_t off = base + static_cast<size_t>(y) * w + x;
    if (binary != nullptr) binary[off] = c[0];
    int mag = 0;
    const int fy = kWindow ? y + row0 : y;  // the frame's row
    const int fh = kWindow ? h_total : h;
    if (fy >= 1 && fy <= fh - 2 && x >= 1 && x <= w - 2) {
      const int nw = c[-kPitch - 1], n = c[-kPitch], ne = c[-kPitch + 1];
      const int west = c[-1], east = c[1];
      const int sw = c[kPitch - 1], s = c[kPitch], se = c[kPitch + 1];
      const int gx = -nw + ne - 2 * west + 2 * east - sw + se;
      const int gy = -nw - 2 * n - ne + sw + 2 * s + se;
      mag = min((abs(gx) + abs(gy)) / 2, 255);
    }
    edges[off] = static_cast<uint8_t>(mag);
  }
}

int tiles(int extent, int tile) { return (extent + tile - 1) / tile; }

// Tile height and shared-memory bytes of a blur-shaped kernel: `fixed` bytes,
// then tile_h rows of column sums.  64 rows while that fits the default 48 KB,
// fewer past it (at least 1, with the opt-in to more shared memory).
void blur_geometry(int h, int w, int r, size_t fixed, int* tile_h, size_t* smem) {
  const int sw_max = std::min(kBlurTileW + 2 * r, w);
  const size_t row_bytes = static_cast<size_t>(sw_max) * sizeof(int);
  int rows = kBlurTileH;
  if (fixed + rows * row_bytes > kDefaultSmem) {
    rows = static_cast<int>((kDefaultSmem - fixed) / row_bytes);
    if (rows < 1) rows = 1;
  }
  *tile_h = std::min(rows, h);
  *smem = fixed + *tile_h * row_bytes;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Tile height, whether the band of frame rows is staged, and the shared-memory
// bytes of K1/K15 (blur_hist_kernel's layout): the tallest of kBlurTileH .. 1 rows whose
// staged band fits kBoxSmemBudget; past that (a radius of hundreds), the column
// sums read the frame from global memory.
void box_geometry(int h, int w, int r, int* tile_h, int* staged, size_t* smem) {
  const int sw_max = std::min(kBlurTileW + 2 * r, w);
  const size_t colsum_row = static_cast<size_t>(sw_max | 1) * sizeof(int);
  const size_t pitch = static_cast<size_t>(sw_max + 30 + 15) / 16 * 16;
  for (*staged = 1; *staged >= 0; --*staged) {
    for (int th = kBlurTileH; th >= 1; th /= 2) {
      *tile_h = std::min(th, h);
      *smem = (256 * sizeof(int) + *tile_h * colsum_row + 15) / 16 * 16;
      if (*staged) *smem += static_cast<size_t>(std::min(*tile_h + 2 * r, h)) * pitch;
      if (*smem <= static_cast<size_t>(kBoxSmemBudget)) return;
    }
  }
  *staged = 0;  // one row of column sums past the budget; the launch checks kMaxSmem
}

template <bool kWindow>
int launch_blur_hist(const void* src, void* dst, void* hist, int n, int h, int w, int r, int row0,
                     int h_total, int row_lo, int row_hi, void* stream) {
  int tile_h, staged;
  size_t smem;
  box_geometry(h, w, r, &tile_h, &staged, &smem);
  const cudaError_t err = allow_smem(blur_hist_kernel<kWindow>, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = tiles(w, kBlurTileW);
  const int tiles_y = tiles(h, tile_h);
  const long long blocks = static_cast<long long>(n) * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  blur_hist_kernel<kWindow><<<static_cast<unsigned>(blocks), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), static_cast<int*>(hist), h,
      w, r, tile_h, tiles_x, tiles_y, staged, row0, h_total, row_lo, row_hi);
  return cudaGetLastError();
}

template <bool kWindow>
int launch_threshold_sobel(const void* src, const void* thr, void* binary, void* edges, int n,
                           int h, int w, int row0, int h_total, void* stream) {
  const int tiles_x = tiles(w, kSobelTileW);
  const int tiles_y = tiles(h, kSobelTileH);
  const long long blocks = static_cast<long long>(n) * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = (kSobelTileH + 2) * (kSobelTileW + 2);
  threshold_sobel_kernel<kWindow><<<static_cast<unsigned>(blocks), kThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(thr),
      static_cast<uint8_t*>(binary), static_cast<uint8_t*>(edges), h, w, tiles_x, tiles_y, row0,
      h_total);
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
  return launch_blur_hist<false>(src, dst, hist, n, h, w, r, 0, h, 0, h, stream);
}

// src, dst: (n, h, w) uint8, one H-shard with its halo rows; hist: (n, 256)
// int32, zeroed by the caller.  Array row y is frame row y + row0 of a frame of
// h_total rows; the caller checks that every window's count is >= 1
// (-r <= row0 and row0 + h <= h_total + r), that 0 <= row_lo <= row_hi <= h,
// and clamps r to where every window is whole.
int gs_blur_hist_window(const void* src, void* dst, void* hist, int n, int h, int w, int r,
                        int row0, int h_total, int row_lo, int row_hi, void* stream) {
  return launch_blur_hist<true>(src, dst, hist, n, h, w, r, row0, h_total, row_lo, row_hi,
                                stream);
}

// src, dst: (n, h, w) uint8; c: the int32 offset.  Radius clamped as in gs_blur_hist.
int gs_adaptive(const void* src, void* dst, int n, int h, int w, int r, int c, void* stream) {
  r = std::min(r, std::max(h, w));
  int tile_h;
  size_t smem;
  blur_geometry(h, w, r, 0, &tile_h, &smem);
  const cudaError_t err = allow_smem(adaptive_kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = tiles(w, kBlurTileW);
  const int tiles_y = tiles(h, tile_h);
  const long long blocks = static_cast<long long>(n) * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  adaptive_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), c, h, w, r, tile_h, tiles_x,
      tiles_y);
  return cudaGetLastError();
}

// src: (n, h, w) uint8; thr: (n,) uint8 or null; binary: (n, h, w) uint8 or null
// (only with thr); edges: (n, h, w) uint8.
int gs_threshold_sobel(const void* src, const void* thr, void* binary, void* edges, int n, int h,
                       int w, void* stream) {
  return launch_threshold_sobel<false>(src, thr, binary, edges, n, h, w, 0, h, stream);
}

// As gs_threshold_sobel on one H-shard with its 1-row halo: thr is (n,) uint8;
// array row y is frame row y + row0 of a frame of h_total rows.
int gs_threshold_sobel_window(const void* src, const void* thr, void* binary, void* edges, int n,
                              int h, int w, int row0, int h_total, void* stream) {
  return launch_threshold_sobel<true>(src, thr, binary, edges, n, h, w, row0, h_total, stream);
}

}  // extern "C"
