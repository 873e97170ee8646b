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
//    gs_adaptive_threshold: `src > (int)(sum / count) - c ? 255 : 0` with K1's
//    clipped window sum (the same column-sum stage, as _adaptive_kernel shares
//    _blur_block), an unsigned division, then an int32 subtraction and compare.
//    No radius gate: any radius whose window sum fits int32, as K1.
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
// What bounds them: both are memory-bound.  Per pixel K1 reads 1 B and writes
// 1 B (plus a few shared-memory atomics for the histogram); K2 reads 1 B and
// writes 1-2 B.  The arithmetic (a handful of integer adds and one integer
// divide per pixel) is far below the card's rate.
//
// What the design does about it: each block owns one output tile of one frame,
// reads the tile and its halo once into shared memory, and writes each output
// byte once, so device memory sees close to the minimal 2-3 B/pixel (halo rows
// and columns are re-read by the neighbouring tile, mostly from L2).  The
// histogram is counted in shared memory and flushed with one global atomic per
// non-empty bin per block; integer atomics give the same counts in any order.
// Unlike the TPU kernels there is no block-divisibility, lane-width or radius
// gate: every tile masks its own ragged edge, only in-frame pixels are counted,
// and the division is a plain unsigned integer divide.
//
// All offsets into frames are size_t.  Each entry returns cudaGetLastError().

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlurTileW = 128;
constexpr int kBlurTileH = 64;
constexpr int kSobelTileW = 128;
constexpr int kSobelTileH = 32;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

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

// Grid: one block per (frame, tile_y, tile_x), flattened into blockIdx.x.
// Shared memory: 256 int histogram bins, then tile_h rows of vertical window
// sums over the tile's columns widened by r on each side (clipped to the frame).
// K1 is kWindow = false (row0, h_total, row_lo and row_hi unused); K15 is
// kWindow = true: counts at global rows, histogram of rows [row_lo, row_hi).
template <bool kWindow>
__global__ void blur_hist_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                                 int* __restrict__ hist, int h, int w, int r, int tile_h,
                                 int tiles_x, int tiles_y, int row0, int h_total, int row_lo,
                                 int row_hi) {
  extern __shared__ __align__(16) unsigned char gs_smem[];
  int* shist = reinterpret_cast<int*>(gs_smem);
  int* colsum = shist + 256;
  const BlurTile t = blur_tile(h, w, r, tile_h, tiles_x, tiles_y);

  if (hist != nullptr) {
    for (int b = threadIdx.x; b < 256; b += blockDim.x) shist[b] = 0;
  }
  column_sums(src + t.base, colsum, t, h, w, r);
  __syncthreads();

  // Horizontal pass, clipped-count division and histogram.
  for (int idx = threadIdx.x; idx < t.rows * t.tw; idx += blockDim.x) {
    const int i = idx / t.tw;
    const int x = t.x0 + (idx - i * t.tw);
    const int y = t.y0 + i;
    const unsigned v = kWindow ? window_mean(colsum, t, i, x, row0, h_total, w, r)
                               : window_mean(colsum, t, i, x, 0, h, w, r);
    dst[t.base + static_cast<size_t>(y) * w + x] = static_cast<uint8_t>(v);
    // K15's mean passes 255 when a summed halo row past the frame is not 0
    // (the count leaves it out); the stored byte, mod 256, is what is counted
    if (hist != nullptr && (!kWindow || (y >= row_lo && y < row_hi))) {
      atomicAdd(&shist[kWindow ? v & 255u : v], 1);
    }
  }

  if (hist != nullptr) {
    __syncthreads();
    for (int b = threadIdx.x; b < 256; b += blockDim.x) {
      if (shist[b] != 0) atomicAdd(&hist[static_cast<size_t>(t.f) * 256 + b], shist[b]);
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

template <bool kWindow>
int launch_blur_hist(const void* src, void* dst, void* hist, int n, int h, int w, int r, int row0,
                     int h_total, int row_lo, int row_hi, void* stream) {
  int tile_h;
  size_t smem;
  blur_geometry(h, w, r, 256 * sizeof(int), &tile_h, &smem);
  const cudaError_t err = allow_smem(blur_hist_kernel<kWindow>, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = tiles(w, kBlurTileW);
  const int tiles_y = tiles(h, tile_h);
  const long long blocks = static_cast<long long>(n) * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  blur_hist_kernel<kWindow><<<static_cast<unsigned>(blocks), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), static_cast<int*>(hist), h,
      w, r, tile_h, tiles_x, tiles_y, row0, h_total, row_lo, row_hi);
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
