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

// Grid: one block per (frame, tile_y, tile_x), flattened into blockIdx.x.
// Shared memory: 256 int histogram bins, then tile_h rows of vertical window
// sums over the tile's columns widened by r on each side (clipped to the frame).
__global__ void blur_hist_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                                 int* __restrict__ hist, int h, int w, int r, int tile_h,
                                 int tiles_x, int tiles_y) {
  extern __shared__ __align__(16) unsigned char gs_smem[];
  int* shist = reinterpret_cast<int*>(gs_smem);
  int* colsum = shist + 256;
  const int per_frame = tiles_x * tiles_y;
  const int f = blockIdx.x / per_frame;
  const int t = blockIdx.x - f * per_frame;
  const int ty = t / tiles_x;
  const int tx = t - ty * tiles_x;
  const int x0 = tx * kBlurTileW;
  const int y0 = ty * tile_h;
  const int x1 = min(x0 + kBlurTileW, w);
  const int y1 = min(y0 + tile_h, h);
  const int cx0 = max(x0 - r, 0);
  const int cx1 = min(x1 + r, w);
  const int sw = cx1 - cx0;
  const int rows = y1 - y0;
  const int tw = x1 - x0;
  const size_t base = static_cast<size_t>(f) * h * w;
  const uint8_t* img = src + base;

  if (hist != nullptr) {
    for (int b = threadIdx.x; b < 256; b += blockDim.x) shist[b] = 0;
  }

  // Vertical pass: one thread slides a clipped (2r+1)-row window down a column.
  for (int c = threadIdx.x; c < sw; c += blockDim.x) {
    const int x = cx0 + c;
    const int lo = max(y0 - r, 0);
    const int hi = min(y0 + r, h - 1);
    int s = 0;
    for (int y = lo; y <= hi; ++y) s += img[static_cast<size_t>(y) * w + x];
    for (int i = 0; i < rows; ++i) {
      colsum[i * sw + c] = s;
      const int y = y0 + i;
      if (y + 1 + r <= h - 1) s += img[static_cast<size_t>(y + 1 + r) * w + x];
      if (y - r >= 0) s -= img[static_cast<size_t>(y - r) * w + x];
    }
  }
  __syncthreads();

  // Horizontal pass, clipped-count division and histogram.
  for (int idx = threadIdx.x; idx < rows * tw; idx += blockDim.x) {
    const int i = idx / tw;
    const int y = y0 + i;
    const int x = x0 + (idx - i * tw);
    const int lo = max(x - r, 0);
    const int hi = min(x + r, w - 1);
    const int* row = colsum + i * sw;
    unsigned s = 0;
    for (int c = lo; c <= hi; ++c) s += static_cast<unsigned>(row[c - cx0]);
    const unsigned cy = static_cast<unsigned>(min(y + r, h - 1) - max(y - r, 0) + 1);
    const unsigned cx = static_cast<unsigned>(hi - lo + 1);
    const unsigned v = s / (cy * cx);
    dst[base + static_cast<size_t>(y) * w + x] = static_cast<uint8_t>(v);
    if (hist != nullptr) atomicAdd(&shist[v], 1);
  }

  if (hist != nullptr) {
    __syncthreads();
    for (int b = threadIdx.x; b < 256; b += blockDim.x) {
      if (shist[b] != 0) atomicAdd(&hist[static_cast<size_t>(f) * 256 + b], shist[b]);
    }
  }
}

// Grid: one block per (frame, tile_y, tile_x).  Shared memory: the tile plus a
// 1-pixel halo, zero outside the frame, already binarized when `thr` is given.
__global__ void threshold_sobel_kernel(const uint8_t* __restrict__ src,
                                       const uint8_t* __restrict__ thr,
                                       uint8_t* __restrict__ binary, uint8_t* __restrict__ edges,
                                       int h, int w, int tiles_x, int tiles_y) {
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
    if (y >= 1 && y <= h - 2 && x >= 1 && x <= w - 2) {
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
  const int sw_max = std::min(kBlurTileW + 2 * r, w);
  const size_t row_bytes = static_cast<size_t>(sw_max) * sizeof(int);
  const size_t fixed = 256 * sizeof(int);
  int tile_h = kBlurTileH;
  if (fixed + tile_h * row_bytes > kDefaultSmem) {
    tile_h = static_cast<int>((kDefaultSmem - fixed) / row_bytes);
    if (tile_h < 1) tile_h = 1;
  }
  tile_h = std::min(tile_h, h);
  const size_t smem = fixed + tile_h * row_bytes;
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        blur_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int tiles_x = tiles(w, kBlurTileW);
  const int tiles_y = tiles(h, tile_h);
  const long long blocks = static_cast<long long>(n) * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  blur_hist_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), static_cast<int*>(hist), h,
      w, r, tile_h, tiles_x, tiles_y);
  return cudaGetLastError();
}

// src: (n, h, w) uint8; thr: (n,) uint8 or null; binary: (n, h, w) uint8 or null
// (only with thr); edges: (n, h, w) uint8.
int gs_threshold_sobel(const void* src, const void* thr, void* binary, void* edges, int n, int h,
                       int w, void* stream) {
  const int tiles_x = tiles(w, kSobelTileW);
  const int tiles_y = tiles(h, kSobelTileH);
  const long long blocks = static_cast<long long>(n) * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = (kSobelTileH + 2) * (kSobelTileW + 2);
  threshold_sobel_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(thr),
      static_cast<uint8_t*>(binary), static_cast<uint8_t*>(edges), h, w, tiles_x, tiles_y);
  return cudaGetLastError();
}

}  // extern "C"
