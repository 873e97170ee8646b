// 3x3 stencils of the dense pixel ops, for Hopper (sm_90a), bound to Python
// through a plain C interface (grayskull_tpu_torch/kernels/_build.py).
//
// K12 gs_morph replaces morph_pallas (grayskull_tpu/kernels/preproc.py:616,
//    body _morph_kernel :593): gs_erode / gs_dilate, the 3x3 min or max over the
//    in-frame neighbours only.  The window is clipped at the border, which is
//    the same as padding with the op-neutral value (255 for erode, 0 for
//    dilate), not with 0.
// K13 gs_filter3 replaces filter3_pallas (:723, body _filter3_kernel :664):
//    gs_filter with a 3x3 kernel, the correlation with zero padding (gs_get
//    reads 0 out of the frame), then C's `int / unsigned`: the int32 sum is
//    reinterpreted as uint32, divided by norm, cast back to int32 and clamped
//    to 0..255 (grayskull_tpu/ops/pixel.py:432-446).  The sum wraps as int32
//    does and is accumulated in uint32_t, where wrapping is defined in C++.
//    Any int32 taps: for int8 taps this gives the TPU kernel's sign-test
//    shortcut (a negative sum with norm > 1 clamps to 255) without special
//    cases, and past int8 it is the XLA path's formula.
//
// What bounds them: device memory.  Each reads 1 B and writes 1 B a pixel;
// nine compares or nine multiply-adds a pixel are far below the card's rate.
// Each block stages its 128x32 output tile plus a 1-pixel halo in shared
// memory once, filled with the op's border value, so
// every thread's nine reads hit shared memory and device memory sees the
// frame about once (halo rows come again from L2).
//
// All offsets into frames are size_t.  Each entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 128;
constexpr int kTileH = 32;
constexpr int kPitch = kTileW + 2;

struct Taps {
  int k[9];
};

// Fills `tile` with the block's tile and its 1-pixel halo; `outside` stands in
// for pixels past the frame.  Returns the frame's base offset.
__device__ __forceinline__ size_t stage_tile(const uint8_t* __restrict__ src, uint8_t* tile,
                                             int h, int w, int tiles_x, int tiles_y,
                                             uint8_t outside, int* y0, int* x0) {
  const int per_frame = tiles_x * tiles_y;
  const int f = blockIdx.x / per_frame;
  const int t = blockIdx.x - f * per_frame;
  const int ty = t / tiles_x;
  *y0 = ty * kTileH;
  *x0 = (t - ty * tiles_x) * kTileW;
  const size_t base = static_cast<size_t>(f) * h * w;
  for (int idx = threadIdx.x; idx < (kTileH + 2) * kPitch; idx += blockDim.x) {
    const int i = idx / kPitch;
    const int y = *y0 - 1 + i;
    const int x = *x0 - 1 + (idx - i * kPitch);
    tile[idx] = (y >= 0 && y < h && x >= 0 && x < w) ? src[base + static_cast<size_t>(y) * w + x]
                                                     : outside;
  }
  return base;
}

// Grid: one block per (frame, tile_y, tile_x), flattened into blockIdx.x.
template <bool kErode>
__global__ void morph_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int h,
                             int w, int tiles_x, int tiles_y) {
  __shared__ uint8_t tile[(kTileH + 2) * kPitch];
  int y0, x0;
  const size_t base = stage_tile(src, tile, h, w, tiles_x, tiles_y, kErode ? 255 : 0, &y0, &x0);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTileH * kTileW; idx += blockDim.x) {
    const int i = idx / kTileW;
    const int j = idx - i * kTileW;
    const int y = y0 + i;
    const int x = x0 + j;
    if (y >= h || x >= w) continue;
    const uint8_t* c = tile + i * kPitch + j;  // the window's top-left
    int v = c[0];
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const int p = c[dy * kPitch + dx];
        v = kErode ? min(v, p) : max(v, p);
      }
    }
    dst[base + static_cast<size_t>(y) * w + x] = static_cast<uint8_t>(v);
  }
}

__global__ void filter3_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                               Taps taps, unsigned norm, int h, int w, int tiles_x,
                               int tiles_y) {
  __shared__ uint8_t tile[(kTileH + 2) * kPitch];
  int y0, x0;
  const size_t base = stage_tile(src, tile, h, w, tiles_x, tiles_y, 0, &y0, &x0);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTileH * kTileW; idx += blockDim.x) {
    const int i = idx / kTileW;
    const int j = idx - i * kTileW;
    const int y = y0 + i;
    const int x = x0 + j;
    if (y >= h || x >= w) continue;
    const uint8_t* c = tile + i * kPitch + j;
    uint32_t sum = 0;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        sum += static_cast<uint32_t>(c[dy * kPitch + dx]) *
               static_cast<uint32_t>(taps.k[dy * 3 + dx]);
      }
    }
    const int q = static_cast<int>(sum / norm);
    dst[base + static_cast<size_t>(y) * w + x] = static_cast<uint8_t>(min(max(q, 0), 255));
  }
}

int tiles(int extent, int tile) { return (extent + tile - 1) / tile; }

bool grid(int n, int h, int w, int* tiles_x, int* tiles_y, unsigned* blocks) {
  *tiles_x = tiles(w, kTileW);
  *tiles_y = tiles(h, kTileH);
  const long long b = static_cast<long long>(n) * *tiles_x * *tiles_y;
  *blocks = static_cast<unsigned>(b);
  return b <= 0x7fffffffLL;
}

}  // namespace

extern "C" {

// src, dst: (n, h, w) uint8; erode: 1 for the min, 0 for the max.
int gs_morph(const void* src, void* dst, int n, int h, int w, int erode, void* stream) {
  int tiles_x, tiles_y;
  unsigned blocks;
  if (!grid(n, h, w, &tiles_x, &tiles_y, &blocks)) return cudaErrorInvalidConfiguration;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto in = static_cast<const uint8_t*>(src);
  const auto out = static_cast<uint8_t*>(dst);
  if (erode) {
    morph_kernel<true><<<blocks, kThreads, 0, s>>>(in, out, h, w, tiles_x, tiles_y);
  } else {
    morph_kernel<false><<<blocks, kThreads, 0, s>>>(in, out, h, w, tiles_x, tiles_y);
  }
  return cudaGetLastError();
}

// src, dst: (n, h, w) uint8; k0..k8: the taps row by row; norm >= 1.
int gs_filter3(const void* src, void* dst, int n, int h, int w, int k0, int k1, int k2, int k3,
               int k4, int k5, int k6, int k7, int k8, unsigned norm, void* stream) {
  int tiles_x, tiles_y;
  unsigned blocks;
  if (!grid(n, h, w, &tiles_x, &tiles_y, &blocks)) return cudaErrorInvalidConfiguration;
  if (norm == 0) return cudaErrorInvalidValue;
  const Taps taps = {{k0, k1, k2, k3, k4, k5, k6, k7, k8}};
  filter3_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), taps, norm, h, w, tiles_x,
      tiles_y);
  return cudaGetLastError();
}

}  // extern "C"
