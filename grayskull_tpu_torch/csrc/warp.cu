// K10 gs_quad_warp: the bilinear quad warp of gs_perspective_correct
// (grayskull.h:423-444) for a batch of uint8 frames, one quad per frame, for
// Hopper (sm_90a), bound to Python through a plain C interface
// (grayskull_tpu_torch/kernels/_build.py).
//
// Replaces the Pallas kernels _quad_sample_banded_pallas
// (grayskull_tpu/kernels/warp.py:163) and _quad_sample_pallas (:98).  Both
// fetch the four bilinear corner samples src[y0|y1, x0|x1] of each output
// pixel with one-hot matrix contractions over a source band, for want of a
// gather on the TPU; the coordinate math before them and the lerp after them
// run in XLA (grayskull_tpu/ops/warp.py:25-65).  Here one kernel does all
// three: coordinates, four byte gathers from L1/L2, lerp.
//
// Float order: every operation rounds on its own, as in the reference and the
// JAX package (the build passes -fmad=false, and the intrinsics say so too):
//   u = x / (dw - 1), v = y / (dh - 1)                    (IEEE division)
//   edge = p0 * (1 - u) + p1 * u;  src = top * (1 - v) + bottom * v
//   clamp to [0, sw - 1], truncate, dx = src_x - x0
//   ((c00*(1-dx))*(1-dy)) + ((c01*dx)*(1-dy)) + ((c10*(1-dx))*dy) + ((c11*dx)*dy)
//   truncating uint8 store.
// A page with one row or one column divides 0 by 0.  C leaves that undefined
// (a NaN cast to int); the JAX package's integer float adder
// (grayskull_tpu/exactf32.py) turns the NaN coordinate into -inf, which its
// clamp sends to 0, so every pixel of such a page is src[0, 0].  The clamp
// here sends a NaN to 0 to give the same page.
//
// What bounds it: issue, and for steep quads the gathers.  12.7 MB move at
// scan's call (8 frames of 768x1024 to 1000x800 pages), 0.004 ms at 3.35 TB/s;
// the gathers hit L1/L2.  A page pixel needs about 25 rounded float
// operations once the terms that depend only on its column (u and the four
// edge points), its row (v) or its frame (the corners) are shared, and its
// type conversions and gathers.  The first port did everything per pixel, two
// IEEE divisions and about 23 conversions among them, one thread a pixel.
//
// What the design does about it.  A block owns a tile of one page: kRows rows
// of threads times blockDim.y, kCols columns a thread.  The frame and the row
// tile come from blockIdx.x with one division a block (frames ride grid.x, so
// a call may hold more than 65,535), column tiles from blockIdx.y.  A thread
// computes its columns' u, 1 - u and edge points once, in registers; the block
// computes the v and 1 - v of its rows once, into shared memory, and converts
// the corners once.  Lane l of a warp takes columns l, l + 32, ... of the
// warp's 32 * kCols, so each gather instruction reads for 32 adjacent page
// columns (the fewest source rows for a steep quad) and each store writes 32
// adjacent bytes.  The stored sum truncates as __fadd_rz(sum, 2^23), whose
// low byte is the uint8 result (an FP32 add in place of F2I); the bytes and
// the coordinates convert with I2F and F2I, which the sweep found faster than
// the same tricks.  The right (lower) neighbour of a frame's last column
// (row) is not read, since its weight dx (dy) is exactly 0 there.  Frames past
// 2^24 columns or rows, or of 2^31 bytes, take the kernel's other template,
// with 64-bit offsets and reads clamped to the frame.
// The constants and choices are the fastest of chip_sweep.py --source warp on
// the H100 (PERF.md), which also carries the rejected alternatives (adjacent
// columns a thread with 4-byte stores, the byte and truncation tricks, the
// neighbours read unchecked in every frame but the last, a staged footprint,
// word gathers).
//
// gs_quad_warp_rows writes a band of rows of the same pages with the same
// kernel (each row's v is still the whole page's y / (dh - 1)): the
// space-sharded scanner's shard warps its own band (grayskull_tpu/ops/warp.py:68
// _warp_rows is the JAX counterpart).
//
// Each entry returns cudaGetLastError().

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block at most
constexpr int kCols = 4;       // page columns a thread, 32 apart
constexpr int kRows = 8;       // page rows a thread walks
constexpr float kTwo23 = 8388608.0f;
constexpr int kExactLimit = 1 << 24;  // sw, sh up to this clamp to sw - 1, sh - 1 exactly
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");

__device__ __forceinline__ float edge(float p0, float p1, float t, float one_minus_t) {
  return __fadd_rn(__fmul_rn(p0, one_minus_t), __fmul_rn(p1, t));
}

// max(0, min(v, hi)) for hi >= 0, a NaN to 0 (fmaxf gives 0 for a NaN)
__device__ __forceinline__ float clamp_coord(float v, float hi) {
  return fminf(fmaxf(v, 0.0f), hi);
}

// trunc(s) of a clamped coordinate, and the same as a float in ``whole``
__device__ __forceinline__ int truncate(float s, float& whole) {
  const int i = __float2int_rz(s);
  whole = static_cast<float>(i);
  return i;
}

__device__ __forceinline__ float byte_to_float(uint32_t b) {
  return static_cast<float>(b);
}

// the uint8 cast of the truncated sum (0 <= sum < 256): sum + 2^23 rounded
// toward zero is 2^23 + trunc(sum), whose low byte is trunc(sum)
__device__ __forceinline__ uint8_t store_byte(float sum) {
  return static_cast<uint8_t>(__float_as_uint(__fadd_rz(sum, kTwo23)));
}

// One page pixel from its column's edge points and its row's v, 1 - v; the
// frame's bytes start at s.  The right (lower) neighbour of the last column
// (row) is not read: its weight dx (dy) is exactly 0 there, and 0 stands in.
// kWide: a frame past 2^24 columns (rows) or of 2^31 bytes, read with 64-bit
// offsets; its clamp's bound (float)sw - 1 can round above sw - 1, so the
// reads clamp to the frame, as the JAX package's gather does (there every
// float is an integer, so dx (dy) is 0).
template <bool kWide>
__device__ __forceinline__ uint8_t warp_pixel(const uint8_t* __restrict__ s, int sw, int swm1,
                                              int shm1, float swm1f, float shm1f, float top_x,
                                              float top_y, float bot_x, float bot_y, float v,
                                              float omv) {
  const float sx = clamp_coord(edge(top_x, bot_x, v, omv), swm1f);
  const float sy = clamp_coord(edge(top_y, bot_y, v, omv), shm1f);
  float fx0, fy0;
  const int x0 = truncate(sx, fx0);
  const int y0 = truncate(sy, fy0);
  const float dx = __fsub_rn(sx, fx0);
  const float dy = __fsub_rn(sy, fy0);
  const float omdx = __fsub_rn(1.0f, dx);
  const float omdy = __fsub_rn(1.0f, dy);
  // gathers
  const uint8_t* p = s + (kWide ? static_cast<size_t>(min(y0, shm1)) * sw + min(x0, swm1)
                                : static_cast<size_t>(static_cast<unsigned>(y0 * sw + x0)));
  const bool right = x0 < swm1, below = y0 < shm1;
  const uint32_t b00 = p[0];
  const uint32_t b01 = right ? p[1] : 0u;
  const uint32_t b10 = below ? p[sw] : 0u;
  const uint32_t b11 = right && below ? p[sw + 1] : 0u;
  // lerp
  const float t1 = __fmul_rn(__fmul_rn(byte_to_float(b00), omdx), omdy);
  const float t2 = __fmul_rn(__fmul_rn(byte_to_float(b01), dx), omdy);
  const float t3 = __fmul_rn(__fmul_rn(byte_to_float(b10), omdx), dy);
  const float t4 = __fmul_rn(__fmul_rn(byte_to_float(b11), dx), dy);
  return store_byte(__fadd_rn(__fadd_rn(__fadd_rn(t1, t2), t3), t4));
}

// A thread's columns x_first + 32 j (j < kCols) in the rows of its tile.
template <bool kWide>
__device__ __forceinline__ void walk_rows(const uint8_t* __restrict__ s, uint8_t* __restrict__ page,
                                          const float2* row_terms, int sh, int sw, int rows,
                                          int dw, unsigned y_first, unsigned x_first,
                                          const float (&top_x)[kCols],
                                          const float (&top_y)[kCols],
                                          const float (&bot_x)[kCols],
                                          const float (&bot_y)[kCols]) {
  const float swm1f = static_cast<float>(sw) - 1.0f, shm1f = static_cast<float>(sh) - 1.0f;
  const int left = dw - static_cast<int>(x_first);
  for (int k = 0; k < kRows; ++k) {
    const unsigned r = threadIdx.y + k * blockDim.y;
    const unsigned y = y_first + r;
    if (y >= static_cast<unsigned>(rows)) break;
    const float2 t = row_terms[r];
    uint8_t* row = page + static_cast<size_t>(y) * dw + x_first;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const uint8_t b = warp_pixel<kWide>(s, sw, sw - 1, sh - 1, swm1f, shm1f, top_x[j],
                                          top_y[j], bot_x[j], bot_y[j], t.x, t.y);
      if (32 * j < left) row[32 * j] = b;
    }
  }
}

// grid (n * tiles_y, min(tiles_x, 65535)), block (gx, ry): blockIdx.x is a
// frame's row tile of ry * kRows rows, blockIdx.y walks the column tiles of gx
// * kCols columns.  dst holds page rows y0 .. y0 + rows - 1 of each frame's
// dh x dw page (y0 = 0, rows = dh: the whole page); a row's v is the page's.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
quad_warp_kernel(const uint8_t* __restrict__ src, const int* __restrict__ corners,
                 uint8_t* __restrict__ dst, int sh, int sw, int dh, int dw, int y0, int rows,
                 int tiles_y, int tiles_x) {
  __shared__ float quad[8];
  __shared__ float2 row_terms[kThreads / 32 * kRows];
  const int f = blockIdx.x / tiles_y;  // the block's one division
  const unsigned span = blockDim.y * kRows;
  const unsigned y_first = (blockIdx.x - f * tiles_y) * span;
  const unsigned tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < 8) quad[tid] = static_cast<float>(corners[static_cast<long long>(f) * 8 + tid]);
  const float dhm1 = static_cast<float>(dh - 1);
  for (unsigned i = tid; i < span; i += blockDim.x * blockDim.y) {
    const float v = __fdiv_rn(static_cast<float>(y0 + y_first + i), dhm1);
    row_terms[i] = make_float2(v, __fsub_rn(1.0f, v));
  }
  __syncthreads();

  const uint8_t* s = src + static_cast<long long>(f) * sh * sw;
  uint8_t* page = dst + static_cast<long long>(f) * rows * dw;
  const float dwm1 = static_cast<float>(dw - 1);
  // (x, y) rows: TL, TR, BR, BL
  const float tl_x = quad[0], tl_y = quad[1], tr_x = quad[2], tr_y = quad[3];
  const float br_x = quad[4], br_y = quad[5], bl_x = quad[6], bl_y = quad[7];
  const unsigned lane = threadIdx.x & 31u;
  for (unsigned tile_x = blockIdx.y; tile_x < static_cast<unsigned>(tiles_x);
       tile_x += gridDim.y) {
    const unsigned x_first = (tile_x * blockDim.x + threadIdx.x - lane) * kCols + lane;
    if (x_first >= static_cast<unsigned>(dw)) continue;
    float top_x[kCols], top_y[kCols], bot_x[kCols], bot_y[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float u = __fdiv_rn(static_cast<float>(x_first + 32 * j), dwm1);
      const float omu = __fsub_rn(1.0f, u);
      top_x[j] = edge(tl_x, tr_x, u, omu);
      top_y[j] = edge(tl_y, tr_y, u, omu);
      bot_x[j] = edge(bl_x, br_x, u, omu);
      bot_y[j] = edge(bl_y, br_y, u, omu);
    }
    walk_rows<kWide>(s, page, row_terms, sh, sw, rows, dw, y_first, x_first, top_x, top_y,
                     bot_x, bot_y);
  }
}

// src: (n, sh, sw) uint8; corners: (n, 4, 2) int32; dst: (n, rows, dw) uint8,
// page rows y0 .. y0 + rows - 1 of a dh x dw page.  Requires n, sh, sw, dh, dw,
// rows >= 1 and 0 <= y0 <= dh - rows.
int launch(const void* src, const void* corners, void* dst, int n, int sh, int sw, int dh, int dw,
           int y0, int rows, void* stream) {
  const long long groups = (static_cast<long long>(dw) + kCols - 1) / kCols;  // threads a row
  const int gx = static_cast<int>(groups < kThreads ? (groups + 31) / 32 * 32 : kThreads);
  const int ry = kThreads / gx;
  const long long span = static_cast<long long>(ry) * kRows;
  const long long tiles_y = (rows + span - 1) / span;
  const long long tiles_x = (groups + gx - 1) / gx;
  const long long blocks = n * tiles_y;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(tiles_x < 65535 ? tiles_x : 65535));
  const dim3 block(gx, ry);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const uint8_t*>(src);
  const auto* c = static_cast<const int*>(corners);
  auto* d = static_cast<uint8_t*>(dst);
  if (sw <= kExactLimit && sh <= kExactLimit && static_cast<long long>(sh) * sw <= INT_MAX) {
    quad_warp_kernel<false><<<grid, block, 0, st>>>(s, c, d, sh, sw, dh, dw, y0, rows,
                                                    static_cast<int>(tiles_y),
                                                    static_cast<int>(tiles_x));
  } else {
    quad_warp_kernel<true><<<grid, block, 0, st>>>(s, c, d, sh, sw, dh, dw, y0, rows,
                                                   static_cast<int>(tiles_y),
                                                   static_cast<int>(tiles_x));
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// src: (n, sh, sw) uint8; corners: (n, 4, 2) int32; dst: (n, dh, dw) uint8.
// Requires n, sh, sw, dh, dw >= 1.
int gs_quad_warp(const void* src, const void* corners, void* dst, int n, int sh, int sw, int dh,
                 int dw, void* stream) {
  return launch(src, corners, dst, n, sh, sw, dh, dw, 0, dh, stream);
}

// The rows y0 .. y0 + rows - 1 of gs_quad_warp's pages, into dst: (n, rows, dw)
// uint8 (a band of the page: the space-sharded scanner's shard).
int gs_quad_warp_rows(const void* src, const void* corners, void* dst, int n, int sh, int sw,
                      int dh, int dw, int y0, int rows, void* stream) {
  return launch(src, corners, dst, n, sh, sw, dh, dw, y0, rows, stream);
}

}  // extern "C"
