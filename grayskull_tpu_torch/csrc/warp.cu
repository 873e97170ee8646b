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
// run in XLA (grayskull_tpu/ops/warp.py:25-65).  Here one thread per output
// pixel does all three: coordinates, four gathers, lerp.
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
// What bounds it: device memory.  Minimum traffic is each source frame read
// once and each page byte written once; the gathers hit L1/L2 since
// neighbouring threads sample neighbouring source pixels.  About 60 float
// operations a pixel are far below the card's rate.
//
// Each entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float edge(float p0, float p1, float t, float one_minus_t) {
  return __fadd_rn(__fmul_rn(p0, one_minus_t), __fmul_rn(p1, t));
}

// max(0, min(v, hi)), a NaN to 0 (fminf would give hi)
__device__ __forceinline__ float clamp_coord(float v, float hi) {
  v = v > hi ? hi : v;
  return v >= 0.0f ? v : 0.0f;
}

__global__ void quad_warp_kernel(const uint8_t* __restrict__ src,
                                 const int* __restrict__ corners, uint8_t* __restrict__ dst,
                                 long long total, int sh, int sw, int dh, int dw) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long page = static_cast<long long>(dh) * dw;
  const long long f = i / page;
  const int rem = static_cast<int>(i - f * page);
  const int y = rem / dw;
  const int x = rem - y * dw;

  const int* c = corners + f * 8;  // (x, y) rows: TL, TR, BR, BL
  const float u = __fdiv_rn(static_cast<float>(x), static_cast<float>(dw - 1));
  const float v = __fdiv_rn(static_cast<float>(y), static_cast<float>(dh - 1));
  const float omu = __fsub_rn(1.0f, u);
  const float omv = __fsub_rn(1.0f, v);
  const float top_x = edge(static_cast<float>(c[0]), static_cast<float>(c[2]), u, omu);
  const float top_y = edge(static_cast<float>(c[1]), static_cast<float>(c[3]), u, omu);
  const float bot_x = edge(static_cast<float>(c[6]), static_cast<float>(c[4]), u, omu);
  const float bot_y = edge(static_cast<float>(c[7]), static_cast<float>(c[5]), u, omu);
  const float sx = clamp_coord(edge(top_x, bot_x, v, omv), static_cast<float>(sw) - 1.0f);
  const float sy = clamp_coord(edge(top_y, bot_y, v, omv), static_cast<float>(sh) - 1.0f);

  const int x0 = __float2int_rz(sx);
  const int y0 = __float2int_rz(sy);
  const int x1 = min(x0 + 1, sw - 1);
  const int y1 = min(y0 + 1, sh - 1);
  const float dx = __fsub_rn(sx, static_cast<float>(x0));
  const float dy = __fsub_rn(sy, static_cast<float>(y0));
  const float omdx = __fsub_rn(1.0f, dx);
  const float omdy = __fsub_rn(1.0f, dy);

  const uint8_t* s = src + f * sh * static_cast<long long>(sw);
  const float c00 = s[static_cast<long long>(y0) * sw + x0];
  const float c01 = s[static_cast<long long>(y0) * sw + x1];
  const float c10 = s[static_cast<long long>(y1) * sw + x0];
  const float c11 = s[static_cast<long long>(y1) * sw + x1];
  const float t1 = __fmul_rn(__fmul_rn(c00, omdx), omdy);
  const float t2 = __fmul_rn(__fmul_rn(c01, dx), omdy);
  const float t3 = __fmul_rn(__fmul_rn(c10, omdx), dy);
  const float t4 = __fmul_rn(__fmul_rn(c11, dx), dy);
  const float sum = __fadd_rn(__fadd_rn(__fadd_rn(t1, t2), t3), t4);
  dst[i] = static_cast<uint8_t>(__float2uint_rz(sum));
}

}  // namespace

extern "C" {

// src: (n, sh, sw) uint8; corners: (n, 4, 2) int32; dst: (n, dh, dw) uint8.
// Requires n, sh, sw, dh, dw >= 1.
int gs_quad_warp(const void* src, const void* corners, void* dst, int n, int sh, int sw, int dh,
                 int dw, void* stream) {
  const long long total = static_cast<long long>(n) * dh * dw;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  quad_warp_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const int*>(corners),
      static_cast<uint8_t*>(dst), total, sh, sw, dh, dw);
  return cudaGetLastError();
}

}  // extern "C"
