// K14 gs_resize: the bilinear resize of gs_resize (grayskull.h:171-187) for a
// batch of uint8 frames, for Hopper (sm_90a), bound to Python through a plain C
// interface (grayskull_tpu_torch/kernels/_build.py).
//
// Replaces the Pallas kernel resize_pallas (grayskull_tpu/kernels/resize.py:217,
// body _kernel :156), which picks the four corner samples of each output pixel
// with one-hot matrix products over a source band and host-made coordinate and
// weight tables, for want of a gather on the TPU.  Here one thread per output
// pixel computes its own coordinates from (sh, sw, dh, dw), gathers the four
// corners and lerps: no tables, no host-to-device copy, no host sync, and no
// shape gate (1-row or 1-column sources, up- and downscales, any width).
//
// Float order: every operation rounds on its own, as in the reference and the
// JAX package (grayskull_tpu/ops/pixel.py:128-179; the build passes
// -fmad=false, and the intrinsics say so too):
//   s = ((x + 0.5f) * (float)sw) / (float)dw - 0.5f, clamped to [0, sw - 1]
//   i0 = (int)s, i1 = min(i0 + 1, sw - 1), d = s - (float)i0   (the same for y)
//   ((c00*(1-dx))*(1-dy) + (c01*dx)*(1-dy)) + (c10*(1-dx))*dy) + (c11*dx)*dy
//   truncating uint8 store.
//
// What bounds it: device memory.  Minimum traffic is each source frame read
// once and each output byte written once; the gathers of neighbouring threads
// hit neighbouring source pixels, so they are served from L1/L2.  About 40
// float operations a pixel (two divisions among them) are far below the card's
// rate.  A block is 32 columns by 8 rows of one frame, so a warp writes 32
// neighbouring bytes.
//
// Each entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlockW = 32;
constexpr int kBlockH = 8;

struct Coord {
  int i0, i1;
  float d;
};

// The source coordinate of output index `o` along an axis of `src_n` source and
// `dst_n` output pixels, in C's float order.
__device__ __forceinline__ Coord source_coord(int o, int src_n, int dst_n) {
  const float hi = __fsub_rn(static_cast<float>(src_n), 1.0f);
  float s = __fsub_rn(__fdiv_rn(__fmul_rn(__fadd_rn(static_cast<float>(o), 0.5f),
                                          static_cast<float>(src_n)),
                                static_cast<float>(dst_n)),
                      0.5f);
  s = fmaxf(0.0f, fminf(s, hi));
  Coord c;
  c.i0 = __float2int_rz(s);
  c.i1 = min(c.i0 + 1, src_n - 1);
  c.d = __fsub_rn(s, static_cast<float>(c.i0));
  return c;
}

// Grid: (dw / 32, dh / 8, frames), rounded up; frames past gridDim.z loop.
__global__ void resize_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int n,
                              int sh, int sw, int dh, int dw) {
  const int x = blockIdx.x * kBlockW + threadIdx.x;
  const int y = blockIdx.y * kBlockH + threadIdx.y;
  if (x >= dw || y >= dh) return;
  const Coord cx = source_coord(x, sw, dw);
  const Coord cy = source_coord(y, sh, dh);
  const float ndx = __fsub_rn(1.0f, cx.d);
  const float ndy = __fsub_rn(1.0f, cy.d);
  const size_t r0 = static_cast<size_t>(cy.i0) * sw;
  const size_t r1 = static_cast<size_t>(cy.i1) * sw;
  for (int f = blockIdx.z; f < n; f += gridDim.z) {
    const uint8_t* s = src + static_cast<size_t>(f) * sh * sw;
    const float c00 = s[r0 + cx.i0];
    const float c01 = s[r0 + cx.i1];
    const float c10 = s[r1 + cx.i0];
    const float c11 = s[r1 + cx.i1];
    const float t1 = __fmul_rn(__fmul_rn(c00, ndx), ndy);
    const float t2 = __fmul_rn(__fmul_rn(c01, cx.d), ndy);
    const float t3 = __fmul_rn(__fmul_rn(c10, ndx), cy.d);
    const float t4 = __fmul_rn(__fmul_rn(c11, cx.d), cy.d);
    const float p = __fadd_rn(__fadd_rn(__fadd_rn(t1, t2), t3), t4);
    dst[static_cast<size_t>(f) * dh * dw + static_cast<size_t>(y) * dw + x] =
        static_cast<uint8_t>(__float2uint_rz(p));
  }
}

}  // namespace

extern "C" {

// src: (n, sh, sw) uint8; dst: (n, dh, dw) uint8.  Requires every size >= 1.
int gs_resize(const void* src, void* dst, int n, int sh, int sw, int dh, int dw, void* stream) {
  const dim3 block(kBlockW, kBlockH);
  const dim3 grid((dw + kBlockW - 1) / kBlockW, (dh + kBlockH - 1) / kBlockH,
                  n < 65535 ? n : 65535);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  resize_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), n, sh, sw, dh, dw);
  return cudaGetLastError();
}

}  // extern "C"
