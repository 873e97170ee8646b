// K3 gs_otsu: Otsu's threshold from per-frame 256-bin histograms, for Hopper
// (sm_90a), bound to Python through a plain C interface.
//
// Replaces the XLA sweep grayskull_tpu/ops/histogram.py:_otsu_from_hist (:55-104),
// which the preprocess main path runs between the blur+histogram kernel and the
// threshold+Sobel kernel.  It is not a Pallas kernel, but in eager PyTorch its
// 256 serial steps would cost thousands of launches per batch.
//
// What bounds it: latency, not bandwidth.  It reads 1 KiB and writes 1 B per
// frame, but each frame is a chain of 512 dependent float operations (two
// serial loops over the bins, the second with two divides per step).
//
// What the design does about it: one thread per frame replays the sweep in the C
// reference's order (gs_otsu_threshold), so a batch of frames runs its chains in
// parallel and the whole sweep is one launch.  Bit-exactness needs every float
// operation rounded on its own: the sweep uses the _rn intrinsics, which nvcc
// never contracts into FMA, and the library is built with -fmad=false as well.
//
// Each entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void otsu_kernel(const int* __restrict__ hist, uint8_t* __restrict__ out, int n,
                            unsigned total) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n) return;
  const int* hf = hist + static_cast<size_t>(f) * 256;

  // sum: (float)i * hist[i], each product rounded, added in bin order.
  float total_sum = 0.0f;
  for (int i = 0; i < 256; ++i) {
    const float term = __fmul_rn(static_cast<float>(i), __uint2float_rn(static_cast<unsigned>(hf[i])));
    total_sum = __fadd_rn(total_sum, term);
  }

  unsigned wb = 0;
  float sum_b = 0.0f;
  float var_max = -1.0f;
  int thr = 0;
  for (int t = 0; t < 256; ++t) {
    const unsigned ht = static_cast<unsigned>(hf[t]);
    wb += ht;
    if (wb == 0) continue;
    const unsigned wf = total - wb;
    if (wf == 0) break;  // before sum_b takes this bin, as in C
    sum_b = __fadd_rn(sum_b, __fmul_rn(static_cast<float>(t), __uint2float_rn(ht)));
    const float fb = __uint2float_rn(wb);
    const float ff = __uint2float_rn(wf);
    const float m_b = __fdiv_rn(sum_b, fb);
    const float m_f = __fdiv_rn(__fsub_rn(total_sum, sum_b), ff);
    const float d = __fsub_rn(m_b, m_f);
    const float var = __fmul_rn(__fmul_rn(__fmul_rn(fb, ff), d), d);
    if (var > var_max) {  // strict: the first maximum wins
      var_max = var;
      thr = t;
    }
  }
  out[f] = static_cast<uint8_t>(thr);
}

}  // namespace

extern "C" {

// hist: (n, 256) int32 counts; out: (n,) uint8; total: pixels per frame.
int gs_otsu(const void* hist, void* out, int n, int total, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  otsu_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(hist), static_cast<uint8_t*>(out), n, static_cast<unsigned>(total));
  return cudaGetLastError();
}

}  // extern "C"
