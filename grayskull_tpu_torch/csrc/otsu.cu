// K3 gs_otsu: Otsu's threshold from per-frame 256-bin histograms, for Hopper
// (sm_90a), bound to Python through a plain C interface.
//
// Replaces the XLA sweep grayskull_tpu/ops/histogram.py:_otsu_from_hist (:55-104),
// which the preprocess main path runs between the blur+histogram kernel and the
// threshold+Sobel kernel.  It is not a Pallas kernel, but in eager PyTorch its
// 256 serial steps would cost thousands of launches per batch.
//
// What bounds it: latency, not bandwidth.  It reads 1 KiB and writes 1 B per
// frame.  Bit-exactness with C's sweep (gs_otsu_threshold) forces two float
// sums to run bin by bin in C's order: the total of (float)i * hist[i] over all
// 256 bins, and sumB over the bins the sweep takes.  Each is 256 dependent
// adds, so a frame cannot take less than 256 add latencies.
//
// What the design does about it: only those two chains are serial, so only
// they run on one lane.  kLanes lanes take a frame, kBins = 256 / kLanes
// consecutive bins each, and a block takes kFrames frames (a warp a block:
// chip_sweep.py --source otsu timed 8, 16 and 32 lanes and 1 to 16 frames a
// block on the H100, and this was the fastest at 1, 8 and 256 frames):
//   1. the lanes load the frame's 1 KiB in one pass (16-byte loads where the
//      histograms are 16-byte aligned);
//   2. the uint32 weight prefix wb (it wraps as C's does, and a wrapping sum
//      is associative) is each lane's own prefix plus a scan across the lanes;
//      from it come the bins C skips (wb == 0) and the first bin where it
//      breaks (a bin it does not skip with total - wb == 0), a minimum across
//      the lanes;
//   3. each lane writes its bins' products to shared memory twice, the second
//      time as 0 on the bins sumB does not take (skipped, or at or past the
//      break): x + 0 is x, so the prefix over that row is sumB at every bin
//      the sweep takes;
//   4. the frame's first lane runs the two chains, interleaved, with
//      __fadd_rn and writes sumB's prefix back in place;
//   5. every lane computes its bins' variances ((wb*wf)*d)*d with the same _rn
//      intrinsics as C's order gives, and the lanes reduce to the largest,
//      ties to the lowest bin: C's strict first maximum, since a bin the sweep
//      takes has a finite variance >= 0 > -1.  A frame with no such bin gives 0.
// Nothing here is contracted into FMA: the _rn intrinsics never are, and the
// library is built with -fmad=false as well.
//
// Each entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // lanes a frame: 8, 16 or 32
constexpr int kFrames = 1;  // frames a block
constexpr int kBins = 256 / kLanes;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kLanes * kFrames % 32 == 0, "a block holds whole warps");
static_assert(kBins % 4 == 0, "a lane's bins are whole 16-byte words");

template <bool kAligned>
__device__ __forceinline__ void load_counts(const int* hf, unsigned (&c)[kBins]) {
  if (kAligned) {
#pragma unroll
    for (int k = 0; k < kBins; k += 4) {
      const int4 v = *reinterpret_cast<const int4*>(hf + k);
      c[k] = static_cast<unsigned>(v.x);
      c[k + 1] = static_cast<unsigned>(v.y);
      c[k + 2] = static_cast<unsigned>(v.z);
      c[k + 3] = static_cast<unsigned>(v.w);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kBins; ++k) c[k] = static_cast<unsigned>(hf[k]);
  }
}

template <bool kAligned>
__global__ void __launch_bounds__(kLanes * kFrames)
    otsu_kernel(const int* __restrict__ hist, uint8_t* __restrict__ out, int n, unsigned total) {
  __shared__ __align__(16) float terms_s[kFrames][256];   // (float)i * hist[i]
  __shared__ __align__(16) float prefix_s[kFrames][256];  // the terms sumB takes; then its prefix
  const int slot = threadIdx.x / kLanes;
  const int g = threadIdx.x % kLanes;
  const int f = blockIdx.x * kFrames + slot;
  const bool valid = f < n;  // a frame past n still takes part in the shuffles
  const int t0 = g * kBins;

  unsigned c[kBins];
  if (valid) {
    load_counts<kAligned>(hist + static_cast<size_t>(f) * 256 + t0, c);
  } else {
#pragma unroll
    for (int k = 0; k < kBins; ++k) c[k] = 0u;
  }

  // wb at each bin: the lane's own prefix, then the lanes before it
  unsigned wb[kBins];
  unsigned run = 0u;
#pragma unroll
  for (int k = 0; k < kBins; ++k) {
    run += c[k];
    wb[k] = run;
  }
  unsigned incl = run;
#pragma unroll
  for (int d = 1; d < kLanes; d *= 2) {
    const unsigned up = __shfl_up_sync(kFull, incl, d, kLanes);
    if (g >= d) incl += up;
  }
  const unsigned before = incl - run;
#pragma unroll
  for (int k = 0; k < kBins; ++k) wb[k] += before;

  // C's break: the first bin it does not skip where wf == 0
  int brk = 256;
#pragma unroll
  for (int k = kBins - 1; k >= 0; --k) {
    if (wb[k] != 0u && total - wb[k] == 0u) brk = t0 + k;
  }
#pragma unroll
  for (int d = kLanes / 2; d >= 1; d /= 2) brk = min(brk, __shfl_xor_sync(kFull, brk, d, kLanes));

  float* ts = terms_s[slot];
  float* ps = prefix_s[slot];
#pragma unroll
  for (int k = 0; k < kBins; k += 4) {
    float term[4], taken[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + k + j;
      term[j] = __fmul_rn(static_cast<float>(t), __uint2float_rn(c[k + j]));
      taken[j] = wb[k + j] != 0u && t < brk ? term[j] : 0.0f;
    }
    *reinterpret_cast<float4*>(ts + t0 + k) = make_float4(term[0], term[1], term[2], term[3]);
    *reinterpret_cast<float4*>(ps + t0 + k) = make_float4(taken[0], taken[1], taken[2], taken[3]);
  }
  __syncwarp();

  // the two serial chains, in bin order, on the frame's first lane
  float total_sum = 0.0f;
  if (g == 0) {
    float sum_b = 0.0f;
#pragma unroll 8
    for (int t = 0; t < 256; t += 4) {
      const float4 a = *reinterpret_cast<const float4*>(ts + t);
      float4 b = *reinterpret_cast<const float4*>(ps + t);
      total_sum = __fadd_rn(total_sum, a.x);
      sum_b = __fadd_rn(sum_b, b.x);
      b.x = sum_b;
      total_sum = __fadd_rn(total_sum, a.y);
      sum_b = __fadd_rn(sum_b, b.y);
      b.y = sum_b;
      total_sum = __fadd_rn(total_sum, a.z);
      sum_b = __fadd_rn(sum_b, b.z);
      b.z = sum_b;
      total_sum = __fadd_rn(total_sum, a.w);
      sum_b = __fadd_rn(sum_b, b.w);
      b.w = sum_b;
      *reinterpret_cast<float4*>(ps + t) = b;
    }
  }
  __syncwarp();
  total_sum = __shfl_sync(kFull, total_sum, 0, kLanes);

  // each lane's bins, lowest first, with C's strict first-maximum update
  float var_max = -1.0f;
  int thr = 0;
#pragma unroll
  for (int k = 0; k < kBins; ++k) {
    const int t = t0 + k;
    const bool taken = wb[k] != 0u && t < brk;
    const float sum_b = ps[t];
    const float fb = taken ? __uint2float_rn(wb[k]) : 1.0f;  // 1: no division by 0 off the sweep
    const float ff = taken ? __uint2float_rn(total - wb[k]) : 1.0f;
    const float m_b = __fdiv_rn(sum_b, fb);
    const float m_f = __fdiv_rn(__fsub_rn(total_sum, sum_b), ff);
    const float d = __fsub_rn(m_b, m_f);
    const float var = __fmul_rn(__fmul_rn(__fmul_rn(fb, ff), d), d);
    if (taken && var > var_max) {
      var_max = var;
      thr = t;
    }
  }
  // across the lanes: the larger variance, ties to the lower bin
#pragma unroll
  for (int d = kLanes / 2; d >= 1; d /= 2) {
    const float v = __shfl_xor_sync(kFull, var_max, d, kLanes);
    const int u = __shfl_xor_sync(kFull, thr, d, kLanes);
    if (v > var_max || (v == var_max && u < thr)) {
      var_max = v;
      thr = u;
    }
  }
  if (valid && g == 0) out[f] = static_cast<uint8_t>(thr);
}

}  // namespace

extern "C" {

// hist: (n, 256) int32 counts; out: (n,) uint8; total: pixels per frame.
int gs_otsu(const void* hist, void* out, int n, int total, void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + kFrames - 1) / kFrames);
  const auto h = static_cast<const int*>(hist);
  const auto o = static_cast<uint8_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(hist) % 16 == 0) {
    otsu_kernel<true><<<blocks, kLanes * kFrames, 0, s>>>(h, o, n, static_cast<unsigned>(total));
  } else {
    otsu_kernel<false><<<blocks, kLanes * kFrames, 0, s>>>(h, o, n, static_cast<unsigned>(total));
  }
  return cudaGetLastError();
}

}  // extern "C"
