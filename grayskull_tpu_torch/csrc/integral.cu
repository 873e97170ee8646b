// K4 gs_integral: the integral image (inclusive 2-D prefix sum, uint32 with
// wraparound) of a batch of uint8 frames, for Hopper (sm_90a), bound to Python
// through a plain C interface (grayskull_tpu_torch/kernels/_build.py).
//
// Replaces the Pallas kernel integral_pallas (grayskull_tpu/kernels/integral.py:111,
// body _integral_kernel), which ran both scans as triangular matmuls on the
// TPU's matrix unit.  Here the scans are plain integer adds.
//
// What bounds it: device memory.  Per pixel the minimum is 1 B read and 4 B
// written; the adds are nothing next to that.  The column scan is a chain of
// dependent adds down each column, so it also needs enough columns in flight.
//
// What the design does about it: two launches on one stream.
//   1. Row scan: one warp per row.  Lanes read 32 consecutive pixels, take an
//      inclusive warp scan with __shfl_up_sync, add the running carry of the
//      row and write 32 consecutive words (one 128-B store per step).
//   2. Column scan, in place: a block owns 32 adjacent columns of one frame and
//      cuts the rows into kColSegs segments, one warp each.  Each lane scans
//      its column within its segment (reads and writes coalesce across the
//      warp), the segment totals are combined in shared memory, and a second
//      walk adds each segment's carry.  That gives N*W/32*kColSegs independent
//      chains instead of N*W chains of length H.
// The output (39 MB for 32 frames of 640x480) mostly stays in the 50 MB L2
// between the two launches.  All arithmetic is uint32_t, so a sum past 2^32
// wraps exactly as the reference's unsigned ints do (signed overflow would be
// undefined).
//
// Each entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRowWarps = 8;   // rows per block in the row scan
constexpr int kColSegs = 16;   // row segments per block in the column scan

__global__ void row_scan_kernel(const uint8_t* __restrict__ src, uint32_t* __restrict__ dst,
                                long long rows, int w) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const uint8_t* s = src + row * w;
  uint32_t* d = dst + row * w;
  uint32_t carry = 0;
  for (int x0 = 0; x0 < w; x0 += 32) {
    const int x = x0 + lane;
    uint32_t v = x < w ? s[x] : 0u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t up = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += up;
    }
    v += carry;
    if (x < w) d[x] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// Block (32, kColSegs): threadIdx.x picks the column, threadIdx.y the segment.
// Grid (ceil(w / 32), n).
__global__ void col_scan_kernel(uint32_t* __restrict__ img, int h, int w) {
  __shared__ uint32_t seg_total[kColSegs][32];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int seg = threadIdx.y;
  const int seg_len = (h + kColSegs - 1) / kColSegs;
  const int y0 = min(seg * seg_len, h);
  const int y1 = min(y0 + seg_len, h);
  uint32_t* f = img + static_cast<size_t>(blockIdx.y) * h * w;
  const bool live = col < w;

  uint32_t run = 0;
  if (live) {
    for (int y = y0; y < y1; ++y) {
      run += f[static_cast<size_t>(y) * w + col];
      f[static_cast<size_t>(y) * w + col] = run;
    }
  }
  seg_total[seg][threadIdx.x] = run;
  __syncthreads();
  uint32_t carry = 0;
  for (int s = 0; s < seg; ++s) carry += seg_total[s][threadIdx.x];
  if (live && carry != 0) {
    for (int y = y0; y < y1; ++y) f[static_cast<size_t>(y) * w + col] += carry;
  }
}

}  // namespace

extern "C" {

// src: (n, h, w) uint8; dst: (n, h, w) uint32.  Requires n, h, w >= 1.
int gs_integral(const void* src, void* dst, int n, int h, int w, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(n) * h;
  const long long row_blocks = (rows + kRowWarps - 1) / kRowWarps;
  if (row_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  row_scan_kernel<<<static_cast<unsigned>(row_blocks), 32 * kRowWarps, 0, st>>>(
      static_cast<const uint8_t*>(src), static_cast<uint32_t*>(dst), rows, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((w + 31) / 32, n);
  col_scan_kernel<<<grid, dim3(32, kColSegs), 0, st>>>(static_cast<uint32_t*>(dst), h, w);
  return cudaGetLastError();
}

}  // extern "C"
