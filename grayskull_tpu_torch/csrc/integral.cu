// K4 gs_integral: the integral image (inclusive 2-D prefix sum, uint32 with
// wraparound) of a batch of uint8 frames, for Hopper (sm_90a), bound to Python
// through a plain C interface (grayskull_tpu_torch/kernels/_build.py).
//
// Replaces the Pallas kernel integral_pallas (grayskull_tpu/kernels/integral.py:111,
// body _integral_kernel), which ran both scans as triangular matmuls on the
// TPU's matrix unit, one pass over strips with a carried column sum.  Here the
// scans are plain integer adds.
//
// What bounds it: device memory.  Per pixel the minimum is 1 B read and 4 B
// written; the adds are nothing next to that.  So every output word is written
// once, and the bytes are read twice (the second time mostly from L2).
//
// What the design does about it: reduce, then scan, over bands of kBand rows.
//   1. band_totals_kernel, a block per (band, frame) but the last band: the
//      band's column sums, from 4-byte loads summed as 16-bit pairs, written
//      into the band's first output row.
//   2. carry_scan_kernel, a thread per (column, frame): each band's first row
//      becomes the column sums of every row above the band (an exclusive scan
//      down the bands, in place).
//   3. band_scan_kernel, a block per (band, frame): a thread owns 4
//      consecutive columns of a chunk of the row.  It reads its columns' carry
//      and the band's kBand rows of bytes at once, adds each row into running
//      column sums, and row-scans them: in the thread, across the warp by
//      shuffles, across warps through shared memory (one barrier a band), and
//      across chunks by a carry a row.  Each output word is stored once, one
//      16-byte store a thread a row.
// Bands of 16 rows in blocks of up to 256 threads are the fastest of
// chip_sweep.py --source integral on the H100 (PERF.md, which also records
// 8 or 16 pixels a thread, block-local carry sums, a single launch with a
// chained look-back and programmatic dependent launches, all slower or level).
// All arithmetic is uint32_t, so a sum past 2^32 wraps exactly as the
// reference's unsigned ints do, and any order of the adds gives the same bits.
// Frames whose rows are not 4-byte aligned (a width no multiple of 4, or a
// batch that starts inside a word, as imgs[1:] of a contiguous batch does)
// take a byte path: the same kernels with each byte loaded alone and each word
// stored alone.
//
// Each entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBand = 16;         // rows a band
constexpr int kPix = 4;           // consecutive pixels a thread owns in a row: one word
constexpr int kMaxThreads = 256;  // a block's threads: chunks of kMaxThreads * kPix columns
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kScanThreads = 256;
constexpr int kScanGroup = 8;     // band carries a scan thread loads before it stores
static_assert(kBand * 255 < 65536, "a band's column sums fit 16 bits");

// The 4 bytes of row `row` at columns x .. x + 3 as a word; the byte path
// reads each byte alone, and a column at or past w gives 0.
template <bool kVec>
__device__ __forceinline__ uint32_t load_pixels(const uint8_t* __restrict__ row, int x, int w) {
  if (kVec) return *reinterpret_cast<const uint32_t*>(row + x);
  uint32_t v = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (x + b < w) v |= static_cast<uint32_t>(row[x + b]) << (8 * b);
  }
  return v;
}

// The 4 words at out[x ..]: one 16-byte store, or a word at a time below w.
template <bool kVec>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ out, int x, int w,
                                            const uint32_t (&v)[kPix]) {
  if (kVec) {
    *reinterpret_cast<uint4*>(out + x) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if (x + k < w) out[x + k] = v[k];
    }
  }
}

// Grid (nb - 1, n), block a multiple of 32 threads: band b's column sums into
// its first output row (row b * kBand).
template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
band_totals_kernel(const uint8_t* __restrict__ src, uint32_t* __restrict__ dst, int h, int w) {
  const int y0 = blockIdx.x * kBand;
  const size_t first = (static_cast<size_t>(blockIdx.y) * h + y0) * w;
  const uint8_t* s = src + first;
  uint32_t* d = dst + first;
  for (int x = threadIdx.x * kPix; x < w; x += blockDim.x * kPix) {
    // the word's even and odd bytes summed as two 16-bit lanes each
    uint32_t even = 0u, odd = 0u;
#pragma unroll
    for (int r = 0; r < kBand; ++r) {  // a band before the last is whole
      const uint32_t v = load_pixels<kVec>(s + static_cast<size_t>(r) * w, x, w);
      even += v & 0x00ff00ffu;
      odd += (v >> 8) & 0x00ff00ffu;
    }
    const uint32_t t[kPix] = {even & 0xffffu, odd & 0xffffu, even >> 16, odd >> 16};
    store_words<kVec>(d, x, w, t);
  }
}

// Grid (ceil(w / kScanThreads), n): a thread walks column x down the bands;
// band b's first row, which holds its column sums for b < nb - 1, becomes the
// sum of every band above it (band 0's row is left alone).
__global__ void carry_scan_kernel(uint32_t* __restrict__ dst, int h, int w, int nb) {
  const int x = blockIdx.x * kScanThreads + threadIdx.x;
  if (x >= w) return;
  uint32_t* col = dst + static_cast<size_t>(blockIdx.y) * h * w + x;
  const size_t band = static_cast<size_t>(kBand) * w;
  uint32_t run = 0;
  for (int b0 = 0; b0 < nb; b0 += kScanGroup) {
    uint32_t t[kScanGroup];
#pragma unroll
    for (int i = 0; i < kScanGroup; ++i) {  // the loads first: the stores may alias them
      t[i] = b0 + i < nb - 1 ? col[(b0 + i) * band] : 0u;
    }
#pragma unroll
    for (int i = 0; i < kScanGroup; ++i) {
      const int b = b0 + i;
      if (b > 0 && b < nb) col[b * band] = run;
      run += t[i];
    }
  }
}

// Grid (nb, n), block a multiple of 32 threads (at most kMaxThreads): band b's
// rows of the integral.  Bands after the first read their column carries from
// their first row, where carry_scan_kernel left them.
template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
band_scan_kernel(const uint8_t* __restrict__ src, uint32_t* __restrict__ dst, int h, int w) {
  __shared__ uint32_t warp_total[kBand][kMaxWarps];
  __shared__ uint32_t row_carry[kBand];
  const int y0 = blockIdx.x * kBand;
  const int rows = min(kBand, h - y0);
  const size_t first = (static_cast<size_t>(blockIdx.y) * h + y0) * w;
  const uint8_t* s = src + first;
  uint32_t* d = dst + first;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const int chunk = blockDim.x * kPix;
  if (threadIdx.x < kBand) row_carry[threadIdx.x] = 0u;
  for (int x0 = 0; x0 < w; x0 += chunk) {
    const int x = x0 + threadIdx.x * kPix;
    const bool live = x < w;
    uint32_t carry[kPix] = {};  // the column sums of every row above the band
    if (blockIdx.x > 0 && live) {
      if (kVec) {
        const uint4 t = *reinterpret_cast<const uint4*>(d + x);
        carry[0] = t.x;
        carry[1] = t.y;
        carry[2] = t.z;
        carry[3] = t.w;
      } else {
#pragma unroll
        for (int k = 0; k < kPix; ++k) carry[k] = x + k < w ? d[x + k] : 0u;
      }
    }
    uint32_t raw[kBand];  // every row's bytes in flight at once
#pragma unroll
    for (int r = 0; r < kBand; ++r) {
      raw[r] = r < rows && live ? load_pixels<kVec>(s + static_cast<size_t>(r) * w, x, w) : 0u;
    }
    // each row's sum over the thread's running column sums, then the warp's
    // exclusive prefix of it; lane 31 leaves the warp's total for the others
    uint32_t before[kBand];
    {
      uint32_t col[kPix];
#pragma unroll
      for (int k = 0; k < kPix; ++k) col[k] = carry[k];
#pragma unroll
      for (int r = 0; r < kBand; ++r) {
        uint32_t t = 0u;
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          col[k] += ((raw[r] >> (8 * k)) & 0xffu);
          t += col[k];
        }
        uint32_t v = t;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const uint32_t up = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += up;
        }
        before[r] = v - t;
        if (lane == 31) warp_total[r][warp] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kBand; ++r) {  // carry[] now runs down the band as the column sums
      if (r < rows) {
        uint32_t run = before[r] + row_carry[r];
        for (int q = 0; q < warp; ++q) run += warp_total[r][q];
        uint32_t out[kPix];
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          carry[k] += ((raw[r] >> (8 * k)) & 0xffu);
          run += carry[k];
          out[k] = run;
        }
        if (live) store_words<kVec>(d + static_cast<size_t>(r) * w, x, w, out);
      }
    }
    if (x0 + chunk < w) {  // the next chunk starts each row at this one's total
      __syncthreads();
      if (threadIdx.x < rows) {
        for (int q = 0; q < warps; ++q) row_carry[threadIdx.x] += warp_total[threadIdx.x][q];
      }
      __syncthreads();
    }
  }
}

template <bool kVec>
cudaError_t launch(const uint8_t* src, uint32_t* dst, int n, int h, int w, int nb, int threads,
                   cudaStream_t st) {
  if (nb > 1) {
    band_totals_kernel<kVec><<<dim3(nb - 1, n), threads, 0, st>>>(src, dst, h, w);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    carry_scan_kernel<<<dim3((w + kScanThreads - 1) / kScanThreads, n), kScanThreads, 0, st>>>(
        dst, h, w, nb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  band_scan_kernel<kVec><<<dim3(nb, n), threads, 0, st>>>(src, dst, h, w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// src: (n, h, w) uint8; dst: (n, h, w) uint32.  Requires 1 <= n <= 65535 and
// h, w >= 1.
int gs_integral(const void* src, void* dst, int n, int h, int w, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (h + kBand - 1) / kBand;
  const int cols = (w + kPix - 1) / kPix;
  const int threads = cols >= kMaxThreads ? kMaxThreads : (cols + 31) / 32 * 32;
  const auto* s = static_cast<const uint8_t*>(src);
  auto* d = static_cast<uint32_t*>(dst);
  const bool vec = w % kPix == 0 && reinterpret_cast<uintptr_t>(src) % kPix == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  return vec ? launch<true>(s, d, n, h, w, nb, threads, st)
             : launch<false>(s, d, n, h, w, nb, threads, st);
}

}  // extern "C"
