// K7 gs_orb_moments and K8 gs_orb_brief: the keypoint-window stages of ORB
// (gs_compute_orientation and gs_brief_descriptor, grayskull.h:608-637) for
// Hopper (sm_90a), bound to Python through a plain C interface
// (grayskull_tpu_torch/kernels/_build.py).
//
// Both replace the Pallas kernel _extract_pallas (grayskull_tpu/kernels/
// patches.py:99), which cut a zero-padded 48x48 patch per keypoint out of an
// aligned VMEM window with two one-hot matrix products, because the TPU has no
// fast gather; ops/features.py then reduced the patches with disc masks
// (features.py:495-512) and one-hot samplers (features.py:515-564).  On the card
// a gather is an ordinary load, so neither kernel writes patches: each reads
// its keypoint's window straight from the frame, and a read outside the frame
// gives 0, as the patch's zero padding did.  The trig (atan2f, sinf) stays
// outside, in grayskull_tpu_torch/libm32.py, so that a trig mode gives the same
// angles on the card as on the CPU.
//
// K7 orb_moments: m01 = sum dy * p and m10 = sum dx * p over the disc
// dx^2 + dy^2 <= r^2 around (x, y), in int32 (|m| < 2^23 for r <= 20: exact).
// K8 orb_brief: for pair i of the 256-pair pattern (x1, y1, x2, y2),
// dx = (int)(px * cos - py * sin) and dy = (int)(px * sin + py * cos) for each
// endpoint, with every product and sum rounded to float32 on its own
// (__fmul_rn, __fsub_rn, __fadd_rn; the build also passes -fmad=false) and the
// cast truncating toward zero (__float2int_rz), as C's (int) does; bit i % 32
// of word i / 32 is set when the sample at (x + dx1, y + dy1) is brighter than
// the one at (x + dx2, y + dy2).
//
// What bounds them: latency.  They are small: 8,000 keypoints (16 frames x
// 500) read 709 disc pixels and 512 samples each, about 10 MB of scattered
// bytes, mostly from L1/L2, and 0.3 MB of output.  A keypoint's reads are
// dependent on nothing but its coordinates, so the limit is how many loads
// are in flight.
//
// What the design does about it: one warp per keypoint.  In K7 a lane takes a
// row of the disc (dy = lane - r; r = 15 gives 31 rows) and sums it, and a
// shuffle reduction adds the rows, so each lane's loads are contiguous bytes
// of one row.  In K8 a lane takes pair 32 * j + lane of word j, so one
// __ballot_sync builds each word; the lane's eight pairs sit in registers,
// loaded once, and each warp walks over keypoints in a grid-stride loop.
// Lane j stores word j, one 32-byte store per keypoint.
//
// Each entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBriefBlocks = 132 * 16;  // enough warps to fill the card, then loop

__device__ __forceinline__ int pixel(const uint8_t* __restrict__ f, int x, int y, int h, int w) {
  return (x >= 0 && x < w && y >= 0 && y < h) ? f[static_cast<size_t>(y) * w + x] : 0;
}

// Grid ceil(n * k / kWarps), block kThreads; one warp per keypoint.
__global__ void orb_moments_kernel(const uint8_t* __restrict__ imgs, const int* __restrict__ xs,
                                   const int* __restrict__ ys, int* __restrict__ m01,
                                   int* __restrict__ m10, int n, int h, int w, int k, int r) {
  const int kp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (kp >= n * k) return;  // the whole warp leaves together
  const uint8_t* f = imgs + static_cast<size_t>(kp / k) * h * w;
  const int x = xs[kp], y = ys[kp];
  int s01 = 0, s10 = 0;
  for (int dy = lane - r; dy <= r; dy += 32) {
    int half = r;  // the disc's half-width on this row
    while (half * half + dy * dy > r * r) --half;
    int sum = 0, dsum = 0;
    for (int dx = -half; dx <= half; ++dx) {
      const int p = pixel(f, x + dx, y + dy, h, w);
      sum += p;
      dsum += dx * p;
    }
    s01 += dy * sum;
    s10 += dsum;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s01 += __shfl_down_sync(0xffffffffu, s01, off);
    s10 += __shfl_down_sync(0xffffffffu, s10, off);
  }
  if (lane == 0) {
    m01[kp] = s01;
    m10[kp] = s10;
  }
}

// Grid min(ceil(n * k / kWarps), kMaxBriefBlocks), block kThreads; each warp
// walks over keypoints kp = warp, warp + all warps, ...
__global__ void orb_brief_kernel(const uint8_t* __restrict__ imgs, const int* __restrict__ xs,
                                 const int* __restrict__ ys, const float* __restrict__ sins,
                                 const float* __restrict__ coss,
                                 const float* __restrict__ pattern, uint32_t* __restrict__ desc,
                                 int n, int h, int w, int k) {
  const int lane = threadIdx.x % 32;
  float px1[8], py1[8], px2[8], py2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float* p = pattern + 4 * (32 * j + lane);
    px1[j] = p[0];
    py1[j] = p[1];
    px2[j] = p[2];
    py2[j] = p[3];
  }
  const int total = n * k;
  const int stride = gridDim.x * kWarps;
  for (int kp = (blockIdx.x * blockDim.x + threadIdx.x) / 32; kp < total; kp += stride) {
    const uint8_t* f = imgs + static_cast<size_t>(kp / k) * h * w;
    const int x = xs[kp], y = ys[kp];
    const float s = sins[kp], c = coss[kp];
    uint32_t mine = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int dx1 = __float2int_rz(__fsub_rn(__fmul_rn(px1[j], c), __fmul_rn(py1[j], s)));
      const int dy1 = __float2int_rz(__fadd_rn(__fmul_rn(px1[j], s), __fmul_rn(py1[j], c)));
      const int dx2 = __float2int_rz(__fsub_rn(__fmul_rn(px2[j], c), __fmul_rn(py2[j], s)));
      const int dy2 = __float2int_rz(__fadd_rn(__fmul_rn(px2[j], s), __fmul_rn(py2[j], c)));
      const bool bit = pixel(f, x + dx1, y + dy1, h, w) > pixel(f, x + dx2, y + dy2, h, w);
      const uint32_t word = __ballot_sync(0xffffffffu, bit);
      if (lane == j) mine = word;
    }
    if (lane < 8) desc[static_cast<size_t>(kp) * 8 + lane] = mine;
  }
}

}  // namespace

extern "C" {

// imgs: (n, h, w) uint8; x, y: (n, k) int32; m01, m10: (n, k) int32.
int gs_orb_moments(const void* imgs, const void* x, const void* y, void* m01, void* m10, int n,
                   int h, int w, int k, int radius, void* stream) {
  const int blocks = (n * k + kWarps - 1) / kWarps;
  orb_moments_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(imgs), static_cast<const int*>(x), static_cast<const int*>(y),
      static_cast<int*>(m01), static_cast<int*>(m10), n, h, w, k, radius);
  return cudaGetLastError();
}

// imgs: (n, h, w) uint8; x, y: (n, k) int32; sin, cos: (n, k) float32;
// pattern: (256, 4) float32 (x1, y1, x2, y2); desc: (n, k, 8) uint32.
int gs_orb_brief(const void* imgs, const void* x, const void* y, const void* sin, const void* cos,
                 const void* pattern, void* desc, int n, int h, int w, int k, void* stream) {
  int blocks = (n * k + kWarps - 1) / kWarps;
  if (blocks > kMaxBriefBlocks) blocks = kMaxBriefBlocks;
  orb_brief_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(imgs), static_cast<const int*>(x), static_cast<const int*>(y),
      static_cast<const float*>(sin), static_cast<const float*>(cos),
      static_cast<const float*>(pattern), static_cast<uint32_t*>(desc), n, h, w, k);
  return cudaGetLastError();
}

}  // extern "C"
