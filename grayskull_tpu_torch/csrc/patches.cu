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
// are in flight, and for K7 how many sectors each load touches.
//
// What the design does about it.  K7 (redesigned for Hopper): 8 lanes take a
// disc row, each a 4-byte word of it, so one load instruction of a warp reads
// four rows as 32 contiguous bytes each.  A row's words are the aligned words
// around it funnel-shifted (__funnelshift_r) by the row's misalignment, so
// word j always holds columns x - r + 4j .. x - r + 4j + 3 and its weights
// depend only on (r, dy, j): int8 dx weights (0 outside the disc) and a mask
// of ones, which a large block builds once in shared memory while its
// keypoints' coordinates load, and a lane of a small block computes.  Two dp4a
// a word give m10 and the row sum, and m01 = sum dy * rowsum; everything stays exact in int32.  When the whole
// disc lies in the frame, which orb_extract guarantees by clamping, the reads
// take no bounds test (a word holding a byte of the row is read whole: it
// lies in the same aligned 4 bytes of the frame's storage as that byte);
// otherwise each byte is read through pixel() and a read outside the frame
// gives 0.  A shuffle reduction over the keypoint's lanes adds the partial
// sums.  The kernel is latency-bound and pays a fixed cost a block, so a call
// with enough keypoints to give every SM a 1024-thread block takes those,
// and smaller calls (track's pyramid levels) take 256-thread blocks.  A warp
// a keypoint, the block sizes and where the weights come from are the fastest
// of chip_sweep.py --source patches on the H100 (PERF.md), which also carries
// the alternatives it rejected (2 or 4 keypoints a warp, lanes along a row's
// columns, multiply-adds in place of dp4a).
// K8 (redesigned for Hopper): the work is the rotation, not the reads.  A
// lane rotates 16 endpoints a keypoint (four rounded products, two rounded
// sums, two truncations each) and addresses and compares 16 samples: about
// 250 instructions, so a call is bound by issue and by the chain of each
// keypoint (its coordinates, then its samples), not by bytes (PERF.md: in the
// sweep, staging each keypoint's 41 x 41 window in shared memory, by loads or
// cp.async, cost as much as the gathers it saved).  So the samples are byte
// gathers from the frame, with no bounds test when the keypoint's whole window
// (every rotated endpoint lies within 20 of it: the pattern's largest radius is
// 20.52) is in the frame, and a warp with an endpoint past 20 (sin and cos off
// the unit circle) or a window past a border reads through pixel() with the
// patch's bounds, as the plain version reads.  A lane takes pair 32 * j + lane
// of word j, its pairs in registers, loaded once; one __ballot_sync builds
// each word.  A call of fewer keypoints than 32 for each SM of the card
// (track's pyramid levels) splits each keypoint's eight words over four warps,
// a shorter chain a keypoint; a larger call gives a keypoint a warp and walks
// over keypoints in a grid-stride loop.
//
// Each entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int pixel(const uint8_t* __restrict__ f, int x, int y, int h, int w) {
  return (x >= 0 && x < w && y >= 0 && y < h) ? f[static_cast<size_t>(y) * w + x] : 0;
}

// K7's layout: a warp takes a keypoint, and 8 lanes a disc row, a 4-byte word
// each, so the warp reads 4 rows a step.
constexpr int kMaxRadius = 20;  // the wrapper's limit (kernels/patches.py:_check_radius)
constexpr int kDiscRows = 2 * kMaxRadius + 1;
constexpr int kRowLanes = 8;
constexpr int kRowsPerStep = 32 / kRowLanes;
constexpr int kSteps = (kDiscRows + kRowsPerStep - 1) / kRowsPerStep;
// Blocks of kSmallThreads, or of kLargeThreads (at most 32 registers a thread,
// so that two fill an SM) once the call has enough keypoints to give every SM
// one: a large block pays its launch and weight table once for more keypoints.
constexpr int kSmallThreads = 256;
constexpr int kLargeThreads = 1024;
constexpr int kHighWords = 4;  // words 8..10 of a row (3 used) at r > 15

__device__ __forceinline__ int dp4a_us(unsigned a, unsigned b, int c) {
#if defined(__CUDA_ARCH__)
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
#else
  for (int i = 0; i < 4; ++i) {
    c += static_cast<int>((a >> (8 * i)) & 0xffu) * static_cast<int8_t>((b >> (8 * i)) & 0xffu);
  }
  return c;
#endif
}

__device__ __forceinline__ int dp4a_uu(unsigned a, unsigned b, int c) {
#if defined(__CUDA_ARCH__)
  int d;
  asm("dp4a.u32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
#else
  for (int i = 0; i < 4; ++i) {
    c += static_cast<int>(((a >> (8 * i)) & 0xffu) * ((b >> (8 * i)) & 0xffu));
  }
  return c;
#endif
}

// The weights of a disc row's word j (columns x - r + 4j .. x - r + 4j + 3)
// when r^2 - dy^2 = room: .x the int8 dx of each byte inside the disc (0
// outside), .y 1 for each byte inside.
__device__ __forceinline__ uint2 word_weights(int r, int room, int j) {
  uint2 wt = make_uint2(0u, 0u);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int dx = 4 * j + b - r;
    if (dx * dx <= room) {
      wt.x |= (static_cast<unsigned>(dx) & 0xffu) << (8 * b);
      wt.y |= 1u << (8 * b);
    }
  }
  return wt;
}

// The word of disc row (x - r + 4j .., y + dy) with a read outside the frame 0.
__device__ __forceinline__ unsigned guarded_word(const uint8_t* __restrict__ f, int x, int y,
                                                 int h, int w) {
  unsigned v = 0u;
  for (int b = 0; b < 4; ++b) v |= static_cast<unsigned>(pixel(f, x + b, y, h, w)) << (8 * b);
  return v;
}

// Word j of the row that starts at byte `row` (x - r): the aligned words around
// it funnel-shifted by its misalignment.  Only words that hold a byte of the
// row's 2r + 1 are read (`last` is the last of them), so every read is inside
// the frame when the disc is.
__device__ __forceinline__ unsigned interior_word(const uint32_t* __restrict__ aligned,
                                                  unsigned shift, int last, int j) {
  const unsigned lo = j <= last ? aligned[j] : 0u;
  const unsigned hi = j + 1 <= last ? aligned[j + 1] : 0u;
  return __funnelshift_r(lo, hi, shift);
}

// The row sum and m10 of words c and c + kRowLanes of disc row i.
template <bool kInterior, bool kWeightTable>
__device__ __forceinline__ void row_terms(const uint8_t* __restrict__ f, int x, int y, int h,
                                          int w, int r, int i, int c, int words,
                                          const uint2 (*low)[kRowLanes],
                                          const uint2 (*high)[kHighWords], int& sum, int& s10) {
  unsigned v, vh = 0u;
  if (kInterior) {
    const uintptr_t start =
        reinterpret_cast<uintptr_t>(f + static_cast<size_t>(y + i - r) * w + (x - r));
    const unsigned mis = static_cast<unsigned>(start & 3u);
    const uint32_t* aligned = reinterpret_cast<const uint32_t*>(start - mis);
    const int last = static_cast<int>(mis + 2 * r) >> 2;
    v = interior_word(aligned, 8u * mis, last, c);
    if (c + kRowLanes < words) vh = interior_word(aligned, 8u * mis, last, c + kRowLanes);
  } else {
    v = guarded_word(f, x - r + 4 * c, y + i - r, h, w);
    if (c + kRowLanes < words) vh = guarded_word(f, x - r + 4 * (c + kRowLanes), y + i - r, h, w);
  }
  const int room = r * r - (i - r) * (i - r);
  const uint2 wt = kWeightTable ? low[i][c] : word_weights(r, room, c);
  sum = dp4a_uu(v, wt.y, 0);
  s10 = dp4a_us(v, wt.x, s10);
  if (c + kRowLanes < words) {
    const uint2 wh = kWeightTable ? high[i][c] : word_weights(r, room, c + kRowLanes);
    sum = dp4a_uu(vh, wh.y, sum);
    s10 = dp4a_us(vh, wh.x, s10);
  }
}

// Grid ceil(n * k / (kThreads / 32)), block kThreads: a warp takes a keypoint,
// a block kThreads / 32 consecutive ones (in scan order, so their discs share
// rows in L1).  kWeightTable: the weights come from a shared table the block
// builds, else each lane computes its own; the table pays off only where a
// block has many keypoints.
template <int kThreads, int kMinBlocks, bool kWeightTable>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
orb_moments_kernel(const uint8_t* __restrict__ imgs, const int* __restrict__ xs,
                   const int* __restrict__ ys, int* __restrict__ m01, int* __restrict__ m10,
                   int n, int h, int w, int k, int r) {
  __shared__ uint2 low[kWeightTable ? kDiscRows : 1][kRowLanes];    // words 0..7 of each row
  __shared__ uint2 high[kWeightTable ? kDiscRows : 1][kHighWords];  // words 8..10
  const int lane = threadIdx.x % 32;
  const int rq = lane / kRowLanes, c = lane % kRowLanes;
  const int kp = blockIdx.x * (kThreads / 32) + static_cast<int>(threadIdx.x) / 32;
  const bool valid = kp < n * k;
  const int x = valid ? xs[kp] : 0, y = valid ? ys[kp] : 0;  // in flight while the table is built
  const int rows = 2 * r + 1;
  const int words = (rows + 3) / 4;
  if (kWeightTable) {
    for (int e = threadIdx.x; e < rows * (kRowLanes + kHighWords); e += kThreads) {
      const int i = e / (kRowLanes + kHighWords), j = e % (kRowLanes + kHighWords);
      const uint2 wt = word_weights(r, r * r - (i - r) * (i - r), j);
      if (j < kRowLanes) {
        low[i][j] = wt;
      } else {
        high[i][j - kRowLanes] = wt;
      }
    }
    __syncthreads();
  }
  if (!valid) return;  // the whole warp leaves together
  const uint8_t* f = imgs + static_cast<size_t>(kp / k) * h * w;
  int s01 = 0, s10 = 0;
  if (x >= r && x + r < w && y >= r && y + r < h) {  // the whole disc is in the frame
#pragma unroll
    for (int step = 0; step < kSteps; ++step) {
      const int i = rq + step * kRowsPerStep;
      if (i < rows) {
        int sum;
        row_terms<true, kWeightTable>(f, x, y, h, w, r, i, c, words, low, high, sum, s10);
        s01 += (i - r) * sum;
      }
    }
  } else {  // near or past a border: reads outside the frame give 0
    for (int i = rq; i < rows; i += kRowsPerStep) {
      int sum;
      row_terms<false, kWeightTable>(f, x, y, h, w, r, i, c, words, low, high, sum, s10);
      s01 += (i - r) * sum;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s01 += __shfl_xor_sync(0xffffffffu, s01, off);
    s10 += __shfl_xor_sync(0xffffffffu, s10, off);
  }
  if (lane == 0) {
    m01[kp] = s01;
    m10[kp] = s10;
  }
}

// K8's layout: a keypoint's eight words split over kSplit warps; a lane
// rotates 8 / kSplit pairs, held in registers.
constexpr int kReach = 20;             // |dx|, |dy| of a rotated endpoint (PATCH_PAD)
constexpr int kPatch = 48;             // the plain version's patch: offsets -20 .. 27
constexpr int kBriefThreads = 128;     // a block's threads
constexpr int kBriefBlocksPerSm = 8;   // the grid's cap for unsplit calls: blocks an SM, then loop
constexpr int kSplitBelow = 32;        // calls of fewer keypoints than this times the SMs split
constexpr int kSmallSplit = 4;         // warps a keypoint in such calls

// The sample at offset (dx, dy) of the keypoint's 48 x 48 patch: 0 outside
// the patch or the frame.
__device__ __forceinline__ int patch_pixel(const uint8_t* __restrict__ f, int x, int y, int h,
                                           int w, int dx, int dy) {
  const bool in_patch = static_cast<unsigned>(dx) + kReach < static_cast<unsigned>(kPatch) &&
                        static_cast<unsigned>(dy) + kReach < static_cast<unsigned>(kPatch);
  return in_patch ? pixel(f, x + dx, y + dy, h, w) : 0;
}

// The endpoint (px, py) rotated by (s, c), each product and sum rounded on its
// own and truncated toward zero.
__device__ __forceinline__ void rotate(float px, float py, float s, float c, int& dx, int& dy) {
  dx = __float2int_rz(__fsub_rn(__fmul_rn(px, c), __fmul_rn(py, s)));
  dy = __float2int_rz(__fadd_rn(__fmul_rn(px, s), __fmul_rn(py, c)));
}

// Grid ceil(n * k / keys) blocks of kBriefThreads, keys = kBriefThreads / 32 /
// kSplit keypoints a block at once (at most kBriefBlocksPerSm * SMs blocks when
// kSplit is 1); warp q takes words (q % kSplit) * 8 / kSplit .. of keypoint
// q / kSplit, and the block walks over keypoints kp, kp + keys * blocks, ...
template <int kSplit>
__global__ void __launch_bounds__(kBriefThreads)
orb_brief_kernel(const uint8_t* __restrict__ imgs, const int* __restrict__ xs,
                 const int* __restrict__ ys, const float* __restrict__ sins,
                 const float* __restrict__ coss, const float* __restrict__ pattern,
                 uint32_t* __restrict__ desc, int n, int h, int w, int k) {
  constexpr int kPairs = 8 / kSplit;                 // words a warp builds, pairs a lane
  constexpr int kKeys = kBriefThreads / 32 / kSplit;  // keypoints a block holds at once
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int first = (warp % kSplit) * kPairs;         // the warp's first word
  float px1[kPairs], py1[kPairs], px2[kPairs], py2[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const float* p = pattern + 4 * (32 * (first + j) + lane);
    px1[j] = p[0];
    py1[j] = p[1];
    px2[j] = p[2];
    py2[j] = p[3];
  }
  const int total = n * k;
  for (int kp = blockIdx.x * kKeys + warp / kSplit; kp < total; kp += gridDim.x * kKeys) {
    const uint8_t* f = imgs + static_cast<size_t>(kp / k) * h * w;
    const int x = xs[kp], y = ys[kp];
    const float s = sins[kp], c = coss[kp];
    int off1[kPairs], off2[kPairs];
    bool outside = false;  // an endpoint past kReach (sin and cos off the unit circle)
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      int dx1, dy1, dx2, dy2;
      rotate(px1[j], py1[j], s, c, dx1, dy1);
      rotate(px2[j], py2[j], s, c, dx2, dy2);
      outside |= static_cast<unsigned>(dx1) + kReach > 2u * kReach ||
                 static_cast<unsigned>(dy1) + kReach > 2u * kReach ||
                 static_cast<unsigned>(dx2) + kReach > 2u * kReach ||
                 static_cast<unsigned>(dy2) + kReach > 2u * kReach;
      off1[j] = dy1 * w + dx1;
      off2[j] = dy2 * w + dx2;
    }
    const bool inside = x >= kReach && x + kReach < w && y >= kReach && y + kReach < h;
    uint32_t mine = 0;
    if (inside && !__any_sync(0xffffffffu, outside)) {  // every sample in the frame
      const uint8_t* centre = f + static_cast<size_t>(y) * w + x;
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        const uint32_t word = __ballot_sync(0xffffffffu, centre[off1[j]] > centre[off2[j]]);
        if (lane == j) mine = word;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        int dx1, dy1, dx2, dy2;
        rotate(px1[j], py1[j], s, c, dx1, dy1);
        rotate(px2[j], py2[j], s, c, dx2, dy2);
        const uint32_t word = __ballot_sync(0xffffffffu, patch_pixel(f, x, y, h, w, dx1, dy1) >
                                                             patch_pixel(f, x, y, h, w, dx2, dy2));
        if (lane == j) mine = word;
      }
    }
    if (lane < kPairs) desc[static_cast<size_t>(kp) * 8 + first + lane] = mine;
  }
}

}  // namespace

extern "C" {

// imgs: (n, h, w) uint8; x, y: (n, k) int32; m01, m10: (n, k) int32.
int gs_orb_moments(const void* imgs, const void* x, const void* y, void* m01, void* m10, int n,
                   int h, int w, int k, int radius, void* stream) {
  if (radius < 0 || radius > kMaxRadius) return cudaErrorInvalidValue;
  // n * k < 2^28 (the wrapper checks), so the grid fits
  const int total = n * k;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(imgs);
  const int* xs = static_cast<const int*>(x);
  const int* ys = static_cast<const int*>(y);
  int* o01 = static_cast<int*>(m01);
  int* o10 = static_cast<int*>(m10);
  // keypoints a block; a call with a large block for every SM of this card
  // takes large blocks (two host lookups, no sync)
  constexpr int large_keys = kLargeThreads / 32, small_keys = kSmallThreads / 32;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (total >= sms * large_keys) {
    orb_moments_kernel<kLargeThreads, 2048 / kLargeThreads, true>
        <<<(total + large_keys - 1) / large_keys, kLargeThreads, 0, st>>>(f, xs, ys, o01, o10, n,
                                                                          h, w, k, radius);
  } else {
    orb_moments_kernel<kSmallThreads, 1, false>
        <<<(total + small_keys - 1) / small_keys, kSmallThreads, 0, st>>>(f, xs, ys, o01, o10, n,
                                                                          h, w, k, radius);
  }
  return cudaGetLastError();
}

// imgs: (n, h, w) uint8; x, y: (n, k) int32; sin, cos: (n, k) float32;
// pattern: (256, 4) float32 (x1, y1, x2, y2); desc: (n, k, 8) uint32.
int gs_orb_brief(const void* imgs, const void* x, const void* y, const void* sin, const void* cos,
                 const void* pattern, void* desc, int n, int h, int w, int k, void* stream) {
  const int total = n * k;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(imgs);
  const int* xs = static_cast<const int*>(x);
  const int* ys = static_cast<const int*>(y);
  const float* s = static_cast<const float*>(sin);
  const float* c = static_cast<const float*>(cos);
  const float* p = static_cast<const float*>(pattern);
  uint32_t* d = static_cast<uint32_t*>(desc);
  // a call too small to fill the card splits each keypoint over kSmallSplit
  // warps (a shorter chain a keypoint); a larger one gives each a warp
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (total < kSplitBelow * sms) {
    constexpr int keys = kBriefThreads / 32 / kSmallSplit;
    orb_brief_kernel<kSmallSplit><<<(total + keys - 1) / keys, kBriefThreads, 0, st>>>(
        f, xs, ys, s, c, p, d, n, h, w, k);
  } else {
    constexpr int keys = kBriefThreads / 32;
    int blocks = (total + keys - 1) / keys;
    if (blocks > kBriefBlocksPerSm * sms) blocks = kBriefBlocksPerSm * sms;
    orb_brief_kernel<1><<<blocks, kBriefThreads, 0, st>>>(f, xs, ys, s, c, p, d, n, h, w, k);
  }
  return cudaGetLastError();
}

}  // extern "C"
