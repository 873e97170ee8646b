// K6 gs_fast: FAST-9 score map, 3x3 non-maximum suppression and packed
// scan-order keys (gs_fast, grayskull.h:482-534) for Hopper (sm_90a), bound to
// Python through a plain C interface (grayskull_tpu_torch/kernels/_build.py).
//
// Replaces the Pallas kernel _fast_call (grayskull_tpu/kernels/fast.py:207,
// behind fast_pallas, fast_pallas_compact and fast_pallas_lean).  The TPU
// kernel also folded its key map into a few strips (_fold_compact) so that
// approx_max_k had fewer keys to read; that was a TPU emission trick, and the
// port's torch.topk reads the key map as it is.
//
// What it computes, per frame n and pixel (y, x), all in uint32 as C does:
//   bright_k = v_k > p + thr; dark_k = !bright_k && v_k < p - thr  (p - thr
//   wraps when p < thr, so every sample is then "darker"; the else-if lets
//   bright win when both hold).  The pixel is a corner when 9 consecutive
//   samples of the 16-sample circle, read circularly, are all bright or all
//   dark; its score is min |v_k - p| over all 16 samples, and 0 for a
//   non-corner or a pixel outside the 3-pixel interior.  A pixel is kept when
//   its score is > 0 and no 8-neighbour's score is strictly greater (a
//   neighbour outside the frame scores 0).  key = kept ? (h*w - y*w - x) << 8 |
//   score : 0, in int32 when h*w < 2^23 and in int64 above.
//
// What bounds it: the arithmetic.  A pixel reads 16 circle samples and does
// about 120 integer operations, while it moves 1 byte in and 4 (or 5) bytes
// out; at 4.9 M pixels (16 frames of 640x480) that is 0.6 G operations against
// 25 MB.
//
// What the design does about it: a block of 32x8 threads owns a 32x8 tile of
// output.  It stages the tile with a 4-pixel halo (circle radius 3, plus one
// ring for the NMS) in shared memory, so every circle sample is a shared-memory
// read, then scores the tile and its one-pixel ring (34x10) into shared memory,
// then suppresses from shared scores.  The two polarity tests are packed into
// 16-bit masks and the run of 9 is found by a shift-and fold, as the TPU kernel
// does (grayskull_tpu/kernels/fast.py:98-103), instead of a 25-step sweep.
// Neighbouring threads own neighbouring columns, so the loads and stores
// coalesce.
//
// Each entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32;              // tile columns = threads in x
constexpr int kTy = 8;               // tile rows = threads in y
constexpr int kHalo = 4;             // circle radius 3 + one NMS ring
constexpr int kPw = kTx + 2 * kHalo; // staged pixel tile
constexpr int kPh = kTy + 2 * kHalo;
constexpr int kSw = kTx + 2;         // scored tile: the output and its ring
constexpr int kSh = kTy + 2;

__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ bool run9(uint32_t m) {
  const uint32_t x = m | ((m & 0x1FFu) << 16);
  const uint32_t m1 = x & (x >> 1);
  const uint32_t m2 = m1 & (m1 >> 2);
  const uint32_t m4 = m2 & (m2 >> 4);
  return (m4 & (x >> 8)) != 0u;
}

// Grid (ceil(w / kTx), ceil(h / kTy), n), block (kTx, kTy).
template <typename Key>
__global__ void fast_kernel(const uint8_t* __restrict__ imgs, uint8_t* __restrict__ score_out,
                            Key* __restrict__ key_out, int h, int w, uint32_t thr) {
  __shared__ uint8_t pix[kPh][kPw];
  __shared__ uint8_t sc[kSh][kSw];
  const int n = blockIdx.z;
  const int x0 = blockIdx.x * kTx;
  const int y0 = blockIdx.y * kTy;
  const int tid = threadIdx.y * kTx + threadIdx.x;
  const uint8_t* f = imgs + static_cast<size_t>(n) * h * w;

  for (int i = tid; i < kPh * kPw; i += kTx * kTy) {
    const int r = i / kPw, c = i % kPw;
    const int gy = y0 - kHalo + r, gx = x0 - kHalo + c;
    pix[r][c] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? f[static_cast<size_t>(gy) * w + gx] : 0;
  }
  __syncthreads();

  for (int i = tid; i < kSh * kSw; i += kTx * kTy) {
    const int r = i / kSw, c = i % kSw;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    uint32_t s = 0;
    if (gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3) {
      const int pr = r + kHalo - 1, pc = c + kHalo - 1;  // (gy, gx) in pix
      const uint32_t p = pix[pr][pc];
      const uint32_t hi = p + thr, lo = p - thr;
      uint32_t bright = 0, dark = 0, min_diff = 255;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const uint32_t v = pix[pr + kCircleDy[k]][pc + kCircleDx[k]];
        const bool b = v > hi;
        bright |= static_cast<uint32_t>(b) << k;
        dark |= static_cast<uint32_t>(!b && v < lo) << k;
        min_diff = min(min_diff, v > p ? v - p : p - v);
      }
      if (run9(bright) || run9(dark)) s = min_diff;
    }
    sc[r][c] = static_cast<uint8_t>(s);
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  const int r = threadIdx.y + 1, c = threadIdx.x + 1;
  const uint32_t s = sc[r][c];
  bool keep = s > 0;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (dx != 0 || dy != 0) keep = keep && !(sc[r + dy][c + dx] > s);
    }
  }
  const size_t at = static_cast<size_t>(n) * h * w + static_cast<size_t>(y) * w + x;
  const Key inv = static_cast<Key>(h) * w - (static_cast<Key>(y) * w + x);
  key_out[at] = keep ? ((inv << 8) | static_cast<Key>(s)) : Key(0);
  if (score_out != nullptr) score_out[at] = static_cast<uint8_t>(s);
}

}  // namespace

extern "C" {

// imgs: (n, h, w) uint8; score: (n, h, w) uint8 or null; key: (n, h, w) int32,
// or int64 when wide_key != 0 (the caller sets it for h*w >= 2^23).
int gs_fast(const void* imgs, void* score, void* key, int n, int h, int w, int thr, int wide_key,
            void* stream) {
  const dim3 grid((w + kTx - 1) / kTx, (h + kTy - 1) / kTy, n);
  const dim3 block(kTx, kTy);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto t = static_cast<uint32_t>(thr);
  if (wide_key) {
    fast_kernel<int64_t><<<grid, block, 0, s>>>(static_cast<const uint8_t*>(imgs),
                                                static_cast<uint8_t*>(score),
                                                static_cast<int64_t*>(key), h, w, t);
  } else {
    fast_kernel<int32_t><<<grid, block, 0, s>>>(static_cast<const uint8_t*>(imgs),
                                                static_cast<uint8_t*>(score),
                                                static_cast<int32_t*>(key), h, w, t);
  }
  return cudaGetLastError();
}

}  // extern "C"
