// K14 gs_resize: the bilinear resize of gs_resize (grayskull.h:171-187) for a
// batch of uint8 frames, for Hopper (sm_90a), bound to Python through a plain C
// interface (grayskull_tpu_torch/kernels/_build.py).
//
// Replaces the Pallas kernel resize_pallas (grayskull_tpu/kernels/resize.py:217,
// body _kernel :156), which picks the four corner samples of each output pixel
// with one-hot matrix products over a source band and host-made coordinate and
// weight tables, for want of a gather on the TPU.  Here the kernel computes the
// coordinates itself from (sh, sw, dh, dw) and gathers the corners: no tables,
// no host-to-device copy, no host sync, and no shape gate (1-row or 1-column
// sources, up- and downscales, any width, any byte offset).
//
// Float order: every operation rounds on its own, as in the reference and the
// JAX package (grayskull_tpu/ops/pixel.py:128-179; the build passes
// -fmad=false, and the intrinsics say so too):
//   s = ((x + 0.5f) * (float)sw) / (float)dw - 0.5f, clamped to [0, sw - 1]
//   i0 = (int)s, i1 = min(i0 + 1, sw - 1), d = s - (float)i0   (the same for y)
//   ((c00*(1-dx))*(1-dy) + (c01*dx)*(1-dy)) + (c10*(1-dx))*dy) + (c11*dx)*dy
//   truncating uint8 store.
//
// What bounds it: device memory (each source frame read once, each output
// byte written once) as long as an output costs a few instructions.  A
// coordinate costs about 20 (the division is a software sequence): made for
// every output pixel of every frame, coordinates alone would bound the kernel
// by instruction issue.
//
// What the design does about it:
// * a block of kWarps warps owns kTile = 32 * kCols output columns of kWarps
//   output rows (a row a warp) and loops over up to kFrames frames with the
//   same coordinates (fewer where the grid would have under kMinBlocks
//   blocks): a thread makes each of its kCols columns' x-coordinates once, a
//   warp its row's y-coordinate once;
// * a byte becomes a float as the low byte of 2^23's mantissa less 2^23, and
//   a float p in [0, 256) its truncated byte as the low byte of p + 2^23
//   rounded toward zero: both exact, no conversion instructions;
// * the corners come through L1 (__ldg), or, for rows whose bytes are 16-byte
//   aligned and downscales up to kStagePercent / 100 (and every upscale),
//   from the warp's two source rows staged in shared memory with 16-byte
//   cp.async copies, the next frame's in flight while this frame's are used;
// * a thread's kCols outputs are consecutive and stored as 4-byte words where
//   the width and the pointer allow it, bytes otherwise.
//
// The constants are the fastest of chip_sweep.py --source resize on the H100
// (256 frames): at 1024x1024 -> 480x640 the staged rows took 28 % less time
// than L1 gathers and 4 columns a thread 24 % less than 8; 16, 32 and 64
// frames a block were within 2 % of each other; at 480x640 -> 768x1024 16
// columns a thread took 21 % less than 4.  Lane l on columns x0 + l + 32 j
// with byte stores (lane-neighbouring gathers) was within 2 % of the
// consecutive layout.
//
// Each entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // output rows a block makes, a warp each
constexpr int kColsDown = 4;           // consecutive output columns a thread makes, sw >= dw
constexpr int kColsUp = 16;            // the same for upscales, sw < dw
constexpr int kFrames = 32;            // frames a block makes with the same coordinates, at most
constexpr int kMinBlocks = 2048;       // fewer frames a block until the grid has this many
constexpr int kStagePercent = 250;     // staged rows where 100 * sw <= kStagePercent * dw
constexpr int kStageBytes = 512;       // bytes of a staged row segment: 32 lanes of 16

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

// (float)b for a byte b: 2^23 + b is exact, and so is the subtraction.
__device__ __forceinline__ float byte_float(unsigned b) {
  return __fsub_rn(__uint_as_float(0x4B000000u | b), 8388608.0f);
}

// The lerp in C's order; the result's low byte is (uint8_t)(unsigned)p: p is in
// [0, 256), where p + 2^23 rounded toward zero is 2^23 + floor(p).
__device__ __forceinline__ unsigned lerp(unsigned c00, unsigned c01, unsigned c10, unsigned c11,
                                         float dx, float ndx, float dy, float ndy) {
  const float t1 = __fmul_rn(__fmul_rn(byte_float(c00), ndx), ndy);
  const float t2 = __fmul_rn(__fmul_rn(byte_float(c01), dx), ndy);
  const float t3 = __fmul_rn(__fmul_rn(byte_float(c10), ndx), dy);
  const float t4 = __fmul_rn(__fmul_rn(byte_float(c11), dx), dy);
  const float p = __fadd_rn(__fadd_rn(__fadd_rn(t1, t2), t3), t4);
  return __float_as_uint(__fadd_rz(p, 8388608.0f));
}

__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
#else
  *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
#endif
}

__device__ __forceinline__ void copy_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Waits until at most `kPending` of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void copy_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
#endif
}

// A thread's kCols outputs (the low byte of each v[j]) at columns x .. x + kCols - 1 of `row`.
template <int kCols>
__device__ __forceinline__ void store_outputs(uint8_t* row, int x, int dw, bool words,
                                              const unsigned (&v)[kCols]) {
  if (words && x + kCols <= dw) {
#pragma unroll
    for (int j = 0; j < kCols; j += 4) {
      const unsigned lo = __byte_perm(v[j], v[j + 1], 0x0040);
      const unsigned hi = __byte_perm(v[j + 2], v[j + 3], 0x0040);
      *reinterpret_cast<unsigned*>(row + x + j) = __byte_perm(lo, hi, 0x5410);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if (x + j < dw) row[x + j] = static_cast<uint8_t>(v[j]);
    }
  }
}

// Grid: (dw / kTile, dh / kWarps, frame chunks of `frames`), rounded up; chunks
// past gridDim.z loop.  kStaged: the host checked that src and sw are multiples
// of 16 and that a warp's source columns fit kStageBytes with their alignment.
template <int kCols, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    resize_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int n, int sh,
                  int sw, int dh, int dw, int frames, int chunks, int words) {
  constexpr int kTile = 32 * kCols;
  __shared__ __align__(16) uint8_t stage[kStaged ? kWarps : 1][2][2][kStaged ? kStageBytes : 16];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.y * kWarps + warp;
  if (y >= dh) return;  // the whole warp
  const int x0 = blockIdx.x * kTile;
  const int x = x0 + lane * kCols;
  int i0[kCols], i1[kCols];
  float dx[kCols], ndx[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {  // columns past dw repeat the last one, never stored
    const Coord c = source_coord(min(x + j, dw - 1), sw, dw);
    i0[j] = c.i0;
    i1[j] = c.i1;
    dx[j] = c.d;
    ndx[j] = __fsub_rn(1.0f, c.d);
  }
  const Coord cy = source_coord(y, sh, dh);
  const float ndy = __fsub_rn(1.0f, cy.d);
  const size_t plane = static_cast<size_t>(sh) * sw;
  const size_t out_plane = static_cast<size_t>(dh) * dw;
  const size_t r0 = static_cast<size_t>(cy.i0) * sw;
  const size_t r1 = static_cast<size_t>(cy.i1) * sw;
  uint8_t* const out_row = dst + static_cast<size_t>(y) * dw;
  if (!kStaged) {
    for (int c = blockIdx.z; c < chunks; c += gridDim.z) {
      const int f1 = min((c + 1) * frames, n);
      for (int f = c * frames; f < f1; ++f) {
        const uint8_t* s0 = src + f * plane + r0;
        const uint8_t* s1 = src + f * plane + r1;
        unsigned v[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          v[j] = lerp(__ldg(s0 + i0[j]), __ldg(s0 + i1[j]), __ldg(s1 + i0[j]), __ldg(s1 + i1[j]),
                      dx[j], ndx[j], cy.d, ndy);
        }
        store_outputs(out_row + f * out_plane, x, dw, words != 0, v);
      }
    }
    return;
  }
  // The warp's source columns lo .. hi, staged from the 16-byte word holding lo.
  const int lo = source_coord(x0, sw, dw).i0 & ~15;
  const int hi = source_coord(min(x0 + kTile, dw) - 1, sw, dw).i1;
  const int copies = ((hi & ~15) - lo) / 16 + 1;  // <= 32
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    i0[j] -= lo;
    i1[j] -= lo;
  }
  for (int c = blockIdx.z; c < chunks; c += gridDim.z) {
    const int f0 = c * frames, f1 = min(f0 + frames, n);
    if (lane < copies) {
      const uint8_t* s = src + f0 * plane + lo + 16 * lane;
      copy16_async(&stage[warp][0][0][16 * lane], s + r0);
      copy16_async(&stage[warp][0][1][16 * lane], s + r1);
    }
    copy_async_commit();
    for (int f = f0; f < f1; ++f) {
      const int b = (f - f0) & 1;
      if (f + 1 < f1) {  // the next frame's rows into the other buffer
        if (lane < copies) {
          const uint8_t* s = src + (f + 1) * plane + lo + 16 * lane;
          copy16_async(&stage[warp][b ^ 1][0][16 * lane], s + r0);
          copy16_async(&stage[warp][b ^ 1][1][16 * lane], s + r1);
        }
        copy_async_commit();
        copy_async_wait<1>();
      } else {
        copy_async_wait<0>();
      }
      __syncwarp();
      const uint8_t* s0 = stage[warp][b][0];
      const uint8_t* s1 = stage[warp][b][1];
      unsigned v[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        v[j] = lerp(s0[i0[j]], s0[i1[j]], s1[i0[j]], s1[i1[j]], dx[j], ndx[j], cy.d, ndy);
      }
      store_outputs(out_row + f * out_plane, x, dw, words != 0, v);
      __syncwarp();  // every lane has read buffer b before it is filled again
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <int kCols>
int launch(const uint8_t* src, uint8_t* dst, int n, int sh, int sw, int dh, int dw,
           cudaStream_t stream) {
  constexpr int kTile = 32 * kCols;
  const long long tiles =
      static_cast<long long>((dw + kTile - 1) / kTile) * ((dh + kWarps - 1) / kWarps);
  int frames = kFrames;
  while (frames > 1 && tiles * ((n + frames - 1) / frames) < kMinBlocks) frames /= 2;
  const int chunks = (n + frames - 1) / frames;
  const dim3 grid((dw + kTile - 1) / kTile, (dh + kWarps - 1) / kWarps,
                  chunks < 65535 ? chunks : 65535);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  const int words = aligned(dst, 4) && dw % 4 == 0;
  // a warp's kTile columns span at most kTile * sw / dw + 2 source bytes; with
  // the 16-byte alignment they must fit kStageBytes (470 leaves a margin)
  const bool staged = aligned(src, 16) && sw % 16 == 0 &&
                      100LL * sw <= static_cast<long long>(kStagePercent) * dw &&
                      static_cast<long long>(kTile) * sw <= 470LL * dw;
  if (staged) {
    resize_kernel<kCols, true><<<grid, kThreads, 0, stream>>>(src, dst, n, sh, sw, dh, dw, frames,
                                                              chunks, words);
  } else {
    resize_kernel<kCols, false><<<grid, kThreads, 0, stream>>>(src, dst, n, sh, sw, dh, dw,
                                                               frames, chunks, words);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// src: (n, sh, sw) uint8; dst: (n, dh, dw) uint8.  Requires every size >= 1.
int gs_resize(const void* src, void* dst, int n, int sh, int sw, int dh, int dw, void* stream) {
  const auto in = static_cast<const uint8_t*>(src);
  const auto out = static_cast<uint8_t*>(dst);
  const auto s = static_cast<cudaStream_t>(stream);
  return sw < dw ? launch<kColsUp>(in, out, n, sh, sw, dh, dw, s)
                 : launch<kColsDown>(in, out, n, sh, sw, dh, dw, s);
}

}  // extern "C"
