// 3x3 stencils of the dense pixel ops, for Hopper (sm_90a), bound to Python
// through a plain C interface (grayskull_tpu_torch/kernels/_build.py).
//
// K12 gs_morph replaces morph_pallas (grayskull_tpu/kernels/preproc.py:616,
//    body _morph_kernel :593): gs_erode / gs_dilate, the 3x3 min or max over the
//    in-frame neighbours only.  The window is clipped at the border, which is
//    the same as padding with the op-neutral value (255 for erode, 0 for
//    dilate), not with 0.
// K13 gs_filter3 replaces filter3_pallas (:723, body _filter3_kernel :664):
//    gs_filter with a 3x3 kernel, the correlation with zero padding (gs_get
//    reads 0 out of the frame), then C's `int / unsigned`: the int32 sum is
//    reinterpreted as uint32, divided by norm, cast back to int32 and clamped
//    to 0..255 (grayskull_tpu/ops/pixel.py:432-446).  Any int32 taps: for int8
//    taps this gives the TPU kernel's sign-test shortcut (a negative sum with
//    norm > 1 clamps to 255) without special cases, and past int8 it is the
//    XLA path's formula, the sum wrapping as int32 does.
//
// What bounds them: device memory.  Each reads 1 B and writes 1 B a pixel;
// nine compares or nine multiply-adds a pixel are far below the card's rate,
// as long as a pixel costs a few instructions and not a few dozen.
//
// What the design does about it: no shared memory.  A warp sweeps a strip of
// up to kStrip rows over kSegment = 512 columns.  Each lane owns 16
// consecutive columns as four 4-byte words and reads each row once: one
// 16-byte load where the width and the pointers are multiples of 16, four
// 4-byte loads where they are multiples of 4 (config #2's 612-byte rows),
// bytes otherwise.  The next row's load is in flight while the current row is
// computed, three rows stay in registers, and the columns just left and right
// of the lane's 16 come from the neighbouring lanes by shuffles (lanes 0 and
// 31 load the segment's outer two bytes).  Pixels outside the
// frame read the op's border value.  A lane stores its 16 outputs as it
// loaded them.
// K12 works on four pixels a word: the vertical min or max of the three rows'
// words (__vminu4 / __vmaxu4), then the same with the word's two
// __byte_perm-shifted neighbours.
// K13 with taps that all fit int8 (every preset, and the CLI's uint8 kernel
// images read as int8) packs each row of taps into one signed word with a zero
// fourth byte: an output's row of three products is one dp4a of the unsigned
// window bytes [x-1, x, x+1, x+2] (a __byte_perm of adjacent words) against
// it, three dp4a's an output.  |sum| <= 9 * 255 * 128, so the int32 sum cannot
// wrap.  The sum read as uint32 is divided by norm with div_exact, a
// multiply-high by a magic computed once on the host, exact for every uint32
// and norm >= 1, then cast to int32 and clamped.  Wider taps take the same
// windows with a 32-bit multiply-add per tap.
//
// The constants are the fastest of chip_sweep.py --source stencil3 on the
// H100: strips of 16 rows made K12 at 816x612 12 % faster than 64 (8 to 128
// tried; K13 within 1 % from 16 to 64); at 816x612 and 16-row strips the
// 4-byte loads of the lane's own columns beat a layout whose load
// instructions each read 128 consecutive bytes (lane l on words l + 32k) by
// 4-6 %, and the byte path by more than 3x; a rank-1 pass (column sums, then
// row sums) of the Gaussian was 35 % slower than the three dp4a's.
//
// All offsets into frames are size_t.  Each entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStrip = 16;     // rows a warp sweeps, at most
constexpr int kSegment = 512;  // columns a warp covers: 32 lanes of 16

// The bytes of one access to a row: 16, 4 or 1.
enum Access { kBytes = 1, kWords = 4, kVectors = 16 };

struct Taps {
  int k[9];           // row by row
  unsigned packed[3];  // rows of int8 taps as bytes 0..2 of a word, byte 3 zero
  unsigned norm, magic;
};

// The multiplier of div_exact for the divisor d >= 1: floor((2^32 - 1) / d) + 1,
// which is ceil(2^32 / d) but for a power of two, where it is 2^32 / d; for
// d = 1, where that is 2^32, it is 2^32 - 1.
unsigned div_magic(unsigned d) { return d == 1u ? 0xffffffffu : 0xffffffffu / d + 1u; }

// Exact truncating s / d for any uint32 s and d >= 1 from m = div_magic(d).
// With e = m*d - 2^32 in [-1, d), q' = floor(s*m / 2^32) differs from s/d by
// s*e / (d*2^32), less than 1 in size, so q' is the quotient or one off it;
// one step each way, without a branch, corrects it (q'*d and (q'+1)*d may
// pass 2^32, so they are compared in 64 bits).
__device__ __forceinline__ unsigned div_exact(unsigned s, unsigned d, unsigned m) {
  const unsigned q = __umulhi(s, m);
  const unsigned long long qd = static_cast<unsigned long long>(q) * d;
  return q - (qd > s) + (qd + d <= s);
}

// The sum of the four products of a's unsigned bytes and b's signed bytes, plus c.
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

// The widest access that divides the row width and both pointers.
Access access_width(const void* src, const void* dst, int w) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
                      static_cast<uintptr_t>(w);
  return (a & 15) == 0 ? kVectors : (a & 3) == 0 ? kWords : kBytes;
}

// The column of byte 0 of word k of the lane, in a segment starting at seg.
__device__ __forceinline__ int word_col(int seg, int lane, int k) {
  return seg + 16 * lane + 4 * k;
}

// One row of a lane: its four words and, for lanes 0 and 31, the bytes just
// left and right of the segment.
struct Row {
  unsigned v[4];
  unsigned left, right;
};

// Array row y of one frame; `outside` (a byte) stands in for pixels past the frame.
template <Access A>
__device__ __forceinline__ Row load_row(const uint8_t* frame, int y, int h, int w, int seg,
                                        int lane, unsigned outside) {
  const unsigned out4 = outside * 0x01010101u;
  Row row = {{out4, out4, out4, out4}, outside, outside};
  if (y < 0 || y >= h) return row;
  const uint8_t* p = frame + static_cast<size_t>(y) * w;
  if (A == kVectors) {
    const int x = word_col(seg, lane, 0);
    if (x < w) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + x);
      row.v[0] = q.x;
      row.v[1] = q.y;
      row.v[2] = q.z;
      row.v[3] = q.w;
    }
  } else if (A == kWords) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int x = word_col(seg, lane, k);
      if (x < w) row.v[k] = *reinterpret_cast<const unsigned*>(p + x);
    }
  } else {
    const int xs = word_col(seg, lane, 0);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (xs + j < w) {
        const unsigned shift = 8 * (j & 3);
        row.v[j >> 2] = (row.v[j >> 2] & ~(0xffu << shift)) | static_cast<unsigned>(p[xs + j]) << shift;
      }
    }
  }
  if (lane == 0 && seg >= 1) row.left = p[seg - 1];
  if (lane == 31 && seg + kSegment < w) row.right = p[seg + kSegment];
  return row;
}

// prev[k], next[k]: the words whose byte 3 and byte 0 are the columns just
// left and right of word k: from the lane's own words, the neighbouring lanes'
// (by shuffle), or the segment's outer bytes.  Every lane of the warp calls it.
__device__ __forceinline__ void neighbours(const unsigned v[4], unsigned left, unsigned right,
                                           int lane, unsigned prev[4], unsigned next[4]) {
  const unsigned up = __shfl_up_sync(kFull, v[3], 1);
  const unsigned down = __shfl_down_sync(kFull, v[0], 1);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    prev[k] = k == 0 ? (lane == 0 ? left << 24 : up) : v[k - 1];
    next[k] = k == 3 ? (lane == 31 ? right : down) : v[k + 1];
  }
}

template <Access A>
__device__ __forceinline__ void store_row(uint8_t* p, int seg, int lane, int w, const unsigned v[4]) {
  if (A == kVectors) {
    const int x = word_col(seg, lane, 0);
    if (x < w) *reinterpret_cast<uint4*>(p + x) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if (A == kWords) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int x = word_col(seg, lane, k);
      if (x < w) *reinterpret_cast<unsigned*>(p + x) = v[k];
    }
  } else {
    const int xs = word_col(seg, lane, 0);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (xs + j < w) p[xs + j] = static_cast<uint8_t>(v[j >> 2] >> (8 * (j & 3)));
    }
  }
}

// K12's 3x3 min or max of rows a, m, b at the lane's 16 columns.
template <bool kErode>
__device__ __forceinline__ void morph_words(const Row& a, const Row& m, const Row& b, int lane,
                                            unsigned out[4]) {
  unsigned v[4], prev[4], next[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = kErode ? __vminu4(__vminu4(a.v[k], m.v[k]), b.v[k])
                  : __vmaxu4(__vmaxu4(a.v[k], m.v[k]), b.v[k]);
  }
  const unsigned left = kErode ? min(min(a.left, m.left), b.left) : max(max(a.left, m.left), b.left);
  const unsigned right =
      kErode ? min(min(a.right, m.right), b.right) : max(max(a.right, m.right), b.right);
  neighbours(v, left, right, lane, prev, next);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned l = __byte_perm(prev[k], v[k], 0x6543);  // columns x - 1
    const unsigned r = __byte_perm(v[k], next[k], 0x4321);  // columns x + 1
    out[k] = kErode ? __vminu4(__vminu4(l, v[k]), r) : __vmaxu4(__vmaxu4(l, v[k]), r);
  }
}

// A row as K13 reads it: the lane's words with their neighbour words.
struct Windows {
  unsigned prev[4], v[4], next[4];
  // bytes [x-1, x, x+1, x+2] for x the column of byte j of word k
  __device__ __forceinline__ unsigned at(int k, int j) const {
    return j == 0 ? __byte_perm(prev[k], v[k], 0x6543)
                  : j == 1 ? v[k] : __byte_perm(v[k], next[k], j == 2 ? 0x4321 : 0x5432);
  }
};

__device__ __forceinline__ Windows windows(const Row& r, int lane) {
  Windows out;
#pragma unroll
  for (int k = 0; k < 4; ++k) out.v[k] = r.v[k];
  neighbours(r.v, r.left, r.right, lane, out.prev, out.next);
  return out;
}

// K13's outputs at the lane's 16 columns from the windows of rows y - 1, y, y + 1.
template <bool kPacked>
__device__ __forceinline__ void filter_words(const Windows& a, const Windows& m, const Windows& b,
                                             const Taps& t, unsigned out[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[k] = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned sum;
      if (kPacked) {
        int s = dp4a_us(a.at(k, j), t.packed[0], 0);
        s = dp4a_us(m.at(k, j), t.packed[1], s);
        s = dp4a_us(b.at(k, j), t.packed[2], s);
        sum = static_cast<unsigned>(s);
      } else {  // uint32 multiply-adds wrap as the int32 sum does
        sum = 0u;
        const Windows* rows[3] = {&a, &m, &b};
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const unsigned win = rows[dy]->at(k, j);
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            sum += ((win >> (8 * dx)) & 0xffu) * static_cast<unsigned>(t.k[3 * dy + dx]);
          }
        }
      }
      const int q = static_cast<int>(div_exact(sum, t.norm, t.magic));
      out[k] |= static_cast<unsigned>(min(max(q, 0), 255)) << (8 * j);
    }
  }
}

// The warp's (frame, strip, segment), or false for a warp past the last.
struct Place {
  int f, y0, y1, seg;
};

__device__ __forceinline__ bool place(int n, int h, int strip, int strips, int segs, Place* p) {
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (warp >= static_cast<long long>(n) * strips * segs) return false;
  p->seg = static_cast<int>(warp % segs) * kSegment;
  const long long fs = warp / segs;
  p->y0 = static_cast<int>(fs % strips) * strip;
  p->y1 = min(p->y0 + strip, h);
  p->f = static_cast<int>(fs / strips);
  return true;
}

// Grid: one warp per (frame, strip of `strip` rows, segment of 512 columns),
// flattened over the blocks' warps.  Rows y - 1, y, y + 1 sit in registers; the
// load of row y + 2 is issued before row y's outputs are made.
template <Access A, bool kErode>
__global__ void __launch_bounds__(kThreads)
    morph_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int n, int h, int w,
                 int strip, int strips, int segs) {
  Place pl;
  if (!place(n, h, strip, strips, segs, &pl)) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const unsigned outside = kErode ? 255u : 0u;
  const size_t frame_off = static_cast<size_t>(pl.f) * h * w;
  const uint8_t* frame = src + frame_off;
  Row a = load_row<A>(frame, pl.y0 - 1, h, w, pl.seg, lane, outside);
  Row m = load_row<A>(frame, pl.y0, h, w, pl.seg, lane, outside);
  Row b = load_row<A>(frame, pl.y0 + 1, h, w, pl.seg, lane, outside);
  for (int y = pl.y0; y < pl.y1; ++y) {
    const Row next = load_row<A>(frame, y + 2 <= pl.y1 ? y + 2 : -1, h, w, pl.seg, lane, outside);
    unsigned out[4];
    morph_words<kErode>(a, m, b, lane, out);
    store_row<A>(dst + frame_off + static_cast<size_t>(y) * w, pl.seg, lane, w, out);
    a = m;
    m = b;
    b = next;
  }
}

template <Access A, bool kPacked>
__global__ void __launch_bounds__(kThreads)
    filter3_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, Taps taps, int n,
                   int h, int w, int strip, int strips, int segs) {
  Place pl;
  if (!place(n, h, strip, strips, segs, &pl)) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const size_t frame_off = static_cast<size_t>(pl.f) * h * w;
  const uint8_t* frame = src + frame_off;
  Windows a = windows(load_row<A>(frame, pl.y0 - 1, h, w, pl.seg, lane, 0u), lane);
  Windows m = windows(load_row<A>(frame, pl.y0, h, w, pl.seg, lane, 0u), lane);
  Windows b = windows(load_row<A>(frame, pl.y0 + 1, h, w, pl.seg, lane, 0u), lane);
  for (int y = pl.y0; y < pl.y1; ++y) {
    const Row next = load_row<A>(frame, y + 2 <= pl.y1 ? y + 2 : -1, h, w, pl.seg, lane, 0u);
    unsigned out[4];
    filter_words<kPacked>(a, m, b, taps, out);
    store_row<A>(dst + frame_off + static_cast<size_t>(y) * w, pl.seg, lane, w, out);
    a = m;
    m = b;
    b = windows(next, lane);
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The launch of `kernel` over (n, h, w) frames, a warp per strip and segment.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int n, int h, int w, void* stream, Args... args) {
  const int strips = ceil_div(h, kStrip);
  const int strip = ceil_div(h, strips);  // the strips as even as the height allows
  const int segs = ceil_div(w, kSegment);
  const long long warps = static_cast<long long>(n) * strips * segs;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      args..., n, h, w, strip, strips, segs);
  return cudaGetLastError();
}

template <Access A>
int launch_morph(const uint8_t* in, uint8_t* out, int n, int h, int w, bool erode, void* stream) {
  return erode ? launch(morph_kernel<A, true>, n, h, w, stream, in, out)
               : launch(morph_kernel<A, false>, n, h, w, stream, in, out);
}

template <Access A>
int launch_filter3(const uint8_t* in, uint8_t* out, const Taps& taps, bool packed, int n, int h,
                   int w, void* stream) {
  return packed ? launch(filter3_kernel<A, true>, n, h, w, stream, in, out, taps)
                : launch(filter3_kernel<A, false>, n, h, w, stream, in, out, taps);
}

}  // namespace

extern "C" {

// src, dst: (n, h, w) uint8; erode: 1 for the min, 0 for the max.
int gs_morph(const void* src, void* dst, int n, int h, int w, int erode, void* stream) {
  const auto in = static_cast<const uint8_t*>(src);
  const auto out = static_cast<uint8_t*>(dst);
  switch (access_width(src, dst, w)) {
    case kVectors: return launch_morph<kVectors>(in, out, n, h, w, erode != 0, stream);
    case kWords: return launch_morph<kWords>(in, out, n, h, w, erode != 0, stream);
    default: return launch_morph<kBytes>(in, out, n, h, w, erode != 0, stream);
  }
}

// src, dst: (n, h, w) uint8; k0..k8: the taps row by row; norm >= 1.
int gs_filter3(const void* src, void* dst, int n, int h, int w, int k0, int k1, int k2, int k3,
               int k4, int k5, int k6, int k7, int k8, unsigned norm, void* stream) {
  if (norm == 0) return cudaErrorInvalidValue;
  Taps taps = {{k0, k1, k2, k3, k4, k5, k6, k7, k8}, {0u, 0u, 0u}, norm, div_magic(norm)};
  bool packed = true;
  for (int i = 0; i < 9; ++i) {
    packed = packed && taps.k[i] >= -128 && taps.k[i] <= 127;
    taps.packed[i / 3] |= (static_cast<unsigned>(taps.k[i]) & 0xffu) << (8 * (i % 3));
  }
  const auto in = static_cast<const uint8_t*>(src);
  const auto out = static_cast<uint8_t*>(dst);
  switch (access_width(src, dst, w)) {
    case kVectors: return launch_filter3<kVectors>(in, out, taps, packed, n, h, w, stream);
    case kWords: return launch_filter3<kWords>(in, out, taps, packed, n, h, w, stream);
    default: return launch_filter3<kBytes>(in, out, taps, packed, n, h, w, stream);
  }
}

}  // extern "C"
