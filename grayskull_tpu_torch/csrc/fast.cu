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
// What bounds it: integer instruction issue.  A pixel reads 16 circle samples
// and moves 1 byte in and 4 (or 5, or 9) bytes out.  One pixel at a time the
// polarity tests, the run of 9 and the minimum cost about 120 integer
// operations; four pixels a 32-bit operation they are still about 25, as long
// as the bytes take at 16 frames of 640x480, and the kernel issues more.
//
// What the design does about it: no shared memory and no barrier.  A warp
// sweeps a strip of up to kStrip output rows over a segment of 32 * kLaneCols
// columns: each lane owns kLaneCols consecutive columns as kWords 4-byte words
// and reads each frame row once (one 4 * kWords-byte load where the width and
// the pointers are multiples of 16, 4-byte loads where they are multiples of
// 4, bytes otherwise).  Seven rows sit in registers with the next row's load
// in flight; the words just left and right of a lane's come from its
// neighbours by shuffle, so a sample dx columns away is one __byte_perm.
// Lanes 0 and 31 only lend their columns and scores: a segment writes the
// kOutCols columns of lanes 1..30, and segments overlap by a lane on each
// side.  Each score row is made once in a strip and kept for the NMS of the
// rows around it.
// Four pixels a 32-bit operation:
// * bright and dark are unsigned byte compares in bit 7 of each byte:
//   x = (a | 0x80) - (b & 0x7f) - 1 never borrows across bytes, and
//   a > b = (a & ~b) | (~(a ^ b) & x) in bit 7.  v > p + thr is v > hi with
//   hi = p + thr saturated at 255 (never true past it); v < p - thr is
//   v < lo with lo = p - thr saturated at 0, or'd with "p < thr" (C's wrap,
//   every sample dark; thr >= 256 wraps every pixel); bright wins;
// * the 16 samples' bright and dark bits of the lane's kWords words are
//   packed into one word a sample (bits 7 - 2k and 6 - 2k of each byte for
//   word k, a bit-select each; the other bits are garbage that the bitwise
//   logic never moves into them), and the run of 9 is an AND-tree over the
//   16 words read circularly: A2[k] = M[k] & M[k+1], A4[k] = A2[k] & A2[k+2],
//   run = OR_k A4[k] & A4[k+4] & M[k+8];
// * the score is the minimum of __vabsdiffu4 over the samples, taken by the
//   u16 minimum of three (__vimin3_u16x2, a Hopper DPX instruction) on the
//   words and on the words shifted up a byte; the NMS takes the maximum over
//   the 8 neighbours in the same way and compares it with the centre in the
//   byte compares.
// A lane then writes its kLaneCols keys as 16-byte stores where the pointers
// and width allow (int32: 4 keys a store), and its scores when they are asked for.
//
// The constants are the fastest of chip_sweep.py --source fast on the H100
// (16 frames of 640x480, device time): two words a lane took 18-20 % less
// time than one or four (a 640-pixel row takes 768 lanes' columns at two,
// 1024 at four); strips of 16 rows were within 2 % of 12 and 24 and took 22 %
// less than 32; 64 threads a block within 3 % of 128.  The u16 minimum and
// maximum took 22 % less than __vminu4 / __vmaxu4 (six instructions each on
// sm_90).  The kernel issues mostly LOP3s, near the card's INT32 rate.
//
// Each entry returns cudaGetLastError().

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStrip = 16;                          // output rows a warp sweeps, at most
constexpr int kWords = 2;                           // 4-byte words of columns a lane owns
constexpr int kLaneCols = 4 * kWords;               // columns a lane owns
constexpr int kSegment = 32 * kLaneCols;            // columns a warp reads
constexpr int kOutCols = kSegment - 2 * kLaneCols;  // columns it writes: lanes 1..30

constexpr unsigned kMsb = 0x80808080u;
constexpr unsigned kLow7 = 0x7f7f7f7fu;
constexpr unsigned kOnes = 0x01010101u;

// A lane's access to a row: its words as one vector (the width and the
// pointers multiples of 16), as 4-byte words (multiples of 4), or bytes.
enum Access { kBytes = 1, kWordAccess = 4, kVectors = 16 };

// FAST's Bresenham circle of radius 3 (grayskull.h:485-486); dy(k) = dx(k + 12).
__host__ __device__ constexpr int circle_dx(int k) {
  return k < 4 ? k : k < 6 ? 3 : k < 12 ? 8 - k : k < 14 ? -3 : k - 16;
}
__host__ __device__ constexpr int circle_dy(int k) { return circle_dx((k + 12) & 15); }

// Bit 7 of each byte: a > b as unsigned bytes, given x = (a | 0x80) - (b & 0x7f) - 1
// bytewise (bit 7 of x: a's low 7 bits > b's).  The other bits are garbage.
__device__ __forceinline__ unsigned gt_msb(unsigned a, unsigned b, unsigned x) {
  return (a & ~b) | (~(a ^ b) & x);
}

// Each byte 0xff where its bit 7 is set, else 0.
__device__ __forceinline__ unsigned msb_bytes(unsigned m) {
#if defined(__CUDA_ARCH__)
  unsigned r;
  asm("prmt.b32 %0, %1, 0, 0xBA98;" : "=r"(r) : "r"(m));  // bit 3 of a selector: sign-replicate
  return r;
#else
  return ((m & kMsb) >> 7) * 0xffu;
#endif
}

// One row of a lane: its kWords words and the words just left and right of them.
struct Row {
  unsigned v[kWords];
  unsigned left, right;
};

// Word i of the row for i in -1 .. kWords (i is a constant once unrolled).
__device__ __forceinline__ unsigned word(const Row& r, int i) {
  return i < 0 ? r.left : i >= kWords ? r.right : r.v[i];
}

// The word of the pixels dx columns right of word k's (dx in -3 .. 3).
__device__ __forceinline__ unsigned shifted(const Row& r, int k, int dx) {
  if (dx == 0) return r.v[k];
  return dx < 0 ? __byte_perm(word(r, k - 1), r.v[k], 0x3210 + (4 + dx) * 0x1111)
                : __byte_perm(r.v[k], word(r, k + 1), 0x3210 + dx * 0x1111);
}

// The lane's kWords words from one aligned access of 4 * kWords bytes.
__device__ __forceinline__ void load_words(const uint8_t* p, unsigned v[kWords]) {
  if (kWords == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    v[0] = q.x;
    v[1 % kWords] = q.y;
    v[2 % kWords] = q.z;
    v[3 % kWords] = q.w;
  } else if (kWords == 2) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = q.x;
    v[1 % kWords] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < kWords; ++k) v[k] = reinterpret_cast<const unsigned*>(p)[k];
  }
}

__device__ __forceinline__ void store_words(uint8_t* p, const unsigned v[kWords]) {
  if (kWords == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1 % kWords], v[2 % kWords], v[3 % kWords]);
  } else if (kWords == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1 % kWords]);
  } else {
#pragma unroll
    for (int k = 0; k < kWords; ++k) reinterpret_cast<unsigned*>(p)[k] = v[k];
  }
}

// Frame row y at the lane's columns x .. x + kLaneCols - 1; 0 outside the frame.
template <Access A>
__device__ __forceinline__ Row load_row(const uint8_t* frame, int y, int h, int w, int x) {
  Row r;
#pragma unroll
  for (int k = 0; k < kWords; ++k) r.v[k] = 0u;
  r.left = r.right = 0u;
  if (y < 0 || y >= h) return r;
  const uint8_t* p = frame + static_cast<size_t>(y) * w;
  if (A == kVectors) {
    if (x >= 0 && x < w) load_words(p + x, r.v);
  } else if (A != kBytes) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int xk = x + 4 * k;
      if (xk >= 0 && xk < w) r.v[k] = *reinterpret_cast<const unsigned*>(p + xk);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) {
      if (x + j >= 0 && x + j < w) r.v[j >> 2] |= static_cast<unsigned>(p[x + j]) << (8 * (j & 3));
    }
  }
  return r;
}

// The neighbouring lanes' words; every lane of the warp calls it.
__device__ __forceinline__ Row with_neighbours(Row r) {
  r.left = __shfl_up_sync(kFull, r.v[kWords - 1], 1);
  r.right = __shfl_down_sync(kFull, r.v[0], 1);
  return r;
}

// b's bits at the positions set in `pos`, a's elsewhere: one LOP3.
__device__ __forceinline__ unsigned select_bits(unsigned a, unsigned b, unsigned pos) {
  return (a & ~pos) | (b & pos);
}

// The run of 9 set bits, read circularly over the 16 words, in every bit.
__device__ __forceinline__ unsigned run9(const unsigned m[16]) {
  unsigned a2[16], a4[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) a2[k] = m[k] & m[(k + 1) & 15];
#pragma unroll
  for (int k = 0; k < 16; ++k) a4[k] = a2[k] & a2[(k + 2) & 15];
  unsigned run = 0u;
#pragma unroll
  for (int k = 0; k < 16; ++k) run |= a4[k] & a4[(k + 4) & 15] & m[(k + 8) & 15];
  return run;
}

// The scores of score row r at the lane's columns from frame rows r - 3 .. r + 3
// (win[3] is row r); 0 outside the interior (colmask holds the columns').
__device__ __forceinline__ void score_row(const Row (&win)[7], int r, int h,
                                          const unsigned colmask[kWords], unsigned t4,
                                          unsigned wrap_all, unsigned out[kWords]) {
  if (r < 3 || r >= h - 3) {  // the whole warp
#pragma unroll
    for (int k = 0; k < kWords; ++k) out[k] = 0u;
    return;
  }
  unsigned p[kWords], hi[kWords], hi_l1[kWords], lo[kWords], kd[kWords], wrap[kWords];
  // min |v - p| by the u16 minimum (native on sm_90): the high byte of the
  // smaller 16-bit half is the smaller high byte, so min_odd's bytes 1 and 3
  // are the minima of bytes 1 and 3, and min_even's (over the words shifted
  // up a byte) those of bytes 0 and 2; pending holds an even sample's words
  // until the odd one's
  unsigned min_odd[kWords], min_even[kWords], pend_odd[kWords], pend_even[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    p[k] = win[3].v[k];
    hi[k] = __vaddus4(p[k], t4);                   // p + thr, 255 past it
    hi_l1[k] = (hi[k] & kLow7) + kOnes;
    lo[k] = __vsubus4(p[k], t4);                   // p - thr, 0 below it
    kd[k] = (lo[k] | kMsb) + kMsb - kOnes;         // kd - (v | 0x80) = (lo | 0x80) - (v & 0x7f) - 1
    wrap[k] = wrap_all | gt_msb(t4, p[k], (t4 | kMsb) - ((p[k] & kLow7) + kOnes));  // p < thr
    min_odd[k] = min_even[k] = 0xffffffffu;
  }
  unsigned packed[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const Row& row = win[3 + circle_dy(s)];
    unsigned acc = 0u;  // bits outside the packed positions are garbage, never read
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const unsigned v = shifted(row, k, circle_dx(s));
      const unsigned vh = v | kMsb;
      const unsigned bright = gt_msb(v, hi[k], vh - hi_l1[k]);
      const unsigned dark = gt_msb(lo[k], v, kd[k] - vh) | (wrap[k] & ~bright);
      acc = select_bits(acc, bright >> (2 * k), kMsb >> (2 * k));
      acc = select_bits(acc, dark >> (2 * k + 1), kMsb >> (2 * k + 1));
      const unsigned d_odd = __vabsdiffu4(v, p[k]);
      const unsigned d_even = d_odd * 256u;  // a multiply, so that it may issue beside the logic
      if (s % 2 == 0) {
        pend_odd[k] = d_odd;
        pend_even[k] = d_even;
      } else {
        min_odd[k] = __vimin3_u16x2(min_odd[k], pend_odd[k], d_odd);
        min_even[k] = __vimin3_u16x2(min_even[k], pend_even[k], d_even);
      }
    }
    packed[s] = acc;
  }
  const unsigned run = run9(packed);
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const unsigned corner = ((run << (2 * k)) | (run << (2 * k + 1))) & kMsb;
    const unsigned mind = __byte_perm(min_even[k], min_odd[k], 0x7351);  // bytes e1 o1 e3 o3
    out[k] = mind & msb_bytes(corner) & colmask[k];
  }
}

// The bytewise maximum of three words by the u16 maximum (as the minimum in
// score_row): over the words for bytes 1 and 3, over them shifted up a byte
// for bytes 0 and 2.
__device__ __forceinline__ unsigned max3_bytes(unsigned a, unsigned b, unsigned c) {
  const unsigned odd = __vimax3_u16x2(a, b, c);
  const unsigned even = __vimax3_u16x2(a * 256u, b * 256u, c * 256u);
  return __byte_perm(even, odd, 0x7351);
}

// Bit 7 of each byte: the centre score is > 0 and no 8-neighbour's is greater.
__device__ __forceinline__ void keep_row(const unsigned up[kWords], const unsigned mid[kWords],
                                         const unsigned down[kWords], unsigned keep[kWords]) {
  unsigned ud[kWords], col[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    ud[k] = max3_bytes(up[k], down[k], down[k]);
    col[k] = max3_bytes(up[k], mid[k], down[k]);
  }
  const unsigned left = __shfl_up_sync(kFull, col[kWords - 1], 1);
  const unsigned right = __shfl_down_sync(kFull, col[0], 1);
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const unsigned l = __byte_perm(k == 0 ? left : col[k > 0 ? k - 1 : 0], col[k], 0x6543);
    const unsigned r = __byte_perm(col[k], k == kWords - 1 ? right : col[k < kWords - 1 ? k + 1 : k],
                                   0x4321);
    const unsigned nb = max3_bytes(l, r, ud[k]);
    const unsigned c = mid[k];
    const unsigned greater = gt_msb(nb, c, (nb | kMsb) - ((c & kLow7) + kOnes));
    const unsigned nonzero = ((c & kLow7) + kLow7) | c;
    keep[k] = nonzero & ~greater & kMsb;
  }
}

// The lane's keys and scores of output row y at columns x .. x + kLaneCols - 1.
template <Access A, typename Key, bool kScore>
__device__ __forceinline__ void store_row(Key* key_row, uint8_t* score_row_out, int x, int w,
                                          Key inv, const unsigned score[kWords],
                                          const unsigned keep[kWords]) {
  Key keys[kLaneCols];
#pragma unroll
  for (int j = 0; j < kLaneCols; ++j) {
    const unsigned sh = 8 * (j & 3);
    const Key s = static_cast<Key>((score[j >> 2] >> sh) & 0xffu);
    keys[j] = ((keep[j >> 2] >> (sh + 7)) & 1u) ? (((inv - j) << 8) | s) : Key(0);
  }
  const bool whole = x + kLaneCols <= w;
  if (A != kBytes && whole) {  // w and x are multiples of 4: 16-byte aligned keys
    constexpr int per = 16 / sizeof(Key);  // keys a 16-byte store
#pragma unroll
    for (int j = 0; j < kLaneCols; j += per) {
      uint4 q;
      memcpy(&q, &keys[j], 16);
      *reinterpret_cast<uint4*>(key_row + x + j) = q;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) {
      if (x + j < w) key_row[x + j] = keys[j];
    }
  }
  if (!kScore) return;
  if (A == kVectors && whole) {
    store_words(score_row_out + x, score);
  } else if (A != kBytes && whole) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) *reinterpret_cast<unsigned*>(score_row_out + x + 4 * k) = score[k];
  } else {
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) {
      if (x + j < w) score_row_out[x + j] = static_cast<uint8_t>(score[j >> 2] >> (8 * (j & 3)));
    }
  }
}

// Grid: one warp per (frame, strip of `strip` rows, segment), flattened over
// the blocks' warps.
template <Access A, typename Key, bool kScore>
__global__ void __launch_bounds__(kThreads)
    fast_kernel(const uint8_t* __restrict__ imgs, uint8_t* __restrict__ score_out,
                Key* __restrict__ key_out, int n, int h, int w, unsigned t4, unsigned wrap_all,
                int strip, int strips, int segs) {
  const long long warp_id = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (warp_id >= static_cast<long long>(n) * strips * segs) return;  // the whole warp
  const int seg = static_cast<int>(warp_id % segs);
  const long long fs = warp_id / segs;
  const int y0 = static_cast<int>(fs % strips) * strip;
  const int y1 = min(y0 + strip, h);
  const int f = static_cast<int>(fs / strips);
  const int lane = threadIdx.x & 31;
  const int x = seg * kOutCols - kLaneCols + lane * kLaneCols;  // the lane's first column
  const bool writes = lane >= 1 && lane <= 30 && x < w;
  unsigned colmask[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    colmask[k] = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = x + 4 * k + j;
      if (c >= 3 && c < w - 3) colmask[k] |= 0xffu << (8 * j);
    }
  }
  const size_t frame_off = static_cast<size_t>(f) * h * w;
  const uint8_t* frame = imgs + frame_off;
  Row win[7];  // frame rows r - 3 .. r + 3 of the next score row r
#pragma unroll
  for (int i = 0; i < 7; ++i) win[i] = with_neighbours(load_row<A>(frame, y0 - 4 + i, h, w, x));
  unsigned up[kWords], mid[kWords], down[kWords], keep[kWords];
  score_row(win, y0 - 1, h, colmask, t4, wrap_all, up);
#pragma unroll
  for (int i = 0; i < 6; ++i) win[i] = win[i + 1];
  win[6] = with_neighbours(load_row<A>(frame, y0 + 3, h, w, x));
  score_row(win, y0, h, colmask, t4, wrap_all, mid);
#pragma unroll
  for (int i = 0; i < 6; ++i) win[i] = win[i + 1];
  win[6] = with_neighbours(load_row<A>(frame, y0 + 4, h, w, x));
  for (int y = y0; y < y1; ++y) {  // win holds rows y - 2 .. y + 4
    const Row next = load_row<A>(frame, y + 1 < y1 ? y + 5 : -1, h, w, x);
    score_row(win, y + 1, h, colmask, t4, wrap_all, down);
    keep_row(up, mid, down, keep);
    if (writes) {
      const size_t row_off = frame_off + static_cast<size_t>(y) * w;
      const Key inv = static_cast<Key>(h) * w - (static_cast<Key>(y) * w + x);
      store_row<A, Key, kScore>(key_out + row_off, kScore ? score_out + row_off : nullptr, x, w,
                                inv, mid, keep);
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      up[k] = mid[k];
      mid[k] = down[k];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) win[i] = win[i + 1];
    win[6] = with_neighbours(next);
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The widest access that divides the row width and the pointers (none is null).
Access access_width(const void* a, const void* b, int w) {
  const uintptr_t u = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                      static_cast<uintptr_t>(w);
  return (u & 15) == 0 ? kVectors : (u & 3) == 0 ? kWordAccess : kBytes;
}

template <Access A, typename Key>
int launch(const uint8_t* imgs, uint8_t* score, Key* key, int n, int h, int w, int thr,
           cudaStream_t stream) {
  const int strips = ceil_div(h, kStrip);
  const int strip = ceil_div(h, strips);  // the strips as even as the height allows
  const int segs = ceil_div(w, kOutCols);
  const long long warps = static_cast<long long>(n) * strips * segs;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const unsigned t4 = static_cast<unsigned>(thr < 255 ? thr : 255) * kOnes;
  const unsigned wrap_all = thr > 255 ? 0xffffffffu : 0u;
  const auto grid = static_cast<unsigned>(blocks);
  if (score != nullptr) {
    fast_kernel<A, Key, true><<<grid, kThreads, 0, stream>>>(imgs, score, key, n, h, w, t4,
                                                             wrap_all, strip, strips, segs);
  } else {
    fast_kernel<A, Key, false><<<grid, kThreads, 0, stream>>>(imgs, score, key, n, h, w, t4,
                                                              wrap_all, strip, strips, segs);
  }
  return cudaGetLastError();
}

template <typename Key>
int launch_key(const uint8_t* imgs, uint8_t* score, Key* key, int n, int h, int w, int thr,
               cudaStream_t stream) {
  // keys go out as 16-byte vectors on every path but bytes'
  const Access a = (reinterpret_cast<uintptr_t>(key) & 15) != 0
                       ? kBytes
                       : access_width(imgs, score != nullptr ? static_cast<const void*>(score) : imgs, w);
  switch (a) {
    case kVectors: return launch<kVectors>(imgs, score, key, n, h, w, thr, stream);
    case kWordAccess: return launch<kWordAccess>(imgs, score, key, n, h, w, thr, stream);
    default: return launch<kBytes>(imgs, score, key, n, h, w, thr, stream);
  }
}

}  // namespace

extern "C" {

// imgs: (n, h, w) uint8; score: (n, h, w) uint8 or null; key: (n, h, w) int32,
// or int64 when wide_key != 0 (the caller sets it for h*w >= 2^23); thr >= 0.
int gs_fast(const void* imgs, void* score, void* key, int n, int h, int w, int thr, int wide_key,
            void* stream) {
  const auto in = static_cast<const uint8_t*>(imgs);
  const auto sc = static_cast<uint8_t*>(score);
  const auto s = static_cast<cudaStream_t>(stream);
  if (wide_key) return launch_key(in, sc, static_cast<int64_t*>(key), n, h, w, thr, s);
  return launch_key(in, sc, static_cast<int32_t*>(key), n, h, w, thr, s);
}

}  // extern "C"
