// K20 gs_contour: Moore-neighbour contour walks (gs_trace_contour,
// grayskull.h:446-480) over one uint8 frame and one visited mask, for Hopper
// (sm_90a), bound to Python through a plain C interface
// (grayskull_tpu_torch/kernels/_build.py).
//
// Replaces the XLA while-loop trace_contour (grayskull_tpu/ops/contour.py:36),
// and the scan of walks around it in largest_blob_contour and find_contours
// (:112, :160).  It is not a Pallas kernel.  In eager PyTorch each step of a
// walk would be several launches, thousands of them a contour.
//
// What it computes, in the JAX package's order (contour.py:36-99):
//   directions clockwise from East, dx = {1,1,0,-1,-1,-1,0,1},
//   dy = {0,1,1,1,0,-1,-1,-1}; the walk starts with dir = 7;
//   each step counts the current pixel if its mask byte is 0, sets it to 255,
//   scans its neighbours from (dir + 1) % 8 clockwise for the first in-frame
//   pixel > 128 (strictly), stops at a dead end, else moves there, updates the
//   box in C's statement order, turns to (sel + 6) % 8, and stops on the
//   second arrival at the start; at most 4 * h * w + 8 steps (counted in 64
//   bits).  The mask follows JAX's index rule, which matters only for a start
//   outside the frame: a negative index adds the size once, a read still out
//   of range is clamped, a write out of range is dropped.  Coordinates wrap
//   as int32 does.
// Three modes, one launch each:
//   trace:   one walk from the given start, on the caller's mask;
//   find:    for the blob rows k < min(n, cap) in table order, the blob's
//            first raster pixel (the component's minimum, on its box's top
//            row, scanning right from its box's left edge), skipped when its
//            mask byte is already set, else walked; the kept rows compacted;
//   largest: the first row of the largest area among rows < n, walked from
//            its first raster pixel on a fresh mask when n > 0, the area is
//            at least 100 and the pixel exists; else all zero.
// When the blob table's capacity passes 65,535 its uint16 label map wraps
// (as the JAX package's does), so the first pixel is then searched from the
// frame's first pixel, as the JAX package's argmax does.
//
// What bounds it: the serial chain of a walk.  Each step needs the neighbours
// of the pixel the previous step chose, so a walk costs its steps times the
// latency of one dependent step.  The walks of one call need not wait for
// each other: a walk's path depends on the frame alone (the mask only counts
// its length), so the order of find's walks decides only which of them are
// kept and which pixels each counts as fresh, and both follow from the paths.
// A call's least time is the chain of its longest walk.  Bytes are few.
//
// What the design does about it.
//   A step.  Lanes 0-7 read the eight neighbours of the current pixel at once
//   (lane l tests the fixed direction l), a __ballot_sync of "in frame and >
//   128", rotated to the scan's first direction, and __ffs of it give the
//   first in the clockwise scan.  Where two bits a pixel fit in shared memory
//   (frames up to about 0.9 MP), a block of kStageThreads first packs "> 128"
//   (and, for a single walk, "mask byte != 0") into bitmaps there, 16 pixels
//   a thread from 16-byte loads, so a step's loads take shared-memory
//   latency; larger frames are walked on the bytes themselves.
//   trace, largest: one walk on one warp.  Lane 0 keeps the visited state:
//   it reads a pixel's state a step before it counts it, sets its mask byte
//   to 255 at once (predicated PTX) and its bit a step later with a plain
//   store of the word it read (lane 0 alone writes the bitmap; a predicated
//   atomic there was compiled into a warp-wide reduction on every step).
//   Each mode is a kernel of its own.
//   find: windows of kWindow rows in table order, one warp a row, side by
//   side.  Each warp searches its row's first pixel (32 label-map entries a
//   round and a ballot) and walks from it without reading or writing the
//   mask: each visit ORs the walk's bit into the pixel's word of a zeroed
//   scratch map.  Then the window is resolved in table order: row k is kept
//   when its first pixel exists, its mask byte is 0 and no earlier kept walk
//   of the window set a bit at it (the mask holds the earlier windows' kept
//   paths); each walked pixel is visited once, in the span of the lowest walk
//   that reached it (the walk's box, updated in C's order, may leave some of
//   its pixels out), given to the lowest kept walk that reached it (counted
//   when its mask byte is 0), set to 255 when a kept walk reached it, and its
//   word cleared for the next window.  The kept rows are compacted in order.
//
// Each entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStageThreads = 1024;        // the block that packs the bitmaps
constexpr int kWindow = kStageThreads / 32;  // find's walks side by side: a warp and a bit each
constexpr int kMaxBitmapBytes = 227 * 1024;  // shared memory a block may take
constexpr int kDefaultSmem = 48 * 1024;
// dx + 1 and dy + 1, two bits a direction, clockwise from East
constexpr unsigned kDxPacked = 0x901Au;
constexpr unsigned kDyPacked = 0x01A9u;
constexpr int kTrace = 0;  // the modes
constexpr int kFind = 1;
constexpr int kLargest = 2;
constexpr int kRowFields = 7;  // box x, y, w, h, start x, y, length

__device__ __forceinline__ int dx_of(int d) {
  return static_cast<int>((kDxPacked >> (2 * d)) & 3u) - 1;
}

__device__ __forceinline__ int dy_of(int d) {
  return static_cast<int>((kDyPacked >> (2 * d)) & 3u) - 1;
}

// a + b - c with int32 wraparound
__device__ __forceinline__ int wrap(int a, int b, int c = 0) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b) -
                          static_cast<unsigned>(c));
}

struct Walk {
  int bx, by, bw, bh, length;
  long long steps;
};

// A pixel's visited state as lane 0 read it: ``word & mask``.  It is tested
// a step later, when the load has long arrived.
struct Seen {
  unsigned word, mask;
  __device__ bool set() const { return (word & mask) != 0; }
};

struct Args {
  const uint8_t* img;
  uint8_t* vis;
  int h, w;
  const int* start;  // trace: (x, y) on the card, or null for (sx, sy)
  int sx, sy;
  const uint16_t* label_map;  // find, largest: the blob table and its label map
  const int* n_blobs;
  const int* label;
  const int* area;
  const int* box_x;
  const int* box_y;
  int bcap, cap, full_scan;
  int* rows;           // (kRowFields, cap)
  int* count;          // find: the kept rows
  uint8_t* found;      // largest: whether a contour was traced
  long long* steps;    // (cap,) steps of each kept walk
  unsigned* path;      // find: (h, w) words, zero on entry and on exit
};

// ``*byte = 255`` where ``mark``, without a branch
__device__ __forceinline__ void mark_byte(uint8_t* byte, bool mark) {
#if defined(__CUDA_ARCH__)
  asm volatile("{\n .reg .pred p;\n setp.ne.u32 p, %1, 0;\n @p st.global.u8 [%0], %2;\n}"
               :
               : "l"(byte), "r"(static_cast<unsigned>(mark)), "r"(255u)
               : "memory");
#else
  if (mark) *byte = 255;
#endif
}

// ``*word = value`` in shared memory where ``mark``, without a branch
__device__ __forceinline__ void store_word(unsigned* word, unsigned value, bool mark) {
#if defined(__CUDA_ARCH__)
  asm volatile("{\n .reg .pred p;\n setp.ne.u32 p, %2, 0;\n @p st.shared.b32 [%0], %1;\n}"
               :
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(word))), "r"(value),
                 "r"(static_cast<unsigned>(mark))
               : "memory");
#else
  if (mark) *word = value;
#endif
}

// ``*word |= bit`` where ``mark``, without a branch; nothing reads the word
// until the walks are over
__device__ __forceinline__ void or_bit(unsigned* word, unsigned bit, bool mark) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %2, 0;\n @p red.global.or.b32 [%0], %1;\n}"
      :
      : "l"(word), "r"(bit), "r"(static_cast<unsigned>(mark)));
#else
  if (mark) atomicOr(word, bit);
#endif
}

// The frame and the mask as bytes in device memory.  visit(i, mark) returns
// the mask byte and, where ``mark``, sets it to 255; commit has nothing left
// to do.  Only lane 0's result is used, and lane 0 alone marks, so it reads
// its own earlier writes.
struct ByteFrame {
  using Count = long long;  // 4 * h * w + 8 steps may pass 2^31
  using Index = size_t;
  const uint8_t* __restrict__ img;
  uint8_t* vis;
  __device__ bool fg(Index i) const { return __ldg(img + i) > 128; }
  __device__ Seen visit(Index i, bool mark) const {
    const unsigned old = vis[i];
    mark_byte(vis + i, mark);
    return {old, 0xffu};
  }
  __device__ void commit(Index, Seen, bool) const {}
};

// The frame as "> 128" bits and the mask as "!= 0" bits in shared memory,
// pixel i at bit i % 32 of word i / 32.  visit(i, mark) returns pixel i's
// word and bit and, where ``mark``, sets its mask byte to 255; commit(i, seen,
// mark) then sets its bit, a plain store of the word it read (lane 0 alone
// writes the bitmap, so no atomic is needed, and the store waits for no load:
// it comes a step later, before the next visit's read).
struct BitFrame {
  using Count = int;  // at most 4 * 929,792 + 8 steps
  using Index = unsigned;
  const unsigned* fgb;
  unsigned* seenb;
  uint8_t* vis;
  __device__ bool fg(Index i) const { return (fgb[i >> 5] >> (i & 31)) & 1u; }
  __device__ Seen visit(Index i, bool mark) const {
    mark_byte(vis + i, mark);
    return {seenb[i >> 5], 1u << (i & 31)};
  }
  __device__ void commit(Index i, Seen seen, bool mark) const {
    store_word(seenb + (i >> 5), seen.word | seen.mask, mark);
  }
};

// A single walk's visits: lane 0 counts a pixel whose state was clear a
// step before it is counted, and marks it (its bitmap bit at the next visit).
template <class Frame>
struct Marks {
  using Index = typename Frame::Index;
  Seen old{0, 0};
  Index at = 0;  // the last pixel visited
  bool marking = false;
  int length = 0;
  // the start may lie outside the frame: its mask byte follows JAX's rule
  __device__ void start(const Frame& f, int h, int w, int sx, int sy, int lane) {
    const int wx = sx < 0 ? sx + w : sx;
    const int wy = sy < 0 ? sy + h : sy;
    const int rx = min(max(wx, 0), w - 1);
    const int ry = min(max(wy, 0), h - 1);
    at = static_cast<Index>(ry) * static_cast<Index>(w) + static_cast<Index>(rx);
    marking = lane == 0 && rx == wx && ry == wy;
    old = f.visit(at, marking);
  }
  __device__ void count() { length += !old.set(); }
  __device__ void visit(const Frame& f, Index i, int, int, int lane) {
    f.commit(at, old, marking);
    at = i;
    marking = lane == 0;
    old = f.visit(i, marking);
  }
};

// One of find's walks: lane 0 ORs the walk's bit into each visited pixel's
// word of the scratch map, and the walk keeps the span of the pixels it
// visited (the walk's box, updated in C's order, may leave some out); the
// length is counted when the window resolves.
struct PathBits {
  unsigned* path;
  unsigned bit;
  int length = 0;
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  template <class Frame>
  __device__ void start(const Frame&, int, int w, int sx, int sy, int lane) {
    or_bit(path + static_cast<size_t>(sy) * w + sx, bit, lane == 0);
    x0 = x1 = sx;
    y0 = y1 = sy;
  }
  __device__ void count() {}
  template <class Frame>
  __device__ void visit(const Frame&, typename Frame::Index i, int x, int y, int lane) {
    or_bit(path + i, bit, lane == 0);
    x0 = min(x0, x);
    x1 = max(x1, x);
    y0 = min(y0, y);
    y1 = max(y1, y);
  }
};

// The walk from (sx, sy); ``t`` keeps its visits (inlined, so that ``t`` stays
// in registers).
template <class Frame, class Track>
__device__ __forceinline__ Walk walk(const Frame& f, int h, int w, int sx, int sy, int lane,
                                     Track& t) {
  using Count = typename Frame::Count;
  using Index = typename Frame::Index;
  const Count max_steps = static_cast<Count>(4) * h * w + 8;
  // lane l < 8 tests the neighbour in direction l
  const int ldx = dx_of(lane & 7);
  const int ldy = dy_of(lane & 7);
  t.start(f, h, w, sx, sy, lane);
  int px = sx, py = sy, bx = sx, by = sy, bw = 1, bh = 1;
  int ndir = 0;  // the scan's first direction, (dir + 1) % 8 for dir = 7
  bool seen = false;
  Count steps = 0;
  while (true) {
    const int nx = wrap(px, ldx);
    const int ny = wrap(py, ldy);
    const bool ok = lane < 8 && static_cast<unsigned>(nx) < static_cast<unsigned>(w) &&
                    static_cast<unsigned>(ny) < static_cast<unsigned>(h) &&
                    f.fg(static_cast<Index>(ny) * static_cast<Index>(w) + static_cast<Index>(nx));
    const unsigned m = __ballot_sync(kFull, ok);
    t.count();  // lane 0's count is the walk's
    ++steps;
    if (m == 0) break;
    // the first direction at or after ndir, cyclically: bit k of the doubled
    // ballot shifted by ndir is direction (ndir + k) % 8
    const int sel = (ndir + __ffs((m * 0x101u) >> ndir) - 1) & 7;
    ndir = (sel + 7) & 7;  // dir = (sel + 6) % 8
    const unsigned two = 2 * sel;
    px = wrap(px, static_cast<int>((kDxPacked >> two) & 3u), 1);
    py = wrap(py, static_cast<int>((kDyPacked >> two) & 3u), 1);
    bx = min(bx, px);
    by = min(by, py);
    bw = max(bw, wrap(px, 1, bx));
    bh = max(bh, wrap(py, 1, by));
    const bool at_start = px == sx && py == sy;
    if ((at_start && seen) || steps >= max_steps) break;
    seen = seen || at_start;
    // in the frame after a move
    t.visit(f, static_cast<Index>(py) * static_cast<Index>(w) + static_cast<Index>(px), px, py,
            lane);
  }
  return Walk{bx, by, bw, bh, t.length, static_cast<long long>(steps)};
}

// The first raster index >= lo whose label-map entry is ``label``, as (x, y).
__device__ bool first_pixel(const uint16_t* __restrict__ lm, int h, int w, long long lo, int label,
                            int lane, int& x, int& y) {
  const long long total = static_cast<long long>(h) * w;
  for (long long base = lo; base < total; base += 32) {
    const long long i = base + lane;
    const unsigned m = __ballot_sync(kFull, i < total && static_cast<int>(lm[i]) == label);
    if (m != 0) {
      const long long idx = base + __ffs(m) - 1;
      x = static_cast<int>(idx % w);
      y = static_cast<int>(idx / w);
      return true;
    }
  }
  return false;
}

__device__ long long search_from(const Args& a, int row) {
  return a.full_scan ? 0 : static_cast<long long>(a.box_y[row]) * a.w + a.box_x[row];
}

__device__ void put_row(const Args& a, int k, const Walk& r, int sx, int sy) {
  const int v[kRowFields] = {r.bx, r.by, r.bw, r.bh, sx, sy, r.length};
#pragma unroll
  for (int f = 0; f < kRowFields; ++f) a.rows[f * a.cap + k] = v[f];
  a.steps[k] = r.steps;
}

// find's walks of one window and their resolution
struct Window {
  Walk walk[kWindow];
  int x[kWindow], y[kWindow];
  int span[4][kWindow];  // the visited pixels' x0, y0, x1, y1
  unsigned walked;  // bit j: row k0 + j exists and its first pixel was found
  unsigned kept;
};

// One pixel of walk ``j``'s span: resolved where walk j is the lowest walk
// that reached it, its word cleared.
__device__ __forceinline__ void resolve_pixel(const Args& a, Window& s, size_t p, int j) {
  const unsigned word = __ldcg(a.path + p);
  if (((word >> j) & 1u) == 0 || (word & ((1u << j) - 1u)) != 0) return;
  a.path[p] = 0;
  const unsigned kept = word & s.kept;
  if (kept == 0) return;  // only skipped walks reached it: no mark
  if (__ldcg(a.vis + p) == 0) atomicAdd(&s.walk[__ffs(kept) - 1].length, 1);
  a.vis[p] = 255;
}

template <class Frame>
__device__ void find(const Args& a, const Frame& frame, Window& s, int warp, int lane) {
  const int rows = min(*a.n_blobs, a.cap);
  int kept = 0;
  for (int k0 = 0; k0 < rows; k0 += kWindow) {
    // the window's walks, a warp each, marking only their path bits
    const int k = k0 + warp;
    int x0 = 0, y0 = 0;
    const bool found = k < rows && first_pixel(a.label_map, a.h, a.w, search_from(a, k),
                                               a.label[k], lane, x0, y0);
    if (lane == 0 && warp == 0) s.walked = 0;
    __syncthreads();
    if (found) {
      PathBits t{a.path, 1u << warp};
      const Walk r = walk(frame, a.h, a.w, x0, y0, lane, t);
      if (lane == 0) {
        s.walk[warp] = r;
        s.x[warp] = x0;
        s.y[warp] = y0;
        s.span[0][warp] = t.x0;
        s.span[1][warp] = t.y0;
        s.span[2][warp] = t.x1;
        s.span[3][warp] = t.y1;
        atomicOr(&s.walked, 1u << warp);
      }
    }
    __syncthreads();
    // which walks are kept, in table order: the start's mask byte is 0 (the
    // mask holds the earlier windows' kept paths) and no earlier kept walk of
    // this window reached it
    if (warp == 0) {
      const bool walked = (s.walked >> lane) & 1u;
      bool fresh = false;
      unsigned word = 0;
      if (walked) {
        const size_t p = static_cast<size_t>(s.y[lane]) * a.w + s.x[lane];
        fresh = __ldcg(a.vis + p) == 0;
        word = __ldcg(a.path + p);
      }
      unsigned keep = 0;
      for (int j = 0; j < kWindow; ++j) {
        const bool take = __shfl_sync(kFull, fresh && (word & keep) == 0, j);
        keep |= static_cast<unsigned>(take) << j;
      }
      if (lane < kWindow) s.walk[lane].length = 0;
      if (lane == 0) s.kept = keep;
    }
    __syncthreads();
    for (int j = 0; j < kWindow; ++j) {
      if (((s.walked >> j) & 1u) == 0) continue;
      const int bx = s.span[0][j], by = s.span[1][j];
      const int bw = s.span[2][j] - bx + 1, bh = s.span[3][j] - by + 1;
      if (bw <= kStageThreads) {  // kStageThreads / bw rows at a time
        const int per = kStageThreads / bw;
        const int r = threadIdx.x / bw;
        const int c = threadIdx.x - r * bw;
        if (r < per) {
          for (int y = by + r; y < by + bh; y += per) {
            resolve_pixel(a, s, static_cast<size_t>(y) * a.w + bx + c, j);
          }
        }
      } else {
        for (int y = by; y < by + bh; ++y) {
          for (int x = bx + threadIdx.x; x < bx + bw; x += kStageThreads) {
            resolve_pixel(a, s, static_cast<size_t>(y) * a.w + x, j);
          }
        }
      }
    }
    __syncthreads();
    const unsigned keep = s.kept;
    if (warp == 0 && ((keep >> lane) & 1u)) {
      put_row(a, kept + __popc(keep & ((1u << lane) - 1u)), s.walk[lane], s.x[lane], s.y[lane]);
    }
    kept += __popc(keep);
    __syncthreads();  // the window's state is rewritten by the next
  }
  for (int k = kept + static_cast<int>(threadIdx.x); k < a.cap; k += blockDim.x) {
#pragma unroll
    for (int f = 0; f < kRowFields; ++f) a.rows[f * a.cap + k] = 0;
    a.steps[k] = 0;
  }
  if (threadIdx.x == 0) *a.count = kept;
}

// The walks of mode kMode, a kernel each (so that one mode's code does not
// shape another's); find keeps its state in ``window`` (shared memory).
template <int kMode, class Frame>
__device__ void walks(const Args& a, const Frame& frame, Window* window) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if constexpr (kMode == kFind) {
    find(a, frame, *window, warp, lane);
  } else if constexpr (kMode == kTrace) {
    if (warp != 0) return;
    const int sx = a.start ? a.start[0] : a.sx;
    const int sy = a.start ? a.start[1] : a.sy;
    Marks<Frame> t;
    const Walk r = walk(frame, a.h, a.w, sx, sy, lane, t);
    if (lane == 0) put_row(a, 0, r, sx, sy);
  } else {
    if (warp != 0) return;
    // the first maximum of area over rows < n (-1 past n), then a lane reduction
    const int n = *a.n_blobs;
    int best = -2, best_i = 0;
    for (int k = lane; k < a.bcap; k += 32) {
      const int v = k < n ? a.area[k] : -1;
      if (v > best) {
        best = v;
        best_i = k;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int v = __shfl_xor_sync(kFull, best, off);
      const int i = __shfl_xor_sync(kFull, best_i, off);
      if (v > best || (v == best && i < best_i)) {
        best = v;
        best_i = i;
      }
    }
    int x0 = 0, y0 = 0;
    const bool found_px = a.bcap > 0 &&
                          first_pixel(a.label_map, a.h, a.w, search_from(a, best_i),
                                      a.label[best_i], lane, x0, y0);
    const bool found = n > 0 && best >= 100 && found_px;
    Marks<Frame> t;
    const Walk r = found ? walk(frame, a.h, a.w, x0, y0, lane, t) : Walk{0, 0, 0, 0, 0, 0};
    if (lane == 0) {
      put_row(a, 0, r, found ? x0 : 0, found ? y0 : 0);
      *a.found = found;
    }
  }
}

// 16 bytes to 16 bits: bit b set where byte b is > 128 (kAbove) or != 0
template <bool kAbove>
__device__ __forceinline__ unsigned pack16(uint4 v) {
  const unsigned q[4] = {v.x, v.y, v.z, v.w};
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned m = kAbove ? __vcmpgtu4(q[k], 0x80808080u) : __vcmpne4(q[k], 0u);
    bits |= (((m & 0x08040201u) * 0x01010101u) >> 24) << (4 * k);
  }
  return bits;
}

template <int kMode>
__global__ void __launch_bounds__(kMode == kFind ? kStageThreads : 32)
    contour_bytes_kernel(Args a) {
  extern __shared__ unsigned window[];
  walks<kMode>(a, ByteFrame{a.img, a.vis}, reinterpret_cast<Window*>(window));
}

// kStageThreads pack the "> 128" bitmap into words [0, words) and, for a
// single walk, the "!= 0" bitmap into [words, 2 * words): 16 pixels a thread
// from 16-byte loads where the buffers are 16-byte aligned, else (and for the
// last partial word) a warp a word, lane l reading pixel 32 i + l and a ballot
// packing the 32; then the walks run on them.  find keeps its Window where a
// single walk keeps the second bitmap, from word window_at on.
template <int kMode>
__global__ void __launch_bounds__(kStageThreads) contour_bits_kernel(Args a, int words,
                                                                     int window_at) {
  extern __shared__ unsigned bits[];
  const int total = a.h * a.w;  // below 2^30 here
  constexpr bool seen = kMode != kFind;
  const uintptr_t align = reinterpret_cast<uintptr_t>(a.img) |
                          (seen ? reinterpret_cast<uintptr_t>(a.vis) : 0);
  int first = 0;  // the first word packed by ballots
  if ((align & 15) == 0) {
    first = total / 32;
    uint16_t* halves = reinterpret_cast<uint16_t*>(bits);
    const uint4* img4 = reinterpret_cast<const uint4*>(a.img);
    const uint4* vis4 = reinterpret_cast<const uint4*>(a.vis);
    for (int c = threadIdx.x; c < 2 * first; c += kStageThreads) {
      halves[c] = static_cast<uint16_t>(pack16<true>(__ldg(img4 + c)));
      if (seen) halves[2 * words + c] = static_cast<uint16_t>(pack16<false>(vis4[c]));
    }
  }
  const int lane = threadIdx.x & 31;
  for (int i = first + (threadIdx.x >> 5); i < words; i += kStageThreads / 32) {
    const int p = i * 32 + lane;
    const unsigned fg = __ballot_sync(kFull, p < total && a.img[p] > 128);
    const unsigned vis = __ballot_sync(kFull, seen && p < total && a.vis[p] != 0);
    if (lane == 0) {
      bits[i] = fg;
      if (seen) bits[words + i] = vis;
    }
  }
  __syncthreads();
  walks<kMode>(a, BitFrame{bits, bits + words, a.vis},
               reinterpret_cast<Window*>(bits + window_at));
}

}  // namespace

extern "C" {

// img, visited: (h, w) uint8, the mask read and written in place; rows: (7,
// cap) int32; steps: (cap,) int64.  mode 0 (trace, cap 1): start is an int32
// (x, y) on the card, or null for (sx, sy).  mode 1 (find) and 2 (largest,
// cap 1): label_map (h, w) uint16 and the blob table's n (int32), label, area,
// box x and box y (bcap int32 each); find writes the kept rows' count to
// count, largest its found flag (a byte) to found.  full_scan: search every
// blob's first pixel from the frame's first pixel.  path (find): (h, w)
// uint32, zero on entry, left zero.  Requires h, w >= 1.
int gs_contour(const void* img, void* visited, int h, int w, int mode, const void* start, int sx,
               int sy, const void* label_map, const void* n_blobs, const void* label,
               const void* area, const void* box_x, const void* box_y, int bcap, int cap,
               int full_scan, void* rows, void* count, void* found, void* steps, void* path,
               void* stream) {
  Args a;
  a.img = static_cast<const uint8_t*>(img);
  a.vis = static_cast<uint8_t*>(visited);
  a.h = h;
  a.w = w;
  a.start = static_cast<const int*>(start);
  a.sx = sx;
  a.sy = sy;
  a.label_map = static_cast<const uint16_t*>(label_map);
  a.n_blobs = static_cast<const int*>(n_blobs);
  a.label = static_cast<const int*>(label);
  a.area = static_cast<const int*>(area);
  a.box_x = static_cast<const int*>(box_x);
  a.box_y = static_cast<const int*>(box_y);
  a.bcap = bcap;
  a.cap = cap;
  a.full_scan = full_scan;
  a.rows = static_cast<int*>(rows);
  a.count = static_cast<int*>(count);
  a.found = static_cast<uint8_t*>(found);
  a.steps = static_cast<long long*>(steps);
  a.path = static_cast<unsigned*>(path);
  if (mode == kFind && path == nullptr) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const long long words = (static_cast<long long>(h) * w + 31) / 32;
  const long long window_at = (words + 1) / 2 * 2;  // 8-byte aligned
  const long long window_end = (window_at * 4 + static_cast<long long>(sizeof(Window)) + 3) / 4;
  const long long smem = 4 * (mode == kFind && window_end > 2 * words ? window_end : 2 * words);
  if (smem <= kMaxBitmapBytes) {
    const auto kernel = mode == kTrace  ? contour_bits_kernel<kTrace>
                        : mode == kFind ? contour_bits_kernel<kFind>
                                        : contour_bits_kernel<kLargest>;
    if (smem > kDefaultSmem) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    kernel<<<1, kStageThreads, smem, st>>>(a, static_cast<int>(words), static_cast<int>(window_at));
  } else if (mode == kTrace) {
    contour_bytes_kernel<kTrace><<<1, 32, 0, st>>>(a);
  } else if (mode == kFind) {
    contour_bytes_kernel<kFind><<<1, kStageThreads, sizeof(Window), st>>>(a);
  } else {
    contour_bytes_kernel<kLargest><<<1, 32, 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // extern "C"
