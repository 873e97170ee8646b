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
// What bounds it: the serial chain.  Each step needs the neighbours of the
// pixel the previous step chose, so a walk costs steps times the latency of
// one dependent step; the walks of one frame are serial too, since each reads
// the mask the earlier ones wrote.  Bytes are few: the pixels walked.
//
// What the design does about it.  One warp does every walk of the call.
// Lanes 0-7 read the eight neighbours of the current pixel at once, a
// __ballot_sync of "in frame and > 128", rotated to the scan's first
// direction, and __ffs of it give the first in the clockwise scan, so a step
// is one round of loads and one ballot.  A walk is one warp and nothing hides
// its latencies: a step costs about the latencies of its instructions, one
// after the other, so it is kept to few.  Lane l tests the fixed direction l
// (its offsets computed once); the index rule for a start outside the frame
// is applied to the start alone; the step count is 32-bit where it fits;
// lane 0 alone sets the visited state (in predicated PTX) and counts the
// length from the state it read a step earlier.  Where two bits a pixel fit
// in shared memory (frames up to about 0.9 MP), a block of kStageThreads
// first packs "> 128" and "mask byte != 0" into two bitmaps there, so a
// step's loads take shared-memory latency and not L1's or L2's; the mask
// bytes are still written, 255 at each pixel walked.  Larger frames are
// walked on the bytes themselves (chip_sweep.py --source contour times the
// two on the same walks: PERF.md).  The first-pixel search reads 32
// label-map entries a round and ballots.
//
// Each entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStageThreads = 1024;        // the block that packs the bitmaps
constexpr int kMaxBitmapBytes = 227 * 1024;  // shared memory a block may take
constexpr int kDefaultSmem = 48 * 1024;
// dx + 1 and dy + 1, two bits a direction, clockwise from East
constexpr unsigned kDxPacked = 0x901Au;
constexpr unsigned kDyPacked = 0x01A9u;
constexpr int kTrace = 0;  // the modes; any other is kFind (1)
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
  int h, w, mode;
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
};

// ``*word |= bit`` and ``*byte = 255`` where ``mark``, without a branch
__device__ __forceinline__ void mark_bit(unsigned* word, unsigned bit, uint8_t* byte, bool mark) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %3, 0;\n @p red.shared.or.b32 [%0], %1;\n"
      " @p st.global.u8 [%2], %4;\n}"
      :
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(word))), "r"(bit), "l"(byte),
        "r"(static_cast<unsigned>(mark)), "r"(255u)
      : "memory");
#else
  if (mark) {
    *word |= bit;
    *byte = 255;
  }
#endif
}

// The frame and the mask as bytes in device memory.  visit(x, y, mark)
// returns the mask byte and, where ``mark``, sets it to 255; only lane 0's
// result is used, and lane 0 alone marks, so it reads its own earlier writes.
struct ByteFrame {
  using Count = long long;  // 4 * h * w + 8 steps may pass 2^31
  const uint8_t* __restrict__ img;
  uint8_t* vis;
  int w;
  __device__ bool fg(int x, int y) const {
    return __ldg(img + static_cast<size_t>(y) * w + x) > 128;
  }
  __device__ bool seen(int x, int y) const { return vis[static_cast<size_t>(y) * w + x] != 0; }
  __device__ Seen visit(int x, int y, bool mark) const {
    const size_t at = static_cast<size_t>(y) * w + x;
    const unsigned old = vis[at];
    if (mark) vis[at] = 255;
    return {old, 0xffu};
  }
};

// The frame as "> 128" bits and the mask as "!= 0" bits in shared memory,
// pixel i at bit i % 32 of word i / 32; the mask bytes are written as well.
struct BitFrame {
  using Count = int;  // at most 4 * 929,792 + 8 steps
  const unsigned* fgb;
  unsigned* seenb;
  uint8_t* vis;
  int w;
  __device__ bool fg(int x, int y) const {
    const unsigned i = static_cast<unsigned>(y) * w + x;
    return (fgb[i >> 5] >> (i & 31)) & 1u;
  }
  __device__ bool seen(int x, int y) const {
    const unsigned i = static_cast<unsigned>(y) * w + x;
    return (seenb[i >> 5] >> (i & 31)) & 1u;
  }
  __device__ Seen visit(int x, int y, bool mark) const {
    const unsigned i = static_cast<unsigned>(y) * w + x;
    const unsigned word = seenb[i >> 5];
    const unsigned bit = 1u << (i & 31);
    mark_bit(&seenb[i >> 5], bit, vis + i, mark);
    return {word, bit};
  }
};

template <class Frame>
__device__ Walk walk(const Frame& f, int h, int w, int sx, int sy, int lane) {
  using Count = typename Frame::Count;
  const Count max_steps = static_cast<Count>(4) * h * w + 8;
  // lane l < 8 tests the neighbour in direction l
  const int ldx = dx_of(lane & 7);
  const int ldy = dy_of(lane & 7);
  // the start may lie outside the frame: its mask byte follows JAX's rule
  const int wx = sx < 0 ? sx + w : sx;
  const int wy = sy < 0 ? sy + h : sy;
  const int rx = min(max(wx, 0), w - 1);
  const int ry = min(max(wy, 0), h - 1);
  Seen old = f.visit(rx, ry, lane == 0 && rx == wx && ry == wy);
  int px = sx, py = sy, bx = sx, by = sy, bw = 1, bh = 1, length = 0;
  int ndir = 0;  // the scan's first direction, (dir + 1) % 8 for dir = 7
  bool seen = false;
  Count steps = 0;
  while (true) {
    const int nx = wrap(px, ldx);
    const int ny = wrap(py, ldy);
    const bool ok = lane < 8 && static_cast<unsigned>(nx) < static_cast<unsigned>(w) &&
                    static_cast<unsigned>(ny) < static_cast<unsigned>(h) && f.fg(nx, ny);
    const unsigned m = __ballot_sync(kFull, ok);
    length += !old.set();  // lane 0's count is the walk's
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
    old = f.visit(px, py, lane == 0);  // in the frame after a move
  }
  return Walk{bx, by, bw, bh, length, static_cast<long long>(steps)};
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

template <class Frame>
__device__ void walks(const Args& a, const Frame& frame, int lane) {
  if (a.mode == kTrace) {
    const int sx = a.start ? a.start[0] : a.sx;
    const int sy = a.start ? a.start[1] : a.sy;
    const Walk r = walk(frame, a.h, a.w, sx, sy, lane);
    if (lane == 0) put_row(a, 0, r, sx, sy);
    return;
  }
  const int n = *a.n_blobs;
  if (a.mode == kLargest) {
    // the first maximum of area over rows < n (-1 past n), then a lane reduction
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
    const Walk r = found ? walk(frame, a.h, a.w, x0, y0, lane) : Walk{0, 0, 0, 0, 0, 0};
    if (lane == 0) {
      put_row(a, 0, r, found ? x0 : 0, found ? y0 : 0);
      *a.found = found;
    }
    return;
  }
  // find
  const int rows = min(n, a.cap);
  int kept = 0;
  for (int k = 0; k < rows; ++k) {
    int x0, y0;
    if (!first_pixel(a.label_map, a.h, a.w, search_from(a, k), a.label[k], lane, x0, y0)) continue;
    int visited = 0;
    if (lane == 0) visited = frame.seen(x0, y0);
    if (__shfl_sync(kFull, visited, 0) != 0) continue;
    const Walk r = walk(frame, a.h, a.w, x0, y0, lane);
    if (lane == 0) put_row(a, kept, r, x0, y0);
    ++kept;
  }
  for (int k = kept + lane; k < a.cap; k += 32) {
#pragma unroll
    for (int f = 0; f < kRowFields; ++f) a.rows[f * a.cap + k] = 0;
    a.steps[k] = 0;
  }
  if (lane == 0) *a.count = kept;
}

__global__ void __launch_bounds__(32) contour_bytes_kernel(Args a) {
  walks(a, ByteFrame{a.img, a.vis, a.w}, threadIdx.x);
}

// kStageThreads pack the two bitmaps of words [0, words) and [words, 2 * words),
// a warp a word at a time (lane l reads pixel 32 i + l, a ballot packs the
// 32); then warp 0 walks on them.
__global__ void __launch_bounds__(kStageThreads) contour_bits_kernel(Args a, int words) {
  extern __shared__ unsigned bits[];
  const int total = a.h * a.w;  // below 2^30 here
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < words; i += kStageThreads / 32) {
    const int p = i * 32 + lane;
    const unsigned fg = __ballot_sync(kFull, p < total && a.img[p] > 128);
    const unsigned seen = __ballot_sync(kFull, p < total && a.vis[p] != 0);
    if (lane == 0) {
      bits[i] = fg;
      bits[words + i] = seen;
    }
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  walks(a, BitFrame{bits, bits + words, a.vis, a.w}, threadIdx.x);
}

}  // namespace

extern "C" {

// img, visited: (h, w) uint8, the mask read and written in place; rows: (7,
// cap) int32; steps: (cap,) int64.  mode 0 (trace, cap 1): start is an int32
// (x, y) on the card, or null for (sx, sy).  mode 1 (find) and 2 (largest,
// cap 1): label_map (h, w) uint16 and the blob table's n (int32), label, area,
// box x and box y (bcap int32 each); find writes the kept rows' count to
// count, largest its found flag (a byte) to found.  full_scan: search every
// blob's first pixel from the frame's first pixel.  Requires h, w >= 1.
int gs_contour(const void* img, void* visited, int h, int w, int mode, const void* start, int sx,
               int sy, const void* label_map, const void* n_blobs, const void* label,
               const void* area, const void* box_x, const void* box_y, int bcap, int cap,
               int full_scan, void* rows, void* count, void* found, void* steps, void* stream) {
  Args a;
  a.img = static_cast<const uint8_t*>(img);
  a.vis = static_cast<uint8_t*>(visited);
  a.h = h;
  a.w = w;
  a.mode = mode;
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
  const auto st = static_cast<cudaStream_t>(stream);
  const long long words = (static_cast<long long>(h) * w + 31) / 32;
  const long long smem = words * 2 * 4;
  if (smem <= kMaxBitmapBytes) {
    if (smem > kDefaultSmem) {
      const cudaError_t err = cudaFuncSetAttribute(
          contour_bits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    contour_bits_kernel<<<1, kStageThreads, smem, st>>>(a, static_cast<int>(words));
  } else {
    contour_bytes_kernel<<<1, 32, 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // extern "C"
