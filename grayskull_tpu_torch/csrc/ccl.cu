// K9 gs_ccl: 4-connected component labelling of a batch of uint8 frames, for
// Hopper (sm_90a), bound to Python through a plain C interface
// (grayskull_tpu_torch/kernels/_build.py).
//
// Replaces the Pallas kernel ccl_serpentine (grayskull_tpu/kernels/ccl.py:161,
// body _ccl_pass_kernel), which min-propagates raster indices through VMEM
// strips in down and up sweeps until a sweep changes nothing.  It computes the
// fixpoint of that propagation: every foreground pixel (>= 128) gets the
// smallest per-frame raster index y*W + x of its 4-connected component, and
// background gets -1.
//
// What bounds it: device memory and the latency of dependent loads.  The
// minimum is 1 B read and 4 B written per pixel; this design moves about 6 B (it
// reads the frame twice and writes every label once; the flatten reads links
// only of foreground run pieces).  On the scanner's binaries (4 % foreground,
// components of at most a few dozen pixels) unions are rare; the cost is
// passes over the frame, launches, and walks up the union-find's links.
//
// What the design does about it (redesigned for Hopper): three launches on one
// stream, no host sync, and no 64-bit division (frames go on grid.y, with a
// loop past 65,535; a tile's row and column come from one 32-bit division per
// block):
//   1. tile: a block labels a kTileH x kTileW tile in shared memory.  A thread
//      reads 16 pixels of a row (one 16-byte load where the width and the
//      pointer allow, bytes otherwise) as a 16-bit foreground mask; a tile
//      with no foreground writes -1 and stops there.  Row runs come from the
//      masks by bit tricks: a run starts where a pixel is set and its left
//      neighbour is not, and a pixel's run start is one past the highest clear
//      bit to its left.  Each run start is a root; each run unites with the
//      runs above it once per overlap segment (a shared-memory union-find,
//      hooking the larger root under the smaller with atomicCAS).  Unions that
//      land together leave chains as long as a stroke is high, so rounds of
//      pointer jumping over the run starts follow until each links to its
//      root; a pixel then reads its root in one load.  The labels (-1, or the
//      frame raster index of the root) go through shared memory so that a
//      warp stores 512 consecutive bytes of a row at once.  The tile index
//      r*kTileW + c maps to (ty + r)*W + tx + c in order, so the tile's root,
//      its minimum, is also the minimum frame index of the part of the
//      component inside the tile;
//   2. border: a thread per pixel of each tile's top row and left column
//      unites it with its neighbour above or to the left in global memory,
//      when both are foreground.  Finds start at the pixels' links (so only
//      tile roots change), walk with volatile loads and halve the path; the
//      larger root is hooked under the smaller with an atomicCAS that only
//      succeeds while it is still a root, and a failed hook retries from the
//      value it found (Jaiganesh & Burtscher, ECL-CC, HPDC 2018);
//   3. flatten: a thread per 16 pixels reads the foreground mask again.  The
//      pixels of a run piece link to one tile root, and only the root's own
//      link can have changed, so the piece's last pixel tells whether the root
//      was hooked; if so the walk to the final root writes nothing, and then
//      every pixel of the piece takes it.  Background never changes and is not
//      read.
// A link only ever points to a smaller index (parent[p] <= p), so a root is
// the minimum of its tree and the result does not depend on the order in
// which the atomics land.  The parent array is the output buffer itself.  A
// frame must have fewer than 2^31 pixels (the wrapper checks).  A frame of one
// tile skips launches 2 and 3.
//
// The tile and the stores through shared memory are the fastest of
// chip_sweep.py --source ccl on the H100 (PERF.md): tiles of 16x128, 64x64,
// 32x256 and 16x256 came within 5 % of 32x128 on the document binaries, and
// neither a flatten of only the tiles with a foreground pair across their edge
// nor stores by each thread helped (the sweep carries both).
//
// Each entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 128;  // a power of two, at least 16
constexpr int kChunk = 16;   // pixels a thread: one 16-byte load
constexpr int kChunks = kTileW / kChunk;
constexpr int kTileThreads = kTileH * kChunks;
constexpr int kBorderThreads = kTileW + kTileH;
constexpr int kMaxFrameBlocks = 65535;

// The foreground bits (byte >= 128) of a 4-byte word: bit 7 of byte b moves to
// bit 28 + b, and no two partial products meet.
__device__ __forceinline__ unsigned fg4(unsigned v) {
  return ((v & 0x80808080u) * 0x00204081u) >> 28;
}

// The 16-bit foreground mask of pixels (y, x .. x + 15) of a frame; pixels
// outside the frame are background.  vec: w % 16 == 0 and the frame is 16-byte
// aligned, so the 16 bytes are one load inside the row.
__device__ __forceinline__ unsigned load_mask(const uint8_t* __restrict__ frame, int y, int x,
                                              int h, int w, bool vec) {
  if (y < 0 || y >= h || x >= w) return 0u;
  const uint8_t* p = frame + static_cast<size_t>(y) * w + x;
  if (vec) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    return fg4(v.x) | fg4(v.y) << 4 | fg4(v.z) << 8 | fg4(v.w) << 12;
  }
  const int count = w - x < kChunk ? w - x : kChunk;
  unsigned m = 0u;
  for (int i = 0; i < count; ++i) m |= static_cast<unsigned>(p[i] >= 128) << i;
  return m;
}

// The first column of the run holding column c of a tile row (c foreground):
// one past the highest background bit left of c.
__device__ __forceinline__ int run_start(const unsigned short* row, int c) {
  int j = c / kChunk;
  unsigned z = ~static_cast<unsigned>(row[j]) & ((1u << (c % kChunk)) - 1u);
  while (z == 0u) {
    if (--j < 0) return 0;
    z = ~static_cast<unsigned>(row[j]) & 0xffffu;
  }
  return j * kChunk + 32 - __clz(z);
}

// The root of p, halving the path on the way (each visited link is pointed at
// its grandparent, which is still an ancestor whatever else runs meanwhile).
// parent is shared memory (a tile) or global memory (a frame); inlined, the
// compiler sees which and issues shared-memory loads and atomics for a tile.
__device__ __forceinline__ int find_root(volatile int* parent, int p) {
  int cur = parent[p];
  if (cur == p) return p;
  int prev = p;
  int next;
  while (cur > (next = parent[cur])) {
    parent[prev] = next;
    prev = cur;
    cur = next;
  }
  return cur;
}

// Joins the trees of a and b.  The walks start at a's and b's links, so only
// roots and the links above them change: in a frame's labels, only tile roots.
__device__ __forceinline__ void unite(int* parent, int a, int b) {
  volatile int* vp = parent;
  int ra = find_root(vp, vp[a]);
  int rb = find_root(vp, vp[b]);
  while (ra != rb) {
    if (ra < rb) {
      const int seen = atomicCAS(parent + rb, rb, ra);
      if (seen == rb) return;
      rb = seen;  // rb was hooked meanwhile: go on from where it points
    } else {
      const int seen = atomicCAS(parent + ra, ra, rb);
      if (seen == ra) return;
      ra = seen;
    }
  }
}

// Stores a thread's 16 labels at dst, of which `room` lie in the row: four
// 16-byte stores where vec (w % 4 == 0 and an aligned output) and the row allow.
__device__ __forceinline__ void store_chunk(int* dst, int room, bool vec,
                                            const int (&out)[kChunk]) {
  if (vec && room >= kChunk) {
#pragma unroll
    for (int i = 0; i < kChunk; i += 4) {
      *reinterpret_cast<int4*>(dst + i) = make_int4(out[i], out[i + 1], out[i + 2], out[i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < room) dst[i] = out[i];
    }
  }
}

// The tile of this block: tiles go over the frame row by row on grid.x.
struct Tile {
  int ty, tx;
  __device__ explicit Tile(int tiles_x) {
    const unsigned row = blockIdx.x / static_cast<unsigned>(tiles_x);
    ty = static_cast<int>(row) * kTileH;
    tx = static_cast<int>(blockIdx.x - row * static_cast<unsigned>(tiles_x)) * kTileW;
  }
};

// Grid (tiles, min(n, kMaxFrameBlocks)), block kTileThreads: thread (r, q)
// takes pixels ty + r, tx + 16q .. tx + 16q + 15.
__global__ void __launch_bounds__(kTileThreads)
tile_kernel(const uint8_t* __restrict__ src, int* __restrict__ label, int n, int h, int w,
            int tiles_x, bool vec_in, bool vec_out) {
  // tile index r * kTileW + c: links at run starts, then labels
  __shared__ __align__(16) int parent[kTileH * kTileW];
  __shared__ unsigned short bits[kTileH][kChunks];
  const int r = threadIdx.x / kChunks, q = threadIdx.x % kChunks;
  const int c0 = q * kChunk, base = r * kTileW;
  const Tile t(tiles_x);
  const int y = t.ty + r, x = t.tx + c0;
  for (int f = blockIdx.y; f < n; f += gridDim.y) {
    const size_t offset = static_cast<size_t>(f) * h * w;
    const unsigned m = load_mask(src + offset, y, x, h, w, vec_in);
    bits[r][q] = static_cast<unsigned short>(m);
    int out[kChunk];
    if (!__syncthreads_or(m != 0u)) {  // an empty tile: every label is -1
#pragma unroll
      for (int i = 0; i < kChunk; ++i) out[i] = -1;
      if (y < h && x < w) {
        store_chunk(label + offset + static_cast<size_t>(y) * w + x, w - x, vec_out, out);
      }
      continue;  // no thread touches bits or parent before the next barrier
    }
    const unsigned left = q > 0 ? bits[r][q - 1] >> (kChunk - 1) : 0u;  // pixel c0 - 1
    const unsigned starts = m & ~(m << 1 | left);
    for (unsigned rest = starts; rest; rest &= rest - 1u) {
      const int c = c0 + __ffs(rest) - 1;
      parent[base + c] = base + c;
    }
    __syncthreads();
    if (r > 0) {  // unite with the runs above, once per overlap segment
      const unsigned up = bits[r - 1][q];
      const unsigned up_left = q > 0 ? bits[r - 1][q - 1] >> (kChunk - 1) : 0u;
      const unsigned ov = m & up;
      unsigned segs = ov & ~(ov << 1 | (left & up_left));
      while (segs) {
        const int c = c0 + __ffs(segs) - 1;
        segs &= segs - 1u;
        unite(parent, base + run_start(bits[r], c), base - kTileW + run_start(bits[r - 1], c));
      }
    }
    __syncthreads();
    // Unions that land together can leave chains as long as a stroke is high.
    // Rounds of pointer jumping over the run starts (each link pointed at its
    // parent's parent, an ancestor) until every run start links to its root.
    bool jumped;
    do {
      jumped = false;
      for (unsigned rest = starts; rest; rest &= rest - 1u) {
        const int s = base + c0 + __ffs(rest) - 1;
        const int up = parent[s], upup = parent[up];
        if (upup != up) {
          parent[s] = upup;
          jumped = true;
        }
      }
    } while (__syncthreads_or(jumped));
    int root = -1;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if ((m >> i) & 1u) {
        if (i == 0 || !((m >> (i - 1)) & 1u)) {
          const int s = i == 0 ? run_start(bits[r], c0) : c0 + i;
          const int lr = parent[base + s];
          root = (t.ty + lr / kTileW) * w + t.tx + lr % kTileW;
        }
        out[i] = root;
      } else {
        out[i] = -1;
      }
    }
    __syncthreads();  // every find is done: the labels go through parent
#pragma unroll
    for (int i = 0; i < kChunk; i += 4) {
      *reinterpret_cast<int4*>(parent + base + c0 + i) =
          make_int4(out[i], out[i + 1], out[i + 2], out[i + 3]);
    }
    __syncthreads();
    // a warp writes kTileW / 4 * 16 consecutive bytes of a row a store
    for (int e = threadIdx.x; e < kTileH * kTileW / 4; e += kTileThreads) {
      const int gy = t.ty + e / (kTileW / 4), c = e % (kTileW / 4) * 4, gx = t.tx + c;
      if (gy >= h || gx >= w) continue;
      const int* from = parent + (gy - t.ty) * kTileW + c;
      int* dst = label + offset + static_cast<size_t>(gy) * w + gx;
      if (vec_out && gx + 4 <= w) {
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(from);
      } else {
        for (int i = 0; i < 4 && gx + i < w; ++i) dst[i] = from[i];
      }
    }
    __syncthreads();  // bits and parent are reused by the next frame
  }
}

// Grid (tiles, min(n, kMaxFrameBlocks)), block kBorderThreads: thread i <
// kTileW takes pixel (ty, tx + i) and its neighbour above; the others pixel
// (ty + i - kTileW, tx) and its neighbour to the left.
__global__ void border_kernel(const uint8_t* __restrict__ src, int* label, int n, int h, int w,
                              int tiles_x) {
  const Tile t(tiles_x);
  const int i = threadIdx.x;
  int p = -1, step = 0;
  if (i < kTileW) {
    if (t.ty > 0 && t.tx + i < w) p = t.ty * w + t.tx + i, step = w;
  } else if (t.tx > 0 && t.ty + i - kTileW < h) {
    p = (t.ty + i - kTileW) * w + t.tx, step = 1;
  }
  if (p < 0) return;
  for (int f = blockIdx.y; f < n; f += gridDim.y) {
    const size_t offset = static_cast<size_t>(f) * h * w;
    if (src[offset + p] >= 128 && src[offset + p - step] >= 128) unite(label + offset, p, p - step);
  }
}

// Grid (tiles, min(n, kMaxFrameBlocks)), block kTileThreads, as tile_kernel.
__global__ void __launch_bounds__(kTileThreads)
flatten_kernel(const uint8_t* __restrict__ src, int* label, int n, int h, int w, int tiles_x,
               bool vec_in) {
  const int r = threadIdx.x / kChunks, q = threadIdx.x % kChunks;
  const Tile t(tiles_x);
  const int y = t.ty + r, x = t.tx + q * kChunk;
  for (int f = blockIdx.y; f < n; f += gridDim.y) {
    const size_t offset = static_cast<size_t>(f) * h * w;
    const unsigned m = load_mask(src + offset, y, x, h, w, vec_in);
    // The pixels of a run piece link to one tile root T; only T's own link can
    // have changed (it heads its piece), so the piece's last pixel tells
    // whether T was hooked, and then every pixel of the piece takes the root.
    // Plain loads are enough: a pixel is written only by its own thread, a
    // root never changes, and a link read before another thread points it at
    // the root is still an ancestor of it.
    int* parent = label + offset;
    for (unsigned pieces = m & ~(m << 1); pieces; pieces &= pieces - 1u) {
      const int i0 = __ffs(pieces) - 1;
      const int len = __ffs(~(m >> i0)) - 1;  // m has 16 bits: a clear bit always ends it
      const int p = y * w + x + i0;
      const int link = parent[p + len - 1];
      int root = parent[link];
      if (root == link) continue;
      for (int next = parent[root]; next != root; next = parent[root]) root = next;
      for (int i = 0; i < len; ++i) parent[p + i] = root;
    }
  }
}

}  // namespace

extern "C" {

// src: (n, h, w) uint8; label: (n, h, w) int32.  Requires n, h, w >= 1 and
// h * w < 2^31.
int gs_ccl(const void* src, void* label, int n, int h, int w, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (static_cast<long long>(h) * w >= (1LL << 31)) return cudaErrorInvalidValue;
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const long long tiles = static_cast<long long>(tiles_x) * ((h + kTileH - 1) / kTileH);
  const dim3 grid(static_cast<unsigned>(tiles), n < kMaxFrameBlocks ? n : kMaxFrameBlocks);
  const uint8_t* s = static_cast<const uint8_t*>(src);
  int* l = static_cast<int*>(label);
  const bool vec_in = w % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const bool vec_out = w % 4 == 0 && reinterpret_cast<uintptr_t>(label) % 16 == 0;
  tile_kernel<<<grid, kTileThreads, 0, st>>>(s, l, n, h, w, tiles_x, vec_in, vec_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return err;
  border_kernel<<<grid, kBorderThreads, 0, st>>>(s, l, n, h, w, tiles_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flatten_kernel<<<grid, kTileThreads, 0, st>>>(s, l, n, h, w, tiles_x, vec_in);
  return cudaGetLastError();
}

}  // extern "C"
