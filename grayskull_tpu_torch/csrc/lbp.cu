// K5 gs_lbp_eval_scale: one ladder scale of the multi-block LBP cascade
// (gs_lbp_window, grayskull.h:790-813) over a grid of windows, for Hopper
// (sm_90a), bound to Python through a plain C interface
// (grayskull_tpu_torch/kernels/_build.py).
//
// Replaces the Pallas kernel lbp_eval_scale (grayskull_tpu/kernels/lbp.py:396,
// body _lbp_scale_kernel).  That kernel evaluated all 20 stages for every window
// because the TPU cannot branch per window; it also needed a phase-decomposed,
// zero-padded copy of the integral and a VMEM strip planner.  None of that
// carries over.
//
// What it computes: for window (n, i, j), at y = oy0 + i*step and
// x = ox0 + j*step, hits[n, i, j] = 1 when every stage passes.  A weak classifier
// reads its feature's 3x3 grid of blocks (each fw x fh, at (x+fx, y+fy)), turns
// the eight outer block sums into an 8-bit code by `block >= center` (bit order
// TL7 TC6 TR5 R4 BR3 BC2 BL1 L0, as ops/lbp.py:_BLOCK_BITS has it), and takes its
// left leaf when bit (code & 31) of subset word (code >> 5) is set and that word
// index is below the weak's subset count, else its right leaf.  A stage sums its
// weaks' leaves in float32 in weak order, starting from the first leaf, and
// passes when the sum is >= its threshold.
//
// Reads of the integral follow the JAX package's zero guard
// (grayskull_tpu/ops/lbp.py:_eval_windows): a corner at row -1 or column -1 (the
// gs_integral_sum edge guard) and any corner past the frame read 0.  Block sums
// and the compares are uint32: a block that reaches past the frame wraps the
// same way in both packages.
//
// What bounds it: the cascade's early exit.  A weak is 16 corner reads (a 4x4
// lattice gives all nine block sums) and about 40 integer operations; most
// windows leave within the first stages, but a window near a face runs dozens of
// weaks.  A thread per window makes each warp of 32 neighbouring windows pay for
// its deepest window, several times the average window's weaks, and each of
// its corner reads was a guarded global gather.  There is no product
// anywhere in the cascade, so the tensor cores have nothing to do here.
//
// What the design does about it:
// * A block owns a tile of tile_w x tile_h windows (64 x 32 down to 32 x 1,
//   chosen so that shared memory stays within kSmemBudget) of one frame.
//   Larger tiles compact better (more live windows a stage to fill warps
//   with); 64 x 32 was the fastest of the sizes tried on an H100.
// * The integral region that the tile's corners touch is copied once into
//   shared memory with cp.async (many copies in flight a thread), the -1
//   guard row and column and everything past the frame written as 0 by the
//   copy's zero fill, so each corner read is one unguarded shared-memory
//   load.  The region's extent comes from the scale's own tables (the
//   smallest fx, fy and the largest fx + 3 fw, fy + 3 fh); the launch
//   reserves room from the grid's geometry, and a block whose region does not
//   fit that room reads the integral through the zero guard in global memory
//   instead (same results).
// * Per-stage compaction: stage 0 runs over every window of the tile; each
//   warp appends its survivors' tile indices to a queue in shared memory with
//   one atomicAdd (offsets from __ballot_sync and __popc); each later stage
//   runs over the queue, 32 live windows a warp, and writes the next queue.  A
//   warp therefore pays for the windows alive at a stage, not for its deepest
//   lane.  The tile ends when the queue is empty or the last stage is done.
// * A stage with fewer live windows than threads (the deep stages, where a
//   tile keeps a few windows near a face) gives each thread one (window,
//   weak) pair: the leaves go to shared memory, then a thread per window adds
//   them in weak order.  The block's threads share the deep windows' weaks
//   instead of one warp running them in series.
// * Compaction reorders windows, never the weaks of one window: a stage's sum
//   starts at its first weak's leaf and adds the rest in weak order with
//   __fadd_rn, so no contraction or reordering changes a float.
// * Each window's hit is set in shared memory and written once, as bytes of
//   the (N, ny, nx) layout, neighbouring threads on neighbouring windows.
//
// Table layout (int32 words; float32 values stored as their bits), built by
// grayskull_tpu_torch/kernels/lbp.py:scale_tables:
//   [nweaks x 4]  fx, fy, fw, fh of the weak's feature at this scale
//   [nweaks x 8]  subset words, zero-padded
//   [nweaks]      subset word count
//   [nweaks x 2]  left leaf, right leaf
//   [nstages x 2] first weak, weak count
//   [nstages]     stage threshold
//
// Each entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;     // what a block may use on Hopper
constexpr int kSmemBudget = 112 * 1024;  // two blocks an SM at the largest tiles
constexpr int kPairCap = 1024;           // leaves a stage of few live windows may hold
constexpr unsigned kFull = 0xffffffffu;

// The scale's tables in shared memory.
struct Tables {
  const int* geo;
  const uint32_t* subs;
  const int* counts;
  const float* leaves;
  const int* stages;
  const float* thresholds;
};

__device__ __forceinline__ Tables tables_at(const int* tab, int nweaks, int nstages) {
  Tables t;
  t.geo = tab;
  t.subs = reinterpret_cast<const uint32_t*>(tab + nweaks * 4);
  t.counts = tab + nweaks * 12;
  t.leaves = reinterpret_cast<const float*>(tab + nweaks * 13);
  t.stages = tab + nweaks * 15;
  t.thresholds = reinterpret_cast<const float*>(tab + nweaks * 15 + nstages * 2);
  return t;
}

// Copies a 4-byte word from global to shared memory without passing through
// registers (cp.async, so a thread keeps many copies in flight), or writes 0
// where `valid` is false (a source size of 0 bytes; `src` is then not read).
__device__ __forceinline__ void copy4_async(void* dst, const void* src, bool valid) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
#else
  *static_cast<uint32_t*>(dst) = valid ? *static_cast<const uint32_t*>(src) : 0u;
#endif
}

// Waits for this thread's copy4_async copies; a barrier then publishes them.
__device__ __forceinline__ void copy_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
#endif
}

// Corner (r, c) of a window, relative to its top-left: the integral at
// (y + r - 1, x + c - 1), 0 past the guard or the frame.  SharedRead reads the
// block's staged region, GlobalRead the integral itself.
struct SharedRead {
  const uint32_t* p;  // the region, offset to the window
  int pitch;
  __device__ __forceinline__ uint32_t operator()(int r, int c) const { return p[r * pitch + c]; }
};

struct GlobalRead {
  const uint32_t* f;
  int y, x, h, w;  // y, x: the window's corner (-1, -1)
  __device__ __forceinline__ uint32_t operator()(int r, int c) const {
    const int rr = y + r, cc = x + c;
    return (rr >= 0 && rr < h && cc >= 0 && cc < w) ? __ldg(f + static_cast<size_t>(rr) * w + cc)
                                                    : 0u;
  }
};

// Weak classifier k's leaf for the window that `rd` reads.
template <class Read>
__device__ __forceinline__ float weak_leaf(const Read& rd, const Tables& tb, int k) {
  const int4 g = reinterpret_cast<const int4*>(tb.geo)[k];  // fx, fy, fw, fh
  uint32_t p[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) p[a][b] = rd(g.y + a * g.w, g.x + b * g.z);
  }
  uint32_t blk[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) blk[a][b] = p[a + 1][b + 1] + p[a][b] - p[a][b + 1] - p[a + 1][b];
  }
  const uint32_t c = blk[1][1];
  const int code = (blk[0][0] >= c) << 7 | (blk[0][1] >= c) << 6 | (blk[0][2] >= c) << 5 |
                   (blk[1][2] >= c) << 4 | (blk[2][2] >= c) << 3 | (blk[2][1] >= c) << 2 |
                   (blk[2][0] >= c) << 1 | (blk[1][0] >= c);
  const int word = code >> 5;
  const bool match = word < tb.counts[k] && ((tb.subs[8 * k + word] >> (code & 31)) & 1u);
  return match ? tb.leaves[2 * k] : tb.leaves[2 * k + 1];
}

// Stage s's sum for the window that `rd` reads: its first weak's leaf, then
// the others added in weak order.
template <class Read>
__device__ __forceinline__ float stage_sum(const Read& rd, const Tables& tb, int s) {
  const int k0 = tb.stages[2 * s];
  const int k1 = k0 + tb.stages[2 * s + 1];
  float sum = weak_leaf(rd, tb, k0);
  for (int k = k0 + 1; k < k1; ++k) sum = __fadd_rn(sum, weak_leaf(rd, tb, k));
  return sum;
}

// The block's geometry: its tile of windows and the region its corners touch.
struct Tile {
  int n, i0, j0, th, tw;  // frame, first window row and column, windows in the tile
  int log_w;              // the nominal tile width is 1 << log_w; tile index = ti << log_w | tj
  int ry0, rx0;           // integral row and column of region (0, 0)
  int lo_y, lo_x;         // the smallest fy, fx of the scale
  int rows, cols;         // the region's extent
};

// Runs the cascade's stages over the tile with per-stage compaction and marks
// the windows that pass them all in `res`.  `make(ti, tj)` gives the corner
// reader of window (ti, tj) of the tile.
template <class Make>
__device__ void run_stages(const Make& make, const Tables& tb, int nstages, const Tile& t,
                           uint16_t* q0, uint16_t* q1, uint8_t* res, float* leaves, int* cnt) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int mask_w = (1 << t.log_w) - 1;
  int live = t.th << t.log_w;  // stage 0: every index of the tile, the ragged edge skipped
  uint16_t* qin = q0;
  uint16_t* qout = q1;
  for (int s = 0; s < nstages; ++s) {
    // cnt[s % 3] counts stage s's survivors; cnt[(s + 1) % 3] was read before
    // the last barrier and is cleared for stage s + 1
    if (threadIdx.x == 0) cnt[(s + 1) % 3] = 0;
    int* out_count = cnt + s % 3;
    const int k0 = tb.stages[2 * s];
    const int nw = tb.stages[2 * s + 1];
    // Fewer live windows than threads: a thread per (window, weak) pair
    // computes the leaves, then a thread per window adds them in weak order.
    const bool pairs = s > 0 && live < static_cast<int>(blockDim.x) && live * nw <= kPairCap;
    if (pairs) {
      for (int idx = threadIdx.x; idx < live * nw; idx += blockDim.x) {
        const int wi = idx / nw;
        const int win = qin[wi];
        leaves[idx] = weak_leaf(make(win >> t.log_w, win & mask_w), tb, k0 + idx - wi * nw);
      }
      __syncthreads();
    }
    for (int base = threadIdx.x - lane; base < live; base += blockDim.x) {
      const int k = base + lane;
      int win = 0;
      bool pass = false;
      if (k < live) {
        win = s == 0 ? k : qin[k];
        if (pairs) {
          float sum = leaves[k * nw];
          for (int j = 1; j < nw; ++j) sum = __fadd_rn(sum, leaves[k * nw + j]);
          pass = sum >= tb.thresholds[s];
        } else {
          const int ti = win >> t.log_w, tj = win & mask_w;
          pass = (s > 0 || tj < t.tw) && stage_sum(make(ti, tj), tb, s) >= tb.thresholds[s];
        }
      }
      const unsigned ballot = __ballot_sync(kFull, pass);
      if (ballot != 0u) {
        int off = 0;
        if (lane == 0) off = atomicAdd(out_count, __popc(ballot));
        off = __shfl_sync(kFull, off, 0);
        if (pass) qout[off + __popc(ballot & below)] = static_cast<uint16_t>(win);
      }
    }
    __syncthreads();
    live = *out_count;
    uint16_t* tmp = qin;
    qin = qout;
    qout = tmp;
    if (live == 0) return;
  }
  for (int k = threadIdx.x; k < live; k += blockDim.x) res[qin[k]] = 1;
}

// Grid (ceil(nx / tile_w), ceil(ny / tile_h), n).  Dynamic shared memory: the
// tables (padded to 16 bytes), then two queues and the hit bytes of
// tile_w * tile_h windows, kPairCap leaves, then `region_cap` words for the
// integral region.
__global__ void __launch_bounds__(kThreads)
    lbp_scale_kernel(const uint32_t* __restrict__ ii, const int* __restrict__ tables,
                     uint8_t* __restrict__ hits, int h, int w, int ny, int nx, int step, int oy0,
                     int ox0, int nweaks, int nstages, int log_w, int tile_h, int region_cap) {
  extern __shared__ __align__(16) int tab[];
  __shared__ int cnt[3];
  __shared__ int ext[4];  // min fx, min fy, max fx + 3 fw, max fy + 3 fh
  const int words = nweaks * 15 + nstages * 3;
  const int words16 = (words + 3) & ~3;
  const int tile_n = tile_h << log_w;
  uint16_t* q0 = reinterpret_cast<uint16_t*>(tab + words16);
  uint16_t* q1 = q0 + tile_n;
  uint8_t* res = reinterpret_cast<uint8_t*>(q1 + tile_n);
  float* leaves = reinterpret_cast<float*>(tab + words16 + ((tile_n * 5 + 15) & ~15) / 4);
  uint32_t* region = reinterpret_cast<uint32_t*>(leaves + kPairCap);

  for (int i = threadIdx.x; i < words; i += blockDim.x) copy4_async(tab + i, tables + i, true);
  for (int i = threadIdx.x; i < tile_n; i += blockDim.x) res[i] = 0;
  if (threadIdx.x == 0) cnt[0] = 0;
  copy_async_wait();
  __syncthreads();
  if (threadIdx.x < 32) {
    int lx = 1 << 30, ly = 1 << 30, hx = -(1 << 30), hy = -(1 << 30);
    for (int k = threadIdx.x; k < nweaks; k += 32) {
      const int4 g = reinterpret_cast<const int4*>(tab)[k];
      lx = min(lx, g.x);
      ly = min(ly, g.y);
      hx = max(hx, g.x + 3 * g.z);
      hy = max(hy, g.y + 3 * g.w);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lx = min(lx, __shfl_xor_sync(kFull, lx, o));
      ly = min(ly, __shfl_xor_sync(kFull, ly, o));
      hx = max(hx, __shfl_xor_sync(kFull, hx, o));
      hy = max(hy, __shfl_xor_sync(kFull, hy, o));
    }
    if (threadIdx.x == 0) {
      ext[0] = lx;
      ext[1] = ly;
      ext[2] = hx;
      ext[3] = hy;
    }
  }
  __syncthreads();

  Tile t;
  t.n = blockIdx.z;
  t.i0 = blockIdx.y * tile_h;
  t.j0 = blockIdx.x << log_w;
  t.th = min(tile_h, ny - t.i0);
  t.tw = min(1 << log_w, nx - t.j0);
  t.log_w = log_w;
  t.lo_x = ext[0];
  t.lo_y = ext[1];
  t.ry0 = oy0 + t.i0 * step + t.lo_y - 1;
  t.rx0 = ox0 + t.j0 * step + t.lo_x - 1;
  const long long rows = static_cast<long long>(t.th - 1) * step + ext[3] - t.lo_y + 1;
  const long long cols = static_cast<long long>(t.tw - 1) * step + ext[2] - t.lo_x + 1;
  const bool staged = rows * cols <= region_cap;
  t.rows = static_cast<int>(rows);
  t.cols = static_cast<int>(cols);
  const Tables tb = tables_at(tab, nweaks, nstages);
  const uint32_t* f = ii + static_cast<size_t>(t.n) * h * w;

  if (staged) {
    // the zero guard: row or column -1 and anything past the frame read 0
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int a = warp; a < t.rows; a += kThreads / 32) {
      const int r = t.ry0 + a;
      const bool row_in = r >= 0 && r < h;
      const uint32_t* src = f + static_cast<size_t>(row_in ? r : 0) * w;
      for (int b = lane; b < t.cols; b += 32) {
        const int c = t.rx0 + b;
        const bool in = row_in && c >= 0 && c < w;
        copy4_async(region + a * t.cols + b, in ? src + c : f, in);
      }
    }
    copy_async_wait();
    __syncthreads();
    const int pitch = t.cols;
    const int dy = step * pitch;
    const int shift = -t.lo_y * pitch - t.lo_x;
    run_stages(
        [&](int ti, int tj) { return SharedRead{region + ti * dy + tj * step + shift, pitch}; }, tb,
        nstages, t, q0, q1, res, leaves, cnt);
  } else {
    const int y0 = oy0 + t.i0 * step - 1, x0 = ox0 + t.j0 * step - 1;
    run_stages(
        [&](int ti, int tj) { return GlobalRead{f, y0 + ti * step, x0 + tj * step, h, w}; }, tb,
        nstages, t, q0, q1, res, leaves, cnt);
  }
  __syncthreads();

  const int mask_w = (1 << log_w) - 1;
  for (int k = threadIdx.x; k < (t.th << log_w); k += blockDim.x) {
    const int ti = k >> log_w, tj = k & mask_w;
    if (tj < t.tw) hits[(static_cast<size_t>(t.n) * ny + t.i0 + ti) * nx + t.j0 + tj] = res[k];
  }
}

}  // namespace

extern "C" {

// ii: (n, h, w) uint32 integral images; tables: the scale's int32 words (layout
// above); hits: (n, ny, nx) uint8, 1 where the window passes every stage.
int gs_lbp_eval_scale(const void* ii, const void* tables, void* hits, int n, int h, int w,
                      int ny, int nx, int step, int oy0, int ox0, int nweaks, int nstages,
                      void* stream) {
  const long long words = static_cast<long long>(nweaks) * 15 + nstages * 3;
  const long long table_bytes = ((words + 3) & ~3LL) * 4;
  // Room for the region: the window's extent is at most what is left of the
  // frame past the grid's last window (plus 2 for the float truncation of the
  // scaled features); a block whose region is larger reads global memory.
  const long long est_h = (h - oy0 - static_cast<long long>(ny - 1) * step > 0
                               ? h - oy0 - static_cast<long long>(ny - 1) * step : 1) + 2;
  const long long est_w = (w - ox0 - static_cast<long long>(nx - 1) * step > 0
                               ? w - ox0 - static_cast<long long>(nx - 1) * step : 1) + 2;
  // tile shapes (log2 width, height), the largest first
  static const int kTiles[][2] = {{6, 32}, {6, 16}, {6, 8}, {5, 8}, {5, 4}, {5, 2}, {5, 1}};
  int log_w = 6, tile_h = 32;
  long long region_words = 0;
  for (const auto& tile : kTiles) {
    const long long tw = 1LL << tile[0], th = tile[1];
    const long long fixed = table_bytes + ((tw * th * 5 + 15) & ~15LL) + kPairCap * 4;
    const long long words_needed = ((th - 1) * step + est_h + 1) * ((tw - 1) * step + est_w + 1);
    if (fixed + words_needed * 4 <= kSmemBudget) {
      log_w = tile[0];
      tile_h = tile[1];
      region_words = words_needed;
      break;
    }
  }
  const long long smem = table_bytes +
                         (((static_cast<long long>(tile_h) << log_w) * 5 + 15) & ~15LL) +
                         kPairCap * 4 + region_words * 4;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        lbp_scale_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((nx + (1 << log_w) - 1) >> log_w, (ny + tile_h - 1) / tile_h, n);
  lbp_scale_kernel<<<grid, kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ii), static_cast<const int*>(tables),
      static_cast<uint8_t*>(hits), h, w, ny, nx, step, oy0, ox0, nweaks, nstages, log_w, tile_h,
      static_cast<int>(region_words));
  return cudaGetLastError();
}

}  // extern "C"
