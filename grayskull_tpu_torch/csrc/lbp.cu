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
// What bounds it: the gathers.  A weak needs 16 corner reads (a 4x4 lattice
// gives all nine block sums), so a window that runs all 139 weaks of the
// frontal-face cascade makes 2,224 four-byte reads; the arithmetic per read is
// a few integer ops.  The frame's integral (1.2 MB at 640x480) sits in L2 and
// neighbouring threads read neighbouring words, so the reads mostly hit L1/L2.
//
// What the design does about it: one thread per window, threads of a warp on
// neighbouring x so their corner reads coalesce; the scale's tables (geometry,
// subset words, leaves, stages; 8.6 KB for the frontal face) are copied once per
// block into shared memory, where every thread of a warp reads the same word (a
// broadcast).  Each window leaves at its first failed stage, as the reference
// does: most windows fail within the first stages, so the average window runs a
// few weaks, not 139.  The stage sum uses __fadd_rn in weak order, so no
// contraction or reordering can change a float.
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

constexpr int kThreads = 128;
constexpr int kMaxSmem = 48 * 1024;  // the default dynamic shared memory limit

__device__ __forceinline__ uint32_t corner(const uint32_t* __restrict__ f, int r, int c, int h,
                                           int w) {
  return (r >= 0 && r < h && c >= 0 && c < w) ? __ldg(f + static_cast<size_t>(r) * w + c) : 0u;
}

// Grid (ceil(nx / kThreads), ny, n); dynamic shared memory holds the tables.
__global__ void lbp_scale_kernel(const uint32_t* __restrict__ ii, const int* __restrict__ tables,
                                 uint8_t* __restrict__ hits, int h, int w, int ny, int nx,
                                 int step, int oy0, int ox0, int nweaks, int nstages) {
  extern __shared__ int tab[];
  const int words = nweaks * 15 + nstages * 3;
  for (int i = threadIdx.x; i < words; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nx) return;
  const int i = blockIdx.y;
  const int n = blockIdx.z;
  const int* geo = tab;
  const uint32_t* subs = reinterpret_cast<const uint32_t*>(tab + nweaks * 4);
  const int* counts = tab + nweaks * 12;
  const float* leaves = reinterpret_cast<const float*>(tab + nweaks * 13);
  const int* stages = tab + nweaks * 15;
  const float* thresholds = reinterpret_cast<const float*>(tab + nweaks * 15 + nstages * 2);

  const uint32_t* f = ii + static_cast<size_t>(n) * h * w;
  const int y = oy0 + i * step;
  const int x = ox0 + j * step;
  uint8_t ok = 1;
  for (int s = 0; s < nstages && ok; ++s) {
    const int k0 = stages[2 * s];
    const int k1 = k0 + stages[2 * s + 1];
    float sum = 0.0f;
    for (int k = k0; k < k1; ++k) {
      const int fx = geo[4 * k], fy = geo[4 * k + 1], fw = geo[4 * k + 2], fh = geo[4 * k + 3];
      int rows[4], cols[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        rows[t] = y + fy + t * fh - 1;
        cols[t] = x + fx + t * fw - 1;
      }
      uint32_t p[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) p[a][b] = corner(f, rows[a], cols[b], h, w);
      }
      uint32_t blk[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          blk[a][b] = p[a + 1][b + 1] + p[a][b] - p[a][b + 1] - p[a + 1][b];
        }
      }
      const uint32_t c = blk[1][1];
      const int code = (blk[0][0] >= c) << 7 | (blk[0][1] >= c) << 6 | (blk[0][2] >= c) << 5 |
                       (blk[1][2] >= c) << 4 | (blk[2][2] >= c) << 3 | (blk[2][1] >= c) << 2 |
                       (blk[2][0] >= c) << 1 | (blk[1][0] >= c);
      const int word = code >> 5;
      const bool match = word < counts[k] && ((subs[8 * k + word] >> (code & 31)) & 1u);
      const float leaf = match ? leaves[2 * k] : leaves[2 * k + 1];
      sum = k == k0 ? leaf : __fadd_rn(sum, leaf);
    }
    ok = sum >= thresholds[s];
  }
  hits[(static_cast<size_t>(n) * ny + i) * nx + j] = ok;
}

}  // namespace

extern "C" {

// ii: (n, h, w) uint32 integral images; tables: the scale's int32 words (layout
// above); hits: (n, ny, nx) uint8, 1 where the window passes every stage.
int gs_lbp_eval_scale(const void* ii, const void* tables, void* hits, int n, int h, int w,
                      int ny, int nx, int step, int oy0, int ox0, int nweaks, int nstages,
                      void* stream) {
  const int smem = (nweaks * 15 + nstages * 3) * static_cast<int>(sizeof(int));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid((nx + kThreads - 1) / kThreads, ny, n);
  lbp_scale_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ii), static_cast<const int*>(tables),
      static_cast<uint8_t*>(hits), h, w, ny, nx, step, oy0, ox0, nweaks, nstages);
  return cudaGetLastError();
}

}  // extern "C"
