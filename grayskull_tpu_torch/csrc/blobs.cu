// K22 gs_blob_stats: the per-label statistics of a batch of label maps (area,
// coordinate sums, bounding box), for Hopper (sm_90a), bound to Python through
// a plain C interface (grayskull_tpu_torch/kernels/_build.py).
//
// Replaces the statistics of grayskull_tpu/ops/blobs.py:112 _aggregate_stats,
// which the JAX package computes with jax.ops.segment_* on the CPU and a one-hot
// MXU contraction on the TPU (no Pallas kernel).  The port's first version ran
// seven PyTorch scatters over int64 keys, each label's updates spread over up to
// 256 slots so that the page blob's atomics would not serialise: some 42 device
// ops and 8 bytes of key a pixel for each of four int64 operands.
//
// Input: an (n, npix) int32 label map of frames w pixels wide, labels 0 ..
// nseg - 1, rows counted from row0.  Output: seven (n, nseg) int64 arrays, one
// after another: area, sum_x, sum_y, min_x, min_y, max_x, max_y.  Label 0
// (background and dropped pixels) is left out: its area and sums are 0, and
// the extremes of a label with no pixel are 2^62 (minima) and -1 (maxima).
// The sums are exact; every result is an integer reduction, so the order in
// which the atomics land does not change it.  Labels outside 0 .. nseg - 1 are
// skipped (the caller never makes them).
//
// What bounds it: device memory.  The work is one read of the label map, 4 bytes
// a pixel (the outputs are n * nseg * 56 bytes); on the scanner's pages 96 % of
// the pixels are background and a few hundred labels share the rest, the page
// blob the most.
//
// What the design does about it: two launches, no host wait.
//   1. init: the seven outputs set to 0, 2^62 and -1 in one pass.
//   2. stats: a block owns a band of one frame's pixels (a multiple of
//      kStep, sized so that the batch makes about kBlocksPerSm blocks an SM)
//      and a table of all nseg labels in shared memory, 36 bytes a label (64-bit
//      sums, 32-bit count and extremes).  A thread loads 4 labels with one
//      16-byte load (scalar loads where the frame is not a multiple of 4 pixels
//      or the map not 16-byte aligned), kUnroll quads in flight.  A quad of
//      background costs the load and a ballot.  A quad of one label in one row
//      joins the warp's other such quads of the same (label, row) through
//      __match_any_sync; the group's lowest lane adds them to the table at once,
//      its sums from the group's lane mask (the quads' columns follow the
//      lanes), so a warp over 128 pixels of one blob makes one update a field.
//      Any other quad adds its runs of one label in one row one by one.  After
//      the band, the block adds each label it saw to the outputs with global
//      64-bit atomics (add, min, max).
// Where nseg labels do not fit a block's shared memory (36 * nseg > 227 KB), the
// same kernel adds each group and run straight to the outputs with global
// atomics; the wrapper chooses the path from nseg and counts it under its own
// key.
//
// Each entry returns cudaGetLastError().

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kQuad = 4;    // labels a thread loads at once: one 16-byte load
constexpr int kUnroll = 2;  // quads a thread has in flight
constexpr long long kStep = static_cast<long long>(kThreads) * kQuad * kUnroll;
constexpr long long kMinSteps = 2;  // a band's least length, in steps
constexpr int kBlocksPerSm = 8;     // the batch's blocks, an SM: about two waves
constexpr int kInitBlocksPerSm = 4;
constexpr int kTableBytesPerLabel = 36;  // two 64-bit sums, five 32-bit fields
constexpr int kMaxTableBytes = 232448;   // 227 KB: a block's most on Hopper
constexpr int kDefaultSmem = 48 * 1024;
constexpr long long kEmptyMin = 1LL << 62;
constexpr unsigned kFullMask = 0xffffffffu;

// The block's table of every label, in dynamic shared memory.
struct Table {
  unsigned long long* sum_x;
  unsigned long long* sum_y;
  unsigned* area;
  int* min_x;
  int* min_y;
  int* max_x;
  int* max_y;

  __device__ Table(unsigned char* smem, int nseg) {
    sum_x = reinterpret_cast<unsigned long long*>(smem);
    sum_y = sum_x + nseg;
    area = reinterpret_cast<unsigned*>(sum_y + nseg);
    min_x = reinterpret_cast<int*>(area + nseg);
    min_y = min_x + nseg;
    max_x = min_y + nseg;
    max_y = max_x + nseg;
  }
};

// One frame's row of each of the seven outputs.
struct Out {
  unsigned long long* area;
  unsigned long long* sum_x;
  unsigned long long* sum_y;
  long long* min_x;
  long long* min_y;
  long long* max_x;
  long long* max_y;

  __device__ Out(long long* out, size_t field, size_t at) {
    area = reinterpret_cast<unsigned long long*>(out + at);
    sum_x = reinterpret_cast<unsigned long long*>(out + field + at);
    sum_y = reinterpret_cast<unsigned long long*>(out + 2 * field + at);
    min_x = out + 3 * field + at;
    min_y = out + 4 * field + at;
    max_x = out + 5 * field + at;
    max_y = out + 6 * field + at;
  }
};

// Adds `count` pixels of label l, all in row y (row0 added), columns x_lo ..
// x_hi, whose columns sum to sum_x.
template <bool kShared>
__device__ void add(const Table& t, const Out& o, int l, unsigned count, unsigned long long sum_x,
                    int x_lo, int x_hi, int y) {
  const unsigned long long sum_y = static_cast<unsigned long long>(count) * y;
  if (kShared) {
    atomicAdd(t.area + l, count);
    atomicAdd(t.sum_x + l, sum_x);
    atomicAdd(t.sum_y + l, sum_y);
    atomicMin(t.min_x + l, x_lo);
    atomicMin(t.min_y + l, y);
    atomicMax(t.max_x + l, x_hi);
    atomicMax(t.max_y + l, y);
  } else {
    atomicAdd(o.area + l, static_cast<unsigned long long>(count));
    atomicAdd(o.sum_x + l, sum_x);
    atomicAdd(o.sum_y + l, sum_y);
    atomicMin(o.min_x + l, static_cast<long long>(x_lo));
    atomicMin(o.min_y + l, static_cast<long long>(y));
    atomicMax(o.max_x + l, static_cast<long long>(x_hi));
    atomicMax(o.max_y + l, static_cast<long long>(y));
  }
}

// A run of c pixels of label l in row y from column x; label 0 and labels out
// of range add nothing.
template <bool kShared>
__device__ void run(const Table& t, const Out& o, int l, int x, int y, int c, int nseg) {
  if (l <= 0 || l >= nseg) return;
  const unsigned long long sum_x =
      static_cast<unsigned long long>(c) * x + static_cast<unsigned long long>(c) * (c - 1) / 2;
  add<kShared>(t, o, l, c, sum_x, x, x + c - 1, y);
}

// The labels of pixels i .. i + 3 of a frame, 0 past `end` (a multiple of 4
// when vec).
__device__ int4 load_quad(const int* __restrict__ frame, long long i, long long end, bool vec) {
  if (vec) return i < end ? __ldg(reinterpret_cast<const int4*>(frame + i)) : make_int4(0, 0, 0, 0);
  int4 v;
  v.x = i < end ? __ldg(frame + i) : 0;
  v.y = i + 1 < end ? __ldg(frame + i + 1) : 0;
  v.z = i + 2 < end ? __ldg(frame + i + 2) : 0;
  v.w = i + 3 < end ? __ldg(frame + i + 3) : 0;
  return v;
}

// The quad of labels v at frame pixel i, in warp-uniform control flow: lane
// j's quad starts at pixel i + 4 * (j - lane).
template <bool kShared>
__device__ void quad(const Table& t, const Out& o, int4 v, long long i, int w, int row0, int nseg,
                     int lane) {
  const bool any = (v.x | v.y | v.z | v.w) != 0;
  int x = 0, y = 0;
  if (any) {  // i is then inside the frame: below 2^31
    const int p = static_cast<int>(i);
    y = p / w;
    x = p - y * w;
    y += row0;
  }
  const bool uniform = any && v.x == v.y && v.y == v.z && v.z == v.w && x + 3 < w &&
                       static_cast<unsigned>(v.x) < static_cast<unsigned>(nseg);
  const unsigned group = __ballot_sync(kFullMask, uniform);
  if (uniform) {
    const unsigned long long key = static_cast<unsigned long long>(static_cast<unsigned>(y)) << 32 |
                                   static_cast<unsigned>(v.x);
    const unsigned same = __match_any_sync(group, key);
    if (lane == __ffs(same) - 1) {
      const int k = __popc(same);
      const int hi = 31 - __clz(same);
      // the sum of the group's lane numbers, bit by bit of the lane number
      const long long lanes = __popc(same & 0xaaaaaaaau) + 2 * __popc(same & 0xccccccccu) +
                              4 * __popc(same & 0xf0f0f0f0u) + 8 * __popc(same & 0xff00ff00u) +
                              16 * __popc(same & 0xffff0000u);
      // lane j's quad covers columns x + 4 (j - lane) .. + 3
      const long long first_cols = static_cast<long long>(k) * (x - 4 * lane) + 4 * lanes;
      add<kShared>(t, o, v.x, 4u * k, static_cast<unsigned long long>(4 * first_cols + 6 * k), x,
                   x + 4 * (hi - lane) + 3, y);
    }
  } else if (any) {  // runs of one label in one row, pixel by pixel
    const int a[kQuad] = {v.x, v.y, v.z, v.w};
    int rx = x, ry = y, l = a[0], c = 1;
#pragma unroll
    for (int j = 1; j < kQuad; ++j) {
      if (++x == w) x = 0, ++y;
      if (a[j] == l && x != 0) {
        ++c;
        continue;
      }
      run<kShared>(t, o, l, rx, ry, c, nseg);
      rx = x, ry = y, l = a[j], c = 1;
    }
    run<kShared>(t, o, l, rx, ry, c, nseg);
  }
}

// Grid: n * bands blocks, block b of frame b / bands owns pixels
// [(b % bands) * band, + band) of it.  Dynamic shared memory: the table, when
// kShared.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    blob_stats_kernel(const int* __restrict__ seg, long long* __restrict__ out, int n, int npix,
                      int w, int row0, int nseg, long long band, int bands, bool vec) {
  extern __shared__ __align__(16) unsigned char blob_table[];
  const int f = blockIdx.x / bands;
  const long long start = (blockIdx.x - static_cast<long long>(f) * bands) * band;
  const long long end = start + band < npix ? start + band : npix;
  const Out o(out, static_cast<size_t>(n) * nseg, static_cast<size_t>(f) * nseg);
  const Table t(blob_table, nseg);
  if (kShared) {
    for (int l = threadIdx.x; l < nseg; l += kThreads) {
      t.sum_x[l] = t.sum_y[l] = 0;
      t.area[l] = 0;
      t.min_x[l] = t.min_y[l] = INT_MAX;
      t.max_x[l] = t.max_y[l] = -1;
    }
    __syncthreads();
  }
  const int* frame = seg + static_cast<size_t>(f) * npix;
  const int lane = threadIdx.x & 31;
  for (long long base = start; base < end; base += kStep) {
    int4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      q[u] = load_quad(frame, base + static_cast<long long>(u * kThreads + threadIdx.x) * kQuad,
                       end, vec);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      quad<kShared>(t, o, q[u], base + static_cast<long long>(u * kThreads + threadIdx.x) * kQuad,
                    w, row0, nseg, lane);
  }
  if (kShared) {
    __syncthreads();
    for (int l = 1 + threadIdx.x; l < nseg; l += kThreads) {
      const unsigned c = t.area[l];
      if (c == 0) continue;
      atomicAdd(o.area + l, static_cast<unsigned long long>(c));
      atomicAdd(o.sum_x + l, t.sum_x[l]);
      atomicAdd(o.sum_y + l, t.sum_y[l]);
      atomicMin(o.min_x + l, static_cast<long long>(t.min_x[l]));
      atomicMin(o.min_y + l, static_cast<long long>(t.min_y[l]));
      atomicMax(o.max_x + l, static_cast<long long>(t.max_x[l]));
      atomicMax(o.max_y + l, static_cast<long long>(t.max_y[l]));
    }
  }
}

// The seven outputs of `field` elements each: 0 (area and sums), 2^62
// (minima), -1 (maxima).
__global__ void __launch_bounds__(kThreads) blob_stats_init_kernel(long long* out, size_t field) {
  const size_t total = 7 * field;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * kThreads)
    out[i] = i < 3 * field ? 0 : i < 5 * field ? kEmptyMin : -1;
}

}  // namespace

extern "C" {

// seg: (n, npix) int32 label maps of frames w wide, rows counted from row0;
// out: (7, n, nseg) int64 (area, sum_x, sum_y, min_x, min_y, max_x, max_y).
// shared_table != 0 keeps each block's table in shared memory (36 * nseg bytes,
// at most 227 KB).  Requires n, w, nseg >= 1, npix >= 0, row0 >= 0, and
// row0 + npix / w < 2^31.
int gs_blob_stats(const void* seg, void* out, int n, int npix, int w, int row0, int nseg,
                  int shared_table, void* stream) {
  if (n < 1 || npix < 0 || w < 1 || nseg < 1 || row0 < 0 ||
      row0 + static_cast<long long>(npix) / w >= (1LL << 31))
    return cudaErrorInvalidValue;
  const size_t smem = shared_table ? static_cast<size_t>(kTableBytesPerLabel) * nseg : 0;
  if (smem > static_cast<size_t>(kMaxTableBytes)) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const auto st = static_cast<cudaStream_t>(stream);
  long long* o = static_cast<long long*>(out);
  const size_t field = static_cast<size_t>(n) * nseg;
  const size_t init_want = (7 * field + kThreads - 1) / kThreads;
  const size_t init_most = static_cast<size_t>(sms) * kInitBlocksPerSm;
  blob_stats_init_kernel<<<static_cast<unsigned>(init_want < init_most ? init_want : init_most),
                           kThreads, 0, st>>>(o, field);
  err = cudaGetLastError();
  if (err != cudaSuccess || npix == 0) return err;
  // a band of whole steps, about kBlocksPerSm blocks an SM over the batch
  const long long target = static_cast<long long>(sms) * kBlocksPerSm;
  long long band = (static_cast<long long>(n) * npix + target - 1) / target;
  if (band < kMinSteps * kStep) band = kMinSteps * kStep;
  band = (band + kStep - 1) / kStep * kStep;
  const long long bands = (npix + band - 1) / band;
  if (bands * n > INT_MAX) return cudaErrorInvalidConfiguration;
  const unsigned blocks = static_cast<unsigned>(bands * n);
  const int* s = static_cast<const int*>(seg);
  const bool vec = npix % kQuad == 0 && reinterpret_cast<uintptr_t>(seg) % 16 == 0;
  if (shared_table) {
    if (smem > static_cast<size_t>(kDefaultSmem)) {
      err = cudaFuncSetAttribute(blob_stats_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    blob_stats_kernel<true><<<blocks, kThreads, smem, st>>>(s, o, n, npix, w, row0, nseg, band,
                                                            static_cast<int>(bands), vec);
  } else {
    blob_stats_kernel<false><<<blocks, kThreads, 0, st>>>(s, o, n, npix, w, row0, nseg, band,
                                                          static_cast<int>(bands), vec);
  }
  return cudaGetLastError();
}

}  // extern "C"
