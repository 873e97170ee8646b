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
// minimum is 1 B read and 4 B written per pixel; the union-find walks are
// chains of dependent 4-B loads, mostly served from L2.
//
// What the design does about it: union-find in global memory, with no sweep
// loop, no convergence flag and no host sync -- three launches on one stream:
//   1. init: label[p] = p for foreground, -1 for background;
//   2. merge: each foreground pixel unites with its foreground left and up
//      neighbours.  Finds walk the parent links with volatile loads (a root
//      cached in a register goes stale) and shorten the path as they go by
//      pointer jumping; the larger root is hooked under the smaller with an
//      atomicCAS that only succeeds while it is still a root, and a failed
//      hook retries from the value it found (Jaiganesh & Burtscher, ECL-CC,
//      HPDC 2018; the same global union-find as Playne & Hawick, IEEE TPDS
//      2018).
//   3. flatten: each foreground pixel takes its root.
// A link only ever points to a smaller index (parent[p] <= p), so a root is
// the minimum of its tree and the result does not depend on the order in
// which the atomics land.  The parent array is the output buffer itself; the
// grid is flat over N*H*W, so any batch and frame size launches (a frame must
// have fewer than 2^31 pixels; the wrapper checks).
//
// Each entry returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void init_kernel(const uint8_t* __restrict__ src, int* __restrict__ label,
                            long long total, long long hw) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  label[i] = src[i] >= 128 ? static_cast<int>(i % hw) : -1;
}

// The root of p, halving the path on the way (each visited link is pointed at
// its grandparent, which is still an ancestor whatever else runs meanwhile).
__device__ int find_root(volatile int* parent, int p) {
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

__device__ void unite(int* parent, int a, int b) {
  volatile int* vp = parent;
  int ra = find_root(vp, a);
  int rb = find_root(vp, b);
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

__global__ void merge_kernel(const uint8_t* __restrict__ src, int* label, long long total,
                             long long hw, int w) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total || src[i] < 128) return;
  const int p = static_cast<int>(i % hw);
  int* parent = label + (i - p);  // this frame's labels, indexed by raster index
  if (p % w != 0 && src[i - 1] >= 128) unite(parent, p, p - 1);
  if (p >= w && src[i - w] >= 128) unite(parent, p, p - w);
}

__global__ void flatten_kernel(int* label, long long total, long long hw) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  volatile int* vl = label;
  const int v = vl[i];
  if (v < 0) return;
  const int p = static_cast<int>(i % hw);
  volatile int* parent = label + (i - p);
  int r = v;
  for (int up = parent[r]; up != r; up = parent[r]) r = up;
  vl[i] = r;
}

}  // namespace

extern "C" {

// src: (n, h, w) uint8; label: (n, h, w) int32.  Requires n, h, w >= 1 and
// h * w < 2^31.
int gs_ccl(const void* src, void* label, int n, int h, int w, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long hw = static_cast<long long>(h) * w;
  const long long total = hw * n;
  if (hw >= (1LL << 31)) return cudaErrorInvalidValue;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const uint8_t* s = static_cast<const uint8_t*>(src);
  int* l = static_cast<int*>(label);
  const unsigned grid = static_cast<unsigned>(blocks);
  init_kernel<<<grid, kThreads, 0, st>>>(s, l, total, hw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<<<grid, kThreads, 0, st>>>(s, l, total, hw, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flatten_kernel<<<grid, kThreads, 0, st>>>(l, total, hw);
  return cudaGetLastError();
}

}  // extern "C"
