// The device-memory bandwidth probe, written for Hopper (sm_90a) and bound to
// Python through a plain C interface (grayskull_tpu_torch/kernels/_build.py).
//
// K17 gs_copy replaces the copy pallas_call of hbm_bandwidth_gbps
//    (grayskull_tpu/profiling.py:56): out = x, uint8, any size.
// K18 gs_triad replaces the triad pallas_call (:61): out = (x + y) mod 256,
//    the TPU's int32 add truncated to uint8.
//
// What bounds them: nothing but device memory.  K17 moves 2 bytes a byte, K18
// 3, and neither does more than one add a byte.
//
// What the design does about it: the point of a probe is to read memory, not
// to measure a byte-per-thread kernel.  Thread i moves the 16 bytes of vector
// i (uint4 loads and stores, neighbouring threads on neighbouring vectors)
// over a grid that covers every vector, with no loop: every access is a full
// 16-byte one, and the resident blocks keep the memory busy while the rest
// wait their turn.  A grid-stride loop over one wave of blocks, tried first,
// stayed below cudaMemcpyAsync.  K18
// adds the four words of a uint4 with __vadd4, a per-byte add that wraps as
// uint8 does.  chip_sweep.py --source bandwidth swaps in K18 kernels that
// move 1 to 8 vectors of 4, 8 or 16 bytes a thread, with or without
// streaming loads and stores, and a ring of bulk copies (cp.async.bulk): on
// the H100 none separated from this one beyond the spread, and none reached
// torch.add.  Thread i also moves byte n_vec * 16 + i when that is below n:
// the bytes past the last whole 16, or all of them when a pointer is not
// 16-byte aligned.
//
// Each entry returns cudaGetLastError().

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, size_t n,
                            size_t n_vec) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n_vec) reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  const size_t j = n_vec * 16 + i;
  if (j < n) dst[j] = src[j];
}

__global__ void triad_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                             uint8_t* __restrict__ out, size_t n, size_t n_vec) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n_vec) {
    const uint4 x = reinterpret_cast<const uint4*>(a)[i];
    const uint4 y = reinterpret_cast<const uint4*>(b)[i];
    reinterpret_cast<uint4*>(out)[i] = make_uint4(__vadd4(x.x, y.x), __vadd4(x.y, y.y),
                                                  __vadd4(x.z, y.z), __vadd4(x.w, y.w));
  }
  const size_t j = n_vec * 16 + i;
  if (j < n) out[j] = static_cast<uint8_t>(a[j] + b[j]);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Blocks for a thread per vector, or per tail byte where those are more.
bool blocks_for(size_t n, size_t n_vec, unsigned* blocks) {
  const size_t work = std::max(n_vec, n - n_vec * 16);
  const size_t want = (work + kThreads - 1) / kThreads;
  if (want > 0x7fffffffULL) return false;
  *blocks = static_cast<unsigned>(want);
  return true;
}

}  // namespace

extern "C" {

// src, dst: n bytes each (n >= 1).
int gs_copy(const void* src, void* dst, size_t n, void* stream) {
  const size_t n_vec = aligned16(src) && aligned16(dst) ? n / 16 : 0;
  unsigned blocks;
  if (!blocks_for(n, n_vec, &blocks)) return cudaErrorInvalidConfiguration;
  copy_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), n, n_vec);
  return cudaGetLastError();
}

// a, b, out: n bytes each (n >= 1).
int gs_triad(const void* a, const void* b, void* out, size_t n, void* stream) {
  const size_t n_vec = aligned16(a) && aligned16(b) && aligned16(out) ? n / 16 : 0;
  unsigned blocks;
  if (!blocks_for(n, n_vec, &blocks)) return cudaErrorInvalidConfiguration;
  triad_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b), static_cast<uint8_t*>(out),
      n, n_vec);
  return cudaGetLastError();
}

}  // extern "C"
