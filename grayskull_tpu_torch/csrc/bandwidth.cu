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
// to measure a byte-per-thread kernel.  Where both pointers are 16-byte
// aligned, K17 thread i moves the 16 bytes of vector i (uint4 loads and
// stores, neighbouring threads on neighbouring vectors) over a grid that
// covers every vector, with no loop, and only the last block moves the bytes
// past the last whole 16; otherwise a thread moves a byte.  K18 thread i
// moves the 16 bytes of vector i likewise, adding the four words with
// __vadd4 (a per-byte add that wraps as uint8 does), and also byte
// n_vec * 16 + i when that is below n: the bytes past the last whole 16, or
// all of them when a pointer is not 16-byte aligned.  The resident blocks
// keep the memory busy while the rest wait their turn; a grid-stride loop
// over one wave of blocks stayed below cudaMemcpyAsync.
//
// chip_sweep.py --source bandwidth swaps in K17 kernels with 1 to 8 vectors
// a thread in blocks of 128 to 1024 threads, streaming or no-allocate hints,
// 32-bit indices, a persistent grid of contiguous spans, and rings of bulk
// copies (cp.async.bulk through 2 to 4 shared-memory stages); and K18 kernels
// with 1 to 8 vectors of 4, 8 or 16 bytes a thread, streaming hints, and a
// bulk-copy ring.  On the H100 one 16-byte vector a thread in 256-thread
// blocks was the fastest K17, level with Tensor.copy_ (a device-to-device
// cudaMemcpyAsync) within the spread; every other K17 was slower,
// the rings by 5-9 %; no K18 reached torch.add.
//
// Each entry returns cudaGetLastError().

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// K17's aligned path.
constexpr int kCopyThreads = 256;

__global__ void __launch_bounds__(kCopyThreads)
    copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, size_t n,
                size_t n_vec) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kCopyThreads + threadIdx.x;
  if (i < n_vec) reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  if (blockIdx.x == gridDim.x - 1) {  // the tail: fewer than 16 bytes
    const size_t k = n_vec * 16 + threadIdx.x;
    if (k < n) dst[k] = src[k];
  }
}

// Blocks of K17's aligned path: at least one, which also moves the tail.
bool copy_blocks(size_t n_vec, unsigned* blocks) {
  const size_t want = std::max<size_t>((n_vec + kCopyThreads - 1) / kCopyThreads, 1);
  if (want > 0x7fffffffULL) return false;
  *blocks = static_cast<unsigned>(want);
  return true;
}

// K17's byte path, where a pointer is not 16-byte aligned: a thread a byte.
__global__ void copy_bytes_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                                  size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) dst[i] = src[i];
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
  const auto s = static_cast<const uint8_t*>(src);
  const auto d = static_cast<uint8_t*>(dst);
  const auto st = static_cast<cudaStream_t>(stream);
  unsigned blocks;
  if (aligned16(src) && aligned16(dst)) {
    const size_t n_vec = n / 16;
    if (!copy_blocks(n_vec, &blocks)) return cudaErrorInvalidConfiguration;
    copy_kernel<<<blocks, kCopyThreads, 0, st>>>(s, d, n, n_vec);
  } else {
    if (!blocks_for(n, 0, &blocks)) return cudaErrorInvalidConfiguration;
    copy_bytes_kernel<<<blocks, kThreads, 0, st>>>(s, d, n);
  }
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
