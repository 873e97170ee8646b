// K21 gs_fs_orient, gs_fs_atan2, gs_fs_sin: the reference's GS_NO_STDLIB trig
// (grayskull.h:70-88), elementwise in float32, for Hopper (sm_90a), bound to
// Python through a plain C interface (grayskull_tpu_torch/kernels/_build.py).
//
// Replaces the XLA polynomials grayskull_tpu/libm32.py:_freestanding_atan2
// (:110-123) and _freestanding_sin (:126-145), which the ORB path runs in the
// freestanding trig mode: atan2f on each keypoint's moments, then sinf of the
// angle and the reference's cosine, sinf(angle + 1.57079f).  Neither is a
// Pallas kernel.  JAX reduces the sine's range with two lax.while_loops on
// jnp.any(v > pi); in eager PyTorch each test of that condition would be a
// host wait, and the polynomials about 30 launches a call.
//
// gs_fs_orient is the ORB path's entry: K7's int32 moments in, each keypoint's
// angle, sine and cosine out, in one launch.  gs_fs_atan2 and gs_fs_sin serve
// libm32's atan2f, sinf and cosf_like_reference on any float tensor.
//
// What bounds it: at ORB's call (8,000 keypoints) the launch itself, far above
// the 160,000 bytes it moves; on a large input device memory.  An orientation
// element reads 8 bytes and writes 12; an atan2 element reads 8 and writes 4, a
// sine element 4 and 4.  Each is a few dozen FP32 instructions (the division's
// Newton steps included) and, in the sine, one add a step of its range
// reduction: ORB's angles lie in [-pi, pi + 1.58] and take at most one step.
//
// What the design does about it: one launch a call and no host wait.  The
// orientation converts the moments in the kernel (__int2float_rn rounds as
// the casts do, past 2^24 too) and keeps the angle in registers for its sine
// and cosine, where three launches and two casts wrote the angle out and read
// it back twice.  A thread an element: at the call's 8,000 elements a
// thread's chain of dependent operations is the time past the launch, and
// more elements a thread (2 or 4, with vector loads) lengthen it
// (chip_sweep.py --source freestanding).  Each thread runs C's two reduction
// loops on its own element.  Every float add, sub, mul and div is a _rn
// intrinsic, which the compiler never contracts into an FMA (and the library
// is built with -fmad=false as well), so each operation rounds on its own as
// C's and the plain version's do: the results are bit-identical to
// kernels/freestanding.py's plain versions.
//
// Where this differs from C and JAX: the range reduction never ends in C for
// +-inf, nor once x - 6.283185f rounds back to x (|x| >= 2^27), and its steps
// grow with |x|.  Here an element with !(|x| < 2^20) (NaN, +-inf, or past
// 2^20) gives NaN without a step; every |x| < 2^20 runs C's loops exactly.
// Every NaN result is the quiet NaN 0x7fc00000: the card's arithmetic gives
// 0x7fffffff and the CPU's keeps the operand's payload, so the NaN's payload
// is not the function's.  (No int32 moments give a NaN angle.)
//
// Each entry returns cudaGetLastError().

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kQuarterPi = 0.785398f;  // grayskull.h's constants, as C rounds them
constexpr float kHalfPi = 1.570796f;
constexpr float kPi = 3.141592f;
constexpr float kTwoPi = 6.283185f;
constexpr float kSin3 = 0.16666667f;
constexpr float kSin5 = 0.0083333310f;
constexpr float kLoopBound = 1048576.0f;  // 2^20: past it, NaN and no loop
constexpr float kCosOffset = 1.57079f;   // the reference's cosine: gs_sin(angle + 1.57079f)
constexpr int kOrientThreads = 128;  // gs_fs_orient's block

__device__ __forceinline__ float canonical(float v) {
  return v != v ? __int_as_float(0x7fc00000) : v;
}

// gs_atan2 (grayskull.h:71-79): the octant polynomial.  abs_y is y >= 0 ? y : -y,
// so -0.0 stays -0.0 as in C; x == 0 (either zero) takes the axis case.
__device__ __forceinline__ float fs_atan2(float y, float x) {
  const float c3 = __fmul_rn(3.0f, kQuarterPi);  // C folds 3*0.785398f in float
  const float abs_y = y >= 0.f ? y : -y;
  float angle;
  if (x >= 0.f) {
    const float r = __fdiv_rn(__fsub_rn(x, abs_y), __fadd_rn(x, abs_y));
    angle = __fsub_rn(kQuarterPi, __fmul_rn(kQuarterPi, r));
  } else {  // and NaN x, as JAX's select does
    const float r = __fdiv_rn(__fadd_rn(x, abs_y), __fsub_rn(abs_y, x));
    angle = __fsub_rn(c3, __fmul_rn(kQuarterPi, r));
  }
  if (y < 0.f) angle = -angle;
  if (x == 0.f) angle = y > 0.f ? kHalfPi : (y < 0.f ? -kHalfPi : 0.f);
  return canonical(angle);
}

// gs_sin (grayskull.h:81-88): C's range reduction, then the odd quintic.
__device__ __forceinline__ float fs_sin(float x) {
  if (!(fabsf(x) < kLoopBound)) return __int_as_float(0x7fc00000);
  while (x > kPi) x = __fsub_rn(x, kTwoPi);
  while (x < -kPi) x = __fadd_rn(x, kTwoPi);
  const bool neg = x < 0.f;
  if (neg) x = -x;
  if (x > kHalfPi) x = __fsub_rn(kPi, x);
  const float x2 = __fmul_rn(x, x);
  const float t = __fsub_rn(kSin3, __fmul_rn(kSin5, x2));
  const float res = __fmul_rn(x, __fsub_rn(1.0f, __fmul_rn(x2, t)));
  return canonical(neg ? -res : res);
}

__global__ void __launch_bounds__(kThreads)
    fs_atan2_kernel(const float* __restrict__ y, const float* __restrict__ x,
                    float* __restrict__ out, size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) out[i] = fs_atan2(y[i], x[i]);
}

// offset is rounded in first (the reference's cosine adds 1.57079f); -0.0f
// adds nothing, not even to -0.0.
__global__ void __launch_bounds__(kThreads)
    fs_sin_kernel(const float* __restrict__ x, float* __restrict__ out, size_t n, float offset) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) out[i] = fs_sin(__fadd_rn(x[i], offset));
}

// A thread an element: angle = gs_atan2 of the moments as float32, sin_out =
// gs_sin(angle), cos_out = gs_sin(angle + 1.57079f).
__global__ void __launch_bounds__(kOrientThreads)
    fs_orient_kernel(const int* __restrict__ m01, const int* __restrict__ m10,
                     float* __restrict__ angle, float* __restrict__ sin_out,
                     float* __restrict__ cos_out, size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kOrientThreads + threadIdx.x;
  if (i >= n) return;
  const float a = fs_atan2(__int2float_rn(m01[i]), __int2float_rn(m10[i]));
  angle[i] = a;
  sin_out[i] = fs_sin(a);
  cos_out[i] = fs_sin(__fadd_rn(a, kCosOffset));
}

bool blocks_for(size_t n, size_t per_block, unsigned* blocks) {
  const size_t want = (n + per_block - 1) / per_block;
  if (want < 1 || want > 0x7fffffffULL) return false;
  *blocks = static_cast<unsigned>(want);
  return true;
}

}  // namespace

extern "C" {

// m01, m10: n int32 each; angle, sin_out, cos_out: n float32 each (n >= 1).
// angle = gs_atan2((float)m01, (float)m10), sin_out = gs_sin(angle),
// cos_out = gs_sin(angle + 1.57079f), the add rounded to float32.
int gs_fs_orient(const void* m01, const void* m10, void* angle, void* sin_out, void* cos_out,
                 size_t n, void* stream) {
  unsigned blocks;
  if (!blocks_for(n, kOrientThreads, &blocks)) return cudaErrorInvalidConfiguration;
  fs_orient_kernel<<<blocks, kOrientThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(m01), static_cast<const int*>(m10), static_cast<float*>(angle),
      static_cast<float*>(sin_out), static_cast<float*>(cos_out), n);
  return cudaGetLastError();
}

// y, x, out: n float32 each (n >= 1).  out = gs_atan2(y, x).
int gs_fs_atan2(const void* y, const void* x, void* out, size_t n, void* stream) {
  unsigned blocks;
  if (!blocks_for(n, kThreads, &blocks)) return cudaErrorInvalidConfiguration;
  fs_atan2_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(x), static_cast<float*>(out), n);
  return cudaGetLastError();
}

// x, out: n float32 each (n >= 1).  out = gs_sin(x + offset), the add rounded to float32.
int gs_fs_sin(const void* x, void* out, size_t n, float offset, void* stream) {
  unsigned blocks;
  if (!blocks_for(n, kThreads, &blocks)) return cudaErrorInvalidConfiguration;
  fs_sin_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, offset);
  return cudaGetLastError();
}

}  // extern "C"
