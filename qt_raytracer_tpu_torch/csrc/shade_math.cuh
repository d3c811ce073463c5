// Device helpers of the shading kernels (fused_shade.cu, diff_bounce.cu):
// single-rounded float arithmetic in PyTorch's association order, its
// NaN-propagating clamps, the scalar constants as PyTorch rounds them, and
// the bounce's hash uniforms.
//
// Each PyTorch op is one kernel that rounds once, so every add and multiply
// here is rounded on its own (__fadd_rn and friends stop nvcc from
// contracting them into FMAs); divides and square roots are IEEE-rounded
// (no --use_fast_math), reciprocal(sqrt(x)) is two rounded operations.
// torch.clamp*, torch.maximum propagate NaN where fminf/fmaxf do not, so
// those are written out. Every scalar constant is the float PyTorch rounds
// the Python double to.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float BIG = 3.0e38f;
constexpr unsigned GOLDEN = 0x9E3779B9u;
constexpr unsigned WEYL2 = 0x85EBCA77u;
// The Python constants of integrator_flat as PyTorch takes them: the
// double, rounded to float.
constexpr float TWO_PI = static_cast<float>(6.283185307179586);
constexpr float INV_PI = static_cast<float>(0.3183098861837907);
constexpr float THIRD = static_cast<float>(1.0 / 3.0);
constexpr float EPS_LEN2 = static_cast<float>(1.0e-20);
constexpr float EPS_DEGEN = static_cast<float>(1.0e-8);
constexpr float P_MIN = static_cast<float>(0.05);
constexpr float SKY_G = static_cast<float>(0.7);
constexpr float TWO_M24 = 5.9604644775390625e-08f;  // 2^-24
// scene.LAMBERTIAN, METAL, DIELECTRIC, EMISSIVE.
constexpr int LAMBERTIAN = 0, METAL = 1, DIELECTRIC = 2, EMISSIVE = 3;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// (ax*bx + ay*by) + az*bz, as the tensor ops round it.
__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

// torch.clamp_min / clamp_max / clamp with scalar bounds: NaN passes.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
// torch.maximum: the first NaN operand wins.
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// vecmath.safe_sqrt: where(x > 0, sqrt(where(x > 0, x, 1)), 0).
__device__ __forceinline__ float safe_sqrt(float x) {
  return x > 0.f ? __fsqrt_rn(x) : 0.f;
}

// The inv_len of integrator_flat._safe_rsqrt_len2: 1 / sqrt(|v|^2), two
// roundings, or 0 where |v|^2 <= 1e-20 (NaN included).
__device__ __forceinline__ float inv_len(float x, float y, float z) {
  const float n2 = dot3(x, y, z, x, y, z);
  return n2 > EPS_LEN2 ? __fdiv_rn(1.f, __fsqrt_rn(n2)) : 0.f;
}

// Wellons' lowbias32 (sampling._lowbias32) in uint32.
__device__ __forceinline__ unsigned lowbias32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// Uniform `slot` of the stream whose offset is stream_word (stream id times
// GOLDEN, mod 2^32) for a hash state: sampling.stream_uniforms' value. The
// uint32 wrap-around is the masked int64 form's bit for bit.
__device__ __forceinline__ float uniform(unsigned key, unsigned stream_word,
                                         unsigned slot) {
  const unsigned bits =
      lowbias32(lowbias32(key + (stream_word + slot * WEYL2)) + GOLDEN);
  return mul(__uint2float_rn(bits >> 8), TWO_M24);
}

}  // namespace
