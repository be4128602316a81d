// Shared device helpers of the port's kernels.
//
// Built with --fmad=false and IEEE division and square root (see
// ops/kernels/build.py), so each expression below rounds exactly like the
// same sequence of f32 operations in PyTorch: these are the formulas of the
// JAX package's ops/pallas/util.py and ops/extrema.py, in their op order.
// Constants are hex literals of the f32 values the Python side uses
// (np.float32 of the same decimals), so no literal rounds differently.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define SIFT_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float round_half_away(float x) {
  // Rust f32::round: floor(x + 0.5), fixed where x + 0.5 is integral and x < 0
  float xp = x + 0.5f;
  float r = floorf(xp);
  return (xp == r && x < 0.0f) ? r - 1.0f : r;
}

__device__ __forceinline__ float rust_round(float x) {
  // half away from zero (ops/extrema.py:rust_round)
  float t = truncf(x);
  float frac = x - t;
  if (fabsf(frac) == 0.5f) return t + (x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f));
  return rintf(x);  // half to even elsewhere, as torch.round
}

__device__ __forceinline__ float atan_f32(float x) {
  // Cephes atanf: |x| reduced to [0, tan(pi/8)], degree-7 odd polynomial
  const float TAN_PI_8 = 0x1.a8279ap-2f;
  const float TAN_3PI_8 = 0x1.3504f4p+1f;
  float ax = fabsf(x);
  bool big = ax > TAN_3PI_8;
  bool mid = (ax > TAN_PI_8) && !big;
  float x1 = big ? -1.0f / fmaxf(ax, 0x1.4484cp-100f)
                 : (mid ? (ax - 1.0f) / (ax + 1.0f) : ax);
  float z = x1 * x1;
  float p = (((0x1.49e1a2p-4f * z - 0x1.1c370ap-3f) * z + 0x1.9924bep-3f) * z
             - 0x1.555454p-2f) * z * x1 + x1;
  float r = big ? 0x1.921fb6p+0f + p : (mid ? 0x1.921fb6p-1f + p : p);
  return x < 0.0f ? -r : r;
}

__device__ __forceinline__ float atan2_f32(float y, float x) {
  // standard quadrant rules, atan2(0, -a) = +pi
  if (x == 0.0f) return y > 0.0f ? 0x1.921fb6p+0f : (y < 0.0f ? -0x1.921fb6p+0f : 0.0f);
  float a = atan_f32(y / x);
  if (x > 0.0f) return a;
  return y >= 0.0f ? a + 0x1.921fb6p+1f : a - 0x1.921fb6p+1f;
}

// exp rounded once to f32 through f64: the plain versions compute the same
// (torch.exp on float64, cast to float32).
__device__ __forceinline__ float exp_f32_via_f64(float x) {
  return (float)exp((double)x);
}
