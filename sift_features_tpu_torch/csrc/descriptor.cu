// K6: 4x4x8 SIFT descriptor histograms over a rotated window.
//
// Replaces the TPU kernel sift_features_tpu/ops/pallas/descriptor_packed.py:
// descriptor_hist_packed_masked (_kernel), which the JAX extractor dispatches
// per scale bucket. Per live keypoint it computes the raw 128-bin
// histogram of compute_descriptor (lib.rs:785-948) with the per-sample f32
// math of that kernel: radius round_half_away(lambda_descr * scale * sqrt2 *
// (n_hist + 1) * 0.5), the window rotated by 360 - angle degrees and scaled
// by 1 / hist_width, samples kept inside the radius, the rotated 4x4 grid
// (+-0.5 bin) and the image interior (0, h-1) x (0, w-1), Gaussian weight
// exp(-2 / n_hist^2 * |rot|^2), magnitude sqrt(gx^2 + gy^2), orientation
// atan2_f32 in degrees, and the trilinear split into (row, col, orientation)
// bins with circular orientation wrap. Each of the 8 corner contributions is
// (u_row * u_col) * (m * u_ori), the product order of the TPU kernel.
// sin, cos and exp are rounded once to f32 from f64, as the plain version
// does (ops/kernels/descriptor.py).
//
// Deterministic: thread r accumulates window row r over columns in ascending
// order into its own shared-memory row (no two threads share a row), then
// thread b sums bin b over rows in ascending order. No atomics.
//
// The window bound is asserted in the kernel: a live keypoint whose radius
// exceeds r_max traps (device-side assert) instead of being cut silently.
//
// Bound on the H100: operations of the per-sample math, not bytes. Each live
// keypoint reads at most (2 r + 3)^2 <= 81^2 floats, mostly from L2, and
// writes 128; each in-window sample costs one atan2, one f64 exp and ~60
// f32 operations. One block of 128 threads per keypoint lane, dead lanes
// exiting at once, keeps the design simple. The row-per-thread split leaves
// threads idle for small radii; a later version can give several threads to
// a row and merge their partial rows in a fixed order.
#include "common.cuh"

#include <assert.h>

#define DESC_THREADS 128
#define MAX_D 128

__device__ __forceinline__ float py_mod(float a, float b) {
  // Python / jnp.mod / torch.remainder semantics for floats
  float r = fmodf(a, b);
  if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r += b;
  return r;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct DescParams {
  int n_hist, n_bins;
  float lambda_descr, sqrt2, deg2rad, rad2deg, bin_step, wscale;
};

__global__ void __launch_bounds__(DESC_THREADS) descriptor_kernel(
    const float* __restrict__ gauss, int Hp, int Wp, const int* __restrict__ plane,
    const int* __restrict__ ys, const int* __restrict__ xs,
    const float* __restrict__ scales, const float* __restrict__ angles,
    const int* __restrict__ live, float* __restrict__ hist, int h, int w, int pad,
    int r_max, DescParams prm) {
  extern __shared__ float rows[];  // (2 r_max + 1) rows of stride D + 1
  const int n_hist = prm.n_hist, n_bins = prm.n_bins;
  const int D = n_hist * n_hist * n_bins;
  const int stride = D + 1;
  int k = blockIdx.x;
  int t = threadIdx.x;
  float* hrow = hist + (long long)k * D;
  if (!live[k]) {
    for (int b = t; b < D; b += blockDim.x) hrow[b] = 0.0f;
    return;
  }
  float scale = scales[k];
  float orientation = 360.0f - angles[k];
  float hw = prm.lambda_descr * scale;
  float radius = round_half_away(hw * prm.sqrt2 * (float)(n_hist + 1) * 0.5f);
  assert(radius >= 0.0f && radius <= (float)r_max);
  float ori_rad = orientation * prm.deg2rad;
  float sin_s = (float)sin((double)ori_rad) / hw;
  float cos_s = (float)cos((double)ori_rad) / hw;
  int ri = (int)radius;
  int n = 2 * ri + 1;
  for (int i = t; i < n * stride; i += blockDim.x) rows[i] = 0.0f;
  __syncthreads();
  int y = ys[k], x = xs[k];
  if (t < n) {
    int dy = t - ri;
    int yy = y + dy;
    if (yy > 0 && yy < h - 1) {
      const float* g = gauss + (long long)plane[k] * Hp * Wp + (long long)(yy + pad) * Wp + pad;
      float* acc = rows + t * stride;
      const float dyf = (float)dy;
      const float half = (float)n_hist * 0.5f;
      const float hi_bin = (float)n_hist + 0.5f;
      for (int dx = -ri; dx <= ri; ++dx) {
        int xx = x + dx;
        if (xx <= 0 || xx >= w - 1) continue;
        float dxf = (float)dx;
        float col_rot = dxf * cos_s - dyf * sin_s;
        float row_rot = dxf * sin_s + dyf * cos_s;
        float row_bin = row_rot + half;
        float col_bin = col_rot + half;
        if (!(row_bin > -0.5f && row_bin < hi_bin && col_bin > -0.5f && col_bin < hi_bin))
          continue;
        float w2 = col_rot * col_rot + row_rot * row_rot;
        float weight = exp_f32_via_f64(w2 * prm.wscale);
        float gx = g[xx + 1] - g[xx - 1];
        float gy = g[xx - Wp] - g[xx + Wp];
        float mag = sqrtf(gx * gx + gy * gy);
        float deg = atan2_f32(gy, gx) * prm.rad2deg;
        float ori_norm = py_mod(deg + 360.0f, 360.0f) - orientation;
        float rb = row_bin - 0.5f;
        float cb = col_bin - 0.5f;
        float m = mag * weight;
        float obin = ori_norm * prm.bin_step;
        float rfl = floorf(rb), cfl = floorf(cb), ofl = floorf(obin);
        float rfr = rb - rfl, cfr = cb - cfl, ofr = obin - ofl;
        int r1 = clampi((int)rfl + 1, 0, n_hist);
        int c1 = clampi((int)cfl + 1, 0, n_hist);
        int of = (int)ofl;
        if (of < 0) of += n_bins;
        if (of >= n_bins) of -= n_bins;
        of = clampi(of, 0, n_bins - 1);
        int of1 = of + 1 >= n_bins ? 0 : of + 1;
        float ur[2] = {1.0f - rfr, rfr};
        float uc[2] = {1.0f - cfr, cfr};
        float uo0 = m * (1.0f - ofr);
        float uo1 = m * ofr;
        for (int dr = 0; dr < 2; ++dr) {
          int rr = r1 + dr;
          if (rr < 1 || rr > n_hist) continue;
          for (int dc = 0; dc < 2; ++dc) {
            int cc = c1 + dc;
            if (cc < 1 || cc > n_hist) continue;
            float wrc = ur[dr] * uc[dc];
            int base = ((rr - 1) * n_hist + (cc - 1)) * n_bins;
            acc[base + of] += wrc * uo0;
            acc[base + of1] += wrc * uo1;
          }
        }
      }
    }
  }
  __syncthreads();
  for (int b = t; b < D; b += blockDim.x) {
    float s = 0.0f;
    for (int r = 0; r < n; ++r) s = s + rows[r * stride + b];
    hrow[b] = s;
  }
}

// gauss (n_planes, Hp, Wp) f32; plane/y/x/live (M,) int32 ((y, x) unpadded
// octave coordinates, the rounded keypoint position); scale/angle (M,) f32
// -> hist (M, n_hist^2 n_bins) raw f32, zero on dead lanes.
SIFT_EXPORT int sift_descriptor(const float* gauss, int Hp, int Wp, const int* plane,
                                const int* y, const int* x, const float* scale,
                                const float* angle, const int* live, float* hist,
                                int M, int h, int w, int pad, int r_max, int n_hist,
                                int n_bins, float lambda_descr, float sqrt2,
                                float deg2rad, float rad2deg, float bin_step,
                                float wscale, cudaStream_t stream) {
  if (n_hist * n_hist * n_bins > MAX_D || 2 * r_max + 1 > DESC_THREADS)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  DescParams prm{n_hist, n_bins, lambda_descr, sqrt2, deg2rad, rad2deg, bin_step, wscale};
  size_t smem = (size_t)(2 * r_max + 1) * (n_hist * n_hist * n_bins + 1) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  descriptor_kernel<<<M, DESC_THREADS, smem, stream>>>(gauss, Hp, Wp, plane, y, x, scale,
                                                       angle, live, hist, h, w, pad,
                                                       r_max, prm);
  return (int)cudaGetLastError();
}
