// K6 and K7: 4x4x8 SIFT descriptor histograms over a rotated window.
// K7's note is at its kernel below.
//
// Replaces the TPU kernels of sift_features_tpu/ops/pallas/descriptor_packed.py
// (one _kernel, two liveness modes), which the JAX extractor dispatches per
// scale bucket: K6 descriptor_hist_packed_masked (a per-lane live flag,
// entry sift_descriptor) and K6' descriptor_hist_packed (lane i is live iff
// i < count, the count read from device memory so the caller never syncs
// the host; entry sift_descriptor_prefix). Per live keypoint it computes the raw 128-bin
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
//
// The Gaussian planes may be f32 or bf16 (the storage modes): K6 and K7 are
// templates on the plane type and widen each sample to f32 at the load
// (K7 as it stages its window), which is exact.
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

// One keypoint's window: the rotation (orientation = 360 - angle degrees,
// sin and cos over the histogram width) and the integer radius, asserted
// to lie within r_max (a device-side trap, never a silent cut).
__device__ __forceinline__ int descriptor_lane(float scale, float angle,
                                               const DescParams& prm, int r_max,
                                               float* orientation, float* sin_s,
                                               float* cos_s) {
  *orientation = 360.0f - angle;
  float hw = prm.lambda_descr * scale;
  float radius = round_half_away(hw * prm.sqrt2 * (float)(prm.n_hist + 1) * 0.5f);
  assert(radius >= 0.0f && radius <= (float)r_max);
  float ori_rad = *orientation * prm.deg2rad;
  *sin_s = (float)sin((double)ori_rad) / hw;
  *cos_s = (float)cos((double)ori_rad) / hw;
  return (int)radius;
}

// Adds window row dy of one keypoint to acc (D bins), columns ascending:
// samples inside the image interior and the rotated 4x4 grid. g points at
// the sample of row y + dy, column x, in a plane of row stride `stride`
// (the Gaussian level in device memory for K6, the staged window for K7).
template <typename T>
__device__ __forceinline__ void descriptor_row(const T* g, int stride, int dy, int ri,
                                               int x, int w, float sin_s, float cos_s,
                                               float orientation, const DescParams& prm,
                                               float* acc) {
  const int n_hist = prm.n_hist, n_bins = prm.n_bins;
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
    float gx = to_f32(g[dx + 1]) - to_f32(g[dx - 1]);
    float gy = to_f32(g[dx - stride]) - to_f32(g[dx + stride]);
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

template <typename T>
__global__ void __launch_bounds__(DESC_THREADS) descriptor_kernel(
    const T* __restrict__ gauss, int Hp, int Wp, const int* __restrict__ plane,
    const int* __restrict__ ys, const int* __restrict__ xs,
    const float* __restrict__ scales, const float* __restrict__ angles,
    const int* __restrict__ live, const int* __restrict__ count,
    float* __restrict__ hist, int h, int w, int pad, int r_max, DescParams prm) {
  extern __shared__ float rows[];  // (2 r_max + 1) rows of stride D + 1
  const int D = prm.n_hist * prm.n_hist * prm.n_bins;
  const int stride = D + 1;
  int k = blockIdx.x;
  int t = threadIdx.x;
  float* hrow = hist + (long long)k * D;
  if (count ? k >= *count : !live[k]) {
    for (int b = t; b < D; b += blockDim.x) hrow[b] = 0.0f;
    return;
  }
  float orientation, sin_s, cos_s;
  int ri = descriptor_lane(scales[k], angles[k], prm, r_max, &orientation, &sin_s, &cos_s);
  int n = 2 * ri + 1;
  for (int i = t; i < n * stride; i += blockDim.x) rows[i] = 0.0f;
  __syncthreads();
  int y = ys[k], x = xs[k];
  if (t < n) {
    int dy = t - ri;
    int yy = y + dy;
    if (yy > 0 && yy < h - 1)
      descriptor_row(gauss + (long long)plane[k] * Hp * Wp + (long long)(yy + pad) * Wp +
                         pad + x,
                     Wp, dy, ri, x, w, sin_s, cos_s, orientation, prm, rows + t * stride);
  }
  __syncthreads();
  for (int b = t; b < D; b += blockDim.x) {
    float s = 0.0f;
    for (int r = 0; r < n; ++r) s = s + rows[r * stride + b];
    hrow[b] = s;
  }
}

static int launch_descriptor(const void* gauss, int gauss_t, int Hp, int Wp,
                             const int* plane, const int* y, const int* x,
                             const float* scale, const float* angle, const int* live,
                             const int* count, float* hist, int M, int h, int w, int pad,
                             int r_max, DescParams prm, cudaStream_t stream) {
  int D = prm.n_hist * prm.n_hist * prm.n_bins;
  if (D > MAX_D || 2 * r_max + 1 > DESC_THREADS ||
      (gauss_t != SIFT_F32 && gauss_t != SIFT_BF16))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  size_t smem = (size_t)(2 * r_max + 1) * (D + 1) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (gauss_t == SIFT_BF16)
    descriptor_kernel<bf16><<<M, DESC_THREADS, smem, stream>>>(
        (const bf16*)gauss, Hp, Wp, plane, y, x, scale, angle, live, count, hist, h, w,
        pad, r_max, prm);
  else
    descriptor_kernel<float><<<M, DESC_THREADS, smem, stream>>>(
        (const float*)gauss, Hp, Wp, plane, y, x, scale, angle, live, count, hist, h, w,
        pad, r_max, prm);
  return (int)cudaGetLastError();
}

// gauss (n_planes, Hp, Wp) of type gauss_t (f32 or bf16); plane/y/x/live
// (M,) int32 ((y, x) unpadded octave coordinates, the rounded keypoint
// position); scale/angle (M,) f32 -> hist (M, n_hist^2 n_bins) raw f32, zero
// on dead lanes.
SIFT_EXPORT int sift_descriptor(const void* gauss, int gauss_t, int Hp, int Wp,
                                const int* plane,
                                const int* y, const int* x, const float* scale,
                                const float* angle, const int* live, float* hist,
                                int M, int h, int w, int pad, int r_max, int n_hist,
                                int n_bins, float lambda_descr, float sqrt2,
                                float deg2rad, float rad2deg, float bin_step,
                                float wscale, cudaStream_t stream) {
  DescParams prm{n_hist, n_bins, lambda_descr, sqrt2, deg2rad, rad2deg, bin_step, wscale};
  return launch_descriptor(gauss, gauss_t, Hp, Wp, plane, y, x, scale, angle, live,
                           nullptr, hist, M, h, w, pad, r_max, prm, stream);
}

// K6': the same with lane i live iff i < *count (count: one int32 on the
// device).
SIFT_EXPORT int sift_descriptor_prefix(const void* gauss, int gauss_t, int Hp, int Wp,
                                       const int* plane, const int* y, const int* x,
                                       const float* scale, const float* angle,
                                       const int* count, float* hist, int M, int h,
                                       int w, int pad, int r_max, int n_hist,
                                       int n_bins, float lambda_descr, float sqrt2,
                                       float deg2rad, float rad2deg, float bin_step,
                                       float wscale, cudaStream_t stream) {
  DescParams prm{n_hist, n_bins, lambda_descr, sqrt2, deg2rad, rad2deg, bin_step, wscale};
  return launch_descriptor(gauss, gauss_t, Hp, Wp, plane, y, x, scale, angle, nullptr,
                           count, hist, M, h, w, pad, r_max, prm, stream);
}

// ---------------------------------------------------------------------------
// K7 (sift_descriptor_perkey): raw 128-bin histograms, one keypoint per
// block, launched once per scale bucket with that bucket's static window
// bound r_max <= 39 (window_kernel="perkey"). Replaces
// ops/pallas/descriptor_kernel.py:descriptor_hist_pallas (_kernel), which
// the JAX dispatcher descriptor_hist_bucketed runs per bucket on compacted
// lanes: lane i is live iff i < *count, the count read on the card.
//
// K8's design: the block stages the keypoint's (2 r_max + 3)^2 window
// (<= 81 x 81 f32, 26 KB) in shared memory with coalesced row reads, then
// thread r sums window row r from there with K6's per-sample code, in K6's
// order, so its raw row equals K6's bit for bit. With the per-row bins the
// block takes up to 26 KB + 77 x 129 f32 = 65 KB of dynamic shared memory.
//
// Bound on the H100: as K6, the operations of the per-sample math.
template <typename T>
__global__ void __launch_bounds__(DESC_THREADS) descriptor_perkey_kernel(
    const T* __restrict__ gauss, int Hp, int Wp, const int* __restrict__ plane,
    const int* __restrict__ ys, const int* __restrict__ xs,
    const float* __restrict__ scales, const float* __restrict__ angles,
    const int* __restrict__ count, float* __restrict__ hist, int h, int w, int pad,
    int r_max, DescParams prm) {
  extern __shared__ float smem[];
  const int D = prm.n_hist * prm.n_hist * prm.n_bins;
  const int stride = D + 1;
  const int wn = 2 * r_max + 3;
  float* win = smem;             // (wn, wn)
  float* rows = smem + wn * wn;  // (2 r_max + 1) rows of stride D + 1
  int k = blockIdx.x;
  int t = threadIdx.x;
  float* hrow = hist + (long long)k * D;
  if (k >= *count) {
    for (int b = t; b < D; b += blockDim.x) hrow[b] = 0.0f;
    return;
  }
  float orientation, sin_s, cos_s;
  int ri = descriptor_lane(scales[k], angles[k], prm, r_max, &orientation, &sin_s, &cos_s);
  int n = 2 * ri + 1;
  int y = ys[k], x = xs[k];
  const T* g0 = gauss + (long long)plane[k] * Hp * Wp +
                (long long)(y + pad - r_max - 1) * Wp + (x + pad - r_max - 1);
  for (int i = t; i < wn * wn; i += blockDim.x)
    win[i] = to_f32(g0[(i / wn) * Wp + i % wn]);
  for (int i = t; i < n * stride; i += blockDim.x) rows[i] = 0.0f;
  __syncthreads();
  if (t < n) {
    int dy = t - ri;
    int yy = y + dy;
    if (yy > 0 && yy < h - 1)
      descriptor_row(win + (r_max + 1 + dy) * wn + r_max + 1, wn, dy, ri, x, w, sin_s,
                     cos_s, orientation, prm, rows + t * stride);
  }
  __syncthreads();
  for (int b = t; b < D; b += blockDim.x) {
    float s = 0.0f;
    for (int r = 0; r < n; ++r) s = s + rows[r * stride + b];
    hrow[b] = s;
  }
}

// gauss (n_planes, Hp, Wp) of type gauss_t (f32 or bf16); plane/y/x (M,)
// int32 ((y, x) unpadded octave coordinates, pad >= r_max + 1); scale/angle
// (M,) f32; count: one int32 on the device -> hist (M, n_hist^2 n_bins) raw
// f32, zero for lanes >= count.
SIFT_EXPORT int sift_descriptor_perkey(const void* gauss, int gauss_t, int Hp, int Wp,
                                       const int* plane, const int* y, const int* x,
                                       const float* scale, const float* angle,
                                       const int* count, float* hist, int M, int h, int w,
                                       int pad, int r_max, int n_hist, int n_bins,
                                       float lambda_descr, float sqrt2, float deg2rad,
                                       float rad2deg, float bin_step, float wscale,
                                       cudaStream_t stream) {
  DescParams prm{n_hist, n_bins, lambda_descr, sqrt2, deg2rad, rad2deg, bin_step, wscale};
  int D = n_hist * n_hist * n_bins;
  if (D > MAX_D || 2 * r_max + 1 > DESC_THREADS || pad < r_max + 1 ||
      (gauss_t != SIFT_F32 && gauss_t != SIFT_BF16))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  size_t smem = ((size_t)(2 * r_max + 3) * (2 * r_max + 3) +
                 (size_t)(2 * r_max + 1) * (D + 1)) * sizeof(float);
  cudaError_t e;
  if (gauss_t == SIFT_BF16) {
    e = cudaFuncSetAttribute(descriptor_perkey_kernel<bf16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    descriptor_perkey_kernel<bf16><<<M, DESC_THREADS, smem, stream>>>(
        (const bf16*)gauss, Hp, Wp, plane, y, x, scale, angle, count, hist, h, w, pad,
        r_max, prm);
  } else {
    e = cudaFuncSetAttribute(descriptor_perkey_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    descriptor_perkey_kernel<float><<<M, DESC_THREADS, smem, stream>>>(
        (const float*)gauss, Hp, Wp, plane, y, x, scale, angle, count, hist, h, w, pad,
        r_max, prm);
  }
  return (int)cudaGetLastError();
}
