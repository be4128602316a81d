// K5: 36-bin gradient-orientation histograms with in-kernel peaks.
//
// Replaces the TPU kernels of sift_features_tpu/ops/pallas/orientation_packed.py
// (one _kernel, two liveness modes), which the JAX extractor dispatches per
// scale bucket: K5 orientation_histograms_packed_masked (a per-lane live
// flag, entry sift_orientation) and K5' orientation_histograms_packed (lane i
// is live iff i < count, the count read from device memory; entry
// sift_orientation_prefix). Per live survivor it computes the raw
// histogram of gradient_direction_histogram (lib.rs:655-757): radius
// round_half_away(3 * lambda_ori * scale), Gaussian weight
// exp(d2 * -1 / (2 sigma^2)) (rounded once from f64), magnitude sqrt(gx^2 +
// gy^2), bin round_half_away(36 / (2 pi) * atan2_f32(gy, gx)) wrapped into
// [0, 36), samples outside [1, h-2] x [1, w-2] skipped. Then it smooths the
// histogram once with [1,4,6,4,1]/16 and returns the first N_PEAKS angles
// of orientation_peaks (lib.rs:394-431) with the true peak count.
//
// Deterministic by construction: thread r sums window row r over columns in
// ascending order into its own shared-memory row, then thread b sums bin b
// over rows in ascending order. No atomics; the plain version
// (ops/kernels/orientation.py) adds in the same order.
//
// Bound on the H100: latency of the per-row serial sums. The bytes are
// small (each survivor reads <= 35 x 35 pixels, mostly from L2, and writes
// 41 floats); the ~25 flops plus one atan2 and one f64 exp per sample are
// a few GFLOP per 1080p batch. One block per lane, with dead lanes exiting
// at once, keeps the design simple; a later version can give a warp per
// row and reduce across the warp in a fixed order.
#include "common.cuh"

#define R_ORI_MAX 16
#define MAX_BINS 64
#define MAX_PEAKS 8

__global__ void orientation_kernel(
    const float* __restrict__ gauss, int Hp, int Wp, const int* __restrict__ plane,
    const int* __restrict__ ys, const int* __restrict__ xs,
    const float* __restrict__ scales, const int* __restrict__ live,
    const int* __restrict__ count, float* __restrict__ hist, float* __restrict__ ang,
    int* __restrict__ npk, int h, int w, int pad, int n_bins, int n_peaks, float radius_factor,
    float lambda_ori, float ratio, float bstep) {
  __shared__ float rows[2 * R_ORI_MAX + 1][MAX_BINS + 1];
  __shared__ float raw[MAX_BINS];
  int k = blockIdx.x;
  int t = threadIdx.x;
  float* hrow = hist + (long long)k * n_bins;
  if (count ? k >= *count : !live[k]) {
    for (int b = t; b < n_bins; b += blockDim.x) hrow[b] = 0.0f;
    for (int j = t; j < n_peaks; j += blockDim.x) ang[(long long)k * n_peaks + j] = 0.0f;
    if (t == 0) npk[k] = 0;
    return;
  }
  float scale = scales[k];
  float radius = round_half_away(radius_factor * scale);
  float sigma = lambda_ori * scale;
  float gws = -1.0f / (2.0f * sigma * sigma);
  int ri = (int)fminf(fmaxf(radius, 0.0f), (float)R_ORI_MAX);
  int n = 2 * ri + 1;
  int y = ys[k], x = xs[k];
  for (int i = t; i < n * n_bins; i += blockDim.x) rows[i / n_bins][i % n_bins] = 0.0f;
  __syncthreads();
  if (t < n) {
    int dy = t - ri;
    int yy = y + dy;
    if (fabsf((float)dy) <= radius && yy >= 1 && yy <= h - 2) {
      const float* g = gauss + (long long)plane[k] * Hp * Wp +
                       (long long)(yy + pad) * Wp + pad;
      for (int dx = -ri; dx <= ri; ++dx) {
        int xx = x + dx;
        if (fabsf((float)dx) > radius || xx < 1 || xx > w - 2) continue;
        float d2 = (float)(dy * dy + dx * dx);
        float weight = exp_f32_via_f64(d2 * gws);
        float gx = g[xx + 1] - g[xx - 1];
        float gy = g[xx - Wp] - g[xx + Wp];
        float mag = sqrtf(gx * gx + gy * gy);
        int b = (int)round_half_away(bstep * atan2_f32(gy, gx));
        if (b >= n_bins) b -= n_bins;
        if (b < 0) b += n_bins;
        rows[t][b] += weight * mag;
      }
    }
  }
  __syncthreads();
  for (int b = t; b < n_bins; b += blockDim.x) {
    float acc = 0.0f;
    for (int r = 0; r < n; ++r) acc = acc + rows[r][b];
    raw[b] = acc;
    hrow[b] = acc;
  }
  __syncthreads();
  if (t != 0) return;
  // smoothing + peaks, in the op order of ops/orientation.py
  float sm[MAX_BINS];
  for (int b = 0; b < n_bins; ++b) {
    float rm2 = raw[(b - 2 + n_bins) % n_bins], rp2 = raw[(b + 2) % n_bins];
    float rm1 = raw[(b - 1 + n_bins) % n_bins], rp1 = raw[(b + 1) % n_bins];
    sm[b] = (rm2 + rp2) * 0.0625f + (rm1 + rp1) * 0.25f + raw[b] * 6.0f / 16.0f;
  }
  float hmax = sm[0];
  for (int b = 1; b < n_bins; ++b) hmax = fmaxf(hmax, sm[b]);
  float thr = hmax * ratio;
  float nb = (float)n_bins;
  float binw = 360.0f / nb;
  int cnt = 0;
  float out[MAX_PEAKS];
  for (int j = 0; j < n_peaks; ++j) out[j] = 0.0f;
  for (int b = 0; b < n_bins; ++b) {
    float hm = sm[(b - 1 + n_bins) % n_bins], hp = sm[(b + 1) % n_bins];
    if (!(sm[b] > hm && sm[b] > hp && sm[b] >= thr)) continue;
    float interp = (hm - hp) / (hm - 2.0f * sm[b] + hp);
    float bin_f = (float)b + 0.5f * interp;
    bin_f = bin_f < 0.0f ? nb + bin_f : (bin_f >= nb ? bin_f - nb : bin_f);
    if (cnt < n_peaks) out[cnt] = 360.0f - binw * bin_f;
    ++cnt;
  }
  for (int j = 0; j < n_peaks; ++j) ang[(long long)k * n_peaks + j] = out[j];
  npk[k] = cnt;
}

static int launch_orientation(const float* gauss, int Hp, int Wp, const int* plane,
                              const int* y, const int* x, const float* scale,
                              const int* live, const int* count, float* hist, float* ang,
                              int* npk, int K, int h, int w, int pad, int n_bins,
                              int n_peaks, float radius_factor, float lambda_ori,
                              float ratio, float bstep, cudaStream_t stream) {
  if (n_bins > MAX_BINS || n_peaks > MAX_PEAKS) return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  orientation_kernel<<<K, 64, 0, stream>>>(gauss, Hp, Wp, plane, y, x, scale, live,
                                           count, hist, ang, npk, h, w, pad, n_bins,
                                           n_peaks, radius_factor, lambda_ori,
                                           ratio, bstep);
  return (int)cudaGetLastError();
}

// gauss (n_planes, Hp, Wp) f32; plane/y/x/live (K,) int32 (y, x unpadded
// octave coordinates); scale (K,) f32 -> hist (K, n_bins) raw f32, ang
// (K, n_peaks) f32, npk (K,) int32. Dead lanes get zeros.
SIFT_EXPORT int sift_orientation(const float* gauss, int Hp, int Wp,
                                 const int* plane, const int* y, const int* x,
                                 const float* scale, const int* live, float* hist,
                                 float* ang, int* npk, int K, int h, int w, int pad,
                                 int n_bins, int n_peaks, float radius_factor,
                                 float lambda_ori, float ratio, float bstep,
                                 cudaStream_t stream) {
  return launch_orientation(gauss, Hp, Wp, plane, y, x, scale, live, nullptr, hist, ang,
                            npk, K, h, w, pad, n_bins, n_peaks, radius_factor,
                            lambda_ori, ratio, bstep, stream);
}

// K5': the same with lane i live iff i < *count (count: one int32 on the
// device).
SIFT_EXPORT int sift_orientation_prefix(const float* gauss, int Hp, int Wp,
                                        const int* plane, const int* y, const int* x,
                                        const float* scale, const int* count,
                                        float* hist, float* ang, int* npk, int K, int h,
                                        int w, int pad, int n_bins, int n_peaks,
                                        float radius_factor, float lambda_ori,
                                        float ratio, float bstep, cudaStream_t stream) {
  return launch_orientation(gauss, Hp, Wp, plane, y, x, scale, nullptr, count, hist, ang,
                            npk, K, h, w, pad, n_bins, n_peaks, radius_factor,
                            lambda_ori, ratio, bstep, stream);
}
