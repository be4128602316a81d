// K5 and K8: 36-bin gradient-orientation histograms (K5 with in-kernel
// peaks). K8's note is at its kernel below.
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
//
// The Gaussian planes may be f32 or bf16 (storage_dtype "bfloat16" or
// "split", gather_dtype "bfloat16"): every kernel here is a template on the
// plane type and widens each sample to f32 at the load, which is exact, so a
// bf16 stack gives the histograms of its widened f32 copy.
#include "common.cuh"

#define R_ORI_MAX 16
#define MAX_BINS 64
#define MAX_PEAKS 8

// Radius (f32), Gaussian weight scale -1 / (2 sigma^2) and the integer
// half-width min(radius, r_max) of one keypoint's window.
__device__ __forceinline__ int orientation_lane(float scale, float radius_factor,
                                                float lambda_ori, int r_max, float* radius,
                                                float* gws) {
  *radius = round_half_away(radius_factor * scale);
  float sigma = lambda_ori * scale;
  *gws = -1.0f / (2.0f * sigma * sigma);
  return (int)fminf(fmaxf(*radius, 0.0f), (float)r_max);
}

// Adds window row dy of one keypoint to acc (n_bins), columns ascending:
// samples within the radius and inside [1, w-2]. g points at the sample of
// row y + dy, column x, in a plane of row stride `stride` (the Gaussian
// level in device memory for K5, the staged window for K8).
template <typename T>
__device__ __forceinline__ void orientation_row(const T* g, int stride, int dy, int ri,
                                                float radius, int x, int w, float gws,
                                                float bstep, int n_bins, float* acc) {
  for (int dx = -ri; dx <= ri; ++dx) {
    int xx = x + dx;
    if (fabsf((float)dx) > radius || xx < 1 || xx > w - 2) continue;
    float d2 = (float)(dy * dy + dx * dx);
    float weight = exp_f32_via_f64(d2 * gws);
    float gx = to_f32(g[dx + 1]) - to_f32(g[dx - 1]);
    float gy = to_f32(g[dx - stride]) - to_f32(g[dx + stride]);
    float mag = sqrtf(gx * gx + gy * gy);
    int b = (int)round_half_away(bstep * atan2_f32(gy, gx));
    if (b >= n_bins) b -= n_bins;
    if (b < 0) b += n_bins;
    acc[b] += weight * mag;
  }
}

template <typename T>
__global__ void orientation_kernel(
    const T* __restrict__ gauss, int Hp, int Wp, const int* __restrict__ plane,
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
  float radius, gws;
  int ri = orientation_lane(scales[k], radius_factor, lambda_ori, R_ORI_MAX, &radius, &gws);
  int n = 2 * ri + 1;
  int y = ys[k], x = xs[k];
  for (int i = t; i < n * n_bins; i += blockDim.x) rows[i / n_bins][i % n_bins] = 0.0f;
  __syncthreads();
  if (t < n) {
    int dy = t - ri;
    int yy = y + dy;
    if (fabsf((float)dy) <= radius && yy >= 1 && yy <= h - 2)
      orientation_row(gauss + (long long)plane[k] * Hp * Wp + (long long)(yy + pad) * Wp +
                          pad + x,
                      Wp, dy, ri, radius, x, w, gws, bstep, n_bins, rows[t]);
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

static int launch_orientation(const void* gauss, int gauss_t, int Hp, int Wp,
                              const int* plane, const int* y, const int* x,
                              const float* scale, const int* live, const int* count,
                              float* hist, float* ang, int* npk, int K, int h, int w,
                              int pad, int n_bins, int n_peaks, float radius_factor,
                              float lambda_ori, float ratio, float bstep,
                              cudaStream_t stream) {
  if (n_bins > MAX_BINS || n_peaks > MAX_PEAKS ||
      (gauss_t != SIFT_F32 && gauss_t != SIFT_BF16))
    return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  if (gauss_t == SIFT_BF16)
    orientation_kernel<bf16><<<K, 64, 0, stream>>>(
        (const bf16*)gauss, Hp, Wp, plane, y, x, scale, live, count, hist, ang, npk, h, w,
        pad, n_bins, n_peaks, radius_factor, lambda_ori, ratio, bstep);
  else
    orientation_kernel<float><<<K, 64, 0, stream>>>(
        (const float*)gauss, Hp, Wp, plane, y, x, scale, live, count, hist, ang, npk, h,
        w, pad, n_bins, n_peaks, radius_factor, lambda_ori, ratio, bstep);
  return (int)cudaGetLastError();
}

// gauss (n_planes, Hp, Wp) of type gauss_t (f32 or bf16); plane/y/x/live (K,) int32 (y, x unpadded
// octave coordinates); scale (K,) f32 -> hist (K, n_bins) raw f32, ang
// (K, n_peaks) f32, npk (K,) int32. Dead lanes get zeros.
SIFT_EXPORT int sift_orientation(const void* gauss, int gauss_t, int Hp, int Wp,
                                 const int* plane, const int* y, const int* x,
                                 const float* scale, const int* live, float* hist,
                                 float* ang, int* npk, int K, int h, int w, int pad,
                                 int n_bins, int n_peaks, float radius_factor,
                                 float lambda_ori, float ratio, float bstep,
                                 cudaStream_t stream) {
  return launch_orientation(gauss, gauss_t, Hp, Wp, plane, y, x, scale, live, nullptr,
                            hist, ang,
                            npk, K, h, w, pad, n_bins, n_peaks, radius_factor,
                            lambda_ori, ratio, bstep, stream);
}

// K5': the same with lane i live iff i < *count (count: one int32 on the
// device).
SIFT_EXPORT int sift_orientation_prefix(const void* gauss, int gauss_t, int Hp, int Wp,
                                        const int* plane, const int* y, const int* x,
                                        const float* scale, const int* count,
                                        float* hist, float* ang, int* npk, int K, int h,
                                        int w, int pad, int n_bins, int n_peaks,
                                        float radius_factor, float lambda_ori,
                                        float ratio, float bstep, cudaStream_t stream) {
  return launch_orientation(gauss, gauss_t, Hp, Wp, plane, y, x, scale, nullptr, count,
                            hist, ang,
                            npk, K, h, w, pad, n_bins, n_peaks, radius_factor,
                            lambda_ori, ratio, bstep, stream);
}

// ---------------------------------------------------------------------------
// K8 (sift_orientation_perkey): raw 36-bin histograms, one keypoint per
// block, launched once per scale bucket with that bucket's static window
// bound r_max <= 16 (window_kernel="perkey"). Replaces
// ops/pallas/orientation_kernel.py:orientation_histograms_pallas
// (_kernel), which the JAX dispatcher orientation_histograms_bucketed runs
// per bucket on compacted lanes: lane i is live iff i < *count, the count
// read on the card. No peaks: the caller smooths the rows and takes
// orientation_peaks, as the JAX extractor does for this mode.
//
// Designed for the card, not copied from K5: the block first stages the
// keypoint's (2 r_max + 3)^2 window (<= 35 x 35 f32, 4.9 KB, widened to f32
// as it is staged) in shared memory with coalesced row reads, then thread r
// sums window row r from there with K5's per-sample code, in K5's order
// (columns ascending, then rows ascending per bin). Samples past a
// keypoint's radius add nothing, so for a radius <= r_max (always, within
// its bucket) its raw row equals K5's bit for bit.
//
// Bound on the H100: as K5, the latency of the per-row serial sums; the
// window reads are the bytes (each live lane reads (2 r_max + 3)^2 floats
// once and writes 36).
template <typename T>
__global__ void orientation_perkey_kernel(
    const T* __restrict__ gauss, int Hp, int Wp, const int* __restrict__ plane,
    const int* __restrict__ ys, const int* __restrict__ xs,
    const float* __restrict__ scales, const int* __restrict__ count,
    float* __restrict__ hist, int h, int w, int pad, int n_bins, int r_max,
    float radius_factor, float lambda_ori, float bstep) {
  __shared__ float win[(2 * R_ORI_MAX + 3) * (2 * R_ORI_MAX + 3)];
  __shared__ float rows[2 * R_ORI_MAX + 1][MAX_BINS + 1];
  int k = blockIdx.x;
  int t = threadIdx.x;
  float* hrow = hist + (long long)k * n_bins;
  if (k >= *count) {
    for (int b = t; b < n_bins; b += blockDim.x) hrow[b] = 0.0f;
    return;
  }
  float radius, gws;
  int ri = orientation_lane(scales[k], radius_factor, lambda_ori, r_max, &radius, &gws);
  int n = 2 * ri + 1;
  int y = ys[k], x = xs[k];
  int wn = 2 * r_max + 3;
  const T* g0 = gauss + (long long)plane[k] * Hp * Wp +
                (long long)(y + pad - r_max - 1) * Wp + (x + pad - r_max - 1);
  for (int i = t; i < wn * wn; i += blockDim.x)
    win[i] = to_f32(g0[(i / wn) * Wp + i % wn]);
  for (int i = t; i < n * n_bins; i += blockDim.x) rows[i / n_bins][i % n_bins] = 0.0f;
  __syncthreads();
  if (t < n) {
    int dy = t - ri;
    int yy = y + dy;
    if (fabsf((float)dy) <= radius && yy >= 1 && yy <= h - 2)
      orientation_row(win + (r_max + 1 + dy) * wn + r_max + 1, wn, dy, ri, radius, x, w,
                      gws, bstep, n_bins, rows[t]);
  }
  __syncthreads();
  for (int b = t; b < n_bins; b += blockDim.x) {
    float acc = 0.0f;
    for (int r = 0; r < n; ++r) acc = acc + rows[r][b];
    hrow[b] = acc;
  }
}

// gauss (n_planes, Hp, Wp) of type gauss_t (f32 or bf16); plane/y/x (K,)
// int32 (y, x unpadded octave coordinates, pad >= r_max + 1); scale (K,) f32;
// count: one int32 on the device -> hist (K, n_bins) raw f32, zero for lanes
// >= count.
SIFT_EXPORT int sift_orientation_perkey(const void* gauss, int gauss_t, int Hp, int Wp,
                                        const int* plane, const int* y, const int* x,
                                        const float* scale, const int* count, float* hist,
                                        int K, int h, int w, int pad, int n_bins, int r_max,
                                        float radius_factor, float lambda_ori, float bstep,
                                        cudaStream_t stream) {
  if (n_bins > MAX_BINS || r_max > R_ORI_MAX || pad < r_max + 1 ||
      (gauss_t != SIFT_F32 && gauss_t != SIFT_BF16))
    return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  if (gauss_t == SIFT_BF16)
    orientation_perkey_kernel<bf16><<<K, 64, 0, stream>>>(
        (const bf16*)gauss, Hp, Wp, plane, y, x, scale, count, hist, h, w, pad, n_bins,
        r_max, radius_factor, lambda_ori, bstep);
  else
    orientation_perkey_kernel<float><<<K, 64, 0, stream>>>(
        (const float*)gauss, Hp, Wp, plane, y, x, scale, count, hist, h, w, pad, n_bins,
        r_max, radius_factor, lambda_ori, bstep);
  return (int)cudaGetLastError();
}
