// K5, K5' and K8: 36-bin gradient-orientation histograms, one CUDA kernel
// (`orientation_kernel`) for all three; K5 and K5' also take the peaks.
//
// Replaces two TPU kernels. sift_features_tpu/ops/pallas/orientation_packed.py
// (one _kernel, two liveness modes), which the JAX extractor dispatches per
// scale bucket: K5 orientation_histograms_packed_masked (a per-lane live
// flag, entry sift_orientation) and K5' orientation_histograms_packed (lane i
// is live iff i < count, the count read from device memory; entry
// sift_orientation_prefix). And ops/pallas/orientation_kernel.py:
// orientation_histograms_pallas, K8 (entry sift_orientation_perkey): the raw
// histograms of one scale bucket's compacted lanes (live iff i < count),
// launched once per bucket with the bucket's window bound r_max <= 16
// (window_kernel="perkey"), no peaks: the caller smooths the rows and takes
// orientation_peaks, as the JAX extractor does for that mode.
//
// Per live lane it computes the raw histogram of
// gradient_direction_histogram (lib.rs:655-757): radius round_half_away(3 *
// lambda_ori * scale), half-width min(radius, r_max) (r_max = R_ORI_MAX for
// K5), Gaussian weight exp(d2 * -1 / (2 sigma^2)) (rounded once from f64),
// magnitude sqrt(gx^2 + gy^2), bin round_half_away(36 / (2 pi) *
// atan2_f32(gy, gx)) wrapped into [0, 36), samples outside [1, h-2] x
// [1, w-2] skipped. K5 then smooths the histogram once with [1,4,6,4,1]/16
// and returns the first N_PEAKS angles of orientation_peaks (lib.rs:394-431)
// with the true peak count. Dead lanes get zero rows.
//
// Deterministic by construction, in one summation order: within each window
// row, columns ascending per bin; then, per bin, rows ascending. No
// atomics; the plain versions (ops/kernels/orientation.py) add in the same
// order, so the rows are equal bit for bit, and K8's raw rows equal K5's
// for every lane whose radius is within the bucket's r_max.
//
// Bound on the H100: operations (the bound counts ~60 f32 instructions a
// sample; the sample's two IEEE divisions and square root expand to
// several each). The bytes are each live lane's <= 35 x 35 window, mostly
// from L2, and every lane's row. Measured on an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md): K5 by its former design, one 64-thread block per lane,
// took 0.43 ms per 1080p B=4 octave-0 launch, of which 65,536 one-lane
// blocks (a third live) and the wrapper's host time made 0.09, the sample
// math 0.10, and one thread's serial sum per window row, every sample read
// from global memory, the rest. K8 had that design too: a block per lane
// over every lane of a bucket, a ninth of them live.
//
// Design: a warp per lane, ORI_WARPS warps a block, the grid sized to what
// the card holds at once and each warp striding over the lanes. In a round
// of 32 lanes, thread j loads lane j's flag and parameters (one load each
// for the warp) and computes its radius, weight scale and half-width (so
// no division waits in a lane's chain), and the warp zeroes the dead
// lanes' rows with coalesced stores, so a dead lane costs little. A live
// lane's warp
//  - stages its (2r+3)^2 window in shared memory (coalesced row reads,
//    ORI_STAGE loads in flight a thread, widened to f32); the first chunk
//    of the next live lane's window is loaded while this lane finishes;
//  - tabulates the Gaussian weight once per distinct (|dy|, |dx|) (<= 153
//    f64 exps instead of <= 1,089);
//  - phase A: all 32 threads compute the samples, each writing a record
//    (bin, weight * magnitude) in row-major order;
//  - phase B: thread r applies row r's records in ascending columns to its
//    row histogram, then thread b sums bin b over the rows in ascending
//    order;
//  - (K5, K5') thread b smooths bin b; a ballot and popc rank the peaks in
//    ascending bin order, with the f32 expressions of orientation_peaks.
// The window and the row histograms share memory (the window is dead once
// phase A ends), and so do the weight table and the raw and smoothed
// histograms: 10.7 KB a warp at 36 bins, 4 blocks of 5 warps an SM. The
// kernel is a template on the plane type and on PEAKS: the K8
// instantiation (PEAKS false) has no smoothing or peak code and writes no
// angles or counts, and its name differs from K5's, so profiles tell them
// apart. Shared memory is sized for R_ORI_MAX in every instantiation. The
// sample loop stays rolled: unrolled, it ran slower on the card. Each live
// lane is latency-bound; phase A takes about half of its cycles.
//
// The Gaussian planes may be f32 or bf16 (storage_dtype "bfloat16" or
// "split", gather_dtype "bfloat16"): the kernel widens each sample to f32 at
// the load, which is exact, so a bf16 stack gives the histograms of its
// widened f32 copy.
#include <climits>
#include <mutex>

#include "common.cuh"

#define R_ORI_MAX 16
#define MAX_BINS 64
#define MAX_PEAKS 8
#define ORI_WARPS 5                                         // 4 blocks, 20 warps an SM
#define ORI_WIN (2 * R_ORI_MAX + 3)                         // window side
#define ORI_N (2 * R_ORI_MAX + 1)                           // sample rows
#define ORI_TAB ((R_ORI_MAX + 1) * (R_ORI_MAX + 2) / 2)     // |dy| <= |dx| pairs
#define ORI_SKIP 255                                        // a record adding nothing
#define ORI_FULL 0xffffffffu
#define ORI_STAGE 8                                         // window loads in flight a thread

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

// Shared memory of one warp, in floats: the window, later the row
// histograms; the records' values; the weight table, later the raw and
// smoothed histograms; the records' bins (bytes).
__host__ __device__ __forceinline__ int ori_union_floats(int n_bins) {
  return ORI_N * (n_bins + 1) > ORI_WIN * ORI_WIN ? ORI_N * (n_bins + 1) : ORI_WIN * ORI_WIN;
}
__host__ __device__ __forceinline__ int ori_tab_floats(int n_bins) {
  return 2 * n_bins > ORI_TAB ? 2 * n_bins : ORI_TAB;
}
__host__ __device__ __forceinline__ int ori_warp_floats(int n_bins) {
  return ori_union_floats(n_bins) + ORI_N * ORI_N + ori_tab_floats(n_bins) +
         (ORI_N * ORI_N + 3) / 4;
}

// b mod n for -n <= b < 2n
__device__ __forceinline__ int ori_wrap(int b, int n) {
  return b < 0 ? b + n : (b >= n ? b - n : b);
}

// One chunk of a window's loads, ORI_STAGE a thread: elements i0 + u * 32 +
// lane of the wn x wn window at padded (oy, ox) of plane g0 (zero outside
// the plane), held in the plane's type so no instruction waits on them
// before their stores into win, which widen them.
template <typename T>
__device__ __forceinline__ void ori_load(T (&v)[ORI_STAGE], const T* g0, int oy, int ox,
                                         int wn, int i0, int lane, int Hp, int Wp) {
  // i / wn for i < 2^11, exact: (i + 0.5) / wn lies >= 0.5 / wn from an
  // integer, far beyond the f32 product's error
  float inv = 1.0f / (float)wn;
#pragma unroll
  for (int u = 0; u < ORI_STAGE; ++u) {
    int i = i0 + u * 32 + lane;
    int r = (int)(((float)i + 0.5f) * inv);
    int gy = oy + r, gx = ox + i - r * wn;
    v[u] = i < wn * wn && gy >= 0 && gy < Hp && gx >= 0 && gx < Wp
               ? g0[(long long)gy * Wp + gx] : from_f32<T>(0.0f);
  }
}
template <typename T>
__device__ __forceinline__ void ori_store(float* win, const T (&v)[ORI_STAGE], int wn,
                                          int i0, int lane) {
#pragma unroll
  for (int u = 0; u < ORI_STAGE; ++u)
    if (i0 + u * 32 + lane < wn * wn) win[i0 + u * 32 + lane] = to_f32(v[u]);
}

// Lane k is live iff live[k] != 0 (count null) or k < *count; windows have
// half-width <= r_max <= R_ORI_MAX. PEAKS: also the smoothed histogram's
// peaks into ang / npk (K5, K5'); without, those stay untouched (K8).
template <typename T, bool PEAKS>
__global__ void __launch_bounds__(ORI_WARPS * 32) orientation_kernel(
    const T* __restrict__ gauss, int n_planes, int Hp, int Wp, const int* __restrict__ plane,
    const int* __restrict__ ys, const int* __restrict__ xs,
    const float* __restrict__ scales, const unsigned char* __restrict__ live,
    const int* __restrict__ count, float* __restrict__ hist, float* __restrict__ ang,
    int* __restrict__ npk, int K, int h, int w, int pad, int n_bins, int n_peaks, int r_max,
    float radius_factor, float lambda_ori, float ratio, float bstep) {
  extern __shared__ float ori_smem[];
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int nb1 = n_bins + 1;
  float* win = ori_smem + wid * ori_warp_floats(n_bins);
  float* rows = win;  // once phase A is done
  float* val = win + ori_union_floats(n_bins);
  float* tab = val + ORI_N * ORI_N;
  float* raw = tab;  // once phase A is done
  float* sm = raw + n_bins;
  unsigned char* bins = reinterpret_cast<unsigned char*>(tab + ori_tab_floats(n_bins));
  int n_live = count ? *count : 0;
  int nw = gridDim.x * ORI_WARPS;
  // a round: lanes k0 + j * nw, j < 32; thread j reads lane j's flag and
  // parameters (one load each for the warp) and derives its window, then
  // the warp zeroes each dead lane's rows with coalesced stores and
  // describes each live one
  for (int k0 = blockIdx.x * ORI_WARPS + wid; k0 < K; k0 += 32 * nw) {
    int kj = k0 + lane * nw;
    bool lv = kj < K && (count ? kj < n_live : live[kj] != 0);
    float rad_j = 0.0f, gws_j = 0.0f;
    int y_j = 0, x_j = 0, p_j = 0, ri_j = 0;
    if (lv) {  // clamped as the plain version clamps
      ri_j = orientation_lane(scales[kj], radius_factor, lambda_ori, r_max, &rad_j, &gws_j);
      y_j = min(max(ys[kj], 0), h - 1);
      x_j = min(max(xs[kj], 0), w - 1);
      p_j = min(max(plane[kj], 0), n_planes - 1);
    }
    for (unsigned z = __ballot_sync(ORI_FULL, kj < K && !lv); z; z &= z - 1) {
      long long k = k0 + (long long)(__ffs(z) - 1) * nw;
      for (int b = lane; b < n_bins; b += 32) hist[k * n_bins + b] = 0.0f;
      if constexpr (PEAKS) {
        if (lane < n_peaks) ang[k * n_peaks + lane] = 0.0f;
        if (lane == 0) npk[k] = 0;
      }
    }
    // the first chunk of the next live lane's window, loaded while the
    // current lane finishes (pre_j: its lane, -1 for none)
    T pre[ORI_STAGE];
    int pre_j = -1;
    for (unsigned todo = __ballot_sync(ORI_FULL, lv); todo; todo &= todo - 1) {
      int j = __ffs(todo) - 1;
      int k = k0 + j * nw;
      float* hrow = hist + (long long)k * n_bins;
      float radius = __shfl_sync(ORI_FULL, rad_j, j), gws = __shfl_sync(ORI_FULL, gws_j, j);
      int ri = __shfl_sync(ORI_FULL, ri_j, j);
      int y = __shfl_sync(ORI_FULL, y_j, j), x = __shfl_sync(ORI_FULL, x_j, j);
      int n = 2 * ri + 1, wn = n + 2;
      // the window rows y - ri - 1 .. y + ri + 1, columns x - ri - 1 ..
      // x + ri + 1, its loads issued ORI_STAGE at a time
      const T* g0 = gauss + (long long)__shfl_sync(ORI_FULL, p_j, j) * Hp * Wp;
      int oy = y + pad - ri - 1, ox = x + pad - ri - 1;
      for (int i0 = 0; i0 < wn * wn; i0 += 32 * ORI_STAGE) {
        if (i0 || pre_j != j) ori_load(pre, g0, oy, ox, wn, i0, lane, Hp, Wp);
        ori_store(win, pre, wn, i0, lane);
      }
      pre_j = -1;
      // tab[b (b + 1) / 2 + a] = weight at |dy|, |dx| = a <= b (either
      // order); b = floor((sqrt(8i + 1) - 1) / 2) exactly: the sqrt is
      // correctly rounded, exact at squares and >= 1 / 70 below the next
      for (int i = lane; i < (ri + 1) * (ri + 2) / 2; i += 32) {
        int b = (int)((sqrtf(8.0f * (float)i + 1.0f) - 1.0f) * 0.5f);
        int a = i - b * (b + 1) / 2;
        tab[i] = exp_f32_via_f64((float)(a * a + b * b) * gws);
      }
      __syncwarp();
      // phase A: one record per sample, row-major
      float inv_n = 1.0f / (float)n;  // exact quotients, as in ori_load
      for (int i = lane; i < n * n; i += 32) {
        int r = (int)(((float)i + 0.5f) * inv_n);
        int c = i - r * n;
        int dy = r - ri, dx = c - ri;
        int yy = y + dy, xx = x + dx;
        unsigned bn = ORI_SKIP;
        float v = 0.0f;
        if (fabsf((float)dy) <= radius && yy >= 1 && yy <= h - 2 &&
            fabsf((float)dx) <= radius && xx >= 1 && xx <= w - 2) {
          const float* g = win + (r + 1) * wn + c + 1;
          float gx = g[1] - g[-1];
          float gy = g[-wn] - g[wn];
          int ay = abs(dy), ax = abs(dx);
          int lo = ay < ax ? ay : ax, hi = ay < ax ? ax : ay;
          float weight = tab[hi * (hi + 1) / 2 + lo];
          float mag = sqrtf(gx * gx + gy * gy);
          int b = (int)round_half_away(bstep * atan2_f32<true>(gy, gx));
          if (b >= n_bins) b -= n_bins;
          if (b < 0) b += n_bins;
          v = weight * mag;
          bn = (unsigned)b;
        }
        val[i] = v;
        bins[i] = (unsigned char)bn;
      }
      __syncwarp();
      if (todo & (todo - 1)) {  // prefetch the next live lane's first chunk
        int jn = __ffs(todo & (todo - 1)) - 1;
        int rin = __shfl_sync(ORI_FULL, ri_j, jn);
        ori_load(pre, gauss + (long long)__shfl_sync(ORI_FULL, p_j, jn) * Hp * Wp,
                 __shfl_sync(ORI_FULL, y_j, jn) + pad - rin - 1,
                 __shfl_sync(ORI_FULL, x_j, jn) + pad - rin - 1, 2 * rin + 3, 0, lane, Hp,
                 Wp);
        pre_j = jn;
      }
      // phase B: row r's records in ascending columns (thread r), then each
      // bin over the rows in ascending order (thread b)
      for (int i = lane; i < n * nb1; i += 32) rows[i] = 0.0f;
      __syncwarp();
      for (int r = lane; r < n; r += 32) {
        // distinct arrays: the next records load ahead of each update
        float* __restrict__ hr = rows + r * nb1;
        const float* __restrict__ vr = val + r * n;
        const unsigned char* __restrict__ br = bins + r * n;
#pragma unroll 4
        for (int c = 0; c < n; ++c) {
          unsigned bn = br[c];
          if (bn != ORI_SKIP) hr[bn] += vr[c];
        }
      }
      __syncwarp();
      for (int b = lane; b < n_bins; b += 32) {
        float acc = 0.0f;
        for (int r = 0; r < n; ++r) acc = acc + rows[r * nb1 + b];
        if constexpr (PEAKS) raw[b] = acc;
        hrow[b] = acc;
      }
      __syncwarp();
      if constexpr (PEAKS) {
        // smoothing + peaks, in the op order of ops/orientation.py
        float* arow = ang + (long long)k * n_peaks;
        float hmax = __uint_as_float(0xff800000u);  // -inf: a lane past n_bins holds no bin
        for (int b = lane; b < n_bins; b += 32) {
          int m2 = n_bins > 1 ? ori_wrap(b - 2, n_bins) : 0;
          int p2 = n_bins > 1 ? ori_wrap(b + 2, n_bins) : 0;
          float rm2 = raw[m2], rp2 = raw[p2];
          float rm1 = raw[ori_wrap(b - 1, n_bins)], rp1 = raw[ori_wrap(b + 1, n_bins)];
          sm[b] = (rm2 + rp2) * 0.0625f + (rm1 + rp1) * 0.25f + raw[b] * 6.0f / 16.0f;
          hmax = fmaxf(hmax, sm[b]);
        }
        for (int o = 16; o > 0; o >>= 1) hmax = fmaxf(hmax, __shfl_xor_sync(ORI_FULL, hmax, o));
        __syncwarp();
        float thr = hmax * ratio;
        float nb = (float)n_bins;
        float binw = 360.0f / nb;
        int cnt = 0;
        for (int b0 = 0; b0 < n_bins; b0 += 32) {
          int b = b0 + lane;
          bool pk = false;
          float out = 0.0f;
          if (b < n_bins) {
            float hm = sm[ori_wrap(b - 1, n_bins)], hp = sm[ori_wrap(b + 1, n_bins)];
            pk = sm[b] > hm && sm[b] > hp && sm[b] >= thr;
            if (pk) {
              float interp = (hm - hp) / (hm - 2.0f * sm[b] + hp);
              float bin_f = (float)b + 0.5f * interp;
              bin_f = bin_f < 0.0f ? nb + bin_f : (bin_f >= nb ? bin_f - nb : bin_f);
              out = 360.0f - binw * bin_f;
            }
          }
          unsigned bal = __ballot_sync(ORI_FULL, pk);
          int rank = cnt + __popc(bal & ((1u << lane) - 1u));
          if (pk && rank < n_peaks) arow[rank] = out;
          cnt += __popc(bal);
        }
        if (lane >= cnt && lane < n_peaks) arow[lane] = 0.0f;
        if (lane == 0) npk[k] = cnt;
        __syncwarp();
      }
    }
  }
}

static std::mutex ori_launch_mu;  // the launch-size caches below

template <typename T, bool PEAKS>
static int launch_orientation_t(const T* gauss, int n_planes, int Hp, int Wp,
                                const int* plane, const int* y, const int* x,
                                const float* scale, const unsigned char* live,
                                const int* count, float* hist, float* ang, int* npk, int K,
                                int h, int w, int pad, int n_bins, int n_peaks, int r_max,
                                float radius_factor, float lambda_ori, float ratio,
                                float bstep, cudaStream_t stream) {
  void (*kern)(const T*, int, int, int, const int*, const int*, const int*, const float*,
               const unsigned char*, const int*, float*, float*, int*, int, int, int, int,
               int, int, int, float, float, float, float) = orientation_kernel<T, PEAKS>;
  int smem = ORI_WARPS * ori_warp_floats(n_bins) * (int)sizeof(float);
  // the grid the card holds at once (no more than one warp per lane), with
  // all of the SM's shared memory; asked once per device and size for each
  // instantiation (the queries cost more host time than a launch), under a
  // lock, since host threads may launch at once
  static int known_dev = -1, known_smem = -1, known_fit = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  std::unique_lock<std::mutex> lock(ori_launch_mu);
  if (dev != known_dev || smem != known_smem) {
    int rc = (int)cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       100);
    if (!rc && smem > 48 * 1024)
      rc = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     smem);
    if (rc) return rc;
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, ORI_WARPS * 32, smem);
    known_fit = sms * (per_sm > 0 ? per_sm : 1);
    known_dev = dev;
    known_smem = smem;
  }
  int fit = known_fit;
  lock.unlock();
  int need = (K + ORI_WARPS - 1) / ORI_WARPS;
  kern<<<need < fit ? need : fit, ORI_WARPS * 32, smem, stream>>>(
      gauss, n_planes, Hp, Wp, plane, y, x, scale, live, count, hist, ang, npk, K, h, w, pad,
      n_bins, n_peaks, r_max, radius_factor, lambda_ori, ratio, bstep);
  return (int)cudaGetLastError();
}

// One launch of the instantiation for gauss_t and PEAKS.
template <bool PEAKS>
static int launch_orientation(const void* gauss, int gauss_t, int n_planes, int Hp, int Wp,
                              const int* plane, const int* y, const int* x,
                              const float* scale, const unsigned char* live,
                              const int* count, float* hist, float* ang, int* npk, int K,
                              int h, int w, int pad, int n_bins, int n_peaks, int r_max,
                              float radius_factor, float lambda_ori, float ratio,
                              float bstep, cudaStream_t stream) {
  if (n_bins < 1 || n_bins > MAX_BINS || n_peaks > MAX_PEAKS || r_max < 0 ||
      r_max > R_ORI_MAX || (gauss_t != SIFT_F32 && gauss_t != SIFT_BF16))
    return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  if (gauss_t == SIFT_BF16)
    return launch_orientation_t<bf16, PEAKS>(
        (const bf16*)gauss, n_planes, Hp, Wp, plane, y, x, scale, live, count, hist, ang, npk,
        K, h, w, pad, n_bins, n_peaks, r_max, radius_factor, lambda_ori, ratio, bstep,
        stream);
  return launch_orientation_t<float, PEAKS>(
      (const float*)gauss, n_planes, Hp, Wp, plane, y, x, scale, live, count, hist, ang, npk,
      K, h, w, pad, n_bins, n_peaks, r_max, radius_factor, lambda_ori, ratio, bstep, stream);
}

// K5: gauss (n_planes, Hp, Wp) of type gauss_t (f32 or bf16); plane/y/x (K,)
// int32 (y, x unpadded octave coordinates; each clamped to its range, as
// the plain version clamps); scale (K,) f32; live (K,) bool (one byte) ->
// hist (K, n_bins) raw f32, ang (K, n_peaks) f32, npk (K,) int32. Dead
// lanes get zeros.
SIFT_EXPORT int sift_orientation(const void* gauss, int gauss_t, int n_planes, int Hp, int Wp,
                                 const int* plane, const int* y, const int* x,
                                 const float* scale, const unsigned char* live, float* hist,
                                 float* ang, int* npk, int K, int h, int w, int pad,
                                 int n_bins, int n_peaks, float radius_factor,
                                 float lambda_ori, float ratio, float bstep,
                                 cudaStream_t stream) {
  return launch_orientation<true>(gauss, gauss_t, n_planes, Hp, Wp, plane, y, x, scale, live,
                                  nullptr, hist, ang, npk, K, h, w, pad, n_bins, n_peaks,
                                  R_ORI_MAX, radius_factor, lambda_ori, ratio, bstep, stream);
}

// K5': the same with lane i live iff i < *count (count: one int32 on the
// device).
SIFT_EXPORT int sift_orientation_prefix(const void* gauss, int gauss_t, int n_planes, int Hp,
                                        int Wp,
                                        const int* plane, const int* y, const int* x,
                                        const float* scale, const int* count,
                                        float* hist, float* ang, int* npk, int K, int h,
                                        int w, int pad, int n_bins, int n_peaks,
                                        float radius_factor, float lambda_ori,
                                        float ratio, float bstep, cudaStream_t stream) {
  return launch_orientation<true>(gauss, gauss_t, n_planes, Hp, Wp, plane, y, x, scale,
                                  nullptr, count, hist, ang, npk, K, h, w, pad, n_bins,
                                  n_peaks, R_ORI_MAX, radius_factor, lambda_ori, ratio, bstep,
                                  stream);
}

// K8: raw histograms only, lane i live iff i < *count (one int32 on the
// device), windows of half-width <= r_max. gauss (n_planes, Hp, Wp) of type
// gauss_t; plane/y/x (K,) int32, the plane already clamped into the stack by
// the wrapper (this entry has no plane count; y and x are clamped here as
// in K5); scale (K,) f32 -> hist (K, n_bins) raw f32, zero for lanes >=
// count.
SIFT_EXPORT int sift_orientation_perkey(const void* gauss, int gauss_t, int Hp, int Wp,
                                        const int* plane, const int* y, const int* x,
                                        const float* scale, const int* count, float* hist,
                                        int K, int h, int w, int pad, int n_bins, int r_max,
                                        float radius_factor, float lambda_ori, float bstep,
                                        cudaStream_t stream) {
  if (pad < r_max + 1) return (int)cudaErrorInvalidValue;
  return launch_orientation<false>(gauss, gauss_t, INT_MAX, Hp, Wp, plane, y, x, scale,
                                   nullptr, count, hist, nullptr, nullptr, K, h, w, pad,
                                   n_bins, 0, r_max, radius_factor, lambda_ori, 0.0f, bstep,
                                   stream);
}
