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
// Summation order (deterministic, no atomics): window row r sums its
// samples over columns in ascending order into its own histogram row, then
// each bin sums the rows in ascending order; the plain version does the
// same.
//
// The window bound is asserted in the kernel: a live keypoint whose radius
// exceeds r_max traps (device-side assert) instead of being cut silently.
//
// Bound on the H100: operations of the per-sample math, not bytes. Each live
// keypoint reads at most (2 r + 3)^2 <= 81^2 floats, mostly from L2, and
// writes 128; each in-radius sample costs ~100 f32 operations (one atan2,
// one f64 exp, one sqrt and the trilinear split), each an FMA issue slot
// when built with --fmad=false (33.5 T/s on the H100).
//
// Design: one block of DESC_THREADS per keypoint lane, dead lanes exiting at
// once. The window's rows go in chunks of at most CHUNK_ROWS (balanced: 51
// rows are 26 + 25), the columns of a chunk in tiles of CHUNK_COLS, and each
// tile runs in two phases:
//  A. all threads compute the per-sample records of the tile, flattened
//     over (row, column): the rotation, the grid and image tests, and for
//     the samples inside them the weight, magnitude, orientation bin and
//     fractions (the f64 exp, the atan2 and the sqrt), with exactly the
//     expressions of the plain version. A record is 4 floats (the row and
//     column fractions, m (1 - u_ori) and m u_ori) and the packed bins;
//  B. one thread per row (one warp) applies its row's records in ascending
//     column order into its histogram row: 16 cheap operations and 8 bin
//     updates per sample, each corner formed as (u_row * u_col) * (m *
//     u_ori) as the TPU kernel does, the 8 bins read before any is written.
// After the last tile of a chunk, thread b adds the chunk's rows to bin b in
// ascending order, keeping the running sum in a register.
// What this does about the limits of a thread-per-row design (35-77 of 128
// threads busy, each with the whole per-sample math): every thread computes
// the expensive per-sample math;
// the valid samples of a window row form one run of columns (the rotated
// grid and the image interior are convex and the f32 rotation is monotone
// along a row), so the warps of phase A diverge only at the ends of a run;
// shared memory is 27 KB whatever the radius (one histogram row per window
// row took 41 KB at R_DESC_MAX), so eight blocks share an SM; the
// orientation wrap takes a compare and a subtraction (wrap360), not fmodf.
// What holds it back: phase B, one warp per block whose 8 read-modify-
// writes per sample meet bank conflicts in the histogram rows, then the
// per-sample math.
//
// The Gaussian planes may be f32 or bf16 (the storage modes): K6 and K7 are
// templates on the plane type and widen each sample to f32 at the load
// (K7 as it stages its window), which is exact.
#include "common.cuh"

#include <assert.h>

#define DESC_THREADS 128
#define MAX_D 128
#define CHUNK_ROWS 32
#define CHUNK_COLS 16
#define REC_VALID (1u << 31)

// (deg + 360) mod 360 for deg = atan2_f32(gy, gx) * rad2deg, so a = deg +
// 360 lies in [180, 541): Python's (and torch.remainder's) a mod 360 is a
// for a < 360 and fmodf(a, 360) = a - 360 above, which f32 subtraction
// gives exactly (Sterbenz's lemma: 360 / 2 <= a <= 2 * 360). Same bits as
// the plain version's torch.remainder, with no fmodf.
__device__ __forceinline__ float wrap360(float a) {
  return a >= 360.0f ? a - 360.0f : a;
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

struct Lane {
  int y, x, ri, n;  // rounded position, radius, window side 2 ri + 1
  float orientation, sin_s, cos_s;
};

// Phase A for one sample (dy, dx) of a lane: its record, or REC_VALID clear
// when it lies outside the image interior or the rotated 4x4 grid. g points
// at the lane's centre sample in a plane of row stride `stride`.
template <typename T>
__device__ __forceinline__ void sample_record(const T* g, int stride, int dy, int dx,
                                              const Lane& ln, int h, int w,
                                              const DescParams& prm, float4* rec,
                                              unsigned* bins) {
  const int n_hist = prm.n_hist, n_bins = prm.n_bins;
  const float half = (float)n_hist * 0.5f;
  const float hi_bin = (float)n_hist + 0.5f;
  int yy = ln.y + dy, xx = ln.x + dx;
  float dxf = (float)dx, dyf = (float)dy;
  float col_rot = dxf * ln.cos_s - dyf * ln.sin_s;
  float row_rot = dxf * ln.sin_s + dyf * ln.cos_s;
  float row_bin = row_rot + half;
  float col_bin = col_rot + half;
  if (!(yy > 0 && yy < h - 1 && xx > 0 && xx < w - 1 && row_bin > -0.5f &&
        row_bin < hi_bin && col_bin > -0.5f && col_bin < hi_bin)) {
    *bins = 0;
    return;
  }
  const T* p = g + (long long)dy * stride + dx;
  float w2 = col_rot * col_rot + row_rot * row_rot;
  float weight = exp_f32_via_f64(w2 * prm.wscale);
  float gx = to_f32(p[1]) - to_f32(p[-1]);
  float gy = to_f32(p[-stride]) - to_f32(p[stride]);
  float mag = sqrtf(gx * gx + gy * gy);
  float deg = atan2_f32(gy, gx) * prm.rad2deg;
  float ori_norm = wrap360(deg + 360.0f) - ln.orientation;
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
  *rec = make_float4(rfr, cfr, m * (1.0f - ofr), m * ofr);
  *bins = REC_VALID | (unsigned)r1 | ((unsigned)c1 << 4) | ((unsigned)of << 8) |
          ((unsigned)of1 << 16);
}

// Phase B for one record: its (at most 8) bin updates of one row's
// histogram acc (D bins and a spare slot acc[D]), corners (row, column) in
// order, orientation bins of then of1. The 8 bins of one sample are
// distinct, so all 8 are read before any is written and the reads overlap;
// a corner outside the grid updates the spare slot, which nothing reads.
__device__ __forceinline__ void apply_record(float4 rec, unsigned bins, int n_hist,
                                             int n_bins, int D, float* acc) {
  int r1 = bins & 15, c1 = (bins >> 4) & 15;
  int of = (bins >> 8) & 255, of1 = (bins >> 16) & 255;
  float ur[2] = {1.0f - rec.x, rec.x};
  float uc[2] = {1.0f - rec.y, rec.y};
  int idx[8];
  float add[8], v[8];
#pragma unroll
  for (int dr = 0; dr < 2; ++dr)
#pragma unroll
    for (int dc = 0; dc < 2; ++dc) {
      int rr = r1 + dr, cc = c1 + dc, e = 2 * (2 * dr + dc);
      bool in = rr >= 1 && rr <= n_hist && cc >= 1 && cc <= n_hist;
      int base = ((rr - 1) * n_hist + (cc - 1)) * n_bins;
      float wrc = ur[dr] * uc[dc];
      idx[e] = in ? base + of : D;
      idx[e + 1] = in ? base + of1 : D;
      add[e] = wrc * rec.z;
      add[e + 1] = wrc * rec.w;
    }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = acc[idx[e]];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[idx[e]] = v[e] + add[e];
}

// Shared memory of describe_lane: a CHUNK_ROWS x CHUNK_COLS tile of
// records (float4 + packed bins, rows padded to REC_STRIDE against bank
// conflicts) and CHUNK_ROWS histogram rows of D + 1 floats: the D bins and
// the spare slot apply_record writes for corners outside the grid.
#define REC_STRIDE (CHUNK_COLS + 1)
__host__ __device__ __forceinline__ size_t desc_smem(int D) {
  return (size_t)CHUNK_ROWS * (REC_STRIDE * (sizeof(float4) + sizeof(unsigned)) +
                               (D + 1) * sizeof(float));
}

// The raw histogram of one live lane into hrow (D floats), by the whole
// block; smem as desc_smem(D). g: the lane's centre sample, row stride
// `stride`. The window's rows go in chunks of at most CHUNK_ROWS (one
// thread each in phase B), the columns of a chunk in tiles of CHUNK_COLS.
template <typename T>
__device__ void describe_lane(const T* g, int stride, const Lane& ln, int h, int w,
                              const DescParams& prm, char* smem, float* __restrict__ hrow) {
  const int D = prm.n_hist * prm.n_hist * prm.n_bins;
  float4* recs = (float4*)smem;
  unsigned* bins = (unsigned*)(recs + CHUNK_ROWS * REC_STRIDE);
  float* rows = (float*)(bins + CHUNK_ROWS * REC_STRIDE);  // CHUNK_ROWS x (D + 1)
  const int hs = D + 1;
  const int t = threadIdx.x, n = ln.n;
  // rows per chunk, balanced over the chunks
  const int n_chunks = (n + CHUNK_ROWS - 1) / CHUNK_ROWS;
  const int chunk = (n + n_chunks - 1) / n_chunks;
  float total = 0.0f;
  for (int row0 = 0; row0 < n; row0 += chunk) {
    const int nr = min(chunk, n - row0);
    for (int i = t; i < nr * hs; i += blockDim.x) rows[i] = 0.0f;
    for (int col0 = 0; col0 < n; col0 += CHUNK_COLS) {
      const int nc = min(CHUNK_COLS, n - col0);
      for (int i = t; i < nr * nc; i += blockDim.x) {
        int lr = i / nc, c = i - lr * nc;
        sample_record(g, stride, row0 + lr - ln.ri, col0 + c - ln.ri, ln, h, w, prm,
                      recs + lr * REC_STRIDE + c, bins + lr * REC_STRIDE + c);
      }
      __syncthreads();
      if (t < nr) {
        // the next record is read before this one's bins are written
        float* acc = rows + t * hs;
        const float4* rrow = recs + t * REC_STRIDE;
        const unsigned* brow = bins + t * REC_STRIDE;
        float4 rec = rrow[0];
        unsigned bc = brow[0];
        for (int c = 0; c < nc; ++c) {
          int cn = min(c + 1, nc - 1);
          float4 rec_n = rrow[cn];
          unsigned bc_n = brow[cn];
          if (bc & REC_VALID) apply_record(rec, bc, prm.n_hist, prm.n_bins, D, acc);
          rec = rec_n;
          bc = bc_n;
        }
      }
      __syncthreads();
    }
    if (t < D)
      for (int r = 0; r < nr; ++r) total = total + rows[r * hs + t];
    __syncthreads();
  }
  if (t < D) hrow[t] = total;
}

__device__ __forceinline__ void zero_row(float* hrow, int D) {
  for (int b = threadIdx.x; b < D; b += blockDim.x) hrow[b] = 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(DESC_THREADS) descriptor_kernel(
    const T* __restrict__ gauss, int Hp, int Wp, const int* __restrict__ plane,
    const int* __restrict__ ys, const int* __restrict__ xs,
    const float* __restrict__ scales, const float* __restrict__ angles,
    const int* __restrict__ live, const int* __restrict__ count,
    float* __restrict__ hist, int h, int w, int pad, int r_max, DescParams prm) {
  extern __shared__ float4 smem4[];
  const int D = prm.n_hist * prm.n_hist * prm.n_bins;
  int k = blockIdx.x;
  float* hrow = hist + (long long)k * D;
  if (count ? k >= *count : !live[k]) {
    zero_row(hrow, D);
    return;
  }
  Lane ln;
  ln.ri = descriptor_lane(scales[k], angles[k], prm, r_max, &ln.orientation, &ln.sin_s,
                          &ln.cos_s);
  ln.n = 2 * ln.ri + 1;
  ln.y = ys[k];
  ln.x = xs[k];
  const T* g = gauss + (long long)plane[k] * Hp * Wp + (long long)(ln.y + pad) * Wp + pad + ln.x;
  describe_lane(g, Wp, ln, h, w, prm, (char*)smem4, hrow);
}

static int launch_descriptor(const void* gauss, int gauss_t, int Hp, int Wp,
                             const int* plane, const int* y, const int* x,
                             const float* scale, const float* angle, const int* live,
                             const int* count, float* hist, int M, int h, int w, int pad,
                             int r_max, DescParams prm, cudaStream_t stream) {
  int D = prm.n_hist * prm.n_hist * prm.n_bins;
  if (D > MAX_D || prm.n_hist > 15 || r_max < 0 ||
      (gauss_t != SIFT_F32 && gauss_t != SIFT_BF16))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  size_t smem = desc_smem(D);
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
// The block stages the keypoint's (2 r_max + 3)^2 window (<= 81 x 81 f32,
// 26 KB) in shared memory with coalesced row reads, then runs K6's two
// phases (describe_lane) on it, so its raw rows equal K6's bit for bit. With
// the chunk buffers the block takes up to 26 KB + 33 KB of dynamic shared
// memory, sized by the bucket's r_max.
//
// Bound on the H100: as K6, the operations of the per-sample math.
template <typename T>
__global__ void __launch_bounds__(DESC_THREADS) descriptor_perkey_kernel(
    const T* __restrict__ gauss, int Hp, int Wp, const int* __restrict__ plane,
    const int* __restrict__ ys, const int* __restrict__ xs,
    const float* __restrict__ scales, const float* __restrict__ angles,
    const int* __restrict__ count, float* __restrict__ hist, int h, int w, int pad,
    int r_max, DescParams prm) {
  extern __shared__ float4 smem4[];
  const int D = prm.n_hist * prm.n_hist * prm.n_bins;
  const int wn = 2 * r_max + 3;
  char* chunk = (char*)smem4;                                // desc_smem(D)
  float* win = (float*)(chunk + desc_smem(D));  // (wn, wn)
  int k = blockIdx.x;
  float* hrow = hist + (long long)k * D;
  if (k >= *count) {
    zero_row(hrow, D);
    return;
  }
  Lane ln;
  ln.ri = descriptor_lane(scales[k], angles[k], prm, r_max, &ln.orientation, &ln.sin_s,
                          &ln.cos_s);
  ln.n = 2 * ln.ri + 1;
  ln.y = ys[k];
  ln.x = xs[k];
  const T* g0 = gauss + (long long)plane[k] * Hp * Wp +
                (long long)(ln.y + pad - r_max - 1) * Wp + (ln.x + pad - r_max - 1);
  for (int i = threadIdx.x; i < wn * wn; i += blockDim.x)
    win[i] = to_f32(g0[(i / wn) * Wp + i % wn]);
  __syncthreads();
  describe_lane(win + (r_max + 1) * wn + r_max + 1, wn, ln, h, w, prm, chunk, hrow);
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
  if (D > MAX_D || n_hist > 15 || r_max < 0 || pad < r_max + 1 ||
      (gauss_t != SIFT_F32 && gauss_t != SIFT_BF16))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  size_t smem = desc_smem(D) + (size_t)(2 * r_max + 3) * (2 * r_max + 3) * sizeof(float);
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
