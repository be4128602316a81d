// K3, K4, K10 and K11: Newton refinement of DoG extrema (lib.rs:508-653).
//
// K3 (sift_refine_walk) replaces the TPU kernel
// sift_features_tpu/ops/pallas/refine_walk_kernel.py:refine_walk_tpu
// (_kernel): the whole <= max_interpolation_steps loop in one launch.
// K4 (sift_refine_step) replaces ops/pallas/refine_kernel.py:
// refine_step_pallas (_kernel): one masked Newton step, driven step by step
// from Python (refine_mode="step"). K10 (sift_refine_region) and K11
// (sift_refine_tile) are the region and tile modes; their notes are at
// their kernels below. All four run the same __device__ function
// `newton_at`, whose f32 operations follow ops/extrema.py:_newton_from_cubes
// in order, so all equal the plain version bit for bit.
//
// Bound on the H100: latency, not bytes or flops. Each candidate reads its
// 27-value cube (108 B) per step and does ~150 flops; a 1080p B=4 octave 0
// has at most 131072 candidate lanes, ~14 MB of cube reads in all. One
// thread per candidate reads its cube straight from the flat DoG
// (B * (S+2), H_pad, W_pad) through L1/L2, with the frame's plane offset.
// Reading from global memory has no window limit, so unlike the TPU walk
// kernel (whose region windows let ~1.4% of walks escape to K4) this K3
// never escapes: column 9 of its rows is always 0.
//
// A bf16 DoG (storage_dtype "bfloat16") goes to K4 alone, as the JAX
// dispatch sends a non-f32 stack to the step loop in every refine_mode
// (ops/extrema.py:refine_tpu_auto; the walk, region and tile kernels assert
// f32). `newton_at` is a template on the stack type and widens each cube
// value to f32 at the load; only K4 is built for bf16.
#include "common.cuh"

#include <limits.h>

struct NewtonParams {
  float contrast_threshold;
  float edge_threshold;
  float n_scales;  // scales_per_octave as f32
};

struct NewtonResult {
  bool ok;
  int step_s, step_y, step_x;
  float off_s, off_y, off_x, response;
  bool keep;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int step_of(float o) {
  // rust_round, clipped to +-1e9 before the int cast (ops/extrema.py)
  float r = rust_round(o);
  r = fminf(fmaxf(r, -0x1.dcd65p+29f), 0x1.dcd65p+29f);
  return (int)r;
}

// Cube centred at (plane p, row y, column x) of a stack with plane size
// `plane` and row length Wp; the caller keeps the cube inside the stack.
template <typename T>
__device__ NewtonResult newton_at(const T* __restrict__ dog, long long plane,
                                  int Wp, int p, int y, int x, NewtonParams prm) {
  const T* c0 = dog + (long long)p * plane + (long long)y * Wp + x;
#define C(ds, dy, dx) to_f32(c0[((ds)-1) * plane + ((dy)-1) * Wp + ((dx)-1)])
  const float two = 2.0f, four = 4.0f;
  float v = C(1, 1, 1);
  float v2 = v * two;
  float g1 = (C(2, 1, 1) - C(0, 1, 1)) / two;
  float g2 = (C(1, 2, 1) - C(1, 0, 1)) / two;
  float g3 = (C(1, 1, 2) - C(1, 1, 0)) / two;
  float h11 = C(2, 1, 1) + C(0, 1, 1) - v2;
  float h12 = (C(2, 2, 1) - C(2, 0, 1) - C(0, 2, 1) + C(0, 0, 1)) / four;
  float h13 = (C(2, 1, 2) - C(2, 1, 0) - C(0, 1, 2) + C(0, 1, 0)) / four;
  float h22 = C(1, 2, 1) + C(1, 0, 1) - v2;
  float h33 = C(1, 1, 2) + C(1, 1, 0) - v2;
  float h23 = (C(1, 2, 2) - C(1, 2, 0) - C(1, 0, 2) + C(1, 0, 0)) / four;
#undef C
  float det = h11 * h22 * h33 - h11 * h23 * h23 - h12 * h12 * h33
              + two * h12 * h13 * h23 - h13 * h13 * h22;
  float hinv11 = (h22 * h33 - h23 * h23) / det;
  float hinv12 = (h13 * h23 - h12 * h33) / det;
  float hinv13 = (h12 * h23 - h13 * h22) / det;
  float hinv22 = (h11 * h33 - h13 * h13) / det;
  float hinv23 = (h12 * h13 - h11 * h23) / det;
  float hinv33 = (h11 * h22 - h12 * h12) / det;
  float off_s = -(hinv11 * g1 + hinv12 * g2 + hinv13 * g3);
  float off_x = -(hinv13 * g1 + hinv23 * g2 + hinv33 * g3);
  float off_y = -(hinv12 * g1 + hinv22 * g2 + hinv23 * g3);
  NewtonResult r;
  // ok is taken before NaN offsets are zeroed (a NaN compares false)
  r.ok = fabsf(off_s) < 0.5f && fabsf(off_x) < 0.5f && fabsf(off_y) < 0.5f;
  if (off_s != off_s) off_s = 0.0f;
  if (off_y != off_y) off_y = 0.0f;
  if (off_x != off_x) off_x = 0.0f;
  float interp = off_s * g1 + off_y * g2 + off_x * g3;
  float contrast = v + interp / two;
  bool keep_c = fabsf(contrast) * prm.n_scales > prm.contrast_threshold;
  float tr = h33 + h22;
  float edet = h33 * h22 - h23 * h23;
  float thr = prm.edge_threshold;
  float thr1 = thr + 1.0f;
  bool on_edge = (edet <= 0.0f) || ((tr * tr * thr) > (thr1 * thr1) * edet);
  r.off_s = off_s;
  r.off_y = off_y;
  r.off_x = off_x;
  r.response = fabsf(contrast);
  r.keep = keep_c && !on_edge;
  r.step_s = step_of(off_s);
  r.step_y = step_of(off_y);
  r.step_x = step_of(off_x);
  return r;
}

// K4: rows (K, 16) = ok | step_s | step_y | step_x | off_s | off_y | off_x |
// response | keep | 0...; all zero where active == 0. p/y/x are clamped
// into [1, n_planes-2] x [1, Hp-2] x [1, Wp-2] like the plain gather.
template <typename T>
__global__ void refine_step_kernel(const T* __restrict__ dog, int n_planes,
                                   int Hp, int Wp, const int* __restrict__ p,
                                   const int* __restrict__ y,
                                   const int* __restrict__ x,
                                   const int* __restrict__ active,
                                   float* __restrict__ out, int K,
                                   NewtonParams prm) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  float* row = out + (long long)k * 16;
  float vals[16];
  for (int j = 0; j < 16; ++j) vals[j] = 0.0f;
  if (active[k]) {
    NewtonResult r = newton_at(dog, (long long)Hp * Wp, Wp,
                               clampi(p[k], 1, n_planes - 2),
                               clampi(y[k], 1, Hp - 2), clampi(x[k], 1, Wp - 2), prm);
    vals[0] = r.ok ? 1.0f : 0.0f;
    vals[1] = (float)r.step_s;
    vals[2] = (float)r.step_y;
    vals[3] = (float)r.step_x;
    vals[4] = r.off_s;
    vals[5] = r.off_y;
    vals[6] = r.off_x;
    vals[7] = r.response;
    vals[8] = r.keep ? 1.0f : 0.0f;
  }
  for (int j = 0; j < 16; ++j) row[j] = vals[j];
}

// K3: rows (K, 16) = ok | s | y | x | off_s | off_y | off_x | response |
// keep | escaped (0) | 0...; result columns 4-8 are zero where the lane did
// not converge. Positions are padded coordinates; the lane's DoG plane is
// clamp(s, 1, n_scales) + plane_off[k]. The bookkeeping is that of
// ops/extrema.py:refine (lib.rs:525-603): a lane converges when all three
// offsets are < 0.5, otherwise moves by the rounded offsets and dies when
// it leaves [border, size - border) or the scale range [1, n_scales].
__global__ void refine_walk_kernel(const float* __restrict__ dog, int n_planes,
                                   int Hp, int Wp, const int* __restrict__ s0,
                                   const int* __restrict__ y0,
                                   const int* __restrict__ x0,
                                   const int* __restrict__ valid,
                                   const int* __restrict__ plane_off,
                                   float* __restrict__ out, int K, int pad, int h,
                                   int w, int border, int n_scales, int max_steps,
                                   NewtonParams prm) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  int s = s0[k], y = y0[k], x = x0[k];
  bool conv = false, dead = !valid[k];
  float fields[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  long long plane = (long long)Hp * Wp;
  for (int it = 0; it < max_steps && !(conv || dead); ++it) {
    int p = clampi(clampi(s, 1, n_scales) + plane_off[k], 1, n_planes - 2);
    NewtonResult r = newton_at(dog, plane, Wp, p, clampi(y, 1, Hp - 2),
                               clampi(x, 1, Wp - 2), prm);
    if (r.ok) {
      conv = true;
      fields[0] = r.off_s;
      fields[1] = r.off_y;
      fields[2] = r.off_x;
      fields[3] = r.response;
      fields[4] = r.keep ? 1.0f : 0.0f;
    } else {
      s += r.step_s;
      y += r.step_y;
      x += r.step_x;
      dead = s < 1 || s > n_scales || x - pad < border || x - pad >= w - border ||
             y - pad < border || y - pad >= h - border;
    }
  }
  float* row = out + (long long)k * 16;
  row[0] = conv ? 1.0f : 0.0f;
  row[1] = (float)s;
  row[2] = (float)y;
  row[3] = (float)x;
  for (int j = 0; j < 5; ++j) row[4 + j] = fields[j];
  for (int j = 9; j < 16; ++j) row[j] = 0.0f;
}

// dog (n_planes, Hp, Wp) of type dog_t (f32 or bf16).
SIFT_EXPORT int sift_refine_step(const void* dog, int dog_t, int n_planes, int Hp,
                                 int Wp, const int* p, const int* y, const int* x,
                                 const int* active, float* out, int K,
                                 float contrast_threshold, float edge_threshold,
                                 float n_scales, cudaStream_t stream) {
  if (dog_t != SIFT_F32 && dog_t != SIFT_BF16) return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  NewtonParams prm{contrast_threshold, edge_threshold, n_scales};
  if (dog_t == SIFT_BF16)
    refine_step_kernel<bf16><<<(K + 127) / 128, 128, 0, stream>>>(
        (const bf16*)dog, n_planes, Hp, Wp, p, y, x, active, out, K, prm);
  else
    refine_step_kernel<float><<<(K + 127) / 128, 128, 0, stream>>>(
        (const float*)dog, n_planes, Hp, Wp, p, y, x, active, out, K, prm);
  return (int)cudaGetLastError();
}

SIFT_EXPORT int sift_refine_walk(const float* dog, int n_planes, int Hp, int Wp,
                                 const int* s0, const int* y0, const int* x0,
                                 const int* valid, const int* plane_off, float* out,
                                 int K, int pad, int h, int w, int border,
                                 int n_scales, int max_steps,
                                 float contrast_threshold, float edge_threshold,
                                 cudaStream_t stream) {
  if (K == 0) return 0;
  NewtonParams prm{contrast_threshold, edge_threshold, (float)n_scales};
  refine_walk_kernel<<<(K + 127) / 128, 128, 0, stream>>>(
      dog, n_planes, Hp, Wp, s0, y0, x0, valid, plane_off, out, K, pad, h, w,
      border, n_scales, max_steps, prm);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K10 (sift_refine_region): one Newton step for all candidates, with the
// cube windows of co-located candidates shared. Replaces
// ops/pallas/refine_region_kernel.py:_region_call (via refine_step_region,
// _kernel), refine_mode="region".
//
// The wrapper (ops/kernels/refine.py) sorts the active lanes stably by the
// JAX region key (plane, 8-row band, 128-column band of the clamped
// position; inactive lanes last) and marks where each region's run starts,
// on the card with no host sync. One block serves one run: it takes the
// bounding box of its candidates' positions (at most 8 x 128 cells, one
// plane), stages the cube window of that box on planes s-1..s+1 in shared
// memory once (at most 3 x 10 x 130 f32, 15.6 KB), and each of its threads
// runs `newton_at` on that window for one candidate, writing the row to the
// candidate's original index. Blocks past the run count exit at once.
// Staging only the box keeps the bytes near K4's when a region holds one
// or two candidates, the common case: chip_smoke.py counts 25,366 active
// lanes in 21,761 runs at the 1080p B=4 octave 0.
//
// The result equals K4's rows for the same inputs, bit for bit in every
// column, non-finite offsets included (no sanitising: the TPU kernel zeroes
// non-finite fields for its one-hot matmuls, which this kernel has not).
// Clamps are K4's: y in [1, Hp-2]. The JAX kernel clamps y to [1, Hp-16]
// (its 16-row DMA window); the two differ only for positions below row
// Hp-16, which an active lane never reaches (it lies inside the image
// border, at least PAD_DESC = 56 rows above the bottom of the stack).
//
// Bound on the H100: like K4, latency of the few reads per candidate; the
// staged box adds one pass over at most 3 x 10 x 130 f32 per region.
#define REGION_THREADS 128
#define REGION_ROWS 8
#define REGION_COLS 128

__global__ void __launch_bounds__(REGION_THREADS) refine_region_kernel(
    const float* __restrict__ dog, int Hp, int Wp, const int* __restrict__ sp,
    const int* __restrict__ yp, const int* __restrict__ xp,
    const int* __restrict__ perm, const int* __restrict__ run_start,
    const int* __restrict__ n_runs, const int* __restrict__ n_active,
    float* __restrict__ out, NewtonParams prm) {
  __shared__ float win[3 * (REGION_ROWS + 2) * (REGION_COLS + 2)];
  __shared__ int box[4];
  const int b = blockIdx.x, t = threadIdx.x;
  const int nr = *n_runs;
  if (b >= nr) return;
  const int start = run_start[b];
  const int end = b + 1 < nr ? run_start[b + 1] : *n_active;
  if (t == 0) {
    box[0] = INT_MAX;
    box[1] = INT_MIN;
    box[2] = INT_MAX;
    box[3] = INT_MIN;
  }
  __syncthreads();
  int ymn = INT_MAX, ymx = INT_MIN, xmn = INT_MAX, xmx = INT_MIN;
  for (int j = start + t; j < end; j += blockDim.x) {
    ymn = min(ymn, yp[j]);
    ymx = max(ymx, yp[j]);
    xmn = min(xmn, xp[j]);
    xmx = max(xmx, xp[j]);
  }
  atomicMin(&box[0], ymn);
  atomicMax(&box[1], ymx);
  atomicMin(&box[2], xmn);
  atomicMax(&box[3], xmx);
  __syncthreads();
  const int y0 = box[0] - 1, x0 = box[2] - 1;
  const int rows = box[1] - box[0] + 3, cols = box[3] - box[2] + 3;
  const int per_plane = rows * cols;
  const long long plane = (long long)Hp * Wp;
  const float* src = dog + (long long)(sp[start] - 1) * plane + (long long)y0 * Wp + x0;
  for (int i = t; i < 3 * per_plane; i += blockDim.x) {
    int p = i / per_plane;
    int rem = i - p * per_plane;
    int r = rem / cols;
    win[i] = src[p * plane + (long long)r * Wp + (rem - r * cols)];
  }
  __syncthreads();
  for (int j = start + t; j < end; j += blockDim.x) {
    NewtonResult r = newton_at(win, per_plane, cols, 1, yp[j] - y0, xp[j] - x0, prm);
    float* row = out + (long long)perm[j] * 16;
    row[0] = r.ok ? 1.0f : 0.0f;
    row[1] = (float)r.step_s;
    row[2] = (float)r.step_y;
    row[3] = (float)r.step_x;
    row[4] = r.off_s;
    row[5] = r.off_y;
    row[6] = r.off_x;
    row[7] = r.response;
    row[8] = r.keep ? 1.0f : 0.0f;
    for (int c = 9; c < 16; ++c) row[c] = 0.0f;
  }
}

// dog (n_planes, Hp, Wp); sp/yp/xp/perm (K,) int32: the clamped positions
// of the lanes in region order and their original indices; run_start
// (n_blocks,) int32; n_runs and n_active: one int32 each on the device.
// out (K, 16) must hold zeros: rows of inactive lanes are not written.
SIFT_EXPORT int sift_refine_region(const float* dog, int Hp, int Wp, const int* sp,
                                   const int* yp, const int* xp, const int* perm,
                                   const int* run_start, const int* n_runs,
                                   const int* n_active, float* out, int n_blocks,
                                   float contrast_threshold, float edge_threshold,
                                   float n_scales, cudaStream_t stream) {
  if (n_blocks == 0) return 0;
  NewtonParams prm{contrast_threshold, edge_threshold, n_scales};
  refine_region_kernel<<<n_blocks, REGION_THREADS, 0, stream>>>(
      dog, Hp, Wp, sp, yp, xp, perm, run_start, n_runs, n_active, out, prm);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K11 (sift_refine_tile): the whole <= max_interpolation_steps walk of a
// block of tile-grouped candidates from a shared-memory window. Replaces
// ops/pallas/refine_tile_kernel.py:_refine_tile_call (via refine_tile_tpu,
// _kernel), refine_mode="tile".
//
// utils/region_group.py groups the candidates by (frame, 32-row x 64-column
// region) and pads each region to blocks of bk slots. One block stages the
// window of its region on ALL S+2 DoG planes, the region plus an 8-cell
// margin on every side, (S+2) x 48 x 80 f32 = 76,800 B for S = 3. Then each
// slot's thread walks its candidate with `newton_at` on that window, with
// K3's bookkeeping, and writes the final row. A walk that moves outside
// the window's interior [1, LR-2] x [1, LW-2] stops and sets column 9
// (escaped); refine_tile (ops/kernels/refine.py) re-refines escaped lanes
// from their original positions with the K4 loop and merges them
// (merge_escaped). A block with no real candidate exits at once; rows of
// empty slots stay zero.
//
// Geometry: the TPU window (5 x 160 x 768 f32, 2.4 MB of VMEM) does not fit
// in the 227 KB of shared memory a block may use. A 32 x 64 region with an
// 8-cell margin keeps two blocks on an SM (2 x 76.8 KB) and a margin wider
// than the usual walk (steps of one cell, at most 5); a larger region would
// share each window among more candidates but leave one block per SM. The
// TPU kernel also escapes any |step| > 7, the limit of its 4-bit step
// field; this kernel stores no packed field, so it has no such rule.
//
// Bound on the H100: the window bytes. Each block reads (S+2) x LR x LW
// f32 for its <= bk candidates, several times the cubes they need: the
// price of serving the walk from shared memory. The walk itself is K3's.
#define TILE_THREADS 256

__global__ void __launch_bounds__(TILE_THREADS) refine_tile_kernel(
    const float* __restrict__ dog, int Hp, int Wp, const int* __restrict__ s_slot,
    const int* __restrict__ y_slot, const int* __restrict__ x_slot,
    const int* __restrict__ a_slot, const int* __restrict__ r0_b,
    const int* __restrict__ c0_b, const int* __restrict__ pb_b,
    const int* __restrict__ active_b, float* __restrict__ out, int bk, int LR,
    int LW, int pad, int h, int w, int border, int n_scales, int max_steps,
    NewtonParams prm) {
  extern __shared__ float win[];  // (n_scales + 2, LR, LW)
  const int blk = blockIdx.x;
  if (active_b[blk] == 0) return;
  const int r0 = r0_b[blk], c0 = c0_b[blk];
  const int per_plane = LR * LW;
  const long long plane = (long long)Hp * Wp;
  const float* src = dog + (long long)pb_b[blk] * plane + (long long)r0 * Wp + c0;
  for (int i = threadIdx.x; i < (n_scales + 2) * per_plane; i += blockDim.x) {
    int p = i / per_plane;
    int rem = i - p * per_plane;
    int r = rem / LW;
    win[i] = src[p * plane + (long long)r * Wp + (rem - r * LW)];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < bk; k += blockDim.x) {
    const long long i = (long long)blk * bk + k;
    float vals[16];
    for (int j = 0; j < 16; ++j) vals[j] = 0.0f;
    if (a_slot[i]) {
      int s = s_slot[i], y = y_slot[i], x = x_slot[i];
      bool conv = false, dead = false, esc = false;
      float fields[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int it = 0; it < max_steps && !(conv || dead || esc); ++it) {
        NewtonResult r = newton_at(win, per_plane, LW, clampi(s, 1, n_scales),
                                   clampi(y - r0, 1, LR - 2), clampi(x - c0, 1, LW - 2),
                                   prm);
        if (r.ok) {
          conv = true;
          fields[0] = r.off_s;
          fields[1] = r.off_y;
          fields[2] = r.off_x;
          fields[3] = r.response;
          fields[4] = r.keep ? 1.0f : 0.0f;
        } else {
          s += r.step_s;
          y += r.step_y;
          x += r.step_x;
          dead = s < 1 || s > n_scales || x - pad < border || x - pad >= w - border ||
                 y - pad < border || y - pad >= h - border;
          esc = !dead && (y - r0 < 1 || y - r0 > LR - 2 || x - c0 < 1 || x - c0 > LW - 2);
        }
      }
      vals[0] = conv ? 1.0f : 0.0f;
      vals[1] = (float)s;
      vals[2] = (float)y;
      vals[3] = (float)x;
      for (int j = 0; j < 5; ++j) vals[4 + j] = fields[j];
      vals[9] = esc ? 1.0f : 0.0f;
    }
    float* row = out + i * 16;
    for (int j = 0; j < 16; ++j) row[j] = vals[j];
  }
}

// dog (n_planes, Hp, Wp); slot arrays (n_blocks * bk,) int32 and block
// arrays (n_blocks,) int32 of utils/region_group.py:group_by_region; out
// (n_blocks * bk, 16) must hold zeros (empty blocks write nothing).
SIFT_EXPORT int sift_refine_tile(const float* dog, int Hp, int Wp, const int* s_slot,
                                 const int* y_slot, const int* x_slot, const int* a_slot,
                                 const int* r0_b, const int* c0_b, const int* pb_b,
                                 const int* active_b, float* out, int n_blocks, int bk,
                                 int LR, int LW, int pad, int h, int w, int border,
                                 int n_scales, int max_steps, float contrast_threshold,
                                 float edge_threshold, cudaStream_t stream) {
  if (n_blocks == 0) return 0;
  size_t smem = (size_t)(n_scales + 2) * LR * LW * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      refine_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  NewtonParams prm{contrast_threshold, edge_threshold, (float)n_scales};
  refine_tile_kernel<<<n_blocks, TILE_THREADS, smem, stream>>>(
      dog, Hp, Wp, s_slot, y_slot, x_slot, a_slot, r0_b, c0_b, pb_b, active_b, out, bk,
      LR, LW, pad, h, w, border, n_scales, max_steps, prm);
  return (int)cudaGetLastError();
}
