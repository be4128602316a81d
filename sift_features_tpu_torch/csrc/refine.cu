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
// in order, so all equal the plain version bit for bit; K3 and K11 also
// share the walk around it (`newton_walk`).
//
// Design on the H100: one thread per candidate (K3, K4, K10) or per slot
// (K11), blocks of 128 threads, each reading its 27-value cube straight
// from the flat DoG (B * (S+2), H_pad, W_pad) through L1/L2, with the
// frame's plane offset. None stages a window in shared memory: the TPU
// kernels shared one DMA'd VMEM window among co-located candidates, but on
// this card a candidate's cube is 108 B against a window of kilobytes, and
// candidates that sit in neighbouring threads (K10's region order, K11's
// slot order) share cache lines anyway. K3, K10 and K11 write each row
// with four 16-byte stores (`store_row`): as 16 scalar stores, each store
// instruction of a warp touched 32 rows 64 bytes apart, and the vector
// stores halved K3's device time (0.031 -> 0.016 ms per 1080p B=4 octave-0
// launch, NVIDIA H100 80GB HBM3, 700 W). K4 stages a warp's rows and writes
// them 512 contiguous bytes a store (`store_rows_warp`).
//
// Bound on the H100: the bytes, each read and written once. A candidate
// reads, per step, the 19 values of its cube that a Newton step uses (the
// centre, the 6 faces and the 12 edges: 76 B; the 8 corners are unused) and
// its inputs, and writes a 64-byte row; ~150 flops a step. A 1080p B=4
// octave 0 has at most 131072 candidate lanes. Reading from global memory
// has no window limit, so unlike the TPU walk kernel (whose region windows
// let ~1.4% of walks escape to K4) K3 never escapes: column 9 of its rows
// is always 0.
//
// A bf16 DoG (storage_dtype "bfloat16") goes to K4 alone, as the JAX
// dispatch sends a non-f32 stack to the step loop in every refine_mode
// (ops/extrema.py:refine_tpu_auto; the walk, region and tile kernels assert
// f32). `newton_at` is a template on the stack type and widens each cube
// value to f32 at the load (exact); only K4 is built for bf16.
#include "common.cuh"

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

// The row of one Newton step: ok | step_s | step_y | step_x | off_s |
// off_y | off_x | response | keep | 0...
__device__ __forceinline__ void step_row(const NewtonResult& r, float vals[16]) {
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

// One 64-byte row as four 16-byte stores (rows are 64-byte aligned: the
// wrappers' outputs are fresh (n, 16) f32 tensors).
__device__ __forceinline__ void store_row(float* __restrict__ row, const float v[16]) {
  float4* r4 = reinterpret_cast<float4*>(row);
  r4[0] = make_float4(v[0], v[1], v[2], v[3]);
  r4[1] = make_float4(v[4], v[5], v[6], v[7]);
  r4[2] = make_float4(v[8], v[9], v[10], v[11]);
  r4[3] = make_float4(v[12], v[13], v[14], v[15]);
}

// The rows of a warp's 32 threads, thread j's row k (k = the warp's first
// row + j, rows past K not written), in blocks of 128 threads: staged in
// shared memory (2 KB a warp), then written as 16-byte stores of 32
// neighbouring threads, 512 contiguous bytes a store instruction. Row r
// holds its four 16-byte quarters q at r * 4 + ((q + r / 2) & 3), so
// neither the writes nor the reads of a quarter-warp meet in a bank. Every
// thread of the warp must call it.
__device__ __forceinline__ void store_rows_warp(float* __restrict__ out, int k, int K,
                                                const float v[16]) {
  __shared__ float4 stage[4][128];
  const int lane = threadIdx.x & 31;
  float4* st = stage[threadIdx.x >> 5];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    st[lane * 4 + ((q + (lane >> 1)) & 3)] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  __syncwarp();
  const long long k0 = (long long)k - lane;
  float4* o = reinterpret_cast<float4*>(out + k0 * 16);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int g = q * 32 + lane, r = g >> 2;
    if (k0 + r < K) o[g] = st[r * 4 + (((g & 3) + (r >> 1)) & 3)];
  }
}

// K4: rows (K, 16) = ok | step_s | step_y | step_x | off_s | off_y | off_x |
// response | keep | 0...; all zero where active[k] == 0. active is one byte
// a lane (the refine loop's bool mask, passed as it is); an inactive lane
// reads nothing else. p/y/x are clamped into [1, n_planes-2] x [1, Hp-2] x
// [1, Wp-2] like the plain gather. One thread per lane over ceil(K / 128)
// blocks; each warp writes its rows with `store_rows_warp`. With `store_row`
// (four 16-byte stores a thread, each store instruction of the warp 32
// rows 64 bytes apart) K4 took 2-14% more device time at the 1080p B=4
// octave 0 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// Bound on the H100: the bytes. Every lane's mask byte and row (65 B) and
// each active lane's position (12 B) and the 19 cube values it reads (76 B
// f32, 38 B bf16).
template <typename T>
__global__ void __launch_bounds__(128) refine_step_kernel(
    const T* __restrict__ dog, int n_planes, int Hp, int Wp, const int* __restrict__ p,
    const int* __restrict__ y, const int* __restrict__ x,
    const unsigned char* __restrict__ active, float* __restrict__ out, int K,
    NewtonParams prm) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  float vals[16];
  for (int c = 0; c < 16; ++c) vals[c] = 0.0f;
  if (k < K && active[k])
    step_row(newton_at(dog, (long long)Hp * Wp, Wp, clampi(p[k], 1, n_planes - 2),
                       clampi(y[k], 1, Hp - 2), clampi(x[k], 1, Wp - 2), prm),
             vals);
  store_rows_warp(out, k, K, vals);
}

// Where a walk reads its cubes: DoG plane clamp(clamp(s, 1, n_scales) +
// pbase, plo, phi), row clamp(y, ylo, yhi), column clamp(x, xlo, xhi).
struct WalkBox {
  int pbase, plo, phi, ylo, yhi, xlo, xhi;
};

// One candidate's whole walk from (s, y, x), with the bookkeeping of
// ops/extrema.py:refine (lib.rs:525-603): it converges when all three
// offsets are < 0.5, otherwise moves by the rounded offsets and dies when
// it leaves [border, size - border) or the scale range [1, n_scales]. A
// walk that is not `live` does not move. A walk that has not died also
// stops, and sets column 9 (escaped), when it moves outside [ylo, yhi] x
// [xlo, xhi]: K11's window interior. K3's box is the stack's interior, which
// holds every position inside the image border, so a K3 walk never escapes.
// vals: ok | s | y | x | off_s | off_y | off_x | response | keep | escaped |
// 0...; columns 4-8 are zero where the walk did not converge.
__device__ __forceinline__ void newton_walk(const float* __restrict__ dog,
                                            long long plane, int Wp, int s, int y,
                                            int x, bool live, WalkBox box, int pad,
                                            int h, int w, int border, int n_scales,
                                            int max_steps, NewtonParams prm,
                                            float vals[16]) {
  bool conv = false, dead = !live, esc = false;
  float fields[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int it = 0; it < max_steps && !(conv || dead || esc); ++it) {
    int p = clampi(clampi(s, 1, n_scales) + box.pbase, box.plo, box.phi);
    NewtonResult r = newton_at(dog, plane, Wp, p, clampi(y, box.ylo, box.yhi),
                               clampi(x, box.xlo, box.xhi), prm);
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
      esc = !dead && (y < box.ylo || y > box.yhi || x < box.xlo || x > box.xhi);
    }
  }
  vals[0] = conv ? 1.0f : 0.0f;
  vals[1] = (float)s;
  vals[2] = (float)y;
  vals[3] = (float)x;
  for (int j = 0; j < 5; ++j) vals[4 + j] = fields[j];
  vals[9] = esc ? 1.0f : 0.0f;
  for (int j = 10; j < 16; ++j) vals[j] = 0.0f;
}

// K3: rows (K, 16) of `newton_walk` from (s0, y0, x0), live where valid;
// positions are padded coordinates, the DoG plane clamp(s, 1, n_scales) +
// plane_off[k] kept in [1, n_planes-2] and the position in the stack's
// interior, so the walk never escapes. valid is one byte a lane (the
// extractor's bool mask, passed as it is: no cast kernel). A dead lane reads
// its mask byte and its start position, writes (0, s0, y0, x0, 0, ...) and
// reads no plane offset and no cube. One thread per lane over ceil(K / 128)
// blocks, each row written with `store_row`.
//
// Bound on the H100: the bytes. Every lane's mask byte, start position and
// row (77 B), each live lane's plane offset (4 B) and, each step, the 19
// cube values a Newton step reads (76 B an active lane). What sets its time
// is the walk (NVIDIA H100 80GB HBM3, 700 W, 1080p B=4 octave 0; PERF.md):
// with every lane dead it takes ~30% of the full time, the first step's
// cubes, scattered over the DoG in 32-byte sectors, ~40%, the four later
// dependent steps ~30%; the compiled code has a step's 19 loads in flight
// before their first use. Tried and dropped: writing a warp's rows through shared memory
// in 512-byte stores (`store_rows_warp`, 5% slower alone, faster only with
// every lane dead), every lane reading its plane offset (no faster), a
// warp fetching its lanes' cubes together, 27 lanes on one cube per
// cp.async (1.7x slower).
__global__ void __launch_bounds__(128) refine_walk_kernel(
    const float* __restrict__ dog, int n_planes, int Hp, int Wp,
    const int* __restrict__ s0, const int* __restrict__ y0, const int* __restrict__ x0,
    const unsigned char* __restrict__ valid, const int* __restrict__ plane_off,
    float* __restrict__ out, int K, int pad, int h, int w, int border, int n_scales,
    int max_steps, NewtonParams prm) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const bool live = valid[k] != 0;
  const WalkBox box{live ? plane_off[k] : 0, 1, n_planes - 2, 1, Hp - 2, 1, Wp - 2};
  float vals[16];
  newton_walk(dog, (long long)Hp * Wp, Wp, s0[k], y0[k], x0[k], live, box, pad, h, w,
              border, n_scales, max_steps, prm, vals);
  store_row(out + (long long)k * 16, vals);
}

// dog (n_planes, Hp, Wp) of type dog_t (f32 or bf16); p/y/x (K,) int32;
// active (K,) bool (one byte).
SIFT_EXPORT int sift_refine_step(const void* dog, int dog_t, int n_planes, int Hp,
                                 int Wp, const int* p, const int* y, const int* x,
                                 const unsigned char* active, float* out, int K,
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

// s0/y0/x0/plane_off (K,) int32; valid (K,) bool (one byte).
SIFT_EXPORT int sift_refine_walk(const float* dog, int n_planes, int Hp, int Wp,
                                 const int* s0, const int* y0, const int* x0,
                                 const unsigned char* valid, const int* plane_off,
                                 float* out,
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
// K10 (sift_refine_region): one Newton step for all candidates, taken in
// region order. Replaces ops/pallas/refine_region_kernel.py:_region_call
// (via refine_step_region, _kernel), refine_mode="region".
//
// The wrapper (ops/kernels/refine.py:region_order) sorts the lanes stably
// by the JAX region key (plane, 8-row band, 128-column band of the clamped
// position; inactive lanes last), on the card with no host sync. Thread j
// of ceil(K / 128) blocks takes the j-th lane of that order: if j is below
// the active count it runs `newton_at` on the DoG in global memory, and it
// writes the lane's row (zero for an inactive lane) to the lane's original
// index perm[j], so every row is written. The sort puts a region's lanes in
// neighbouring threads, whose cube loads then share cache lines.
//
// Why no window: the first design staged the bounding box of each region
// run in shared memory, one block per possible run, min(K, n_regions) =
// 131,072 blocks at the 1080p B=4 octave 0, for 25,366 active lanes in
// 21,761 runs (1.17 lanes a run): the grid and the three barriers of each
// block, not the bytes, set its time (0.143 ms, NVIDIA H100 80GB HBM3).
//
// The result equals K4's rows for the same inputs, bit for bit in every
// column, non-finite offsets included (no sanitising: the TPU kernel zeroes
// non-finite fields for its one-hot matmuls, which this kernel has not).
// Clamps are K4's: y in [1, Hp-2]. The JAX kernel clamps y to [1, Hp-16]
// (its 16-row DMA window); the two differ only for positions below row
// Hp-16, which an active lane never reaches (it lies inside the image
// border, at least PAD_DESC = 56 rows above the bottom of the stack).
//
// Bound on the H100: the bytes, as K4's: each lane's index and row
// (K x 68 B), and each active lane's clamped position and 19 cube values
// (88 B).
__global__ void __launch_bounds__(128) refine_region_kernel(
    const float* __restrict__ dog, int Hp, int Wp, const int* __restrict__ sp,
    const int* __restrict__ yp, const int* __restrict__ xp,
    const int* __restrict__ perm, const int* __restrict__ n_active,
    float* __restrict__ out, int K, NewtonParams prm) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= K) return;
  float vals[16];
  for (int c = 0; c < 16; ++c) vals[c] = 0.0f;
  if (j < *n_active)
    step_row(newton_at(dog, (long long)Hp * Wp, Wp, sp[j], yp[j], xp[j], prm), vals);
  store_row(out + (long long)perm[j] * 16, vals);
}

// dog (n_planes, Hp, Wp); sp/yp/xp/perm (K,) int32: the clamped positions
// of the lanes in region order (active lanes first) and their original
// indices; n_active: one int32 on the device. Writes all K rows of out.
SIFT_EXPORT int sift_refine_region(const float* dog, int Hp, int Wp, const int* sp,
                                   const int* yp, const int* xp, const int* perm,
                                   const int* n_active, float* out, int K,
                                   float contrast_threshold, float edge_threshold,
                                   float n_scales, cudaStream_t stream) {
  if (K == 0) return 0;
  NewtonParams prm{contrast_threshold, edge_threshold, n_scales};
  refine_region_kernel<<<(K + 127) / 128, 128, 0, stream>>>(
      dog, Hp, Wp, sp, yp, xp, perm, n_active, out, K, prm);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K11 (sift_refine_tile): the whole <= max_interpolation_steps walk of
// tile-grouped candidates, each walk held inside its block's window.
// Replaces ops/pallas/refine_tile_kernel.py:_refine_tile_call (via
// refine_tile_tpu, _kernel), refine_mode="tile".
//
// utils/region_group.py groups the candidates by (frame, 32-row x 64-column
// region) and pads each region to blocks of bk slots; block b's window is
// rows r0_b + [0, LR), columns c0_b + [0, LW) of DoG planes pb_b + [0, S+2),
// the region plus an 8-cell margin (48 x 80). One thread per slot over
// ceil(T_cap / 128) blocks: a slot of a block with no real candidate, or an
// empty slot, writes a zero row; a live slot walks its candidate with K3's
// `newton_walk`, its cubes read from the DoG in global memory at plane
// pb_b + clamp(s, 1, S) and position r0_b + clamp(y - r0_b, 1, LR-2),
// c0_b + clamp(x - c0_b, 1, LW-2): the values the window held at the same
// offsets, so the rows are those of a walk on the window. A walk that moves
// outside the window's interior [1, LR-2] x [1, LW-2] stops and sets
// column 9 (escaped); refine_tile (ops/kernels/refine.py) re-refines
// escaped lanes from their original positions with the K4 loop and merges
// them (merge_escaped). utils/region_group.py clamps every window into the
// stack, so no read leaves it (tests/test_torch_modes.py holds that).
//
// Why no window is staged: the first design copied each active block's
// window on all S+2 planes into shared memory, (S+2) x 48 x 80 f32 =
// 76.8 KB, to serve about two candidates with 16 of its 256 threads: at the
// 1080p B=4 octave 0, ~10^4 active blocks staged ~1 GB for walks that need
// ~3 MB of cubes (1.30 ms, NVIDIA H100 80GB HBM3). The slots of one region
// are neighbouring threads, so L1/L2 share their cube lines instead. The
// 48 x 80 window stays as the escape geometry, which the plain version and
// the tests share. The TPU kernel also escapes any |step| > 7, the limit of
// its 4-bit step field; this kernel stores no packed field, so it has no
// such rule.
//
// Bound on the H100: the bytes. Every slot's row, T_cap x 64 B, and every
// block's active count, nb x 4 B; each active block's slot flags and window
// origin, bk x 4 + 12 B; each live slot's (s, y, x), 12 B; and the walks'
// 19 cube values, 76 B a step. The rows of the empty slots (~94% of T_cap
// at 1080p) are most of it.
__global__ void __launch_bounds__(128) refine_tile_kernel(
    const float* __restrict__ dog, int Hp, int Wp, const int* __restrict__ s_slot,
    const int* __restrict__ y_slot, const int* __restrict__ x_slot,
    const int* __restrict__ a_slot, const int* __restrict__ r0_b,
    const int* __restrict__ c0_b, const int* __restrict__ pb_b,
    const int* __restrict__ active_b, float* __restrict__ out, int T, int bk, int LR,
    int LW, int pad, int h, int w, int border, int n_scales, int max_steps,
    NewtonParams prm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T) return;
  const int blk = i / bk;
  float vals[16];
  for (int j = 0; j < 16; ++j) vals[j] = 0.0f;
  if (active_b[blk] != 0 && a_slot[i] != 0) {
    const int r0 = r0_b[blk], c0 = c0_b[blk], pb = pb_b[blk];
    const WalkBox box{pb, pb + 1, pb + n_scales, r0 + 1, r0 + LR - 2, c0 + 1, c0 + LW - 2};
    newton_walk(dog, (long long)Hp * Wp, Wp, s_slot[i], y_slot[i], x_slot[i], true, box,
                pad, h, w, border, n_scales, max_steps, prm, vals);
  }
  store_row(out + (long long)i * 16, vals);
}

// dog (n_planes, Hp, Wp); slot arrays (n_blocks * bk,) int32 and block
// arrays (n_blocks,) int32 of utils/region_group.py:group_by_region. Writes
// all n_blocks * bk rows of out.
SIFT_EXPORT int sift_refine_tile(const float* dog, int Hp, int Wp, const int* s_slot,
                                 const int* y_slot, const int* x_slot, const int* a_slot,
                                 const int* r0_b, const int* c0_b, const int* pb_b,
                                 const int* active_b, float* out, int n_blocks, int bk,
                                 int LR, int LW, int pad, int h, int w, int border,
                                 int n_scales, int max_steps, float contrast_threshold,
                                 float edge_threshold, cudaStream_t stream) {
  const int T = n_blocks * bk;
  if (T == 0) return 0;
  NewtonParams prm{contrast_threshold, edge_threshold, (float)n_scales};
  refine_tile_kernel<<<(T + 127) / 128, 128, 0, stream>>>(
      dog, Hp, Wp, s_slot, y_slot, x_slot, a_slot, r0_b, c0_b, pb_b, active_b, out, T,
      bk, LR, LW, pad, h, w, border, n_scales, max_steps, prm);
  return (int)cudaGetLastError();
}
