// K3 and K4: Newton refinement of DoG extrema (lib.rs:508-653).
//
// K3 (sift_refine_walk) replaces the TPU kernel
// sift_features_tpu/ops/pallas/refine_walk_kernel.py:refine_walk_tpu
// (_kernel): the whole <= max_interpolation_steps loop in one launch.
// K4 (sift_refine_step) replaces ops/pallas/refine_kernel.py:
// refine_step_pallas (_kernel): one masked Newton step, driven step by step
// from Python (refine_mode="step"). Both run the same __device__ function
// `newton_at`, whose f32 operations follow ops/extrema.py:_newton_from_cubes
// in order, so both equal the plain version bit for bit.
//
// Bound on the H100: latency, not bytes or flops. Each candidate reads its
// 27-value cube (108 B) per step and does ~150 flops; a 1080p B=4 octave 0
// has at most 131072 candidate lanes, ~14 MB of cube reads in all. One
// thread per candidate reads its cube straight from the flat DoG
// (B * (S+2), H_pad, W_pad) through L1/L2, with the frame's plane offset.
// Reading from global memory has no window limit, so unlike the TPU walk
// kernel (whose region windows let ~1.4% of walks escape to K4) this K3
// never escapes: column 9 of its rows is always 0.
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
__device__ NewtonResult newton_at(const float* __restrict__ dog, long long plane,
                                  int Wp, int p, int y, int x, NewtonParams prm) {
  const float* c0 = dog + (long long)p * plane + (long long)y * Wp + x;
#define C(ds, dy, dx) c0[((ds)-1) * plane + ((dy)-1) * Wp + ((dx)-1)]
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
__global__ void refine_step_kernel(const float* __restrict__ dog, int n_planes,
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

SIFT_EXPORT int sift_refine_step(const float* dog, int n_planes, int Hp, int Wp,
                                 const int* p, const int* y, const int* x,
                                 const int* active, float* out, int K,
                                 float contrast_threshold, float edge_threshold,
                                 float n_scales, cudaStream_t stream) {
  if (K == 0) return 0;
  NewtonParams prm{contrast_threshold, edge_threshold, n_scales};
  refine_step_kernel<<<(K + 127) / 128, 128, 0, stream>>>(dog, n_planes, Hp, Wp, p, y,
                                                          x, active, out, K, prm);
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
