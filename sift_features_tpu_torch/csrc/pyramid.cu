// K1: whole-octave Gaussian blur chain + DoG over the padded plane, and K9:
// one level of that chain per call.
//
// Replaces the TPU kernel sift_features_tpu/ops/pallas/pyramid_kernel.py:
// build_octave_fused (_octave_kernel). Same arithmetic: each level is a
// horizontal then a vertical ascending tap sum (one f32 multiply and one f32
// add per tap), chained over the reflect-padded plane of the octave base, and
// DoG_k = L_{k+1} - L_k. Edge rule: a tap that falls outside the padded plane
// reads 0. (The TPU kernel's strip-roll wrap instead poisons the outer ring;
// both differ only in the outermost cumulative-radius ring of the 56-px pad,
// which nothing reads.)
//
// Bound on the H100: memory. The work is ~2 * sum(ksize) flops per pixel and
// level, far below the bytes it moves. At octave 0 of the 1080p B=4 batch the
// least traffic is 4 input planes + 32 output planes of 2304x4096 f32
// (~1.36 GB, ~0.4 ms at 3.35 TB/s). This first design is one launch per pass
// (H then V per level), one thread per output pixel, with the H result in a
// scratch plane: it moves ~4 planes per level instead of ~1.6, and relies on
// L1/L2 for the tap re-reads. Keeping the chain on chip (shared-memory row
// strips with the cumulative halo, as the TPU kernel does in VMEM) is later
// work.
//
// K9 replaces sift_features_tpu/ops/pallas/pyramid_kernel.py:_call_level
// (driven level by level by build_octave_padded, the per-frame path's
// octave construction): one H pass and one V pass (which also writes the
// DoG) from a given source plane into a given Gaussian slot and DoG slot.
// Same two kernels as K1, so a chain of K9 calls equals K1 bit for bit;
// its bound per level is one plane read and two written.
#include "common.cuh"

#define MAX_TAPS 64

struct Taps {
  float t[MAX_TAPS];
  int n;
};

__global__ void hpass_kernel(const float* __restrict__ src, long long src_fs,
                             float* __restrict__ dst, int Hp, int Wp, Taps taps) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  int f = blockIdx.z;
  if (x >= Wp) return;
  const float* row = src + f * src_fs + (long long)y * Wp;
  int r = taps.n / 2;
  float acc = 0.0f;
  for (int j = 0; j < taps.n; ++j) {
    int c = x + j - r;
    float v = (c >= 0 && c < Wp) ? row[c] : 0.0f;
    float term = taps.t[j] * v;
    acc = (j == 0) ? term : acc + term;
  }
  dst[(long long)f * Hp * Wp + (long long)y * Wp + x] = acc;
}

__global__ void vpass_kernel(const float* __restrict__ tmp,
                             const float* __restrict__ prev, long long prev_fs,
                             float* __restrict__ out, long long out_fs,
                             float* __restrict__ dog, long long dog_fs,
                             int Hp, int Wp, Taps taps) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  int f = blockIdx.z;
  if (x >= Wp) return;
  const float* col = tmp + (long long)f * Hp * Wp + x;
  int r = taps.n / 2;
  float acc = 0.0f;
  for (int j = 0; j < taps.n; ++j) {
    int rr = y + j - r;
    float v = (rr >= 0 && rr < Hp) ? col[(long long)rr * Wp] : 0.0f;
    float term = taps.t[j] * v;
    acc = (j == 0) ? term : acc + term;
  }
  long long o = (long long)y * Wp + x;
  out[f * out_fs + o] = acc;
  dog[f * dog_fs + o] = acc - prev[f * prev_fs + o];
}

// base (B, Hp, Wp); gauss (B, n_keep, Hp, Wp) = levels 1..n_keep;
// extra (B, n_levels - n_keep, Hp, Wp) = the deeper levels (chain scratch);
// dog (B, n_levels, Hp, Wp); tmp (B, Hp, Wp) the H-pass scratch.
// taps_all: n_levels * MAX_TAPS host floats; ksizes: n_levels host ints.
SIFT_EXPORT int sift_octave_fused(const float* base, float* gauss, float* extra,
                                  float* dog, float* tmp, int B, int Hp, int Wp,
                                  int n_keep, int n_levels, const float* taps_all,
                                  const int* ksizes, cudaStream_t stream) {
  long long plane = (long long)Hp * Wp;
  dim3 block(256);
  dim3 grid((Wp + 255) / 256, Hp, B);
  const float* prev = base;
  long long prev_fs = plane;
  for (int l = 1; l <= n_levels; ++l) {
    Taps taps;
    taps.n = ksizes[l - 1];
    if (taps.n > MAX_TAPS || taps.n < 1) return (int)cudaErrorInvalidValue;
    for (int j = 0; j < taps.n; ++j) taps.t[j] = taps_all[(l - 1) * MAX_TAPS + j];
    float* out;
    long long out_fs;
    if (l <= n_keep) {
      out = gauss + (l - 1) * plane;
      out_fs = (long long)n_keep * plane;
    } else {
      out = extra + (l - 1 - n_keep) * plane;
      out_fs = (long long)(n_levels - n_keep) * plane;
    }
    hpass_kernel<<<grid, block, 0, stream>>>(prev, prev_fs, tmp, Hp, Wp, taps);
    vpass_kernel<<<grid, block, 0, stream>>>(tmp, prev, prev_fs, out, out_fs,
                                             dog + (l - 1) * plane,
                                             (long long)n_levels * plane, Hp, Wp, taps);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    prev = out;
    prev_fs = out_fs;
  }
  return (int)cudaGetLastError();
}

// K9: one level. prev (B frames at stride prev_fs) -> out (stride out_fs),
// dog = out - prev (stride dog_fs); tmp (B, Hp, Wp) the H-pass scratch;
// taps: ksize host floats.
SIFT_EXPORT int sift_octave_level(const float* prev, long long prev_fs, float* out,
                                  long long out_fs, float* dog, long long dog_fs,
                                  float* tmp, int B, int Hp, int Wp, const float* taps_in,
                                  int ksize, cudaStream_t stream) {
  if (ksize > MAX_TAPS || ksize < 1) return (int)cudaErrorInvalidValue;
  Taps taps;
  taps.n = ksize;
  for (int j = 0; j < ksize; ++j) taps.t[j] = taps_in[j];
  dim3 block(256);
  dim3 grid((Wp + 255) / 256, Hp, B);
  hpass_kernel<<<grid, block, 0, stream>>>(prev, prev_fs, tmp, Hp, Wp, taps);
  vpass_kernel<<<grid, block, 0, stream>>>(tmp, prev, prev_fs, out, out_fs, dog, dog_fs,
                                           Hp, Wp, taps);
  return (int)cudaGetLastError();
}
