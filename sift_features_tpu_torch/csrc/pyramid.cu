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
// Storage modes (SiftConfig.storage_dtype / gather_dtype). The base may be
// f32 or bf16, and the Gaussian and DoG planes are stored as f32 or bf16,
// but the chain itself never rounds: every level is computed in f32 from the
// f32 value of the level before, as the TPU kernel keeps it in VMEM. A level
// whose stored plane is bf16 is therefore chained through an f32 scratch
// plane (two, used in turn), and a store rounds to nearest even. So the
// "split" mode's f32 DoG is bit-equal to the f32 mode's, and its `l3` output
// (level S in f32, the next octave's base) equals the f32 mode's level S.
// gather16 adds a bf16 copy of the stored Gaussian levels. In f32 storage
// the stored levels 1..S are the chain, and only level S+1 takes scratch
// (level S+2 feeds the last DoG and nothing else, so it is not stored).
//
// Bound on the H100: memory. The work is ~2 * sum(ksize) flops per pixel and
// level, far below the bytes it moves. At octave 0 of the 1080p B=4 batch the
// least traffic in f32 is 4 input planes + 32 output planes of 2304x4096 f32
// (~1.36 GB, ~0.4 ms at 3.35 TB/s); bf16 storage halves the stores. This
// first design is one launch per pass (H then V per level), one thread per
// output pixel, with the H result in a scratch plane: it moves ~4 planes per
// level instead of ~1.6, and relies on L1/L2 for the tap re-reads. Keeping
// the chain on chip (shared-memory row strips with the cumulative halo, as
// the TPU kernel does in VMEM) is later work.
//
// K9 replaces sift_features_tpu/ops/pallas/pyramid_kernel.py:_call_level
// (driven level by level by build_octave_padded and
// build_octave_padded_batched): one H pass and one V pass (which also writes
// the DoG) from a given source plane into a given Gaussian slot and DoG
// slot, for a batch of frames. Same two kernels as K1. Unlike K1, a K9 chain
// reads each level back from its stored slot, so in bf16 storage it rounds
// between levels, exactly as the TPU's per-level kernel does. In f32 a chain
// of K9 calls equals K1 bit for bit; its bound per level is one plane read
// and two written.
#include "common.cuh"

#define MAX_TAPS 64

struct Taps {
  float t[MAX_TAPS];
  int n;
};

template <typename Tin>
__global__ void hpass_kernel(const Tin* __restrict__ src, long long src_fs,
                             float* __restrict__ dst, int Hp, int Wp, Taps taps) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  int f = blockIdx.z;
  if (x >= Wp) return;
  const Tin* row = src + f * src_fs + (long long)y * Wp;
  int r = taps.n / 2;
  float acc = 0.0f;
  for (int j = 0; j < taps.n; ++j) {
    int c = x + j - r;
    float v = (c >= 0 && c < Wp) ? to_f32(row[c]) : 0.0f;
    float term = taps.t[j] * v;
    acc = (j == 0) ? term : acc + term;
  }
  dst[(long long)f * Hp * Wp + (long long)y * Wp + x] = acc;
}

// The outputs of a V pass besides the DoG, as a compile-time mask (a null
// test per store at run time measured slower on the H100).
#define OUT_CHAIN 1
#define OUT_GAUSS 2
#define OUT_G16 4

// The V pass of one level: the level's f32 value goes to `chain` (the plane
// the next level reads), rounded to Tg into `gauss` and to bf16 into `g16`,
// each when OUTS has it, and DoG = level - prev, rounded to Td.
template <typename Tp, typename Tg, typename Td, int OUTS>
__global__ void vpass_kernel(const float* __restrict__ tmp,
                             const Tp* __restrict__ prev, long long prev_fs,
                             float* __restrict__ chain, Tg* __restrict__ gauss,
                             long long gauss_fs, bf16* __restrict__ g16,
                             long long g16_fs, Td* __restrict__ dog, long long dog_fs,
                             int Hp, int Wp, Taps taps) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  int f = blockIdx.z;
  if (x >= Wp) return;
  long long plane = (long long)Hp * Wp;
  const float* col = tmp + (long long)f * plane + x;
  int r = taps.n / 2;
  float acc = 0.0f;
  for (int j = 0; j < taps.n; ++j) {
    int rr = y + j - r;
    float v = (rr >= 0 && rr < Hp) ? col[(long long)rr * Wp] : 0.0f;
    float term = taps.t[j] * v;
    acc = (j == 0) ? term : acc + term;
  }
  long long o = (long long)y * Wp + x;
  if (OUTS & OUT_CHAIN) chain[f * plane + o] = acc;
  if (OUTS & OUT_GAUSS) gauss[f * gauss_fs + o] = from_f32<Tg>(acc);
  if (OUTS & OUT_G16) g16[f * g16_fs + o] = __float2bfloat16_rn(acc);
  dog[f * dog_fs + o] = from_f32<Td>(acc - to_f32(prev[f * prev_fs + o]));
}

static size_t elem_size(int t) { return t == SIFT_BF16 ? 2 : 4; }

// vpass_kernel for the output sets K1 and K9 use: none (K1's last level),
// the chain alone, the Gaussian slot alone, both, the slot and its bf16 copy.
template <typename Tp, typename Tg, typename Td>
static cudaError_t launch_vpass(dim3 grid, dim3 block, cudaStream_t stream,
                                const float* tmp, const void* prev, long long prev_fs,
                                float* chain, void* gauss, long long gauss_fs,
                                bf16* g16, long long g16_fs, void* dog, long long dog_fs,
                                int Hp, int Wp, const Taps& taps) {
  int outs = (chain ? OUT_CHAIN : 0) | (gauss ? OUT_GAUSS : 0) | (g16 ? OUT_G16 : 0);
#define VPASS(OUTS)                                                                   \
  vpass_kernel<Tp, Tg, Td, OUTS><<<grid, block, 0, stream>>>(                          \
      tmp, (const Tp*)prev, prev_fs, chain, (Tg*)gauss, gauss_fs, g16, g16_fs,        \
      (Td*)dog, dog_fs, Hp, Wp, taps)
  switch (outs) {
    case 0: VPASS(0); break;
    case OUT_CHAIN: VPASS(OUT_CHAIN); break;
    case OUT_GAUSS: VPASS(OUT_GAUSS); break;
    case OUT_CHAIN | OUT_GAUSS: VPASS(OUT_CHAIN | OUT_GAUSS); break;
    case OUT_GAUSS | OUT_G16: VPASS(OUT_GAUSS | OUT_G16); break;
    default: return cudaErrorInvalidValue;
  }
#undef VPASS
  return cudaGetLastError();
}

// One level for B frames: prev (type prev_t, frame stride prev_fs) -> the
// outputs of vpass_kernel; tmp (B, Hp, Wp) f32 the H-pass scratch.
static cudaError_t launch_level(const void* prev, int prev_t, long long prev_fs,
                                float* tmp, float* chain, void* gauss, int g_t,
                                long long gauss_fs, bf16* g16, long long g16_fs,
                                void* dog, int d_t, long long dog_fs, int B, int Hp,
                                int Wp, const Taps& taps, cudaStream_t stream) {
  dim3 block(256);
  dim3 grid((Wp + 255) / 256, Hp, B);
  if (prev_t == SIFT_BF16)
    hpass_kernel<bf16><<<grid, block, 0, stream>>>((const bf16*)prev, prev_fs, tmp, Hp,
                                                   Wp, taps);
  else
    hpass_kernel<float><<<grid, block, 0, stream>>>((const float*)prev, prev_fs, tmp, Hp,
                                                    Wp, taps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
#define VPASS(TP, TG, TD)                                                             \
  launch_vpass<TP, TG, TD>(grid, block, stream, tmp, prev, prev_fs, chain, gauss,      \
                           gauss_fs, g16, g16_fs, dog, dog_fs, Hp, Wp, taps)
  switch ((prev_t << 2) | (g_t << 1) | d_t) {
    case 0: return VPASS(float, float, float);
    case 1: return VPASS(float, float, bf16);
    case 2: return VPASS(float, bf16, float);
    case 3: return VPASS(float, bf16, bf16);
    case 4: return VPASS(bf16, float, float);
    case 5: return VPASS(bf16, float, bf16);
    case 6: return VPASS(bf16, bf16, float);
    case 7: return VPASS(bf16, bf16, bf16);
    default: return cudaErrorInvalidValue;
  }
#undef VPASS
}

static bool valid_type(int t) { return t == SIFT_F32 || t == SIFT_BF16; }

// K1. base (B, Hp, Wp) of type base_t; gauss (B, n_keep, Hp, Wp) of type g_t
// = levels 1..n_keep; dog (B, n_levels, Hp, Wp) of type d_t; g16 (B, n_keep,
// Hp, Wp) bf16 or null; l3 (B, Hp, Wp) f32 or null: level n_keep in f32
// (only with bf16 gauss); scratch (n_scratch, B, Hp, Wp) f32: the chain's
// levels that no f32 output holds; tmp (B, Hp, Wp) f32 the H-pass scratch.
// taps_all: n_levels * MAX_TAPS host floats; ksizes: n_levels host ints.
SIFT_EXPORT int sift_octave_fused(const void* base, int base_t, void* gauss, int g_t,
                                  void* dog, int d_t, void* g16, float* l3,
                                  float* scratch, int n_scratch, float* tmp, int B,
                                  int Hp, int Wp, int n_keep, int n_levels,
                                  const float* taps_all, const int* ksizes,
                                  cudaStream_t stream) {
  if (!valid_type(base_t) || !valid_type(g_t) || !valid_type(d_t) ||
      (l3 && g_t == SIFT_F32))
    return (int)cudaErrorInvalidValue;
  long long plane = (long long)Hp * Wp;
  const void* prev = base;
  int prev_t = base_t;
  long long prev_fs = plane;
  int next_scratch = 0;
  for (int l = 1; l <= n_levels; ++l) {
    Taps taps;
    taps.n = ksizes[l - 1];
    if (taps.n > MAX_TAPS || taps.n < 1) return (int)cudaErrorInvalidValue;
    for (int j = 0; j < taps.n; ++j) taps.t[j] = taps_all[(l - 1) * MAX_TAPS + j];
    bool keep = l <= n_keep;
    void* gout = keep ? (char*)gauss + (size_t)(l - 1) * plane * elem_size(g_t) : nullptr;
    bf16* g16out = (keep && g16) ? (bf16*)g16 + (l - 1) * plane : nullptr;
    float* chain = nullptr;
    if (l < n_levels && !(keep && g_t == SIFT_F32)) {
      if (keep && l == n_keep && l3) {
        chain = l3;
      } else {
        if (n_scratch < 1) return (int)cudaErrorInvalidValue;
        chain = scratch + (long long)(next_scratch++ % n_scratch) * B * plane;
      }
      if ((const void*)chain == prev) return (int)cudaErrorInvalidValue;
    }
    cudaError_t e = launch_level(
        prev, prev_t, prev_fs, tmp, chain, gout, g_t, (long long)n_keep * plane, g16out,
        (long long)n_keep * plane, (char*)dog + (size_t)(l - 1) * plane * elem_size(d_t),
        d_t, (long long)n_levels * plane, B, Hp, Wp, taps, stream);
    if (e != cudaSuccess) return (int)e;
    if (chain) {
      prev = chain;
      prev_t = SIFT_F32;
      prev_fs = plane;
    } else {
      prev = gout;
      prev_t = g_t;
      prev_fs = (long long)n_keep * plane;
    }
  }
  return (int)cudaGetLastError();
}

// K9: one level for B frames. prev (type prev_t, frame stride prev_fs) ->
// out (type g_t, stride out_fs), g16 (bf16, stride g16_fs, or null), dog =
// out - prev before rounding (type d_t, stride dog_fs); tmp (B, Hp, Wp) the
// H-pass scratch; taps: ksize host floats.
SIFT_EXPORT int sift_octave_level(const void* prev, int prev_t, long long prev_fs,
                                  void* out, int g_t, long long out_fs, void* g16,
                                  long long g16_fs, void* dog, int d_t, long long dog_fs,
                                  float* tmp, int B, int Hp, int Wp, const float* taps_in,
                                  int ksize, cudaStream_t stream) {
  if (ksize > MAX_TAPS || ksize < 1 || !valid_type(prev_t) || !valid_type(g_t) ||
      !valid_type(d_t))
    return (int)cudaErrorInvalidValue;
  Taps taps;
  taps.n = ksize;
  for (int j = 0; j < ksize; ++j) taps.t[j] = taps_in[j];
  return (int)launch_level(prev, prev_t, prev_fs, tmp, nullptr, out, g_t, out_fs,
                           (bf16*)g16, g16_fs, dog, d_t, dog_fs, B, Hp, Wp, taps, stream);
}
