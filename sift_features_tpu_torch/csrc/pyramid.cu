// K1: whole-octave Gaussian blur chain + DoG over the padded plane, and K9:
// one level of that chain per call. Both launch one fused level kernel per
// level.
//
// Replaces the TPU kernel sift_features_tpu/ops/pallas/pyramid_kernel.py:
// build_octave_fused (_octave_kernel). Same arithmetic: each level is a
// horizontal then a vertical ascending tap sum (one f32 multiply and one f32
// add per tap: acc = t0 * v0, then acc + t_j * v_j, j ascending, the order
// of ops/gaussian.py:tap_sum), chained over the reflect-padded plane of the
// octave base, and DoG_k = L_{k+1} - L_k. Edge rule: a tap that falls
// outside the padded plane reads 0. (The TPU kernel's strip-roll wrap
// instead poisons the outer ring; both differ only in the outermost
// cumulative-radius ring of the 56-px pad, which nothing reads.)
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
// Bound on the H100 at octave 0 of the 1080p B=4 batch (4 x 2304 x 4096,
// f32): bytes and operations bind alike. The least traffic is 1 + 3 + 5
// planes (1.36 GB, 0.41 ms at 3.35 TB/s). The operations are 89 taps x 2
// passes x (multiply + add) per pixel, 13.4 G f32 instructions; built with
// --fmad=false each takes a whole FMA issue slot, so 132 SMs x 128 lanes x
// 1.98 GHz (33.5 T/s) need 0.41 ms as well.
//
// Design: one launch per level. A block owns a TILE_W x tile_h output tile
// (128 x 64 for the default taps; `tile_h` is planned on the host,
// ops/kernels/pyramid.py:level_plan) and
//  1. stages the previous level's tile with a halo of r rows and
//     align4(r) columns in shared memory, widened to f32; a tap outside the
//     padded plane is staged as 0 (the edge rule). Tiles whose halo lies
//     inside the plane load 16 (f32) or 8 (bf16) bytes per thread and test
//     no bounds; only edge tiles mask;
//  2. runs the H pass of all tile_h + 2r rows into a second shared tile:
//     each thread 4 neighbouring outputs, every staged value read once (as
//     a float4) and used for all four;
//  3. runs the V pass from there, each thread PY = 8 outputs down a column,
//     every value read once for all eight, and writes chain / gauss / g16 /
//     dog under the compile-time OUTS mask; the DoG subtracts the staged
//     centre, so the previous level is read from device memory once.
// Every output keeps its own accumulator in the tap order above, so the
// result is bit-equal to the plain version. The radius is a template
// parameter for the radii of the default octave (5, 6, 8, 10, 13): the tap
// loops unroll and the taps become immediate operands. Any other radius up
// to MAX_RADIUS runs the same tiles with run-time tap loops.
//
// What it moves: the previous level once from device memory (plus the
// halo, from L2) and each output once, ~2.8 planes per level against ~5-6
// for an H pass and a V pass through an f32 scratch plane (151 MB at octave
// 0, which the level kernel does not need). Its operations: the H pass of
// the halo rows is done by both tiles that share them, (tile_h + 2r) /
// tile_h = 1.4x at r = 13.
//
// K9 replaces sift_features_tpu/ops/pallas/pyramid_kernel.py:_call_level
// (driven level by level by build_octave_padded and
// build_octave_padded_batched): one level from a given source plane into a
// given Gaussian slot and DoG slot, for a batch of frames, with the same
// level kernel. Unlike K1, a K9 chain reads each level back from its
// stored slot, so in bf16 storage it rounds between levels, exactly as the
// TPU's per-level kernel does. In f32 a chain of K9 calls equals K1 bit for
// bit; its bound per level is one plane read and two written.
#include "common.cuh"

#define MAX_RADIUS 31
#define MAX_TAPS (2 * MAX_RADIUS + 1)
#define TILE_W 128
#define LEVEL_THREADS 256
#define PY 8                 // outputs per thread down a column (V pass)
#define SMEM_LIMIT 232448    // shared memory a block may use on the H100

struct Taps {
  float t[MAX_TAPS];
  int n;
};

// The outputs of a level besides the DoG, as a compile-time mask (a null
// test per store at run time measured slower on the H100).
#define OUT_CHAIN 1
#define OUT_GAUSS 2
#define OUT_G16 4

// One level launch: prev (f32, or bf16 when prev_bf16; frame stride
// prev_fs) -> the outputs named by OUTS and the DoG. `vec`: prev's rows
// may be read as aligned 4-element vectors.
struct LevelArgs {
  const void* prev;
  int prev_bf16, vec;
  long long prev_fs;
  float* chain;
  void* gauss;
  long long gauss_fs;
  bf16* g16;
  long long g16_fs;
  void* dog;
  long long dog_fs;
  int Hp, Wp, tile_h;
};

__host__ __device__ __forceinline__ int align4(int r) { return (r + 3) & ~3; }

// Shared memory of one level block: the staged tile (tile_h + 2r rows of
// TILE_W + 2 align4(r) columns) and the H pass (tile_h + 2r rows of
// TILE_W), f32. ops/kernels/pyramid.py:level_plan computes the same.
static size_t level_smem(int tile_h, int r) {
  return (size_t)(tile_h + 2 * r) * (2 * TILE_W + 2 * align4(r)) * sizeof(float);
}

__device__ __forceinline__ float4 bf16x4_to_f32(uint2 u) {
  // exact: a bf16 is the high half of its f32
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// acc[k] gets tap `tap` of value v: the first tap sets it, the others add.
__device__ __forceinline__ void add_tap(float& acc, int tap, float t, float v) {
  acc = tap == 0 ? t * v : acc + t * v;
}

template <int R, typename Tg, typename Td, int OUTS>
__global__ void __launch_bounds__(LEVEL_THREADS) level_kernel(LevelArgs a, Taps taps) {
  extern __shared__ float4 smem4[];
  float* smem = (float*)smem4;
  const int r = R > 0 ? R : taps.n / 2;
  const int ra = align4(r);
  const int ws = TILE_W + 2 * ra;  // staged row stride, a multiple of 4
  const int tile_h = a.tile_h;
  const int rows = tile_h + 2 * r;
  float* src = smem;               // rows x ws: prev with its halo, f32
  float* hbuf = smem + rows * ws;  // rows x TILE_W: the H pass
  const int Hp = a.Hp, Wp = a.Wp;
  const int x0 = blockIdx.x * TILE_W, y0 = blockIdx.y * tile_h, f = blockIdx.z;
  const int tid = threadIdx.x;

  // 1. stage prev[y0 - r : y0 + tile_h + r, x0 - ra : x0 + TILE_W + ra]
  const bool inside = y0 - r >= 0 && y0 + tile_h + r <= Hp && x0 - ra >= 0 &&
                      x0 + TILE_W + ra <= Wp;
  const long long corner = f * a.prev_fs + (long long)(y0 - r) * Wp + (x0 - ra);
  if (inside && a.vec) {
    const int n4 = ws / 4;
    for (int i = tid; i < rows * n4; i += LEVEL_THREADS) {
      int row = i / n4, c4 = i - row * n4;
      long long g = corner + (long long)row * Wp + 4 * c4;
      float4 v = a.prev_bf16 ? bf16x4_to_f32(*(const uint2*)((const bf16*)a.prev + g))
                             : *(const float4*)((const float*)a.prev + g);
      *(float4*)(src + row * ws + 4 * c4) = v;
    }
  } else {
    for (int i = tid; i < rows * ws; i += LEVEL_THREADS) {
      int row = i / ws, c = i - row * ws;
      int gy = y0 - r + row, gx = x0 - ra + c;
      float v = 0.0f;
      if (gy >= 0 && gy < Hp && gx >= 0 && gx < Wp) {
        long long g = corner + (long long)row * Wp + c;
        v = a.prev_bf16 ? to_f32(((const bf16*)a.prev)[g]) : ((const float*)a.prev)[g];
      }
      src[i] = v;
    }
  }
  __syncthreads();

  // 2. H pass: output column c of a row sums src[row][c + ra - r + j]
  const int off = ra - r;
  for (int i = tid; i < rows * (TILE_W / 4); i += LEVEL_THREADS) {
    int row = i / (TILE_W / 4), g = i - row * (TILE_W / 4);
    const float* s = src + row * ws + 4 * g;
    float acc[4];
    if constexpr (R > 0) {
      constexpr int RA = (R + 3) & ~3;
#pragma unroll
      for (int ch = 0; ch < 1 + RA / 2; ++ch) {
        float4 v4 = *(const float4*)(s + 4 * ch);
        float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            constexpr int OFF = RA - R;
            int tap = 4 * ch + e - OFF - k;
            if (tap >= 0 && tap <= 2 * R) add_tap(acc[k], tap, taps.t[tap], v[e]);
          }
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        for (int j = 0; j < taps.n; ++j) add_tap(acc[k], j, taps.t[j], s[off + k + j]);
    }
    *(float4*)(hbuf + row * TILE_W + 4 * g) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
  __syncthreads();

  // 3. V pass: output row y of the tile sums hbuf[y + j][c], then the stores
  const bool store_inside = y0 + tile_h <= Hp && x0 + TILE_W <= Wp;
  const long long plane = (long long)Hp * Wp;
  Tg* gauss = (Tg*)a.gauss;
  Td* dog = (Td*)a.dog;
  for (int i = tid; i < TILE_W * (tile_h / PY); i += LEVEL_THREADS) {
    int c = i % TILE_W, q = i / TILE_W;
    const float* col = hbuf + q * PY * TILE_W + c;
    float acc[PY];
    if constexpr (R > 0) {
#pragma unroll
      for (int j = 0; j < PY + 2 * R; ++j) {
        float v = col[j * TILE_W];
#pragma unroll
        for (int k = 0; k < PY; ++k) {
          int tap = j - k;
          if (tap >= 0 && tap <= 2 * R) add_tap(acc[k], tap, taps.t[tap], v);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < PY; ++k)
        for (int j = 0; j < taps.n; ++j)
          add_tap(acc[k], j, taps.t[j], col[(k + j) * TILE_W]);
    }
    const int x = x0 + c;
#pragma unroll
    for (int k = 0; k < PY; ++k) {
      int y = y0 + q * PY + k;
      if (!store_inside && (y >= Hp || x >= Wp)) continue;
      long long o = (long long)y * Wp + x;
      float centre = src[(q * PY + k + r) * ws + ra + c];
      if (OUTS & OUT_CHAIN) a.chain[f * plane + o] = acc[k];
      if (OUTS & OUT_GAUSS) gauss[f * a.gauss_fs + o] = from_f32<Tg>(acc[k]);
      if (OUTS & OUT_G16) a.g16[f * a.g16_fs + o] = __float2bfloat16_rn(acc[k]);
      dog[f * a.dog_fs + o] = from_f32<Td>(acc[k] - centre);
    }
  }
}

template <int R, typename Tg, typename Td, int OUTS>
static cudaError_t launch_kernel(const LevelArgs& a, const Taps& taps, int B,
                                 cudaStream_t stream) {
  size_t smem = level_smem(a.tile_h, taps.n / 2);
  auto kern = level_kernel<R, Tg, Td, OUTS>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.Wp + TILE_W - 1) / TILE_W, (a.Hp + a.tile_h - 1) / a.tile_h, B);
  kern<<<grid, LEVEL_THREADS, smem, stream>>>(a, taps);
  return cudaGetLastError();
}

// The output sets K1 and K9 use: none (K1's last level), the chain alone,
// the Gaussian slot alone, and with f32 slots the slot and its bf16 copy
// (the slot is then the chain), with bf16 slots the slot and the chain.
template <int R, typename Tg, typename Td>
static cudaError_t launch_outs(const LevelArgs& a, const Taps& taps, int B,
                               cudaStream_t stream) {
  int outs = (a.chain ? OUT_CHAIN : 0) | (a.gauss ? OUT_GAUSS : 0) | (a.g16 ? OUT_G16 : 0);
  switch (outs) {
    case 0: return launch_kernel<R, Tg, Td, 0>(a, taps, B, stream);
    case OUT_CHAIN: return launch_kernel<R, Tg, Td, OUT_CHAIN>(a, taps, B, stream);
    case OUT_GAUSS: return launch_kernel<R, Tg, Td, OUT_GAUSS>(a, taps, B, stream);
    case OUT_GAUSS | OUT_G16:
      if constexpr (sizeof(Tg) == 4)
        return launch_kernel<R, Tg, Td, OUT_GAUSS | OUT_G16>(a, taps, B, stream);
      return cudaErrorInvalidValue;
    case OUT_CHAIN | OUT_GAUSS:
      if constexpr (sizeof(Tg) == 2)
        return launch_kernel<R, Tg, Td, OUT_CHAIN | OUT_GAUSS>(a, taps, B, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// Gaussian and DoG store types: f32 / f32, bf16 / f32 (split), bf16 / bf16.
template <int R>
static cudaError_t launch_types(const LevelArgs& a, int g_t, int d_t, const Taps& taps,
                                int B, cudaStream_t stream) {
  if (g_t == SIFT_F32 && d_t == SIFT_F32) return launch_outs<R, float, float>(a, taps, B, stream);
  if (g_t == SIFT_BF16 && d_t == SIFT_F32) return launch_outs<R, bf16, float>(a, taps, B, stream);
  if (g_t == SIFT_BF16 && d_t == SIFT_BF16) return launch_outs<R, bf16, bf16>(a, taps, B, stream);
  return cudaErrorInvalidValue;
}

static size_t elem_size(int t) { return t == SIFT_BF16 ? 2 : 4; }

static bool valid_type(int t) { return t == SIFT_F32 || t == SIFT_BF16; }

// One level for B frames; the radius picks the unrolled kernel, if any.
static cudaError_t launch_level(LevelArgs a, int prev_t, int g_t, int d_t, const Taps& taps,
                                int B, cudaStream_t stream) {
  int r = taps.n / 2;
  if (taps.n < 1 || taps.n > MAX_TAPS || taps.n % 2 == 0 || a.tile_h < PY ||
      a.tile_h % PY != 0 || level_smem(a.tile_h, r) > SMEM_LIMIT || !valid_type(prev_t))
    return cudaErrorInvalidValue;
  a.prev_bf16 = prev_t == SIFT_BF16;
  // aligned vectors of 4 elements: 16 bytes of f32, 8 of bf16
  size_t vbytes = a.prev_bf16 ? 8 : 16;
  a.vec = (uintptr_t)a.prev % vbytes == 0 && a.Wp % 4 == 0 && a.prev_fs % 4 == 0;
  switch (r) {
    case 5: return launch_types<5>(a, g_t, d_t, taps, B, stream);
    case 6: return launch_types<6>(a, g_t, d_t, taps, B, stream);
    case 8: return launch_types<8>(a, g_t, d_t, taps, B, stream);
    case 10: return launch_types<10>(a, g_t, d_t, taps, B, stream);
    case 13: return launch_types<13>(a, g_t, d_t, taps, B, stream);
    default: return launch_types<0>(a, g_t, d_t, taps, B, stream);
  }
}

// K1. base (B, Hp, Wp) of type base_t; gauss (B, n_keep, Hp, Wp) of type g_t
// = levels 1..n_keep; dog (B, n_levels, Hp, Wp) of type d_t; g16 (B, n_keep,
// Hp, Wp) bf16 or null; l3 (B, Hp, Wp) f32 or null: level n_keep in f32
// (only with bf16 gauss); scratch (n_scratch, B, Hp, Wp) f32: the chain's
// levels that no f32 output holds. taps_all: n_levels * MAX_TAPS host
// floats; ksizes, tile_hs: n_levels host ints (the taps and the planned
// tile height of each level).
SIFT_EXPORT int sift_octave_fused(const void* base, int base_t, void* gauss, int g_t,
                                  void* dog, int d_t, void* g16, float* l3,
                                  float* scratch, int n_scratch, int B, int Hp, int Wp,
                                  int n_keep, int n_levels, const float* taps_all,
                                  const int* ksizes, const int* tile_hs,
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
    LevelArgs a{prev, 0, 0, prev_fs, chain, gout, (long long)n_keep * plane, g16out,
                (long long)n_keep * plane,
                (char*)dog + (size_t)(l - 1) * plane * elem_size(d_t),
                (long long)n_levels * plane, Hp, Wp, tile_hs[l - 1]};
    cudaError_t e = launch_level(a, prev_t, g_t, d_t, taps, B, stream);
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
// out - prev before rounding (type d_t, stride dog_fs); taps: ksize host
// floats; tile_h: the planned tile height.
SIFT_EXPORT int sift_octave_level(const void* prev, int prev_t, long long prev_fs,
                                  void* out, int g_t, long long out_fs, void* g16,
                                  long long g16_fs, void* dog, int d_t, long long dog_fs,
                                  int B, int Hp, int Wp, const float* taps_in, int ksize,
                                  int tile_h, cudaStream_t stream) {
  if (ksize > MAX_TAPS || ksize < 1 || !valid_type(g_t) || !valid_type(d_t))
    return (int)cudaErrorInvalidValue;
  Taps taps;
  taps.n = ksize;
  for (int j = 0; j < ksize; ++j) taps.t[j] = taps_in[j];
  LevelArgs a{prev, 0, 0, prev_fs, nullptr, out, out_fs, (bf16*)g16, g16_fs, dog, dog_fs,
              Hp, Wp, tile_h};
  return (int)launch_level(a, prev_t, g_t, d_t, taps, B, stream);
}
