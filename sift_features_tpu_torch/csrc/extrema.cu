// K2: 3x3x3 DoG extremum test, packed into int32 words.
//
// Replaces the TPU kernel sift_features_tpu/ops/pallas/extrema_kernel.py:
// extrema_words_batched (_kernel). Same test (lib.rs:437-506 with the JAX
// package's quirk): v > 0 && v >= max of the 27-cube, or v < 0 && v <= min,
// inside the padded-coordinate bounds [y0, y1) x [x0, x1); zero outside.
// Word (f, s, y, w) holds columns 32w..32w+31 of row y, bit j = column
// 32w + j (bit 31 is the int32 sign bit). Neighbours outside the plane are
// left out of the max and min, as the plain version's -inf padding does.
//
// Bound on the H100: bytes. It must read the 5 DoG planes of each frame
// once (5 x 37.7 MB per frame at octave 0 of a 1080p batch) and write 3/32
// of a plane; the compares are ~20 instructions a pixel.
//
// Design: each value is read from device memory once. A warp owns 128
// columns (f32: 4 a thread, one 16-byte load per plane and row) or 256
// (bf16: 8 a thread, one 16-byte load, max / min / compare on packed
// bf16 pairs, two columns an instruction) of a strip of K2_ROWS rows of one
// frame, and walks down it, loading the next row while it tests the
// current one. The row's column neighbours come from the next lanes by
// shuffle (lanes 0 and 31 load the one column past the warp's edge). Per
// row it forms each plane's horizontal 3-max and 3-min once, folds them
// into each scale's 3-plane maxima H_s(y), and keeps in registers
// max(H_s(y-1), H_s(y)), H_s(y) and the centre values, so the 27-max of row
// y is max(that pair, H_s(y+1)): 5 planar results a pixel instead of 27
// loads per scale. Each thread packs its bits, and shuffles OR the lanes of
// a word together. Only the rows [y0-1, y1] and the warps that meet
// [x0, x1) read the DoG; other words are written as zeros. One launch
// serves up to 3 scales (S + 2 <= 5 planes in registers, <= 168 registers
// a thread, 3 blocks an SM); a larger S runs one launch per group of 3.
//
// Exactness: max, min and the compares round nothing, and NaN does not
// occur in a DoG, so any evaluation order gives the same bits (NaN stands
// for "no value" at the plane's edges: max.f32 and max.bf16x2 return the
// other operand); +-0 cannot change a bit because the tests are strict
// (v > 0, v < 0). A bf16 DoG (storage_dtype "bfloat16") is compared in
// bf16, whose order is that of its exact f32 widening, and moves half the
// bytes.
#include "common.cuh"

#define K2_WARPS 4
#define K2_THREADS (32 * K2_WARPS)
#define K2_ROWS 32
#define K2_FULL 0xffffffffu

// K2's arithmetic on the plane type. A thread holds 4 elements of a row
// per plane: f32 values (4 columns, one 16-byte load), or bf16 pairs
// packed in 32 bits (8 columns, one 16-byte load, max / min / compare two
// columns per instruction, exactly). NaN stands for "no value": max and
// min return the other operand (max.f32, max.bf16x2).
template <typename T> struct K2Ops;

template <> struct K2Ops<float> {
  typedef float E;
  static constexpr int COLS = 1;  // columns per element
  static __device__ __forceinline__ E nan() { return __uint_as_float(0x7fc00000u); }
  static __device__ __forceinline__ E max(E a, E b) { return fmaxf(a, b); }
  static __device__ __forceinline__ E min(E a, E b) { return fminf(a, b); }
  static __device__ __forceinline__ void load(const float* p, E (&v)[4]) {
    float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  // the elements holding the columns left / right of each column of cur
  static __device__ __forceinline__ E left(E prev, E) { return prev; }
  static __device__ __forceinline__ E right(E, E next) { return next; }
  // lane 0's element left of the warp, lane 31's right of it, from the
  // edge column e
  static __device__ __forceinline__ E edge(float e) { return e; }
  // bit c: column c of the element is an extremum
  static __device__ __forceinline__ unsigned test(E c, E mx, E mn) {
    return (c > 0.0f && c >= mx) || (c < 0.0f && c <= mn) ? 1u : 0u;
  }
};

__device__ __forceinline__ unsigned bf2_max(unsigned a, unsigned b) {
  unsigned d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned bf2_min(unsigned a, unsigned b) {
  unsigned d;
  asm("min.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
#define K2_BF2_SET(name, op)                                               \
  __device__ __forceinline__ unsigned name(unsigned a, unsigned b) {      \
    unsigned d;                                                           \
    asm("set." op ".u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));  \
    return d;                                                             \
  }
K2_BF2_SET(bf2_gt, "gt")
K2_BF2_SET(bf2_ge, "ge")
K2_BF2_SET(bf2_lt, "lt")
K2_BF2_SET(bf2_le, "le")

template <> struct K2Ops<bf16> {
  typedef unsigned E;             // columns 2i (low half) and 2i + 1
  static constexpr int COLS = 2;
  static __device__ __forceinline__ E nan() { return 0x7fc07fc0u; }
  static __device__ __forceinline__ E max(E a, E b) { return bf2_max(a, b); }
  static __device__ __forceinline__ E min(E a, E b) { return bf2_min(a, b); }
  static __device__ __forceinline__ void load(const bf16* p, E (&v)[4]) {
    uint4 t = *reinterpret_cast<const uint4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  // (prev's high column, cur's low column): the columns left of cur's two
  static __device__ __forceinline__ E left(E prev, E cur) { return __byte_perm(prev, cur, 0x5432); }
  static __device__ __forceinline__ E right(E cur, E next) { return __byte_perm(cur, next, 0x5432); }
  static __device__ __forceinline__ E edge(float e) {
    unsigned b = __float_as_uint(e) >> 16;  // exact: e was widened from bf16
    return b | (b << 16);
  }
  static __device__ __forceinline__ unsigned test(E c, E mx, E mn) {
    unsigned m = (bf2_gt(c, 0u) & bf2_ge(c, mx)) | (bf2_lt(c, 0u) & bf2_le(c, mn));
    return (m & 1u) | ((m >> 15) & 2u);
  }
};

// One row of NP planes as a thread sees it: its 4 elements per plane, and
// for lane 0 the column left of the warp, for lane 31 the one right of it
// (NaN where that column, or the row, lies outside the plane).
template <typename T, int NP>
struct K2Row {
  typename K2Ops<T>::E v[NP][4];
  float e[NP];
};

template <typename T, int NP>
__device__ __forceinline__ void k2_load(K2Row<T, NP>& row, const T* f0, long long plane,
                                        int r, int Hp, int Wp, int x, int lane) {
  typedef K2Ops<T> O;
  constexpr int CPT = 4 * O::COLS;
  if (r < 0 || r >= Hp || x >= Wp) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      row.e[p] = __uint_as_float(0x7fc00000u);
#pragma unroll
      for (int j = 0; j < 4; ++j) row.v[p][j] = O::nan();
    }
    return;
  }
  const T* c = f0 + (long long)r * Wp + x;
  int ex = lane == 0 ? -1 : CPT;
  bool eok = (lane == 0 && x > 0) || (lane == 31 && x + CPT < Wp);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    O::load(c + p * plane, row.v[p]);
    row.e[p] = eok ? to_f32(c[p * plane + ex]) : __uint_as_float(0x7fc00000u);
  }
}

// Running state of a thread's columns for G scales: max(H(y-1), H(y)) and
// H(y) of each scale's 3-plane horizontal max (and min), and the centre
// values of row y.
template <typename T, int G>
struct K2State {
  typedef typename K2Ops<T>::E E;
  E pmx[G][4], cmx[G][4], pmn[G][4], cmn[G][4], ctr[G][4];
};

// Takes row r into the state; with `emit`, first tests row r - 1 and
// writes its words (wout: this thread's word at row r - 1 of scale 0, if
// the word lies in the plane, wok).
template <typename T, int G>
__device__ __forceinline__ void k2_step(K2State<T, G>& st, const K2Row<T, G + 2>& row,
                                        int lane, bool emit, unsigned colmask, int* wout,
                                        bool wok, long long sstride) {
  typedef K2Ops<T> O;
  typedef typename O::E E;
  constexpr int NP = G + 2;
  constexpr int CPT = 4 * O::COLS;  // columns, so bits, per thread
  E hx[G][4], hn[G][4];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    E prv = (E)__shfl_up_sync(K2_FULL, row.v[p][3], 1);
    E nxt = (E)__shfl_down_sync(K2_FULL, row.v[p][0], 1);
    if (lane == 0) prv = O::edge(row.e[p]);
    if (lane == 31) nxt = O::edge(row.e[p]);
    E a[6] = {prv, row.v[p][0], row.v[p][1], row.v[p][2], row.v[p][3], nxt};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      E l = O::left(a[j], a[j + 1]), r = O::right(a[j + 1], a[j + 2]);
      E mx = O::max(O::max(l, a[j + 1]), r);
      E mn = O::min(O::min(l, a[j + 1]), r);
#pragma unroll
      for (int s = 0; s < G; ++s) {
        if (p == s) {
          hx[s][j] = mx;
          hn[s][j] = mn;
        } else if (p > s && p <= s + 2) {
          hx[s][j] = O::max(hx[s][j], mx);
          hn[s][j] = O::min(hn[s][j], mn);
        }
      }
    }
  }
  if (emit) {
#pragma unroll
    for (int s = 0; s < G; ++s) {
      unsigned bits = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bits |= O::test(st.ctr[s][j], O::max(st.pmx[s][j], hx[s][j]),
                        O::min(st.pmn[s][j], hn[s][j])) << (j * O::COLS);
      unsigned wd = (bits & colmask) << (CPT * (lane & (32 / CPT - 1)));
#pragma unroll
      for (int o = 1; o < 32 / CPT; o <<= 1) wd |= __shfl_xor_sync(K2_FULL, wd, o);
      if ((lane & (32 / CPT - 1)) == 0 && wok) wout[s * sstride] = (int)wd;
    }
  }
#pragma unroll
  for (int s = 0; s < G; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      st.pmx[s][j] = O::max(st.cmx[s][j], hx[s][j]);
      st.pmn[s][j] = O::min(st.cmn[s][j], hn[s][j]);
      st.cmx[s][j] = hx[s][j];
      st.cmn[s][j] = hn[s][j];
      st.ctr[s][j] = row.v[s + 1][j];
    }
}

// 3 blocks (12 warps) an SM: <= 168 registers a thread
template <typename T, int G>
__global__ void __launch_bounds__(K2_THREADS, 3) extrema_words_kernel(
    const T* __restrict__ dog, int* __restrict__ words, int n_s, int s_first, int Hp,
    int Wp, int y0, int y1, int x0, int x1) {
  typedef K2Ops<T> O;
  constexpr int NP = G + 2;
  constexpr int CPT = 4 * O::COLS;  // columns per thread
  constexpr int WC = 32 * CPT;      // columns per warp
  int lane = threadIdx.x & 31;
  int xs = (blockIdx.x * K2_WARPS + (threadIdx.x >> 5)) * WC;
  if (xs >= Wp) return;  // a whole warp
  int f = blockIdx.z;
  int ra = blockIdx.y * K2_ROWS, rb = min(ra + K2_ROWS, Hp);
  int w32 = Wp / 32, nwd = min(WC, Wp - xs) / 32;  // words of this warp's row
  long long plane = (long long)Hp * Wp;
  long long sstride = (long long)Hp * w32;
  // words (f, s_first - 1 + s, y, xs / 32 + i) at wrow[s * sstride + y * w32 + i]
  int* wrow = words + ((long long)f * n_s + s_first - 1) * sstride + xs / 32;
  int ea = max(ra, y0), eb = min(rb, y1);
  bool work = ea < eb && xs < x1 && xs + WC > x0;
  if (!work) ea = eb = rb;
  // zero words of the strip's rows outside [ea, eb)
  int nz = (ea - ra) + (rb - eb);
  for (int i = lane; i < nz * G * nwd; i += 32) {
    int rr = i / (G * nwd), s = (i / nwd) % G;
    int y = rr < ea - ra ? ra + rr : eb + rr - (ea - ra);
    wrow[s * sstride + (long long)y * w32 + i % nwd] = 0;
  }
  if (!work) return;

  int x = xs + lane * CPT;
  unsigned colmask = 0;
#pragma unroll
  for (int j = 0; j < CPT; ++j) colmask |= (x + j >= x0 && x + j < x1 ? 1u : 0u) << j;
  const T* f0 = dog + ((long long)f * (n_s + 2) + s_first - 1) * plane;
  int* wout = wrow + lane / (32 / CPT);
  bool wok = lane / (32 / CPT) < nwd;

  K2State<T, G> st;
#pragma unroll
  for (int s = 0; s < G; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st.pmx[s][j] = st.cmx[s][j] = st.pmn[s][j] = st.cmn[s][j] = O::nan();
  // rows ea - 1 .. eb, each loaded one step ahead; row r tests row r - 1
  K2Row<T, NP> cur, nxt;
  k2_load(cur, f0, plane, ea - 1, Hp, Wp, x, lane);
  for (int r = ea - 1; r <= eb; ++r) {
    if (r < eb) k2_load(nxt, f0, plane, r + 1, Hp, Wp, x, lane);
    k2_step(st, cur, lane, r > ea, colmask, wout + (long long)(r - 1) * w32, wok, sstride);
    cur = nxt;
  }
}

template <typename T>
static int launch_extrema(const T* dog, int* words, int B, int n_s, int Hp, int Wp, int y0,
                          int y1, int x0, int x1, cudaStream_t stream) {
  constexpr int WC = 128 * K2Ops<T>::COLS;  // columns per warp
  dim3 grid((Wp + WC * K2_WARPS - 1) / (WC * K2_WARPS), (Hp + K2_ROWS - 1) / K2_ROWS, B);
  for (int s0 = 1; s0 <= n_s; s0 += 3) {
    int g = n_s - s0 + 1 < 3 ? n_s - s0 + 1 : 3;
    if (g == 3)
      extrema_words_kernel<T, 3><<<grid, K2_THREADS, 0, stream>>>(dog, words, n_s, s0, Hp,
                                                                   Wp, y0, y1, x0, x1);
    else if (g == 2)
      extrema_words_kernel<T, 2><<<grid, K2_THREADS, 0, stream>>>(dog, words, n_s, s0, Hp,
                                                                   Wp, y0, y1, x0, x1);
    else
      extrema_words_kernel<T, 1><<<grid, K2_THREADS, 0, stream>>>(dog, words, n_s, s0, Hp,
                                                                   Wp, y0, y1, x0, x1);
  }
  return (int)cudaGetLastError();
}

// dog (B, n_s + 2, Hp, Wp) of type dog_t (f32 or bf16) -> words (B, n_s,
// Hp, Wp / 32) int32. Wp must be a multiple of 128 (a warp covers whole
// words; in bf16 a row's last warp may cover half its 256 columns); the
// bounds are clipped to the plane.
SIFT_EXPORT int sift_extrema_words(const void* dog, int dog_t, int* words, int B,
                                   int n_s, int Hp, int Wp, int y0, int y1, int x0,
                                   int x1, cudaStream_t stream) {
  if (Wp % 128 != 0 || n_s < 1) return (int)cudaErrorInvalidValue;
  y0 = y0 < 0 ? 0 : y0;
  y1 = y1 > Hp ? Hp : y1;
  x0 = x0 < 0 ? 0 : x0;
  x1 = x1 > Wp ? Wp : x1;
  if (dog_t == SIFT_BF16)
    return launch_extrema((const bf16*)dog, words, B, n_s, Hp, Wp, y0, y1, x0, x1, stream);
  if (dog_t == SIFT_F32)
    return launch_extrema((const float*)dog, words, B, n_s, Hp, Wp, y0, y1, x0, x1, stream);
  return (int)cudaErrorInvalidValue;
}
