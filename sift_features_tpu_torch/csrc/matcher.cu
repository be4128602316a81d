// M1: the brute-force matcher's float64 distances and cross-check minima,
// fused, on u8 descriptors.
//
// Replaces no TPU kernel: the JAX package leaves the matcher to XLA (a dot
// and two argmins, sift_features_tpu/ops/matcher.py:_match_jit), and the
// port's plain version is the chunk loop of ops/matcher.py:match_dense (one
// (Q, chunk) f64 distance matrix per chunk of train rows, then its row and
// column argmins). M1 computes the same distances and keeps only the two
// minima: the matrix never reaches device memory.
//
// Output: packed keys, (f32 bits of d^2) << 32 | index, as u64, so that a
// u64 min picks the smallest distance and, among equal ones, the lowest
// index: row_key[q] over all train rows, col_key[t] over all query rows.
// The caller fills row_key with ~0; col_key needs no fill.
//
// Bound on the H100: operations. A query of Q rows against T train rows
// is Q T pairs of 128 multiply-adds in float64: at the keyframe-index
// cell's 8,192 x 37,199,872 that is 7.80e13 operations, 1,166 ms at the
// 66.9 TFLOP/s of the f64 tensor cores. Two query rows share each operand
// (below), so the products M1 runs are half of that: 583 ms. The bytes
// (the train rows once, 4.76 GB, 1.4 ms) do not matter. Design, against
// that bound:
// - The products run on the tensor cores, mma.sync m16n8k16 f64 (no wgmma
//   form takes f64). A loop of them on registers alone holds 66-67 TFLOP/s
//   on the H100 for seconds; m16n8k8 reaches 65, m16n8k4 63, m8n8k4 32.
// - Two query rows in one operand. Every value is an integer, b <= 255, and
//   a pair's a.b <= 128 x 255^2 < 2^23, so the operand B = b1 + 2^24 b2
//   carries rows b1 and b2 in separate fields. The train operand is -2 a
//   and the accumulator starts at 2^52 + G (1 + 2^24), G = ||a||^2 + 2^23,
//   so it ends at 2^52 + F1 + 2^24 F2 with Fj = G - 2 a.bj = d^2 - ||bj||^2
//   + 2^23 in [65,408, 16,711,808], inside [0, 2^24). Every partial sum is
//   an integer in [2^52, 2^53), so float64 is exact in any order of
//   summation, and one m16n8k16 computes 32 query rows x 8 train rows. The
//   k order inside a step is permuted so that a thread loads its four
//   values of a row with two 16-byte loads.
// - The operand's conversion is integer work and one f64 add: the low word
//   byte_i(w1) | byte_i(w2) << 24 (a byte permute and a mask) under the high
//   word of 2^52, less 2^52. No I2F.
// - The epilogue is integer work on the double's words lo and hi: s1 = lo
//   << 8 = F1 << 8 and s2 = (hi:lo >> 16) & ~0xff = F2 << 8. s + column,
//   and s + ((||b||^2 - 2^23) << 8) + row (= d^2 << 8 | row), are the 32-bit
//   keys of a row's minimum (up to the row's constant) and of a column's:
//   one add-and-min (VIADDMNMX) a candidate on each side.
// - A persistent grid, one block per SM, each owning a contiguous range of
//   64-row train tiles. For each tile the block sweeps every 128-row block
//   of queries, whose u8 rows (256 KB a pass) stay in L2: a train row's
//   column minimum is complete inside the block and written once, with no
//   atomics; the queries' running keys live in shared memory for the
//   block's whole range and are merged once per block with a 64-bit
//   atomicMin per query. More than M1_QMAX queries go in passes, each
//   sweeping the range again and merging the column keys it finds.
// - The block is two groups of four warps, one warp of each on every
//   scheduler, taking alternate blocks of queries. Each converts its next
//   64-column slice of queries to f64 operands (from L2 into registers a
//   slice ahead, then into a two-stage ring) and reduces its finished
//   blocks while the other group's products run: the groups take turns at
//   the tensor cores through two named barriers, a turn being a slice's
//   four k16 steps. The train tile is converted once per tile. Slices of
//   64 columns halve the turns of 32-column ones, and their stages leave
//   shared memory for the keys of 2,048 queries a pass (PERF.md).
// - Shared-memory row strides of 130 and 34 doubles (an odd number of 16
//   bytes) keep the fragment loads and the conversion's stores free of
//   bank conflicts.
// Padding rows (the ragged ends of T and Q) are zero rows. A padding train
// row starts at G = 2^24 - 1, a field above every real one: it never wins a
// row's minimum. A padding query row's squared norm is set to 2^23, so its
// d^2 is above every real one and d^2 << 8 stays below 2^32: it never wins
// a column's minimum. Their own keys are not written.
#include "common.cuh"

#define M1_DIM 128       // bytes a row; narrower rows arrive zero-padded
#define M1_BT 64         // train rows a tile
#define M1_BA 64         // operand rows a block of queries (a group's step)
#define M1_BQ (2 * M1_BA)  // query rows a block: two to an operand row
#define M1_KS 64         // columns a slice of a query block
#define M1_SLICES (M1_DIM / M1_KS)
#define M1_QMAX 2048     // query rows a pass (their keys in shared memory)
static_assert(M1_KS == 64, "a turn runs a slice's four k16 steps");
#define M1_THREADS 256   // 2 groups of 4 warps, 2 along the queries x 2 along the tile
#define M1_SB (M1_DIM + 2)  // row stride of the train tile, doubles
#define M1_SA (M1_KS + 2)   // row stride of a query slice, doubles
#define M1_HI52 0x43300000  // the high word of 2^52
#define M1_OFFSET (1u << 23)  // the fields' offset: G = ||a||^2 + 2^23
#define M1_TRAIN_PAD_G ((1u << 24) - 1)  // a padding train row's G
#define M1_QUERY_PAD_NORM (1u << 23)     // a padding query row's ||b||^2

// named barriers: a group's own (GROUP + group, 128 threads) and the turn
// of a group at the tensor cores (TURN + group, both groups)
#define M1_BAR_GROUP 1
#define M1_BAR_TURN 3

// shared memory, bytes: the train tile, each group's two query stages, the
// tile's accumulator starts, each group's ||b||^2 halves of its query
// block, the column reduction, then one key a query of the pass
#define M1_STAGE (M1_BA * M1_SA)  // doubles
#define M1_OFF_A (M1_BT * M1_SB * 8)
#define M1_OFF_AA (M1_OFF_A + 4 * M1_STAGE * 8)
#define M1_OFF_BB (M1_OFF_AA + M1_BT * 8)
#define M1_OFF_COL (M1_OFF_BB + 4 * M1_BQ * 4)
#define M1_OFF_KEY (M1_OFF_COL + 4 * M1_BT * 8)

typedef unsigned long long u64;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[8],
                                        const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
      "{%0,%1,%2,%3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// byte i of w as a double (one I2F.F64.U8 with a byte select)
__device__ __forceinline__ double byte_f64(uint32_t w, int i) {
  return (double)(unsigned char)(w >> (8 * i));
}

// byte i of w1 + 2^24 byte i of w2 as a double: the word under the high
// word of 2^52, less 2^52 (exact)
__device__ __forceinline__ double pair_f64(uint32_t w1, uint32_t w2, int i) {
  const uint32_t lo = __byte_perm(w1, w2, ((4 + i) << 12) | i) & 0xFF0000FFu;
  return __hiloint2double(M1_HI52, (int)lo) - 4503599627370496.0;
}

__device__ __forceinline__ u64 pack_key(uint32_t d2, uint32_t index) {
  return ((u64)__float_as_uint(__uint2float_rn(d2)) << 32) | index;
}

// (d, i) < (od, oi), lexicographically
__device__ __forceinline__ bool lex_less(uint32_t od, uint32_t oi, uint32_t d,
                                         uint32_t i) {
  return od < d || (od == d && oi < i);
}

// thread (g, tig) of a warp holds rows g and g + 8 of each m16 tile and
// column g of each n8 tile, and logical k tig + 4 i of a k16 step from
// physical column 4 tig + i (a permutation of k that A and B share, so
// that a row's four values come in two 16-byte loads)
struct Frags {
  double a[2][8], b[4][4];
};

__device__ __forceinline__ void load_frags(Frags& f, const double* pa,
                                           const double* pb) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const double* p = pa + mt * 16 * M1_SA;
    const double2 x0 = *reinterpret_cast<const double2*>(p);
    const double2 x1 = *reinterpret_cast<const double2*>(p + 2);
    const double2 y0 = *reinterpret_cast<const double2*>(p + 8 * M1_SA);
    const double2 y1 = *reinterpret_cast<const double2*>(p + 8 * M1_SA + 2);
    f.a[mt][0] = x0.x; f.a[mt][2] = x0.y; f.a[mt][4] = x1.x; f.a[mt][6] = x1.y;
    f.a[mt][1] = y0.x; f.a[mt][3] = y0.y; f.a[mt][5] = y1.x; f.a[mt][7] = y1.y;
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const double* p = pb + nt * 8 * M1_SB;
    const double2 z0 = *reinterpret_cast<const double2*>(p);
    const double2 z1 = *reinterpret_cast<const double2*>(p + 2);
    f.b[nt][0] = z0.x; f.b[nt][1] = z0.y; f.b[nt][2] = z1.x; f.b[nt][3] = z1.y;
  }
}

__global__ void __launch_bounds__(M1_THREADS, 1)
m1_match_keys(const uint8_t* __restrict__ train, int n_t,
              const uint8_t* __restrict__ query, int n_q,
              u64* __restrict__ row_key, u64* __restrict__ col_key) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* sB = reinterpret_cast<double*>(smem);
  double* sA = reinterpret_cast<double*>(smem + M1_OFF_A);
  double* saa = reinterpret_cast<double*>(smem + M1_OFF_AA);
  uint32_t* sbb = reinterpret_cast<uint32_t*>(smem + M1_OFF_BB);
  uint32_t* scol = reinterpret_cast<uint32_t*>(smem + M1_OFF_COL);
  u64* skey = reinterpret_cast<u64*>(smem + M1_OFF_KEY);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  // group gi: warps 4 gi .. 4 gi + 3, one on each of the SM's four
  // schedulers, so that the two groups share every tensor core
  const int gi = warp >> 2, wm = warp & 1, wn = (warp >> 1) & 1;
  const int gt = tid & 127;
  const int n_tiles = (n_t + M1_BT - 1) / M1_BT;
  const int tb = (int)((long long)blockIdx.x * n_tiles / gridDim.x);
  const int te = (int)((long long)(blockIdx.x + 1) * n_tiles / gridDim.x);
  // loads: bytes [32 qh, 32 qh + 32) of operand row qr of a group's query
  // slice, which holds the block's query rows qw and qw + 32 (warp qr / 32
  // along the queries owns rows [64 (qr / 32), 64 (qr / 32) + 64));
  // bytes [32 tq, 32 tq + 32) of row tr of a train tile
  const int qr = gt & (M1_BA - 1), qh = gt >> 6;
  const int qw = (qr >> 5) * 64 + (qr & 31);
  const int tr = tid >> 2, tq = tid & 3;
  double* sAg = sA + gi * 2 * M1_STAGE;
  uint32_t* sbbg = sbb + gi * 2 * M1_BQ;
  // the thread's operand rows of a query block and its fragments' bases
  const int row0 = wm * 32 + g;
  const double* pa0 = sAg + row0 * M1_SA + 4 * tig;
  const double* pb0 = sB + (wn * 32 + g) * M1_SB + 4 * tig;
  // the turns: group 0 goes first; group 1's arrival stands for its turn
  // before the first
  if (gi == 1) bar_arrive(M1_BAR_TURN, M1_THREADS);

  auto load_train = [&](int tile, uint4 (&v)[2]) {
    const int row = tile * M1_BT + tr;
    if (row < n_t) {
      const uint4* p = reinterpret_cast<const uint4*>(
          train + (size_t)row * M1_DIM + tq * 32);
      v[0] = __ldcs(p);
      v[1] = __ldcs(p + 1);
    } else {
      v[0] = v[1] = make_uint4(0, 0, 0, 0);
    }
  };
  // the tile as -2 a, and each column's accumulator start 2^52 + G (1 +
  // 2^24) (see the note); every thread takes part
  auto store_train = [&](int tile, const uint4 (&v)[2]) {
    const uint32_t w[8] = {v[0].x, v[0].y, v[0].z, v[0].w,
                           v[1].x, v[1].y, v[1].z, v[1].w};
    double* dst = sB + tr * M1_SB + tq * 32;
    uint32_t aa = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      aa = __dp4a(w[k], w[k], aa);
      *reinterpret_cast<double2*>(dst + 4 * k) = make_double2(
          -2.0 * byte_f64(w[k], 0), -2.0 * byte_f64(w[k], 1));
      *reinterpret_cast<double2*>(dst + 4 * k + 2) = make_double2(
          -2.0 * byte_f64(w[k], 2), -2.0 * byte_f64(w[k], 3));
    }
    aa += __shfl_xor_sync(0xffffffffu, aa, 1);
    aa += __shfl_xor_sync(0xffffffffu, aa, 2);
    if (tq == 0) {
      const u64 gs = tile * M1_BT + tr < n_t ? aa + M1_OFFSET : M1_TRAIN_PAD_G;
      saa[tr] = __longlong_as_double(
          (long long)(((u64)M1_HI52 << 32) + gs * ((1ull << 24) + 1)));
    }
  };

  long long phases_left = 0;  // group 1: turns still to hand back
  for (int q0 = 0; q0 < n_q; q0 += M1_QMAX)
    phases_left += (long long)(te - tb) *
                   ((min(M1_QMAX, n_q - q0) + 2 * M1_BQ - 1) / (2 * M1_BQ)) *
                   M1_SLICES;

  for (int q0 = 0; q0 < n_q; q0 += M1_QMAX) {
    const int nq = min(M1_QMAX, n_q - q0);
    // group gi takes the pass's query blocks gi, gi + 2, ...; both take
    // as many (the last one may be all padding)
    const int n_sl = (nq + 2 * M1_BQ - 1) / (2 * M1_BQ) * M1_SLICES;
    for (int i = tid; i < nq; i += M1_THREADS) skey[i] = ~0ull;

    // slice s of a group's sweep: its query block 2 (s / M1_SLICES) + gi,
    // columns (s % M1_SLICES) M1_KS + [0, M1_KS); the thread's two rows
    auto load_query = [&](int s, uint4 (&v)[2][2]) {
      const int row = (2 * (s / M1_SLICES) + gi) * M1_BQ + qw;
      const size_t col = (s % M1_SLICES) * M1_KS + qh * 32;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const uint4* p = reinterpret_cast<const uint4*>(
            query + (size_t)(q0 + row + 32 * f) * M1_DIM + col);
        const bool real = row + 32 * f < nq;
        v[f][0] = real ? __ldg(p) : make_uint4(0, 0, 0, 0);
        v[f][1] = real ? __ldg(p + 1) : make_uint4(0, 0, 0, 0);
      }
    };
    // the slice's packed operands into a stage; its rows' squared norms'
    // halves, summed over the block's slices in bb and written to sbbg
    // (padding rows: M1_QUERY_PAD_NORM) at the last one
    auto store_query = [&](int s, int stage, const uint4 (&v)[2][2],
                           uint32_t (&bb)[2]) {
      const uint32_t w1[8] = {v[0][0].x, v[0][0].y, v[0][0].z, v[0][0].w,
                              v[0][1].x, v[0][1].y, v[0][1].z, v[0][1].w};
      const uint32_t w2[8] = {v[1][0].x, v[1][0].y, v[1][0].z, v[1][0].w,
                              v[1][1].x, v[1][1].y, v[1][1].z, v[1][1].w};
      double* dst = sAg + stage * M1_STAGE + qr * M1_SA + qh * 32;
      if (s % M1_SLICES == 0) bb[0] = bb[1] = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        bb[0] = __dp4a(w1[k], w1[k], bb[0]);
        bb[1] = __dp4a(w2[k], w2[k], bb[1]);
        *reinterpret_cast<double2*>(dst + 4 * k) =
            make_double2(pair_f64(w1[k], w2[k], 0), pair_f64(w1[k], w2[k], 1));
        *reinterpret_cast<double2*>(dst + 4 * k + 2) =
            make_double2(pair_f64(w1[k], w2[k], 2), pair_f64(w1[k], w2[k], 3));
      }
      if (s % M1_SLICES == M1_SLICES - 1) {
        const int row = (2 * (s / M1_SLICES) + gi) * M1_BQ + qw;
#pragma unroll
        for (int f = 0; f < 2; ++f)
          sbbg[qh * M1_BQ + qw + 32 * f] =
              row + 32 * f >= nq ? (qh ? 0u : M1_QUERY_PAD_NORM) : bb[f];
      }
    };

    uint4 tnext[2], qnext[2][2];
    uint32_t bb_part[2];
    load_train(tb, tnext);
    load_query(0, qnext);
    store_train(tb, tnext);
    store_query(0, 0, qnext, bb_part);
    __syncthreads();
    int stage = 0;

    for (int tile = tb; tile < te; ++tile) {
      const bool more = tile + 1 < te;
      if (more) load_train(tile + 1, tnext);
      // each column's running minimum (d^2, query) over the group's sweep
      uint32_t best_d[4][2], best_q[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          best_d[nt][j] = ~0u;
          best_q[nt][j] = 0;
        }
      double acc[2][4][4];

      for (int s = 0; s < n_sl; ++s) {
        const int ks = s % M1_SLICES;
        const bool has_next = s + 1 < n_sl || more;
        const int ns = s + 1 < n_sl ? s + 1 : 0;
        if (has_next) load_query(ns, qnext);
        if (ks == 0) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const double c0 = saa[wn * 32 + nt * 8 + 2 * tig + j];
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
                acc[mt][nt][j] = acc[mt][nt][2 + j] = c0;
            }
        }
        const double* pa = pa0 + stage * M1_STAGE;
        const double* pb = pb0 + ks * M1_KS;
        // the first two k16 steps' fragments, then the group's turn at the
        // tensor cores: its products run while the other group converts
        // and reduces; each step's fragments are loaded again for the step
        // after next as soon as its products are sent
        Frags f0, f1;
        load_frags(f0, pa, pb);
        load_frags(f1, pa + 16, pb + 16);
        bar_sync(M1_BAR_TURN + gi, M1_THREADS);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_f64(acc[mt][nt], f0.a[mt], f0.b[nt]);
        load_frags(f0, pa + 32, pb + 32);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_f64(acc[mt][nt], f1.a[mt], f1.b[nt]);
        load_frags(f1, pa + 48, pb + 48);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_f64(acc[mt][nt], f0.a[mt], f0.b[nt]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_f64(acc[mt][nt], f1.a[mt], f1.b[nt]);
        if (gi == 0 || --phases_left > 0)
          bar_arrive(M1_BAR_TURN + (gi ^ 1), M1_THREADS);

        if (ks == M1_SLICES - 1) {
          // the block of queries is done: acc[mt][nt][i] holds operand row
          // row0 + 16 mt + 8 (i >> 1), column wn 32 + nt 8 + 2 tig + (i & 1),
          // as 2^52 + F1 + 2^24 F2: field f is the warp's query row
          // lr = 32 f + 16 mt + 8 (i >> 1) + g of its 64
          const int qb0 = (2 * (s / M1_SLICES) + gi) * M1_BQ + wm * 64;
          uint32_t sk[2][4][4][2];  // F << 8 by [mt][nt][i][f]
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const uint32_t lo = (uint32_t)__double2loint(acc[mt][nt][i]);
                const uint32_t hi = (uint32_t)__double2hiint(acc[mt][nt][i]);
                sk[mt][nt][i][0] = lo << 8;
                sk[mt][nt][i][1] = __funnelshift_r(lo, hi, 16) & ~0xFFu;
              }
          uint32_t rmin[2][2][2], bbm[2][2][2], r8[2][2][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int f = 0; f < 2; ++f) {
                const int lr = 32 * f + 16 * mt + 8 * h + g;
                bbm[mt][h][f] = sbbg[wm * 64 + lr] + sbbg[M1_BQ + wm * 64 + lr] -
                                M1_OFFSET;
                r8[mt][h][f] = (bbm[mt][h][f] << 8) + (uint32_t)lr;
                // the row's key: F << 8 + column, the same order as d^2
                uint32_t m = ~0u;
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                  for (int j = 0; j < 2; ++j)
                    m = __viaddmin_u32(sk[mt][nt][2 * h + j][f],
                                       (uint32_t)(wn * 32 + nt * 8 + 2 * tig + j), m);
                rmin[mt][h][f] = m;
              }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              // the column's key: F << 8 + r8 = d^2 << 8 | row
              uint32_t m = ~0u;
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                  for (int f = 0; f < 2; ++f)
                    m = __viaddmin_u32(sk[mt][nt][2 * h + j][f], r8[mt][h][f], m);
              if ((m >> 8) < best_d[nt][j]) {
                best_d[nt][j] = m >> 8;
                best_q[nt][j] = (uint32_t)(q0 + qb0) + (m & 0xFFu);
              }
            }
          // rows: the minimum over the quad's columns; lane tig then takes
          // rows (mt, h) = (tig >> 1, tig & 1) of both fields
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int f = 0; f < 2; ++f) {
                uint32_t m = rmin[mt][h][f];
                m = min(m, __shfl_xor_sync(0xffffffffu, m, 1));
                m = min(m, __shfl_xor_sync(0xffffffffu, m, 2));
                rmin[mt][h][f] = m;
              }
          const int mt = tig >> 1, h = tig & 1;
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const uint32_t m = mt ? (h ? rmin[1][1][f] : rmin[1][0][f])
                                  : (h ? rmin[0][1][f] : rmin[0][0][f]);
            const uint32_t bm = mt ? (h ? bbm[1][1][f] : bbm[1][0][f])
                                   : (h ? bbm[0][1][f] : bbm[0][0][f]);
            const int row = qb0 + 32 * f + 16 * mt + 8 * h + g;
            if (row < nq)
              atomicMin(&skey[row], pack_key((m >> 8) + bm,
                                             (uint32_t)(tile * M1_BT) + (m & 0xFFu)));
          }
        }

        if (has_next) store_query(ns, stage ^ 1, qnext, bb_part);
        bar_sync(M1_BAR_GROUP + gi, M1_THREADS / 2);
        stage ^= 1;
      }

      // the tile is done: each column's minimum over the lanes that share
      // it, then over the four warps along the queries (two a group)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t d = best_d[nt][j], q = best_q[nt][j];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            const uint32_t od = __shfl_xor_sync(0xffffffffu, d, off);
            const uint32_t oq = __shfl_xor_sync(0xffffffffu, q, off);
            if (lex_less(od, oq, d, q)) { d = od; q = oq; }
          }
          if (g == 0) {
            const int c = wn * 32 + nt * 8 + 2 * tig + j;
            scol[2 * ((2 * gi + wm) * M1_BT + c)] = d;
            scol[2 * ((2 * gi + wm) * M1_BT + c) + 1] = q;
          }
        }
      __syncthreads();  // both groups are past the tile's last product
      if (more) store_train(tile + 1, tnext);
      if (tid < M1_BT && tile * M1_BT + tid < n_t) {
        uint32_t d = scol[2 * tid], q = scol[2 * tid + 1];
#pragma unroll
        for (int w = 1; w < 4; ++w) {
          const uint32_t od = scol[2 * (w * M1_BT + tid)];
          const uint32_t oq = scol[2 * (w * M1_BT + tid) + 1];
          if (lex_less(od, oq, d, q)) { d = od; q = oq; }
        }
        const size_t t = (size_t)tile * M1_BT + tid;
        u64 key = pack_key(d, q);
        if (q0 > 0) key = min(key, col_key[t]);
        col_key[t] = key;
      }
      __syncthreads();
    }
    for (int i = tid; i < nq; i += M1_THREADS) {
      const u64 k = skey[i];
      if (k != ~0ull) atomicMin(&row_key[q0 + i], k);
    }
    __syncthreads();
  }
}

// train (n_t, 128) and query (n_q, 128) u8, rows 16-byte aligned; row_key
// (n_q,) filled with ~0, col_key (n_t,); n_sm: the card's SM count.
SIFT_EXPORT int sift_match_keys(const void* train, int n_t, const void* query,
                                int n_q, void* row_key, void* col_key, int n_sm,
                                void* stream) {
  const int n_tiles = (n_t + M1_BT - 1) / M1_BT;
  const int grid = n_sm < n_tiles ? n_sm : n_tiles;
  const int keys = n_q < M1_QMAX ? n_q : M1_QMAX;
  const int smem = M1_OFF_KEY + 8 * keys;
  cudaError_t e = cudaFuncSetAttribute(
      m1_match_keys, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  m1_match_keys<<<grid, M1_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)train, n_t, (const uint8_t*)query, n_q, (u64*)row_key,
      (u64*)col_key);
  return (int)cudaGetLastError();
}
