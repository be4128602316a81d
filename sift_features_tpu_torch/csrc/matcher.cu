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
// 66.9 TFLOP/s of the f64 tensor cores. The bytes (the train rows once,
// 4.76 GB, 1.4 ms) do not matter. Design, against that bound:
// - The products run on the tensor cores, mma.sync m16n8k16 f64 (no wgmma
//   form takes f64). A loop of them on registers alone holds 66-67 TFLOP/s
//   on the H100 for seconds; m16n8k8 reaches 65, m16n8k4 63, m8n8k4 32.
// - Every operand is an integer below 2^8 and every partial sum an integer
//   below 2^53, so float64 is exact in any order of summation: the k order
//   inside a step is permuted so that a thread loads its four values of a
//   row with two 16-byte loads.
// - The epilogue is integer work. The train operand is -128 a and the
//   accumulator starts at 2^52 + 2^6 (||a||^2 + 2^25), so it ends at 2^52 +
//   2^6 (d^2 - ||b||^2 + 2^25), a double whose low word is that integer
//   (below 2^32). That word plus a column, and that word plus 2^6
//   (||b||^2 - 2^25) + row, are the 32-bit keys d^2 << 6 | column (up to a
//   row's constant) and d^2 << 6 | row: one add-and-min (VIADDMNMX) a
//   candidate on each side (d^2 < 2^23, since 128 x 255^2 < 2^23).
// - A persistent grid, one block per SM, each owning a contiguous range of
//   64-row train tiles. For each tile the block sweeps every 64-row block
//   of queries, whose u8 rows (1 MB at Q = 8,192) stay in L2: a train row's
//   column minimum is complete inside the block and written once, with no
//   atomics; the queries' running keys live in shared memory for the
//   block's whole range and are merged once per block with a 64-bit
//   atomicMin per query. More than M1_QMAX queries go in passes, each
//   sweeping the range again and merging the column keys it finds.
// - The block is two groups of four warps, one warp of each on every
//   scheduler, taking alternate blocks of queries. Each converts its next
//   32-column slice of queries to f64 (from L2 into registers a slice
//   ahead, then into a two-stage ring) and reduces its finished blocks while
//   the other group's products run: the groups take turns at the tensor
//   cores through two named barriers. The train tile is converted once per
//   tile. The queries' conversion, two per pair of rows, together with
//   the turns that hide it, is most of what keeps M1 from its bound: the
//   conversion alone, under the same turns, is not (PERF.md).
// - Shared-memory row strides of 130 and 34 doubles (an odd number of 16
//   bytes) keep the fragment loads and the conversion's stores free of
//   bank conflicts.
// Padding rows (the ragged ends of T and Q) are zero rows whose squared
// norm is set to 2^24, above every real d^2: they never win a minimum, and
// their own keys are not written.
#include "common.cuh"

#define M1_DIM 128       // bytes a row; narrower rows arrive zero-padded
#define M1_BT 64         // train rows a tile
#define M1_BQ 64         // query rows a block of queries (a group's step)
#define M1_KS 32         // columns a slice of a query block
#define M1_SLICES (M1_DIM / M1_KS)
#define M1_QMAX 8192     // query rows a pass (their keys in shared memory)
#define M1_THREADS 256   // 2 groups of 4 warps, 2 along the queries x 2 along the tile
#define M1_SB (M1_DIM + 2)  // row stride of the train tile, doubles
#define M1_SA (M1_KS + 2)   // row stride of a query slice, doubles
#define M1_PAD_NORM (1u << 24)
#define M1_OFFSET (1u << 25)

// named barriers: a group's own (GROUP + group, 128 threads) and the turn
// of a group at the tensor cores (TURN + group, both groups)
#define M1_BAR_GROUP 1
#define M1_BAR_TURN 3

// shared memory, bytes: the train tile, each group's two query stages,
// ||a||^2 of the tile, each group's ||b||^2 halves of its query block, the
// column reduction, then one key a query of the pass
#define M1_STAGE (M1_BQ * M1_SA)  // doubles
#define M1_OFF_A (M1_BT * M1_SB * 8)
#define M1_OFF_AA (M1_OFF_A + 4 * M1_STAGE * 8)
#define M1_OFF_BB (M1_OFF_AA + M1_BT * 4)
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
  uint32_t* saa = reinterpret_cast<uint32_t*>(smem + M1_OFF_AA);
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
  // loads: bytes [16 qh, 16 qh + 16) of row qr of a group's query slice;
  // bytes [32 tq, 32 tq + 32) of row tr of a train tile
  const int qr = gt & (M1_BQ - 1), qh = gt >> 6;
  const int tr = tid >> 2, tq = tid & 3;
  double* sAg = sA + gi * 2 * M1_STAGE;
  uint32_t* sbbg = sbb + gi * 2 * M1_BQ;
  // the thread's rows of a query block and its fragments' bases
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
  // the tile as -128 a and 2^6 (||a||^2 + 2^25), the accumulators' start:
  // the keys' scale (see the note); every thread takes part
  auto store_train = [&](int tile, const uint4 (&v)[2]) {
    const uint32_t w[8] = {v[0].x, v[0].y, v[0].z, v[0].w,
                           v[1].x, v[1].y, v[1].z, v[1].w};
    double* dst = sB + tr * M1_SB + tq * 32;
    uint32_t aa = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      aa = __dp4a(w[k], w[k], aa);
      *reinterpret_cast<double2*>(dst + 4 * k) = make_double2(
          -128.0 * byte_f64(w[k], 0), -128.0 * byte_f64(w[k], 1));
      *reinterpret_cast<double2*>(dst + 4 * k + 2) = make_double2(
          -128.0 * byte_f64(w[k], 2), -128.0 * byte_f64(w[k], 3));
    }
    aa += __shfl_xor_sync(0xffffffffu, aa, 1);
    aa += __shfl_xor_sync(0xffffffffu, aa, 2);
    if (tq == 0)
      saa[tr] = ((tile * M1_BT + tr < n_t ? aa : M1_PAD_NORM) + M1_OFFSET) << 6;
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
    // columns (s % M1_SLICES) M1_KS + [0, M1_KS)
    auto load_query = [&](int s) {
      const int row = (2 * (s / M1_SLICES) + gi) * M1_BQ + qr;
      if (row < nq)
        return __ldg(reinterpret_cast<const uint4*>(
            query + (size_t)(q0 + row) * M1_DIM + (s % M1_SLICES) * M1_KS +
            qh * 16));
      return make_uint4(0, 0, 0, 0);
    };
    // the slice's doubles into a stage; its rows' squared norms' halves,
    // summed over the block's slices in bb and written to sbbg (padding
    // rows: M1_PAD_NORM) at the last one
    auto store_query = [&](int s, int stage, uint4 v, uint32_t& bb) {
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      double* dst = sAg + stage * M1_STAGE + qr * M1_SA + qh * 16;
      if (s % M1_SLICES == 0) bb = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bb = __dp4a(w[k], w[k], bb);
        *reinterpret_cast<double2*>(dst + 4 * k) =
            make_double2(byte_f64(w[k], 0), byte_f64(w[k], 1));
        *reinterpret_cast<double2*>(dst + 4 * k + 2) =
            make_double2(byte_f64(w[k], 2), byte_f64(w[k], 3));
      }
      if (s % M1_SLICES == M1_SLICES - 1) {
        const bool pad = (2 * (s / M1_SLICES) + gi) * M1_BQ + qr >= nq;
        sbbg[qh * M1_BQ + qr] = pad ? (qh ? 0u : M1_PAD_NORM) : bb;
      }
    };

    uint4 tnext[2];
    uint32_t bb_part = 0;
    load_train(tb, tnext);
    uint4 qnext = load_query(0);
    store_train(tb, tnext);
    store_query(0, 0, qnext, bb_part);
    __syncthreads();
    int stage = 0;

    for (int tile = tb; tile < te; ++tile) {
      const bool more = tile + 1 < te;
      if (more) load_train(tile + 1, tnext);
      // the accumulators' start by column, and each column's running
      // minimum (d^2, query) over the group's sweep
      uint32_t c0[4][2], best_d[4][2], best_q[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          c0[nt][j] = saa[wn * 32 + nt * 8 + 2 * tig + j];
          best_d[nt][j] = ~0u;
          best_q[nt][j] = 0;
        }
      double acc[2][4][4];

      for (int s = 0; s < n_sl; ++s) {
        const int ks = s % M1_SLICES;
        const bool has_next = s + 1 < n_sl || more;
        const int ns = s + 1 < n_sl ? s + 1 : 0;
        if (has_next) qnext = load_query(ns);
        if (ks == 0) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                acc[mt][nt][i] = __hiloint2double(0x43300000, (int)c0[nt][i & 1]);
        }
        const double* pa = pa0 + stage * M1_STAGE;
        const double* pb = pb0 + ks * M1_KS;
        // both k16 steps' fragments, then the group's turn at the tensor
        // cores: its products are issued while the other group converts
        // and reduces
        Frags f0, f1;
        load_frags(f0, pa, pb);
        load_frags(f1, pa + 16, pb + 16);
        bar_sync(M1_BAR_TURN + gi, M1_THREADS);
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
          // the block of queries is done: acc[mt][nt][i] holds row row0 +
          // 16 mt + 8 (i >> 1), column wn 32 + nt 8 + 2 tig + (i & 1), as
          // 2^52 + 2^6 (d^2 - ||b||^2 + 2^25)
          const int qb0 = (2 * (s / M1_SLICES) + gi) * M1_BQ;
          uint32_t rmin[2][2], bbm[2][2], r6[2][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = row0 + mt * 16 + 8 * h;
              bbm[mt][h] = sbbg[row] + sbbg[M1_BQ + row] - M1_OFFSET;
              r6[mt][h] = (bbm[mt][h] << 6) + (uint32_t)row;
              // the row's key: low word + column, the same order as d^2
              uint32_t m = ~0u;
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                  m = __viaddmin_u32((uint32_t)__double2loint(acc[mt][nt][2 * h + j]),
                                     (uint32_t)(wn * 32 + nt * 8 + 2 * tig + j), m);
              rmin[mt][h] = m;
            }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              // the column's key: low word + r6 = d^2 << 6 | row
              uint32_t m = ~0u;
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  m = __viaddmin_u32((uint32_t)__double2loint(acc[mt][nt][2 * h + j]),
                                     r6[mt][h], m);
              if ((m >> 6) < best_d[nt][j]) {
                best_d[nt][j] = m >> 6;
                best_q[nt][j] = (uint32_t)(q0 + qb0) + (m & 63u);
              }
            }
          // rows: the minimum over the quad's columns; lane tig then takes
          // row (mt, h) = (tig >> 1, tig & 1)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t m = rmin[mt][h];
              m = min(m, __shfl_xor_sync(0xffffffffu, m, 1));
              m = min(m, __shfl_xor_sync(0xffffffffu, m, 2));
              rmin[mt][h] = m;
            }
          const int mt = tig >> 1, h = tig & 1;
          const uint32_t m = mt ? (h ? rmin[1][1] : rmin[1][0])
                                : (h ? rmin[0][1] : rmin[0][0]);
          const uint32_t bm = mt ? (h ? bbm[1][1] : bbm[1][0])
                                 : (h ? bbm[0][1] : bbm[0][0]);
          const int row = qb0 + row0 + mt * 16 + 8 * h;
          if (row < nq)
            atomicMin(&skey[row], pack_key((m >> 6) + bm,
                                           (uint32_t)(tile * M1_BT) + (m & 63u)));
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
