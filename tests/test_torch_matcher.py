"""The port's matcher under every state of PyTorch's TF32 switches, against
the JAX matcher (`_match_jit`, f32 at HIGHEST precision) on the CPU.

The matcher must give the JAX matcher's matches whatever the caller has set
through the legacy `torch.backends.cuda.matmul.allow_tf32` or the current
`fp32_precision` (globally or for `cuda.matmul`), and leave each of those
settings as it found it: it reads and writes none of them. With
`fp32_precision` set to "tf32", reading the legacy flag raises, so a matcher
that read it would fail here. Each case restores the switches in a
`finally`, so no other test on the worker sees them changed.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_features_tpu.ops.matcher import _match_jit
from sift_features_tpu_torch.ops.matcher import match_brute_force, match_dense


def _u8_case():
    """The u8 descriptors of test_torch_extract.py:test_matcher_matches_jax,
    with exact matches and ties."""
    rng = np.random.RandomState(9)
    train = rng.randint(0, 256, (300, 128)).astype(np.uint8)
    query = rng.randint(0, 256, (200, 128)).astype(np.uint8)
    query[:20] = train[40:60]               # exact matches
    query[20:25] = query[20]                # duplicate queries: ties
    train[100:103] = train[100]             # duplicate trains: ties
    return train, query


def _f32_case():
    """Non-integer f32 descriptors, 60 queries noisy copies of a train row,
    with no near ties: for every query and every train row the two smallest
    squared distances differ by more than 1e-4 of the second (checked
    below). A matched pair's d^2 (~20) is about half of ||a||^2 (~43), so
    the JAX side's f32 ||a||^2 + ||b||^2 - 2 a.b cancels mildly and stays
    within 1e-6 of the true distance."""
    rng = np.random.RandomState(13)
    train = rng.rand(300, 128).astype(np.float32)
    query = rng.rand(200, 128).astype(np.float32)
    query[:60] = train[100:160] + rng.normal(0, 0.4, (60, 128)).astype(np.float32)
    return train, query


@functools.lru_cache(maxsize=None)
def _jax_reference(kind):
    train, query = _u8_case() if kind == "u8" else _f32_case()
    bt, dist, keep = _match_jit(jnp.asarray(train, jnp.float32),
                                jnp.asarray(query, jnp.float32), True)
    return train, query, np.asarray(bt), np.asarray(dist), np.asarray(keep)


def _switches():
    """Every TF32 / fp32 precision setting as it reads now; a read that
    raises (the legacy flag after the current API set "tf32") reads as
    "raises"."""
    b = torch.backends
    getters = {
        "fp32_precision": lambda: b.fp32_precision,
        "cuda.matmul.fp32_precision": lambda: b.cuda.matmul.fp32_precision,
        "cuda.matmul.allow_tf32": lambda: b.cuda.matmul.allow_tf32,
        "cudnn.fp32_precision": lambda: b.cudnn.fp32_precision,
        "cudnn.allow_tf32": lambda: b.cudnn.allow_tf32,
        "mkldnn.matmul.fp32_precision": lambda: b.mkldnn.matmul.fp32_precision,
        "float32_matmul_precision": torch.get_float32_matmul_precision,
    }
    out = {}
    for name, get in getters.items():
        try:
            out[name] = get()
        except RuntimeError:
            out[name] = "raises"
    return out


def _set(state):
    where, value = state
    if where == "legacy":
        torch.backends.cuda.matmul.allow_tf32 = value
    elif where == "global":
        torch.backends.fp32_precision = value
    else:
        torch.backends.cuda.matmul.fp32_precision = value


STATES = ([("legacy", True), ("legacy", False)]
          + [(where, v) for where in ("global", "cuda.matmul")
             for v in ("tf32", "ieee", "none")])


@pytest.mark.parametrize("state", STATES, ids=[f"{w}={v}" for w, v in STATES])
def test_matcher_under_tf32_switches(state):
    saved_global = torch.backends.fp32_precision
    saved_matmul = torch.backends.cuda.matmul.fp32_precision
    before_all = _switches()
    try:
        _set(state)
        before = _switches()

        # u8: exact matches and ties, as test_matcher_matches_jax checks them
        train, query, jbt, jdist, jkeep = _jax_reference("u8")
        m = match_brute_force(train, query, device="cpu")
        bt, dist, keep = match_dense(torch.from_numpy(train), torch.from_numpy(query))
        np.testing.assert_array_equal(bt.numpy(), jbt)
        np.testing.assert_array_equal(keep.numpy(), jkeep)
        d2 = ((train[bt.numpy()].astype(np.int64) - query.astype(np.int64)) ** 2).sum(1)
        np.testing.assert_array_equal(dist.numpy(), np.sqrt(d2.astype(np.float32)))
        np.testing.assert_allclose(dist.numpy(), jdist, rtol=2.5e-7, atol=0)
        np.testing.assert_array_equal(m.query_idx, np.nonzero(jkeep)[0])
        np.testing.assert_array_equal(m.train_idx, jbt[jkeep])
        np.testing.assert_array_equal(m.distance, dist.numpy()[jkeep])

        # f32, non-integer: the same indices, distances within rtol 1e-6
        train, query, jbt, jdist, jkeep = _jax_reference("f32")
        e2 = ((query[:, None].astype(np.float64) - train[None]) ** 2).sum(-1)
        for s in (np.sort(e2, 1).T, np.sort(e2, 0)):
            assert ((s[1] - s[0]) / s[1]).min() > 1e-4      # no near ties
        assert jkeep.sum() >= 40
        m = match_brute_force(train, query, device="cpu")
        np.testing.assert_array_equal(m.query_idx, np.nonzero(jkeep)[0])
        np.testing.assert_array_equal(m.train_idx, jbt[jkeep])
        np.testing.assert_allclose(m.distance, jdist[jkeep], rtol=1e-6, atol=0)

        assert _switches() == before
    finally:
        # the legacy flag first: after it, the current API's values alone
        # leave it half set ("mix of the legacy and new APIs")
        if isinstance(before_all["cuda.matmul.allow_tf32"], bool):
            torch.backends.cuda.matmul.allow_tf32 = before_all["cuda.matmul.allow_tf32"]
        torch.backends.fp32_precision = saved_global
        torch.backends.cuda.matmul.fp32_precision = saved_matmul
    assert _switches() == before_all


@pytest.mark.parametrize("chunk_rows", [None, 96])
def test_int8_matcher_matches_jax(monkeypatch, chunk_rows):
    """SIFT_INT8_MATCH=1, read at each call: on u8 x u8 the int8 path
    (torch._int_mm) equals the default f64 path and JAX `_match_jit(...,
    int8=True)` bit for bit, with and without the cross-check, in one chunk
    and in chunks of 96 train rows (the last one 12 rows: padded to 16 for
    _int_mm); f32 input ignores the variable, as in JAX."""
    from sift_features_tpu_torch.ops import matcher

    train, query = _u8_case()
    t, q = torch.from_numpy(train), torch.from_numpy(query)
    if chunk_rows is not None:
        monkeypatch.setattr(matcher, "TEMP_BYTES", chunk_rows * 4 * len(query))
    for cc in (True, False):
        default = match_dense(t, q, cc)
        int8 = match_dense(t, q, cc, int8=True)
        for a, b in zip(int8, default):
            assert a.dtype == b.dtype and torch.equal(a, b)
        jbt, jdist, jkeep = (np.asarray(x) for x in _match_jit(
            jnp.asarray(train), jnp.asarray(query), cc, True))
        np.testing.assert_array_equal(int8[0].numpy(), jbt)
        assert int8[1].numpy().tobytes() == jdist.tobytes()
        np.testing.assert_array_equal(int8[2].numpy(), jkeep)
        monkeypatch.setenv("SIFT_INT8_MATCH", "1")
        calls = []
        real = matcher._chunk_d2_int8
        monkeypatch.setattr(matcher, "_chunk_d2_int8",
                            lambda *a: calls.append(1) or real(*a))
        m = match_brute_force(train, query, cc, device="cpu")
        assert len(calls) == (1 if chunk_rows is None else 4)
        np.testing.assert_array_equal(m.train_idx, jbt[m.query_idx])
        assert m.distance.tobytes() == jdist[m.query_idx].tobytes()
        f32 = match_brute_force(train.astype(np.float32),
                                query.astype(np.float32), cc, device="cpu")
        assert len(calls) == (1 if chunk_rows is None else 4)
        for f in ("query_idx", "train_idx", "distance"):
            np.testing.assert_array_equal(getattr(f32, f), getattr(m, f))
        monkeypatch.setenv("SIFT_INT8_MATCH", "0")
        monkeypatch.setattr(matcher, "_chunk_d2_int8", real)
        assert match_brute_force(train, query, cc, device="cpu") \
            .distance.tobytes() == m.distance.tobytes()


# --- M1 (ops/kernels/matcher.py, csrc/matcher.cu) ---------------------------

M32 = (1 << 32) - 1


def _f32_bits(d2: np.ndarray) -> np.ndarray:
    return d2.astype(np.float32).view(np.uint32).astype(np.uint64)


def _m1_model(train, query, bt, bq, n_blocks, qmax, groups=2):
    """A plain model of M1's reduction (csrc/matcher.cu), in its integer
    arithmetic. Query rows pack two to an f64 operand, B = b1 + 2^24 b2
    (rows l and l + bq/4 of each half of a block of bq rows: the kernel's
    two warps along the queries); the train tile is -2 a and the
    accumulator starts at 2^52 + G (1 + 2^24), G = ||a||^2 + 2^23 (a
    padding train row: G = 2^24 - 1), so it ends at 2^52 + F1 + 2^24 F2,
    Fj = G - 2 a.bj, every field in [0, 2^24) and every accumulator in
    [2^52, 2^53) (asserted). The fields are read from the low word lo and
    high word hi: s1 = lo << 8 and s2 = (hi:lo >> 16) & ~0xff, each F << 8.
    The 32-bit keys are s + column (a row's minimum) and s + ((||b||^2 -
    2^23) << 8) + row in the half (d^2 << 8 | row, a column's), taken mod
    2^32; a padding query row is a zero row of norm 2^23. The train tiles
    of bt rows split into n_blocks contiguous ranges, each sweeping blocks
    of bq queries in passes of qmax queries, the blocks dealt round-robin to
    `groups` groups that each keep their own running column minima (merged
    at the tile's end), as many blocks to each group (the last ones all
    padding); the packed u64 keys min-merged across tiles, blocks and
    passes. Returns (row_key, col_key) as int64. The keys' 8 index bits
    hold a tile of at most 64 train rows and a half of at most 64 queries,
    the kernel's sizes."""
    assert bt <= 64 and bq <= 128 and bq % 4 == 0
    n_t, n_q = len(train), len(query)
    n_tiles = -(-n_t // bt)
    a = np.zeros((n_tiles * bt, train.shape[1]), np.int64)
    a[:n_t] = train
    g_start = (a * a).sum(1) + (1 << 23)
    g_start[n_t:] = (1 << 24) - 1
    hw, pr = bq // 2, bq // 4        # rows a half, operands a half
    row_key = np.full(n_q, np.uint64(2 ** 64 - 1))
    col_key = np.zeros(n_t, np.uint64)
    for q0 in range(0, n_q, qmax):
        nq = min(qmax, n_q - q0)
        nqb = -(-nq // (bq * groups)) * groups
        b = np.zeros((nqb * bq, train.shape[1]), np.int64)
        b[:nq] = query[q0:q0 + nq]
        bb = (b * b).sum(1)
        bb[nq:] = 1 << 23
        bbm = bb - (1 << 23)
        for blk in range(n_blocks):
            skey = np.full(nq, np.uint64(2 ** 64 - 1))
            for tile in range(blk * n_tiles // n_blocks,
                              (blk + 1) * n_tiles // n_blocks):
                cols = slice(tile * bt, (tile + 1) * bt)
                best = []
                for grp in range(groups):
                    best_d = np.full(bt, M32, np.int64)
                    best_q = np.zeros(bt, np.int64)
                    for qb in range(grp, nqb, groups):
                        for half in range(2):
                            h0 = qb * bq + half * hw
                            b1, b2 = b[h0:h0 + pr], b[h0 + pr:h0 + hw]
                            acc = ((1 << 52) + g_start[None, cols] * ((1 << 24) + 1)
                                   - 2 * ((b1 + (b2 << 24)) @ a[cols].T))
                            assert acc.min() >= 1 << 52 and acc.max() < 1 << 53
                            lo, hi = acc & M32, acc >> 32
                            f1, f2 = lo & 0xFFFFFF, (acc >> 24) & 0xFFFFFF
                            assert f1.max() < 1 << 24 and f2.max() < 1 << 24
                            s1 = (lo << 8) & M32
                            s2 = ((((hi << 32) | lo) >> 16) & M32) & ~0xFF
                            assert (s1 == f1 << 8).all() and (s2 == f2 << 8).all()
                            s = np.concatenate([s1, s2])   # rows of the half
                            r = (s + np.arange(bt)[None]).min(1)
                            rows = slice(h0, h0 + hw)
                            d = ((r >> 8) + bbm[rows]) & M32
                            key = (_f32_bits(d) << np.uint64(32)) | (
                                tile * bt + (r & 0xFF)).astype(np.uint64)
                            n_valid = max(0, min(hw, nq - h0))
                            sl = slice(h0, h0 + n_valid)
                            skey[sl] = np.minimum(skey[sl], key[:n_valid])
                            c = ((s + ((bbm[rows] << 8)
                                       + np.arange(hw))[:, None]) & M32).min(0)
                            better = (c >> 8) < best_d
                            best_d = np.where(better, c >> 8, best_d)
                            best_q = np.where(better, q0 + h0 + (c & 0xFF), best_q)
                    best.append((best_d, best_q))
                best_d, best_q = best[0]
                for od, oq in best[1:]:
                    take = (od < best_d) | ((od == best_d) & (oq < best_q))
                    best_d = np.where(take, od, best_d)
                    best_q = np.where(take, oq, best_q)
                t_valid = max(0, min(bt, n_t - tile * bt))
                key = (_f32_bits(best_d) << np.uint64(32)) | best_q.astype(np.uint64)
                ts = slice(tile * bt, tile * bt + t_valid)
                col_key[ts] = key[:t_valid] if q0 == 0 else np.minimum(
                    col_key[ts], key[:t_valid])
            row_key[q0:q0 + nq] = np.minimum(row_key[q0:q0 + nq], skey)
    return (torch.from_numpy(row_key.view(np.int64)),
            torch.from_numpy(col_key.view(np.int64)))


def _tie_cases():
    """_u8_case's exact matches and duplicated rows on both sides, and a
    case of all-equal rows, every distance tied."""
    yield _u8_case()
    rng = np.random.RandomState(10)
    row = rng.randint(0, 256, (1, 128)).astype(np.uint8)
    yield np.repeat(row, 70, 0), np.repeat(rng.randint(0, 256, (1, 128))
                                           .astype(np.uint8), 45, 0)


def _extreme_cases():
    """The ends of d^2 and of the fields: all-255 queries against all-0
    train rows (every d^2 = 128 x 255^2 = 8,323,200, the largest) and
    against all-255 rows (d^2 = 0, F = 65,408, the smallest field), then
    both kinds of row on both sides (all-0 queries against all-255 rows:
    F = 16,711,808, the largest field), ties everywhere."""
    full, zero = np.full((1, 128), 255, np.uint8), np.zeros((1, 128), np.uint8)
    yield np.repeat(zero, 70, 0), np.repeat(full, 45, 0)
    yield np.repeat(full, 70, 0), np.repeat(full, 45, 0)
    yield np.concatenate([np.repeat(zero, 40, 0), np.repeat(full, 30, 0)]), \
        np.concatenate([np.repeat(full, 9, 0), np.repeat(zero, 8, 0)])


def _odd_q_case():
    """An odd number of queries (the last operand holds one real row beside
    a padding row), each a copy of a train row, some tied."""
    rng = np.random.RandomState(11)
    train = rng.randint(0, 256, (90, 128)).astype(np.uint8)
    query = train[rng.randint(0, 90, 33)]
    query[31] = query[5]
    yield train, query


def _ragged_pair_case():
    """A ragged train tile (65 rows: the second tile holds one real row and
    63 padding rows) against queries that pack the tile's real last row's
    copy beside a padding query row, and all-255 queries beside it: the
    padding train rows' fields (2^24 - 1) sit beside real fields and never
    win."""
    rng = np.random.RandomState(12)
    train = rng.randint(0, 256, (65, 128)).astype(np.uint8)
    train[64] = 255
    query = rng.randint(0, 256, (7, 128)).astype(np.uint8)
    query[6] = train[64]
    query[2] = 255
    query[3] = 0
    yield train, query


M1_CASES = {"kernel": ((64, 128, 1, 2048), _tie_cases),
            "kernel-3-blocks": ((64, 128, 3, 2048), _tie_cases),
            "ragged-passes": ((7, 12, 4, 50), _tie_cases),
            "ragged-tiles": ((50, 60, 2, 8192, 1), _tie_cases),
            "single-rows": ((1, 4, 2, 3, 3), _tie_cases),
            "extremes": ((64, 128, 2, 2048), _extreme_cases),
            "odd-q": ((64, 128, 1, 2048), _odd_q_case),
            "ragged-pair": ((64, 128, 1, 2048), _ragged_pair_case)}


@pytest.mark.parametrize("case", list(M1_CASES))
def test_m1_model_equals_chunk_loop(case):
    """M1's reduction, modelled in plain integer arithmetic with its packed
    operands and keys, min-merged over train-range and query-block splits
    (and passes), unpacked by the wrapper module's `keys_to_matches`, equals
    the chunk loop bit for bit, with and without the cross-check: on
    planted ties, on the fields' extreme rows, on an odd Q and on a ragged
    train tile beside a padded query operand."""
    from sift_features_tpu_torch.ops.kernels import matcher as kmatcher

    split, cases = M1_CASES[case]
    for train, query in cases():
        keys = _m1_model(train, query, *split)
        t, q = torch.from_numpy(train), torch.from_numpy(query)
        for cc in (True, False):
            want = match_dense(t, q, cc)
            got = kmatcher.keys_to_matches(*keys, cc)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b)
        if len(set(map(bytes, train))) == 1:     # all-equal rows
            bt, _, keep = match_dense(t, q)
            assert bt.eq(0).all() and keep.sum() == 1 and keep[0]


def test_m1_dispatch(monkeypatch):
    """The route follows the input: u8 x u8 rows of at most 128 bytes on a
    CUDA device without the int8 opt-in take M1, everything else the chunk
    loop. With the rule evaluated as on a CUDA device, u8 calls the M1
    wrapper (faked here by the model) once and never the loop, and its
    `matcher.chunks` span says route "kernel"; f32, rows wider than 128
    bytes and the int8 opt-in run the loop."""
    from sift_features_tpu_torch.ops import matcher
    from sift_features_tpu_torch.utils import profiling

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    u8, f32 = torch.uint8, torch.float32
    assert matcher.kernel_route(cuda, u8, u8, 128, False)
    assert matcher.kernel_route(cuda, u8, u8, 1, False)
    assert not matcher.kernel_route(cuda, u8, u8, 129, False)
    assert not matcher.kernel_route(cuda, u8, u8, 128, True)
    assert not matcher.kernel_route(cuda, f32, f32, 128, False)
    assert not matcher.kernel_route(cuda, u8, f32, 128, False)
    assert not matcher.kernel_route(cpu, u8, u8, 128, False)

    train, query = _u8_case()
    t, q = torch.from_numpy(train), torch.from_numpy(query)
    want = match_dense(t, q)
    calls = {"kernel": 0, "loop": 0}
    real_route, real_chunk = matcher.kernel_route, matcher._chunk_d2

    def fake_keys(tr, qu):
        calls["kernel"] += 1
        return _m1_model(tr.numpy(), qu.numpy(), 64, 128, 2, 2048)

    def loop_chunk(*a):
        calls["loop"] += 1
        return real_chunk(*a)

    def loop_chunk_int8(*a):
        calls["loop"] += 1
        return real_int8(*a)

    real_int8 = matcher._chunk_d2_int8
    monkeypatch.setattr(matcher, "kernel_route",
                        lambda dev, td, qd, w, i8: real_route(cuda, td, qd,
                                                              w, i8))
    monkeypatch.setattr(matcher.kmatcher, "match_keys", fake_keys)
    monkeypatch.setattr(matcher, "_chunk_d2", loop_chunk)
    monkeypatch.setattr(matcher, "_chunk_d2_int8", loop_chunk_int8)

    def spans_route():
        return [s for s in profiling.spans()
                if s.name == "matcher.chunks"][-1].attrs["route"]

    profiling.clear()
    got = match_dense(t, q)
    assert calls == {"kernel": 1, "loop": 0}
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    spans = {s.name: s for s in profiling.spans()}
    assert spans["matcher.chunks"].attrs == {"chunks": 1, "pairs": 300 * 200,
                                             "route": "kernel"}
    match_dense(t.float(), q.float())
    assert calls == {"kernel": 1, "loop": 1}
    wide = match_dense(torch.cat([t, t[:, :2]], 1), torch.cat([q, q[:, :2]], 1))
    assert calls == {"kernel": 1, "loop": 2}
    assert spans_route() == "plain" and wide[0].dtype == torch.int64
    monkeypatch.setenv("SIFT_INT8_MATCH", "1")
    m = match_brute_force(train, query, device="cpu")
    assert calls == {"kernel": 1, "loop": 3}
    np.testing.assert_array_equal(m.train_idx, want[0].numpy()[m.query_idx])
    profiling.clear()


def test_m1_wrapper_refuses(monkeypatch):
    """The M1 wrapper raises on CPU, non-contiguous and non-u8 rows, and on
    rows wider than its keys hold, before any build."""
    from sift_features_tpu_torch.ops.kernels import build
    from sift_features_tpu_torch.ops.kernels import matcher as kmatcher

    def no_build(*a, **k):
        raise AssertionError("the wrapper built a library")

    monkeypatch.setattr(build, "build_all", no_build)
    train, query = (torch.from_numpy(x) for x in _u8_case())
    cases = [(train, query, "CUDA"),
             (train.t().contiguous().t(), query, "contiguous"),
             (train[:, ::2], query[:, ::2], "contiguous"),
             (train.float(), query, "uint8"),
             (train, query.to(torch.int8), "uint8"),
             (torch.cat([train, train], 1), torch.cat([query, query], 1), "width")]
    for tr, qu, what in cases:
        with pytest.raises(ValueError, match=what):
            kmatcher.match_keys(tr, qu)
