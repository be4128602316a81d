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
