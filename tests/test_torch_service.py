"""The port's descriptor database and service against the JAX package's, on
the CPU (no interpret-mode compile; the JAX matcher compiles in seconds):

- shards written by either package load in the other, arrays byte-equal;
- `DescriptorIndex.query` equal to JAX `DescriptorIndex.query` in all four
  `QueryResult` arrays, with and without the cross-check, on the synthetic
  set of tests/test_aux.py:test_descriptor_index_service and on a set with
  duplicated rows that forces ties;
- the chunked `match_dense` at a chunk of 7 train rows (chunk edges
  misaligned with the data, ties across an edge) equal to the one-chunk
  form and to JAX `match_brute_force`;
- `add_frames(device="cpu")` equal to the port's `extract_batch` rows, and
  `query_image` to `extract` followed by `query`;
- the empty index and the empty query.
"""

import os

import numpy as np
import pytest
import torch

from sift_features_tpu.io.database import DescriptorDB as JDB
from sift_features_tpu.ops.matcher import match_brute_force as jmatch
from sift_features_tpu.service import DescriptorIndex as JIndex
from sift_features_tpu_torch.io.database import DescriptorDB
from sift_features_tpu_torch.models import extractor as tx
from sift_features_tpu_torch.ops import matcher
from sift_features_tpu_torch.service import DescriptorIndex, QueryResult

from test_torch_gpu import one_torch_thread, smooth_images  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIELDS = ("frame_ids", "offsets", "keypoints", "descriptors")
RESULT = ("query_idx", "frame_id", "keypoint_idx", "distance")


def _synthetic():
    """tests/test_aux.py:test_descriptor_index_service's batch (counts [5,
    0, 9, 3], frame ids 10-13) and a query of frame 12's rows, noise rows
    and a noisy copy of a frame-0 row."""
    rng = np.random.RandomState(3)
    counts = [5, 0, 9, 3]
    B, M = len(counts), max(counts)
    valid = np.zeros((B, M), bool)
    for i, c in enumerate(counts):
        valid[i, :c] = True
    desc = rng.randint(0, 256, (B, M, 128)).astype(np.uint8)
    kps = rng.rand(B, M, 5).astype(np.float32)
    near = np.clip(desc[0, 2].astype(int) + rng.randint(-3, 4, 128), 0, 255)
    q = np.concatenate([desc[2, :counts[2]],
                        rng.randint(0, 256, (6, 128)).astype(np.uint8),
                        near.astype(np.uint8)[None]])
    return {"kps": kps, "desc": desc, "valid": valid}, np.array([10, 11, 12, 13]), q


def _ties():
    """Rows duplicated across and within frames, and duplicated queries:
    the best match and the cross-check both meet ties."""
    rng = np.random.RandomState(8)
    B, M = 3, 12
    valid = np.ones((B, M), bool)
    valid[1, 7:] = False
    desc = rng.randint(0, 256, (B, M, 128)).astype(np.uint8)
    desc[2, 3] = desc[0, 5]          # one row in frames 0 and 2
    desc[0, 9] = desc[0, 1]          # twice in frame 0
    desc[1, 4] = desc[2, 8] = desc[0, 1]
    kps = rng.rand(B, M, 5).astype(np.float32)
    q = np.concatenate([desc[0, [5, 1, 1]], desc[2, [8, 0]],
                        rng.randint(0, 256, (4, 128)).astype(np.uint8),
                        desc[1, [4, 2]]])
    return {"kps": kps, "desc": desc, "valid": valid}, None, q


def _as_torch(res):
    return {k: torch.from_numpy(v) for k, v in res.items()}


def _assert_db_equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


def _assert_result_equal(a, b):
    for f in RESULT:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shards_cross_packages(tmp_path, writer):
    """Shards of three frames in two (an uneven split) written by one
    package load in the other, shard by shard and whole, arrays byte-equal
    (dtypes included) to the writer's database."""
    res, ids, _ = _synthetic()
    port_db = DescriptorDB.from_batch(_as_torch(res), ids)
    jax_db = JDB.from_batch(res, ids)
    _assert_db_equal(port_db, jax_db)
    db, reader = (port_db, JDB) if writer == "port" else (jax_db, DescriptorDB)
    db.save_sharded(str(tmp_path), 2)
    back = reader.load_all(str(tmp_path))
    _assert_db_equal(back, db)
    first = reader.load_shard(str(tmp_path), 0)
    assert list(first.frame_ids) == [10, 11]
    np.testing.assert_array_equal(first.frame(0)[1], db.frame(0)[1])


@pytest.mark.parametrize("cross_check", [True, False])
@pytest.mark.parametrize("case", [_synthetic, _ties])
def test_query_matches_jax(case, cross_check):
    res, ids, q = case()
    want = JIndex()
    want.add_batch_result(res, frame_ids=ids)
    idx = DescriptorIndex(device="cpu")
    idx.add_batch_result(_as_torch(res), frame_ids=ids)
    _assert_db_equal(idx.db, want.db)
    got = idx.query(q, cross_check)
    ref = want.query(q, cross_check)
    _assert_result_equal(got, ref)
    # a query tensor gives the same result, and a second query reuses the
    # database's descriptors on the device
    train = idx._train()
    _assert_result_equal(idx.query(torch.from_numpy(q), cross_check), ref)
    assert idx._train() is train
    assert len(ref.query_idx) >= 4 and (ref.distance == 0).sum() >= 2


@pytest.mark.parametrize("cross_check", [True, False])
def test_chunked_match_dense(monkeypatch, cross_check):
    """Train rows in chunks of 7 (T = 95: the last chunk is partial), with
    equal rows on both sides of chunk edges (6 | 7, 20 | 21 and 13, 14 |
    28) and duplicated queries: the same best train rows, distances and
    cross-check as one chunk, and as JAX match_brute_force."""
    rng = np.random.RandomState(21)
    train = rng.randint(0, 256, (95, 128)).astype(np.uint8)
    train[7] = train[6]
    train[21] = train[20]
    train[13] = train[14] = train[28]
    query = rng.randint(0, 256, (40, 128)).astype(np.uint8)
    query[:5] = train[[6, 20, 28, 50, 94]]
    query[5:8] = train[13]
    query[8:10] = np.clip(train[[7, 21]].astype(int) + 1, 0, 255)
    t, q = torch.from_numpy(train).float(), torch.from_numpy(query).float()
    one = matcher.match_dense(t, q, cross_check)
    monkeypatch.setattr(matcher, "TEMP_BYTES", 7 * 8 * len(query))
    chunked = matcher.match_dense(t, q, cross_check)
    for a, b in zip(chunked, one):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert list(one[0][:3]) == [6, 20, 13]
    got = matcher.match_brute_force(train, query, cross_check, device="cpu")
    ref = jmatch(train, query, cross_check)
    for f in ("query_idx", "train_idx", "distance"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(ref, f)))


def test_add_frames_and_query_image_on_cpu(tmp_path):
    """add_frames on two small frames gives the port's extract_batch rows;
    query_image gives extract's keypoints and descriptors and their query;
    save and load round-trip byte-equal."""
    frames = smooth_images(11, 2, 64, 80)
    idx = DescriptorIndex(device="cpu")
    idx.add_frames(frames, frame_ids=[7, 9])
    res = tx.extract_batch(frames, device="cpu")
    want = DescriptorDB.from_batch(res, [7, 9])
    _assert_db_equal(idx.db, want)
    v = res["valid"].numpy()
    assert np.array_equal(idx.db.keypoints, res["kps"].numpy()[v])
    assert np.array_equal(np.diff(idx.db.offsets), v.sum(1))
    assert idx.db.offsets[1] > 20 and idx.db.offsets[2] > idx.db.offsets[1] + 20

    kps, desc, r = idx.query_image(frames[1])
    k1, d1 = tx.extract(frames[1], device="cpu")
    assert np.array_equal(kps, k1) and np.array_equal(desc, d1)
    _assert_result_equal(r, idx.query(d1))
    # frame 1's own rows: every retained match lies in frame 9 at distance 0
    assert len(r.query_idx) > 20
    assert (r.frame_id == 9).all() and (r.distance == 0).all()
    np.testing.assert_array_equal(idx.db.frame(1)[1][r.keypoint_idx],
                                  desc[r.query_idx])

    idx.save(str(tmp_path), n_shards=2)
    back = DescriptorIndex.load(str(tmp_path), device="cpu")
    _assert_db_equal(back.db, idx.db)
    _assert_result_equal(back.query(d1), r)


def test_empty_index_and_empty_query(tmp_path):
    """An empty index answers every query with nothing, a query of no rows
    gets nothing, an empty index saves and loads; an index on a one-rank
    mesh (the ring path) answers as the dense one, loads with the mesh, and
    refuses a device other than the mesh's (tests/test_torch_parallel.py
    holds the ring on three ranks)."""
    res, ids, q = _synthetic()
    empty = DescriptorIndex(device="cpu")
    full = DescriptorIndex(device="cpu")
    full.add_batch_result(_as_torch(res), frame_ids=ids)
    want = JIndex().query(q)
    for r in (empty.query(q), full.query(np.zeros((0, 128), np.uint8)),
              full.query(torch.zeros((0, 128), dtype=torch.uint8))):
        assert isinstance(r, QueryResult)
        _assert_result_equal(r, want)
        assert len(r.query_idx) == 0
    empty.save(str(tmp_path))
    back = DescriptorIndex.load(str(tmp_path), device="cpu")
    _assert_db_equal(back.db, DescriptorDB.empty())
    assert len(back.query(q).query_idx) == 0
    from sift_features_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    ring = DescriptorIndex(None, mesh)
    ring.add_batch_result(_as_torch(res), frame_ids=ids)
    assert ring.device == mesh.device
    _assert_result_equal(ring.query(q), full.query(q))
    ring.save(str(tmp_path / "ring"))          # one shard: the axis size
    assert sorted(os.listdir(tmp_path / "ring")) == ["shard_00000.npz"]
    back = DescriptorIndex.load(str(tmp_path / "ring"), mesh)
    assert back.mesh is mesh
    _assert_result_equal(back.query(q, False), full.query(q, False))
    assert DescriptorIndex(None, mesh, device="cpu").device == mesh.device
    with pytest.raises(ValueError, match="differs from the mesh"):
        DescriptorIndex(None, mesh, device="meta")
