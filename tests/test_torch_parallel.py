"""The port's distributed path against the JAX package's and its own plain
forms, on the CPU:

- three gloo ranks, started once as subprocesses (port only, no JAX; one
  PyTorch thread each), run every multi-rank case and write their results:
  `ring_match` on u8 173 x 128 train rows and 97 queries (uneven padding)
  with and without the cross-check, the same rows as integer-valued f32, a
  tie case (identical train rows and identical queries in different
  shards), the tagged ring body, `extract_batch_dp` and
  `extract_match_step` on three 48 x 64 frames with and without a
  features_limit, a `DescriptorIndex(mesh=...)` query and `save()`'s
  default shard count, `barrier`; on a (data=1, space=3) mesh of the same
  ranks, a halo-exchange blur, `psum` and the spatial `extract_match_step`
  with and without the limit;
- here, the ranks' results against each other, the ring against JAX
  `ring_match` on a three-device mesh and the port's dense matcher (bit for
  bit), the tagged body against JAX `_ring_body` under `shard_map` and the
  port's `match_tagged_dense`, the three-rank pipeline against the port's
  one-rank run and against `extract_batch`, the halo blur against the
  port's `gaussian_blur` and JAX `gaussian_blur_sharded`, the spatial step
  against the split path and the one-rank step;
- the port's one-rank `extract_match_step` against JAX
  `extract_match_step` on a one-device mesh (one jit compile, ~40 s);
- the mesh, sharding, runner and scaling helpers in this process.

Under pytest-xdist the ranks start once per test run: the first worker to
need them starts them under a file lock, and the others read its results.
"""

import fcntl
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from sift_features_tpu_torch.config import DEFAULT_CONFIG as CFG
from sift_features_tpu_torch.models import extractor as tx
from sift_features_tpu_torch.ops import matcher
from sift_features_tpu_torch.parallel import mesh as tmesh
from sift_features_tpu_torch.parallel import pipeline, ring, runner

from test_torch_gpu import one_torch_thread, smooth_images  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_RANKS = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTRACT_KEYS = ("kps", "desc", "valid", "n_candidates", "n_survivors",
                "n_emitted")
LIMIT, LIMIT_QUERIES = 24, 16

WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["SIFT_REPO"])
import numpy as np
import torch
torch.set_num_threads(1)

from sift_features_tpu_torch.config import DEFAULT_CONFIG as CFG
from sift_features_tpu_torch.models import extractor as tx
from sift_features_tpu_torch.parallel import (extract_batch_dp,
                                              extract_match_step, make_mesh,
                                              ring_match)
from sift_features_tpu_torch.parallel import mesh as tmesh
from sift_features_tpu_torch.parallel import ring
from sift_features_tpu_torch.parallel.halo import gaussian_blur_sharded
from sift_features_tpu_torch.parallel.runner import barrier, init_distributed
from sift_features_tpu_torch.service import DescriptorIndex

rank, n, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
assert init_distributed(f"127.0.0.1:{port}", n, rank, device="cpu") == rank
res = {"barrier_s": barrier("start", timeout_s=120.0)}
mesh = make_mesh(device="cpu")
assert mesh.shape == {"data": n, "space": 1} and mesh.coords["data"] == rank
inp = np.load(os.path.join(out, "inputs.npz"))

def put(name, got):
    for i, a in enumerate(got):
        res[f"{name}_{i}"] = np.asarray(a)

for case in ("u8", "ties"):
    t, q = inp[f"{case}_train"], inp[f"{case}_query"]
    put(f"{case}_cc", ring_match(t, q, mesh))
    put(f"{case}_nocc", ring_match(t, q, mesh, cross_check=False))
    put(f"{case}_f32", ring_match(t.astype(np.float32), q.astype(np.float32),
                                  mesh))
# the tagged body on this rank's blocks
blocks = {}
for k in ("q", "qv", "q_tag", "t", "tv", "t_tag"):
    a = torch.from_numpy(inp[f"tag_{k}"])
    per = a.shape[0] // n
    blocks[k] = a[rank * per:(rank + 1) * per]
put("tagged", ring._ring_body(blocks["q"], blocks["qv"], blocks["t"],
                              blocks["tv"], mesh, "data",
                              blocks["t"].shape[0], q_tag=blocks["q_tag"],
                              t_tag=blocks["t_tag"]))
res["hops"] = tmesh.TRAFFIC["hops"]

frames = inp["frames"]
n_oct = tx._n_octaves(frames.shape[1], frames.shape[2], CFG)
dp = extract_batch_dp(frames, mesh, CFG)
res.update({f"dp_{k}": v.numpy() for k, v in dp.items()})
step = extract_match_step(frames, n_oct, CFG, mesh, 128)
res.update({f"step_{k}": v.numpy() for k, v in step.items()})
lim = extract_match_step(frames, n_oct, CFG, mesh, int(inp["limit_queries"]),
                         int(inp["limit"]))
res.update({f"lim_{k}": v.numpy() for k, v in lim.items()})

idx = DescriptorIndex(None, mesh)
idx.add_batch_result(dp)
query = idx.db.frame(1)[1]
r = idx.query(query)
put("service", (r.query_idx, r.frame_id, r.keypoint_idx, r.distance))
d = os.path.join(out, f"db{rank}")
idx.save(d)
res["shards"] = len([f for f in os.listdir(d) if f.startswith("shard_")])
back = DescriptorIndex.load(d, mesh)
r2 = back.query(query)
res["load_same"] = all(np.array_equal(getattr(r, f), getattr(r2, f)) for f in
                       ("query_idx", "frame_id", "keypoint_idx", "distance"))
# the spatial mesh: one frame's rows over all n ranks
smesh = make_mesh(1, n, device="cpu")
assert smesh.shape == {"data": 1, "space": n} and smesh.coords["space"] == rank
x = torch.from_numpy(inp["halo_x"])
h_loc = x.shape[0] // n
base = dict(tmesh.TRAFFIC)
res["halo_blur"] = tmesh.all_gather(smesh, "space", gaussian_blur_sharded(
    x[rank * h_loc:(rank + 1) * h_loc], 2.0, smesh)).numpy()
res.update({f"halo_{k}": tmesh.TRAFFIC[k] - base[k] for k in base})
res["psum"] = tmesh.psum(smesh, "space", torch.tensor([rank, 1])).numpy()
sp = extract_match_step(frames, n_oct, CFG, smesh, 128)
res.update({f"sp_{k}": v.numpy() for k, v in sp.items()})
sl = extract_match_step(frames, n_oct, CFG, smesh, int(inp["limit_queries"]),
                        int(inp["limit"]))
res.update({f"splim_{k}": v.numpy() for k, v in sl.items()})
res["barrier_end_s"] = barrier("end", timeout_s=120.0)
np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
print(f"rank {rank} OK", flush=True)
"""


def _inputs():
    """The ranks' inputs, made from seeds."""
    rng = np.random.RandomState(11)
    u8_t = rng.randint(0, 256, (173, 128)).astype(np.uint8)
    u8_q = np.concatenate([u8_t[rng.choice(173, 40, replace=False)],
                           rng.randint(0, 256, (57, 128)).astype(np.uint8)])
    # ties: identical train rows 1, 5, 9 (shards of 4 rows: one per rank)
    # and identical queries 2, 6, 9 (shards of 4), plus a train row twice
    # within a shard
    ties_t = rng.randint(0, 256, (12, 128)).astype(np.uint8)
    ties_q = rng.randint(0, 256, (10, 128)).astype(np.uint8)
    ties_t[[5, 9]] = ties_t[1]
    ties_q[[2, 6, 9]] = ties_t[1]
    ties_t[3] = ties_t[2]
    ties_q[0] = ties_t[2]
    # the tagged body: 4 frames' rows, 2 of them invalid per shard
    q = rng.randint(0, 256, (30, 128)).astype(np.uint8)
    t = np.concatenate([q[:12], rng.randint(0, 256, (24, 128)).astype(np.uint8)])
    qv, tv = np.ones(30, bool), np.ones(36, bool)
    qv[[4, 17]] = False
    tv[[2, 20, 33]] = False
    tags = {"tag_q": q, "tag_qv": qv, "tag_q_tag": (np.arange(30) // 8).astype(np.int32),
            "tag_t": t, "tag_tv": tv,
            "tag_t_tag": (np.arange(36) // 9).astype(np.int32)}
    frames = smooth_images(3, N_RANKS, 48, 64)
    return {"u8_train": u8_t, "u8_query": u8_q, "ties_train": ties_t,
            "ties_query": ties_q, **tags, "frames": frames,
            "limit": LIMIT, "limit_queries": LIMIT_QUERIES,
            "halo_x": rng.rand(96, 40).astype(np.float32)}


def _start_ranks(out):
    np.savez(out / "inputs.npz", **_inputs())
    (out / "worker.py").write_text(WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, SIFT_REPO=REPO, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
    procs = [subprocess.Popen(
        [sys.executable, str(out / "worker.py"), str(r), str(N_RANKS), port,
         str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(N_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    failed = [f"rank {r}:\n{log[-3000:]}" for r, (p, log) in
              enumerate(zip(procs, logs)) if p.returncode != 0]
    return "\n".join(failed) or "ok"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The three ranks' results (one dict per rank) and their inputs. Under
    pytest-xdist the first worker to get here starts the ranks; the others
    wait on the lock and read the same files."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    out = (base.parent if uid else base) / f"torch_ranks_{uid or 'serial'}"
    out.mkdir(exist_ok=True)
    with open(out / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        status = out / "status"
        if not status.exists():
            status.write_text(_start_ranks(out))
    if status.read_text() != "ok":
        pytest.fail(f"the gloo ranks failed:\n{status.read_text()}")
    inp = dict(np.load(out / "inputs.npz"))
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(N_RANKS)], inp


_CACHE = {}


def _cached(key, fn):
    if key not in _CACHE:
        _CACHE[key] = fn()
    return _CACHE[key]


def _extract_batch(frames):
    return _cached("extract", lambda: {k: v.numpy() for k, v in tx.extract_batch(
        frames, CFG, device="cpu").items()})


def _one_rank_step(frames, limit=None):
    n_oct = tx._n_octaves(frames.shape[1], frames.shape[2], CFG)
    k = 128 if limit is None else LIMIT_QUERIES
    return _cached(("step", limit), lambda: {
        key: v.numpy() for key, v in pipeline.extract_match_step(
            frames, n_oct, CFG, tmesh.make_mesh(device="cpu"), k,
            limit).items()})


def _triple(res, name):
    return tuple(res[f"{name}_{i}"] for i in range(3))


def _assert_triple_equal(got, want, what):
    for a, b, part in zip(got, want, ("query_idx", "train_idx", "distance")):
        assert np.array_equal(np.asarray(a), np.asarray(b)), (what, part)
        if part == "distance":
            assert np.asarray(a).dtype == np.float32, what


def test_ranks_agree(ranks):
    """Every rank returns the same whole result, after real hops (the
    tagged body's results are each rank's own queries)."""
    res, _ = ranks
    for r in res[1:]:
        assert set(r) == set(res[0])
        for k in res[0]:
            if not k.startswith(("barrier", "tagged")):
                assert np.array_equal(r[k], res[0][k]), k
    # ring_match: 2 cases x 3 calls, then the tagged body: n hops each
    assert res[0]["hops"] == 7 * N_RANKS


@pytest.mark.parametrize("case", ["u8", "ties"])
def test_ring_matches_jax_and_dense(ranks, case):
    """The 3-rank ring equals JAX ring_match on a 3-device mesh and the
    port's dense matcher, bit for bit, with and without the cross-check, on
    u8 and on the same rows as integer-valued f32; in the tie case the
    lowest global index wins across hops."""
    from sift_features_tpu.parallel.mesh import make_mesh as jmake_mesh
    from sift_features_tpu.parallel.ring import ring_match as jring

    res, inp = ranks
    t, q = inp[f"{case}_train"], inp[f"{case}_query"]
    jmesh = jmake_mesh(n_data=N_RANKS)
    for cc, name in ((True, f"{case}_cc"), (False, f"{case}_nocc")):
        got = _triple(res[0], name)
        _assert_triple_equal(got, jring(t, q, jmesh, cross_check=cc), name)
        m = matcher.match_brute_force(t, q, cc, device="cpu")
        _assert_triple_equal(got, (m.query_idx, m.train_idx, m.distance), name)
    tf, qf = t.astype(np.float32), q.astype(np.float32)
    got = _triple(res[0], f"{case}_f32")
    _assert_triple_equal(got, jring(tf, qf, jmesh), f"{case} f32")
    m = matcher.match_brute_force(tf, qf, device="cpu")
    _assert_triple_equal(got, (m.query_idx, m.train_idx, m.distance),
                         f"{case} f32")
    _assert_triple_equal(got, _triple(res[0], f"{case}_cc"), f"{case} f32")
    if case == "ties":
        qi, ti, _ = _triple(res[0], "ties_cc")
        best = dict(zip(qi.tolist(), ti.tolist()))
        # queries 2, 6, 9 equal train rows 1, 5, 9: row 1 wins; train row
        # 1's best query is 2, so only query 2 keeps its match
        assert best.get(2) == 1 and 6 not in best and 9 not in best
        assert best.get(0) == 2          # rows 2 and 3 tie within a shard
        _, ti_all, _ = _triple(res[0], "ties_nocc")
        nocc = dict(zip(_triple(res[0], "ties_nocc")[0].tolist(), ti_all.tolist()))
        assert nocc[6] == nocc[9] == 1


def test_tagged_ring_matches_jax_and_dense(ranks):
    """The tagged ring body (self-frame exclusion, invalid rows and
    queries) equals JAX _ring_body under shard_map on a 3-device mesh and
    the port's match_tagged_dense, bit for bit."""
    import jax
    from jax.sharding import PartitionSpec as JP

    from sift_features_tpu.parallel.mesh import make_mesh as jmake_mesh
    from sift_features_tpu.parallel.ring import _ring_body as jbody

    res, inp = ranks
    got = [np.concatenate([r[f"tagged_{i}"] for r in res]) for i in range(3)]
    a = {k: inp[f"tag_{k}"] for k in ("q", "qv", "q_tag", "t", "tv", "t_tag")}
    jmesh = jmake_mesh(n_data=N_RANKS)
    t_blk = len(a["t"]) // N_RANKS
    spec = JP("data")
    want = jax.jit(jax.shard_map(
        lambda q, qv, qt, t, tv, tt: jbody(q, qv, t, tv, "data", N_RANKS,
                                           t_blk, q_tag=qt, t_tag=tt),
        mesh=jmesh, in_specs=(JP("data", None), spec, spec,
                              JP("data", None), spec, spec),
        out_specs=(spec, spec, spec)))(a["q"], a["qv"], a["q_tag"], a["t"],
                                        a["tv"], a["t_tag"])
    plain = ring.match_tagged_dense(*(torch.from_numpy(a[k]) for k in
                                      ("t", "tv", "t_tag", "q", "qv", "q_tag")))
    keep = got[2]
    assert 5 < keep.sum() < len(keep) and not keep[[4, 17]].any()
    for i, what in enumerate(("best_t", "distance", "keep")):
        w = np.asarray(want[i])
        assert np.array_equal(got[i], w), what
        assert np.array_equal(got[i], plain[i].numpy()), what
    # no kept match lies in the query's own frame
    assert (a["t_tag"][got[0][keep]] != a["q_tag"][keep]).all()


def test_extract_batch_dp_equals_extract_batch(ranks):
    """3-rank extract_batch_dp equals the port's extract_batch on the
    whole batch, every key."""
    res, inp = ranks
    want = _extract_batch(inp["frames"])
    assert set(k[3:] for k in res[0] if k.startswith("dp_")) == set(want)
    for k, v in want.items():
        assert np.array_equal(res[0][f"dp_{k}"], v), k
    assert want["valid"].sum(1).min() >= 15


@pytest.mark.parametrize("limit", [None, LIMIT])
def test_extract_match_step_equals_one_rank(ranks, limit):
    """The 3-rank extract_match_step equals the one-rank run, every key,
    with and without a features_limit; its extraction equals
    extract_batch (budgeted likewise), and its matches the tagged dense
    reference."""
    res, inp = ranks
    frames = inp["frames"]
    one = _one_rank_step(frames, limit)
    pre = "step_" if limit is None else "lim_"
    assert set(k[len(pre):] for k in res[0] if k.startswith(pre)) == set(one)
    for k, v in one.items():
        assert np.array_equal(res[0][pre + k], v), k
    full = _extract_batch(frames)
    if limit is not None:   # the budget path's output (held in test_torch_budget.py)
        full = {k: v.numpy() for k, v in tx._truncate_result(
            {k: torch.from_numpy(v) for k, v in full.items()}, limit).items()}
    for k in EXTRACT_KEYS:
        assert np.array_equal(one[k], full[k]), k
    _, q, qv, qt, t, tv, tt = pipeline.queries_and_database(
        {k: torch.from_numpy(one[k]) for k in ("kps", "desc", "valid")}, 0,
        one["query_idx"].shape[1])
    bt, bd, keep = ring.match_tagged_dense(t, tv, tt, q, qv, qt)
    b = frames.shape[0]
    assert np.array_equal(one["match_train"], bt.reshape(b, -1).numpy())
    assert np.array_equal(one["match_dist"], bd.reshape(b, -1).numpy())
    assert np.array_equal(one["match_keep"], keep.reshape(b, -1).numpy())
    assert one["match_keep"].sum() >= 5


def test_service_mesh_query_and_shards(ranks):
    """A DescriptorIndex(mesh=...) query equals the dense index's; save()
    writes one shard per rank of the axis; load(mesh=) answers the same."""
    from sift_features_tpu_torch.service import DescriptorIndex

    res, _ = ranks
    dp = {k: torch.from_numpy(res[0][f"dp_{k}"]) for k in ("kps", "desc", "valid")}
    dense = DescriptorIndex(device="cpu")
    dense.add_batch_result(dp)
    want = dense.query(dense.db.frame(1)[1])
    for i, f in enumerate(("query_idx", "frame_id", "keypoint_idx", "distance")):
        assert np.array_equal(res[0][f"service_{i}"], getattr(want, f)), f
    assert len(want.query_idx) > 5
    assert all(r["shards"] == N_RANKS and r["load_same"] for r in res)
    assert all(0 <= r["barrier_s"] < 120 and 0 <= r["barrier_end_s"] < 120
               for r in res)


def _split_path(frames):
    """The frames through precompute + extract_with_precomputed: the plain
    reflect-101 blur chain, which the spatial path's halo blurs compute."""
    return _cached("split", lambda: {k: v.numpy() for k, v in
                                     tx.extract_with_precomputed(
                                         *tx.precompute(frames, CFG, device="cpu"),
                                         CFG, device="cpu").items()})


def _canon(kps, desc, valid):
    """A frame's valid rows [kps | desc], sorted: the keypoint set."""
    comb = np.concatenate([kps[valid], desc[valid].astype(np.float32)], 1)
    return comb[np.lexsort(comb.T[::-1])]


def _step_of(res, pre):
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _assert_matches_dense(step):
    """The step's matches equal the tagged dense reference run on its own
    queries and rows."""
    _, q, qv, qt, t, tv, tt = pipeline.queries_and_database(
        {k: torch.from_numpy(step[k]) for k in ("kps", "desc", "valid")}, 0,
        step["query_idx"].shape[1])
    b = step["valid"].shape[0]
    for k, r in zip(("match_train", "match_dist", "match_keep"),
                    ring.match_tagged_dense(t, tv, tt, q, qv, qt)):
        assert np.array_equal(step[k], r.reshape(b, -1).numpy()), k


def test_halo_blur_matches_port_and_jax(ranks):
    """The three members' halo blur (sigma 2, 32 rows each), gathered, is
    bit-equal to the port's gaussian_blur of the whole array and within
    3e-7 of JAX gaussian_blur_sharded under shard_map on a three-device
    mesh (the bar of JAX's test_halo_blur_matches_unsharded); each member
    made two hops of r = 8 rows and one gather, all counted on the space
    axis (TRAFFIC per axis); psum sums over the members."""
    import jax
    from jax.sharding import PartitionSpec as JP

    from sift_features_tpu.parallel.halo import gaussian_blur_sharded as jblur
    from sift_features_tpu.parallel.mesh import make_mesh as jmake_mesh
    from sift_features_tpu_torch.ops.gaussian import gaussian_blur

    res, inp = ranks
    x = inp["halo_x"]
    got = res[0]["halo_blur"]
    assert np.array_equal(got, gaussian_blur(torch.from_numpy(x), 2.0).numpy())
    want = jax.jit(jax.shard_map(
        lambda xs: jblur(xs, 2.0, "space", N_RANKS),
        mesh=jmake_mesh(n_data=1, n_space=N_RANKS),
        in_specs=JP("space", None), out_specs=JP("space", None)))(x)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=3e-7)
    # two hops and the gather, each counted on the space axis alone
    for r in res:
        assert r["halo_hops"] == r["halo_hops_space"] == 2
        assert r["halo_hop_bytes"] == r["halo_hop_bytes_space"] == 2 * 8 * 40 * 4
        assert r["halo_gathers"] == r["halo_gathers_space"] == 1
        assert r["halo_hops_data"] == r["halo_gathers_data"] == 0
    assert all(np.array_equal(r["psum"], [3, N_RANKS]) for r in res)


def test_spatial_step_equals_split_path(ranks):
    """extract_match_step on a (data=1, space=3) mesh (octaves of 96 and 48
    rows built row-sharded, the smaller ones whole): per frame, the valid
    rows are the keypoint set of precompute + extract_with_precomputed
    byte for byte (JAX's test_spatial_detection_equals_single, whose
    single-chip reference on the CPU is that same plain blur chain), and
    the counters equal. Against the one-rank step, whose K1 blurs the
    padded plane (ulps apart near the borders), the counters and counts
    are equal and the split path's rows, in scan order, are within
    test_split_matches_fused's bar. The matches are the tagged dense
    reference's on the spatial layout's own queries and rows."""
    res, inp = ranks
    frames = inp["frames"]
    sp = _step_of(res[0], "sp_")
    one = _one_rank_step(frames)
    assert set(sp) == set(one)
    split = _split_path(frames)
    m_tot = split["valid"].shape[1]
    assert sp["valid"].shape == (N_RANKS, N_RANKS * m_tot)
    for f in range(frames.shape[0]):
        a = _canon(sp["kps"][f], sp["desc"][f], sp["valid"][f])
        assert a.shape[0] >= 15
        assert np.array_equal(a, _canon(split["kps"][f], split["desc"][f],
                                        split["valid"][f])), f
    for k in ("n_candidates", "n_survivors", "n_emitted"):
        assert np.array_equal(sp[k], split[k]), k
        assert np.array_equal(sp[k], one[k]), k
    vs, vo = split["valid"], one["valid"]
    assert np.array_equal(vs.sum(1), vo.sum(1))
    np.testing.assert_allclose(split["kps"][vs], one["kps"][vo], rtol=0,
                               atol=1e-4)
    assert np.abs(split["desc"][vs].astype(int)
                  - one["desc"][vo].astype(int)).max() <= 1
    _assert_matches_dense(sp)
    assert sp["match_keep"].sum() >= 5


def test_spatial_step_budget(ranks):
    """The spatial step with features_limit (the spatial part of JAX
    test_extract_match_step_budget): LIMIT rows a frame holding the
    response top-LIMIT of the unbudgeted spatial step, each kept row's
    keypoint and descriptor bytes those of its row there; the counters of
    the unbudgeted step; the matches the tagged dense reference's."""
    res, _ = ranks
    full, lim = _step_of(res[0], "sp_"), _step_of(res[0], "splim_")
    assert lim["kps"].shape[1] == LIMIT
    for k in ("n_candidates", "n_survivors", "n_emitted"):
        assert np.array_equal(lim[k], full[k]), k
    for f in range(lim["valid"].shape[0]):
        resp = np.where(full["valid"][f], full["kps"][f][:, 4], -np.inf)
        order = np.argsort(-resp, kind="stable")[:LIMIT]
        order = order[resp[order] > -np.inf]
        kept = lim["valid"][f]
        assert kept.sum() == len(order) >= 15
        np.testing.assert_array_equal(np.sort(lim["kps"][f][kept][:, 4]),
                                      np.sort(full["kps"][f][order][:, 4]))
        want = {full["kps"][f][i].tobytes(): full["desc"][f][i] for i in order}
        for kp, d in zip(lim["kps"][f][kept], lim["desc"][f][kept]):
            assert np.array_equal(want[kp.tobytes()], d)
    _assert_matches_dense(lim)


def test_one_rank_step_matches_jax():
    """The port's one-rank extract_match_step against JAX
    extract_match_step on a one-device mesh, on tests/test_torch_extract.py's
    batch (2 x 96 x 128). The two extraction routes differ by ulps (kps
    within 1e-3, descriptor bytes by at most one in <= 2% of rows, as
    test_torch_extract.py holds them); the queries, their matches and the
    cross-check are equal, and each distance is equal wherever the query
    and train rows are byte-equal in both, else within the triangle
    inequality's bound, the norm of the two rows' byte differences."""
    from sift_features_tpu.config import DEFAULT_CONFIG as JCFG
    from sift_features_tpu.parallel.mesh import make_mesh as jmake_mesh
    from sift_features_tpu.parallel.pipeline import extract_match_step as jstep

    imgs = smooth_images(0, 2, 96, 128)
    n_oct = tx._n_octaves(96, 128, CFG)
    got = {k: v.numpy() for k, v in pipeline.extract_match_step(
        imgs, n_oct, CFG, tmesh.make_mesh(device="cpu"), 128).items()}
    want = {k: np.asarray(v) for k, v in jstep(
        imgs, n_oct, JCFG, jmake_mesh(n_data=1), 128).items()}
    assert set(got) == set(want)
    v = want["valid"]
    for k in ("valid", "n_candidates", "n_survivors", "n_emitted",
              "query_idx", "match_train", "match_keep"):
        assert np.array_equal(got[k], want[k]), k
    np.testing.assert_allclose(got["kps"][v], want["kps"][v], rtol=0, atol=1e-3)
    diff = np.abs(got["desc"].astype(int) - want["desc"].astype(int))
    rows_differ = diff.any(-1) & v
    assert rows_differ.sum() <= 0.02 * v.sum()
    # each query's and its match's row differences
    b, k = got["query_idx"].shape
    n = v.shape[1]
    q_diff = np.take_along_axis(diff, got["query_idx"][..., None].astype(int),
                                axis=1)
    t_diff = diff.reshape(b * n, -1)[got["match_train"]]
    bound = np.sqrt((q_diff ** 2).sum(-1)) + np.sqrt((t_diff ** 2).sum(-1))
    same = bound == 0
    keep = got["match_keep"]
    assert keep.sum() >= 50 and same[keep].mean() > 0.95
    assert np.array_equal(got["match_dist"][same], want["match_dist"][same])
    assert (np.abs(got["match_dist"] - want["match_dist"])[~same]
            <= bound[~same] + 1e-4).all()


def test_mesh_and_sharding_in_one_process():
    """Without a process group the world is one rank: the collectives are
    identities, the shardings whole, and a mesh that needs more ranks
    raises JAX's ValueError."""
    m = tmesh.make_mesh(device="cpu")
    assert m.shape == {"data": 1, "space": 1} and m.device.type == "cpu"
    x = torch.arange(24).reshape(2, 3, 4)
    assert torch.equal(tmesh.frames_sharding(m).shard(x), x)
    assert torch.equal(tmesh.replicated(m).shard(x), x)
    assert tmesh.all_gather(m, "data", x) is x
    buf = torch.zeros(8, dtype=torch.uint8)
    assert tmesh.shift(m, "data", buf) is buf
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        tmesh.make_mesh(2, device="cpu")
    # a 2 x 2 layout seen from rank 3: its block of a (4, 6, W) batch
    import dataclasses

    m4 = dataclasses.replace(m, shape={"data": 2, "space": 2},
                             coords={"data": 1, "space": 1})
    y = torch.arange(4 * 6 * 2).reshape(4, 6, 2)
    assert torch.equal(tmesh.frames_sharding(m4).shard(y), y[2:4, 3:6])
    with pytest.raises(ValueError, match="does not split"):
        tmesh.frames_sharding(m4).shard(y[:3])


def test_runner_reenqueues_and_barrier():
    """BatchRunner retries a failed batch at the end of the queue, gives
    up after max_retries, and runs a health barrier; init_distributed
    without a coordinator joins nothing."""
    assert runner.init_distributed(device="cpu") == 0
    assert runner.barrier("one", timeout_s=5.0) >= 0
    fails = {"b": 1}

    def step(frames):
        if fails.get(frames):
            fails[frames] -= 1
            raise RuntimeError("lost")
        return frames.upper()

    br = runner.BatchRunner(step, max_retries=1, health_check_every=2,
                            device="cpu")
    out = list(br.run([(0, "a"), (1, "b"), (2, "c")]))
    assert out == [(0, "A"), (2, "C"), (1, "B")]
    assert br.completed == 3 and br.retried == 1
    fails["d"] = 5
    with pytest.raises(RuntimeError, match="batch 3 failed 2 times"):
        list(runner.BatchRunner(step, max_retries=1, device="cpu").run([(3, "d")]))


def test_scaling_model_matches_jax():
    """step_traffic and projected_efficiency equal the JAX package's, with
    the link rate given."""
    from sift_features_tpu.utils import scaling as js
    from sift_features_tpu_torch.utils import scaling as ts

    for args in ((4, 8704, 128, 2), (8, 2048, 64, 4, 2)):
        assert vars(ts.step_traffic(*args)) == vars(js.step_traffic(*args))
    kw = dict(fps_per_chip=37.0, batch=4, n_kps=8704, queries_per_frame=128,
              n_chips=4, link_bps=2.0e10)
    assert ts.projected_efficiency(**kw) == js.projected_efficiency(**kw)
    with pytest.raises(TypeError):
        ts.projected_efficiency(37.0, 4, 8704, 128, 4)
    assert not hasattr(ts, "ICI_BPS") and not hasattr(ts, "DCN_BPS")
