"""The spatial path's pieces in one process, on the CPU:

- the row-band detector (`_detect_octave(row_range=..., describe=False)`
  and `_describe_octave_subset`) against the JAX package's, its plain
  branch compiled once with the band traced, on octave 0 of a 48 x 64 frame split into two
  bands; the bands' union against the whole octave; K2′ never called on a
  band;
- the mesh collectives and the halo blur on a one-rank or fake mesh;
- `_extract_single_spatial` on a one-member mesh against the split path,
  with and without a budget.

The multi-rank cases run on the gloo ranks of tests/test_torch_parallel.py.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_features_tpu_torch.config import DEFAULT_CONFIG as CFG
from sift_features_tpu_torch.models import extractor as tx
from sift_features_tpu_torch.parallel import extract as textract
from sift_features_tpu_torch.parallel import halo
from sift_features_tpu_torch.parallel import mesh as tmesh

from test_torch_gpu import one_torch_thread, smooth_images  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _octave0():
    """Octave 0 of one 48 x 64 frame: (6, 96, 128) f32 Gaussian levels of
    the port's plain chain (bit-equal to the JAX package's scale space,
    test_torch_single.py)."""
    octs, _ = tx.precompute(smooth_images(3, 1, 48, 64), CFG, device="cpu")
    return octs[0][0]


def _set(r, desc):
    v = r["valid"]
    comb = np.concatenate([np.asarray(r["kps"])[v],
                           np.asarray(desc)[v].astype(np.float32)], 1)
    return comb[np.lexsort(comb.T[::-1])]


def _jax_band(jg, h: int, w: int):
    """JAX _detect_octave(row_range=(y0, y1), describe=False) and
    _describe_octave_subset on its valid rows, on the CPU (its plain
    branch), compiled once with the band traced, as the JAX spatial path
    runs it inside shard_map: (y0, y1) -> (result without win_ctx, desc).
    One compile in place of eager dispatch's ~330 single-op compiles."""
    import jax

    from sift_features_tpu.config import DEFAULT_CONFIG as JCFG
    from sift_features_tpu.models import extractor as jx

    def band(jg, y0, y1):
        r = jx._detect_octave(jg, jg[1:] - jg[:-1], 0, JCFG, row_range=(y0, y1),
                              describe=False)
        win_ctx = r.pop("win_ctx")
        assert not win_ctx[2]                   # the plain branch
        return r, jx._describe_octave_subset(win_ctx, r["desc_in"],
                                             r["valid"], JCFG, h, w)

    jitted = jax.jit(band)
    return lambda y0, y1: jitted(jg, y0, y1)


def test_row_bands_match_jax_and_whole_octave(monkeypatch):
    """Two row bands of octave 0 (rows [0, 48) and [48, 96)): counters and
    valid equal to JAX _detect_octave(row_range=..., describe=False) on its
    plain branch, keypoints within 1e-3, and the subset descriptors
    (_describe_octave_subset on the valid rows) differing by at most one
    in a byte, in under 2% of rows (the bar of
    test_detect_octave_matches_pallas_path). The bands' union is the
    whole octave's keypoint set, byte for byte, and a band never reaches
    K2′."""
    g = _octave0()
    h, w = g.shape[-2:]
    whole = tx._detect_octave(g, None, 0, CFG)

    def no_k2(*a, **k):
        raise AssertionError("K2′ called on a row band")

    monkeypatch.setattr(tx, "extrema_words_single", no_k2)
    jax_band = _jax_band(jnp.asarray(g.numpy()), h, w)
    got_sets, n_rows = [], 0
    for band in ((0, 48), (48, 96)):
        got = tx._detect_octave(g, None, 0, CFG, row_range=band,
                                describe=False)
        assert "desc" not in got and got["win_ctx"][2]      # the kernel branch
        want, jdesc = jax_band(*band)
        for k in ("n_candidates", "n_survivors", "n_emitted", "valid"):
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
        v = got["valid"].numpy()
        n_rows += int(v.sum())
        np.testing.assert_allclose(got["kps"].numpy()[v],
                                   np.asarray(want["kps"])[v], rtol=0, atol=1e-3)
        desc = tx._describe_octave_subset(got["win_ctx"], got["desc_in"],
                                          got["valid"], CFG, h, w)
        diff = np.abs(desc.numpy()[v].astype(int)
                      - np.asarray(jdesc)[v].astype(int))
        assert diff.max() <= 1 and (diff > 0).any(1).mean() < 0.02
        got_sets.append(_set(got, desc))
    union = np.concatenate(got_sets)
    union = union[np.lexsort(union.T[::-1])]
    assert n_rows >= 5
    assert np.array_equal(union, _set(whole, whole["desc"]))


def test_row_band_clips_to_the_border():
    """A band whose edge falls inside image_border is clipped there: the
    band of the top border rows finds nothing, and a band reaching past
    the octave equals the band cut at its last row."""
    g = _octave0()
    b = CFG.image_border
    top = tx._detect_octave(g, None, 0, CFG, row_range=(0, b))
    assert int(top["n_candidates"]) == 0 and not top["valid"].any()
    a = tx._detect_octave(g, None, 0, CFG, row_range=(40, 96))
    c = tx._detect_octave(g, None, 0, CFG, row_range=(40, 1000))
    assert all(torch.equal(a[k], c[k]) for k in a)


def test_collectives_and_halo_on_one_rank():
    """Without a process group: shift (both ways), psum and the tiled
    gather along any dim are identities; the halo blur on one member is
    the whole blur. On a fake four-member space axis, a shard shorter than
    the blur radius raises ValueError (JAX asserts), and so does a shard
    of exactly r rows, whose border reflection needs row r."""
    from sift_features_tpu_torch.ops.gaussian import gaussian_blur

    m = tmesh.make_mesh(device="cpu")
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert tmesh.shift(m, "space", x, -1) is x
    assert tmesh.shift(m, "data", x, 1) is x
    assert tmesh.psum(m, "space", x) is x
    assert tmesh.all_gather(m, "space", x, 1) is x
    y = torch.from_numpy(np.random.RandomState(2).rand(10, 16).astype(np.float32))
    assert torch.equal(halo.gaussian_blur_sharded(y, 2.0, m),
                       gaussian_blur(y, 2.0))
    m4 = dataclasses.replace(m, shape={"data": 1, "space": 4})
    with pytest.raises(ValueError, match="shard height 2"):
        halo.gaussian_blur_sharded(torch.ones(2, 16), 4.0, m4)
    r = len(halo.gaussian_kernel(4.0)) // 2
    with pytest.raises(ValueError, match=f"shard height {r} "):
        halo.gaussian_blur_sharded(torch.ones(r, 16), 4.0, m4)


def test_sharding_rule():
    """An octave shards while its rows split into even shards taller than
    every blur radius (13 at the default sigmas): the 1080p seed's
    octaves 0-2 over two members, the 48 x 64 frames' octaves 0-1 over
    three."""
    assert [textract.shards_rows(2160 >> o, 2, CFG) for o in range(5)] == [
        True, True, True, False, False]
    assert [textract.shards_rows(96 >> o, 3, CFG) for o in range(4)] == [
        True, True, False, False]
    assert not textract.shards_rows(27 * 2, 2, CFG)       # odd shards
    assert textract.shards_rows(14 * 2, 2, CFG)
    assert not textract.shards_rows(12 * 2, 2, CFG)       # 12 rows < r


@functools.cache
def _split_path():
    """A seeded 48 x 64 frame and the split path's result for it."""
    img = smooth_images(5, 1, 48, 64)
    return img, tx.extract_with_precomputed(
        *tx.precompute(img, CFG, device="cpu"), CFG, device="cpu")


@pytest.mark.parametrize("budget", [None, 12])
def test_extract_single_spatial_one_member(budget):
    """On a one-member mesh the spatial path of a frame (one band per
    octave) equals the split path's row for it, byte for byte; with a
    budget, its truncation (_truncate_result) in kps, desc and valid."""
    img, want = _split_path()
    n_oct = tx._n_octaves(48, 64, CFG)
    m = tmesh.make_mesh(device="cpu")
    got = textract._extract_single_spatial(torch.from_numpy(img[0]), n_oct,
                                           CFG, m, budget)
    if budget is not None:
        want = tx._truncate_result(want, budget)
    assert int(want["valid"].sum()) >= (12 if budget else 15)
    for k in ("kps", "desc", "valid", "n_candidates", "n_survivors",
              "n_emitted"):
        assert torch.equal(got[k], want[k][0]), k
