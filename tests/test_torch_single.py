"""The port's per-frame path and the precompute split vs the JAX package on
the CPU:

- the plain K9 chain against `build_octave_padded(interpret=True)`;
- the plain K2′ against `extrema_words(interpret=True)`;
- the plain K5′ / K6′ through the port's bucketed dispatchers (count
  prefix; K6′'s also with a mask) against the Pallas `orientation_histograms_bucketed` /
  `descriptor_hist_bucketed` in interpret mode;
- the port's single-frame `_detect_octave` (kernel branch) against JAX
  `_detect_octave(padded=..., interpret=True)` on the same K9 slots;
- `_extract_single` against `extract_batch`, `precompute` against the JAX
  package's scale space, and the split against the fused path.

JAX runs refine_mode="step" (K4) as in test_torch_extract.py: the modes give
identical outputs and the walk kernel's interpret compile is the costliest.
The JAX compiles are the cost, so every JAX reference runs on one 96 x 128
seed (padded 256 x 256) at the shapes of its own `_detect_octave` call.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_features_tpu.config import DEFAULT_CONFIG as JCFG
from sift_features_tpu.ops import descriptor as jdesc
from sift_features_tpu_torch.config import DEFAULT_CONFIG as CFG
from sift_features_tpu_torch.models import extractor as tx
from sift_features_tpu_torch.ops import descriptor as tdesc
from sift_features_tpu_torch.ops.kernels import descriptor as tk6
from sift_features_tpu_torch.ops.kernels import extrema as tk2
from sift_features_tpu_torch.ops.kernels import orientation as tk5
from sift_features_tpu_torch.ops.kernels import pyramid as tk9

from test_torch_extract import _window_lanes
from test_torch_gpu import one_torch_thread, smooth_images  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

P = jdesc.PAD_DESC
JCFG_STEP = dataclasses.replace(JCFG, refine_mode="step")


@functools.lru_cache(maxsize=None)
def _base():
    """Reflect-padded seed of one 48 x 64 frame: (256, 256) f32, (h, w)."""
    from sift_features_tpu_torch.ops.pyramid import create_seed_image

    seed = create_seed_image(torch.as_tensor(smooth_images(3, 1, 48, 64,
                                                           blur=1.0)), CFG)[0]
    h, w = seed.shape
    hp, wp = tx.padded_dims(h, w)
    base = tk9.reflect_pad_image(seed, P, wp - w - 2 * P, hp - h - 2 * P)
    return base.contiguous(), (h, w)


@functools.lru_cache(maxsize=None)
def _slots():
    base, hw = _base()
    g, d = tk9.build_octave_padded(base, CFG)
    return g, d, hw


def test_k9_plain_matches_pallas():
    from sift_features_tpu.ops.pallas.pyramid_kernel import build_octave_padded

    base, (h, w) = _base()
    g, d, _ = _slots()
    gj, dj = build_octave_padded(jnp.asarray(base.numpy()), JCFG, interpret=True)
    assert g.shape == gj.shape == (5, 256, 256)
    # the port reads 0 outside the plane, the TPU kernel wraps inside its
    # strips: they agree on the image interior, which is all any consumer
    # reads. The ascending tap order is the same, but XLA:CPU compiles the
    # interpret-mode kernel with some multiply-adds contracted to FMA, so
    # the bound is the JAX package's own for this kernel against its
    # tap-sum path (test_pallas_kernels.py:130-136)
    inner = (slice(None), slice(P, P + h), slice(P, P + w))
    np.testing.assert_allclose(g.numpy()[inner], np.asarray(gj)[inner], rtol=0,
                               atol=3e-7)
    np.testing.assert_allclose(d.numpy()[inner], np.asarray(dj)[inner], rtol=0,
                               atol=6e-7)
    # and a chain of K9 levels is the K1 octave, bit for bit
    g1, d1, _, _ = tk9.octave_fused(base[None], CFG)
    assert torch.equal(g[:3], g1[0]) and torch.equal(d, d1[0])


def test_k2_single_plain_matches_pallas():
    from sift_features_tpu.ops.pallas.extrema_kernel import extrema_words

    _, d, (h, w) = _slots()
    b = CFG.image_border
    bounds = (P + b, P + h - b, P + b, P + w - b)
    want = np.asarray(extrema_words(jnp.asarray(d.numpy()), bounds, 3, True))
    got = tk2.extrema_words_single(d, bounds, CFG)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).sum() > 10


def _prefix_lanes(n, count):
    """n lanes over the K9 slots, live below count. n is the survivor (K5′)
    or keypoint (K6′) capacity of this octave, and JAX runs with
    JCFG_STEP, so these calls share their compiled kernels with the ones
    inside JAX `_detect_octave` (test_detect_octave_matches_pallas_path)."""
    g, _, (h, w) = _slots()
    lanes = _window_lanes(np.random.RandomState(11), n, h, w)
    return g, (h, w), lanes, torch.arange(n) < count


def test_k5_prefix_matches_pallas_bucketed():
    from sift_features_tpu.ops.pallas.orientation_kernel import (
        orientation_histograms_bucketed)

    g, (h, w), ln, live = _prefix_lanes(tx.octave_capacities(96, 128, CFG)[1],
                                        117)
    s_img = ln["s_level"] - 1                       # the K9 slot layout
    count = int(live.sum())
    hist_j = np.asarray(orientation_histograms_bucketed(
        jnp.asarray(g.numpy()), jnp.asarray(s_img), jnp.asarray(ln["s_level"]),
        jnp.asarray(ln["y"]), jnp.asarray(ln["x"]), jnp.asarray(ln["ks"]),
        count, h, w, P, JCFG_STEP, True))
    args = [torch.from_numpy(a) for a in
            (s_img, ln["s_level"], ln["y"], ln["x"], ln["ks"])]
    hist, _, npk = (t.numpy() for t in tk5.orientation_histograms_bucketed(
        g, *args, torch.tensor(count), h, w, P, CFG, with_peaks=True))
    lv = live.numpy()
    # tolerances of the K5 test (test_torch_extract.py): summation order and
    # the f32 exp of XLA against the port's f64-rounded exp
    np.testing.assert_allclose(hist[lv], hist_j[lv], rtol=2e-4, atol=2e-5)
    assert (hist[~lv] == 0).all() and (npk[~lv] == 0).all()
    assert (hist_j[~lv] == 0).all()


def test_k6_prefix_matches_pallas_bucketed():
    from sift_features_tpu.ops.pallas.descriptor_kernel import (
        descriptor_hist_bucketed)

    g, (h, w), ln, live = _prefix_lanes(tx.octave_capacities(96, 128, CFG)[2],
                                        131)
    s_img = ln["s_level"] - 1
    count = int(live.sum())
    hist_j = np.asarray(descriptor_hist_bucketed(
        jnp.asarray(g.numpy()), jnp.asarray(s_img), jnp.asarray(ln["s_level"]),
        jnp.asarray(ln["x"]), jnp.asarray(ln["y"]), jnp.asarray(ln["ks"]),
        jnp.asarray(ln["ang"]), count, h, w, P, JCFG_STEP, True))
    args = [torch.from_numpy(a) for a in
            (s_img, ln["s_level"], ln["x"], ln["y"], ln["ks"], ln["ang"])]
    hist = tk6.descriptor_hist_bucketed(g, *args, torch.tensor(count), h, w, P,
                                        CFG)
    assert torch.equal(hist, tk6.descriptor_hist_bucketed(
        g, *args, None, h, w, P, CFG, live=live))
    lv = live.numpy()
    # tolerances of the K6 test (test_torch_extract.py)
    np.testing.assert_allclose(hist.numpy()[lv], hist_j[lv], rtol=1e-4,
                               atol=1e-5)
    desc = tdesc.finalize_descriptor(hist, CFG).numpy()
    desc_j = np.asarray(jdesc.finalize_descriptor(jnp.asarray(hist_j), JCFG))
    diff = np.abs(desc[lv].astype(int) - desc_j[lv].astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02
    assert (hist.numpy()[~lv] == 0).all()


def test_detect_octave_matches_pallas_path():
    from sift_features_tpu.models.extractor import _detect_octave

    g, d, hw = _slots()
    want = _detect_octave(None, None, 0, JCFG_STEP,
                          padded=(jnp.asarray(g.numpy()), jnp.asarray(d.numpy()),
                                  1), hw=hw, interpret=True)
    got = tx._detect_octave(None, None, 0, CFG, padded=(g, d, 1), hw=hw)
    for k in ("n_candidates", "n_survivors", "n_emitted"):
        assert int(got[k]) == int(want[k]), k
    v = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    assert v.sum() >= 80
    np.testing.assert_allclose(got["kps"].numpy()[v], np.asarray(want["kps"])[v],
                               rtol=0, atol=1e-3)
    # K5′/K6′ against the Pallas kernels: a u8 byte moves by at most one at
    # a rounding edge (the bound of test_torch_extract.py's octave test)
    diff = np.abs(got["desc"].numpy()[v].astype(int)
                  - np.asarray(want["desc"])[v].astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02


def test_extract_single_matches_batch():
    imgs = smooth_images(2, 2, 96, 128)
    full = tx.extract_batch(imgs, device="cpu")
    n_oct = full["n_emitted"].shape[1]
    for f in range(2):
        one = tx._extract_single(torch.from_numpy(imgs[f]), n_oct, CFG)
        for k in ("n_candidates", "n_survivors", "n_emitted", "valid", "kps",
                  "desc"):
            assert torch.equal(one[k], full[k][f]), k
    assert int(full["valid"].sum()) >= 200


def test_precompute_matches_jax_scale_space():
    from sift_features_tpu.ops import pyramid as jpyr

    imgs = smooth_images(4, 2, 40, 56)
    octs, dogs = tx.precompute(imgs, device="cpu")
    assert len(octs) == JCFG.n_octaves(80, 112) == 5
    assert octs[0].shape == (2, 6, 80, 112) and dogs[0].shape == (2, 5, 80, 112)
    assert [o.shape[-2:] for o in octs] == [(80, 112), (40, 56), (20, 28),
                                           (10, 14), (5, 7)]
    # the JAX scale space op by op (no jit: XLA:CPU would contract FMAs), its
    # first two octaves (op-by-op dispatch is the cost)
    seed = jpyr.create_seed_image(jnp.asarray(imgs), JCFG)
    j_octs = jpyr.build_scale_space(seed, 2, JCFG)
    for a, b in zip(octs[:2] + dogs[:2], j_octs + jpyr.build_dog(j_octs)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", [5, 6])
def test_split_matches_fused(seed):
    """tests/test_split_api.py for the port: precompute +
    extract_with_precomputed against extract_batch."""
    img = smooth_images(seed, 1, 48, 64)
    octs, dogs = tx.precompute(img, device="cpu")
    assert octs[0].shape[1] == 6 and dogs[0].shape[1] == 5
    sp = tx.extract_with_precomputed(octs, dogs, device="cpu")
    fu = tx.extract_batch(img, device="cpu")
    vs, vf = sp["valid"][0], fu["valid"][0]
    assert int(vs.sum()) == int(vf.sum()) >= 20
    for k in ("n_candidates", "n_survivors", "n_emitted"):
        assert sp[k].shape == fu[k].shape
    np.testing.assert_allclose(sp["kps"][0][vs].numpy(), fu["kps"][0][vf].numpy(),
                               rtol=0, atol=1e-4)
    d = sp["desc"][0][vs].int() - fu["desc"][0][vf].int()
    assert int(d.abs().max()) <= 1
