"""Port vs the JAX package on the CPU, above the single ops:

- the plain versions of K5 and K6 against the Pallas window kernels in
  interpret mode (orientation_histograms_bucketed with peaks;
  descriptor_hist_masked + finalize_descriptor);
- the port's batched octave against JAX `_detect_octave_batched(...,
  interpret=True)` on a 96 x 128 seed: the only comparison with the fused
  kernel path itself, since JAX `extract_batch` on the CPU takes
  `_extract_single`;
- the port's `extract_batch(device="cpu")` on a 2 x 96 x 128 batch (7
  octaves: 4 on the kernel path, 3 tiny) against JAX `extract_batch`, in
  the default configuration and in each other refine and window mode, and
  the same batch through the port's streaming executor;
- the matcher against `_match_jit`.

The JAX references are the expensive part (XLA:CPU compiles every
interpret-mode kernel), so the module fixture computes each one at the
first test that reads it and keeps it: under pytest-xdist's `--dist load`
a worker computes only the parts its own tests read. The K6 reference runs
at the shapes of the octave's descriptor call, so the two share one
compiled kernel when one worker runs both.
"""

import dataclasses

import jax
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
from sift_features_tpu_torch.ops.kernels import orientation as tk5

from test_torch_gpu import one_torch_thread, smooth_images  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

P = jdesc.PAD_DESC
# JAX runs refine_mode="step" (K4 loop): the walk kernel's interpret-mode
# compile is the costliest of all, and the JAX package's modes give
# identical outputs (config.py:98); the port runs its default walk (K3)
JCFG_STEP = dataclasses.replace(JCFG, refine_mode="step")


def _window_lanes(rng, n, h, w):
    """Scattered-liveness lanes over all three scale levels (like
    test_pallas_kernels.py:masked_case)."""
    s_level = np.sort(rng.randint(1, 4, n)).astype(np.int32)
    lo = np.array([0.0, 1.6, 2.26, 2.85])[s_level]
    hi = np.array([0.0, 2.26, 2.85, 3.59])[s_level]
    return dict(s_level=s_level,
                live=rng.rand(n) > 0.25,
                ks=(lo + (hi - lo) * rng.rand(n)).astype(np.float32),
                y=rng.randint(8, h - 8, n).astype(np.int32),
                x=rng.randint(8, w - 8, n).astype(np.int32),
                ang=(rng.rand(n) * 360.0).astype(np.float32))


def _jax_octave_inputs(_):
    """JAX fused octave 0 of one 48 x 64 frame (96 x 128 seed)."""
    from sift_features_tpu.ops import pyramid as jpyr
    from sift_features_tpu.ops.pallas.pyramid_kernel import (
        build_octave_fused, reflect_pad_image)

    seed = jpyr.create_seed_image(
        jnp.asarray(smooth_images(3, 1, 48, 64, blur=1.0)), JCFG)
    h, w = seed.shape[1], seed.shape[2]
    hp, wp = tx.padded_dims(h, w)
    base = jax.vmap(lambda im: reflect_pad_image(
        im, P, wp - w - 2 * P, hp - h - 2 * P))(seed)
    g, d, _, _ = build_octave_fused(base, JCFG, interpret=True)
    return {"g": np.array(g), "d": np.array(d), "hw": (h, w)}


def _jax_octave(ref):
    from sift_features_tpu.models.extractor import _detect_octave_batched

    det = _detect_octave_batched(jnp.asarray(ref["g"]), jnp.asarray(ref["d"]),
                                 0, JCFG_STEP, ref["hw"], interpret=True)
    return {"det": {k: np.asarray(v) for k, v in det.items()}}


def _jax_k6(ref):
    """K6 on the octave's Gaussian levels, at the shapes of the octave's own
    descriptor call (so the two share one compiled kernel)."""
    from sift_features_tpu.ops.pallas.descriptor_kernel import (
        descriptor_hist_masked)

    g, (h, w) = ref["g"], ref["hw"]
    m = tx.octave_capacities(h, w, CFG)[2]
    lanes = _window_lanes(np.random.RandomState(6), m, h, w)
    hist = descriptor_hist_masked(
        jnp.asarray(g.reshape(-1, *g.shape[2:])),
        jnp.asarray(lanes["s_level"] - 1),
        jnp.asarray(lanes["s_level"]), jnp.asarray(lanes["x"]),
        jnp.asarray(lanes["y"]), jnp.asarray(lanes["ks"]),
        jnp.asarray(lanes["ang"]), h, w, P, JCFG_STEP, interpret=True,
        live=jnp.asarray(lanes["live"]))
    return {"k6": (lanes, np.asarray(hist),
                   np.asarray(jdesc.finalize_descriptor(hist, JCFG)))}


def _jax_extract(_):
    from sift_features_tpu.models.extractor import extract_batch

    imgs = smooth_images(0, 2, 96, 128)
    res = {k: np.asarray(v) for k, v in extract_batch(imgs, JCFG).items()}
    return {"imgs": imgs, "extract": res}


def _jax_k5(_):
    from sift_features_tpu.ops.pallas.orientation_kernel import (
        orientation_histograms_bucketed)

    rng = np.random.RandomState(5)
    h, w = 96, 128
    gp = np.array(jdesc.pad_stack_for_kernels(
        jnp.asarray(rng.rand(6, h, w).astype(np.float32))))
    lanes = _window_lanes(rng, 300, h, w)
    hist, ang, npk = orientation_histograms_bucketed(
        jnp.asarray(gp), jnp.asarray(lanes["s_level"]),
        jnp.asarray(lanes["s_level"]), jnp.asarray(lanes["y"]),
        jnp.asarray(lanes["x"]), jnp.asarray(lanes["ks"]), None, h, w, P,
        JCFG, interpret=True, live=jnp.asarray(lanes["live"]),
        with_peaks=True)
    return {"k5": (gp, lanes, (h, w), np.asarray(hist), np.asarray(ang),
                   np.asarray(npk))}


_PART_OF = {"g": _jax_octave_inputs, "d": _jax_octave_inputs,
            "hw": _jax_octave_inputs, "det": _jax_octave, "k6": _jax_k6,
            "imgs": _jax_extract, "extract": _jax_extract, "k5": _jax_k5}


class _Refs(dict):
    """The JAX references by name, each part computed at its first read."""

    def __missing__(self, key):
        self.update(_PART_OF[key](self))
        return self[key]


@pytest.fixture(scope="module")
def ref():
    return _Refs()


def test_k5_plain_matches_pallas_bucketed(ref):
    gp, lanes, (h, w), hist_j, ang_j, npk_j = ref["k5"]
    live = lanes["live"]
    raw, ang, npk = tk5.orientation_hist_peaks(
        torch.from_numpy(gp), torch.from_numpy(lanes["s_level"]),
        torch.from_numpy(lanes["y"]), torch.from_numpy(lanes["x"]),
        torch.from_numpy(lanes["ks"]), torch.from_numpy(live), h, w, P, CFG)
    from sift_features_tpu_torch.ops.orientation import smooth

    hist = smooth(raw).numpy()
    assert live.sum() > 150
    # summation order (rows then columns vs the TPU kernel's sublane/lane
    # trees) and the f32 exp of XLA vs the port's f64-rounded exp: last-ulp
    # differences, within the JAX package's own kernel-vs-XLA tolerance
    # (test_pallas_kernels.py:256-257)
    np.testing.assert_allclose(hist[live], hist_j[live], rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(npk.numpy()[live], npk_j[live])
    np.testing.assert_allclose(ang.numpy()[live], ang_j[live], rtol=0,
                               atol=1e-3)
    assert (raw.numpy()[~live] == 0).all() and (npk.numpy()[~live] == 0).all()


def test_k6_plain_matches_pallas_masked(ref):
    lanes, hist_j, desc_j = ref["k6"]
    g = torch.from_numpy(ref["g"])
    h, w = ref["hw"]
    live = lanes["live"]
    hist = tk6.descriptor_hist(
        g.reshape(-1, *g.shape[2:]), torch.from_numpy(lanes["s_level"] - 1),
        torch.from_numpy(lanes["x"]), torch.from_numpy(lanes["y"]),
        torch.from_numpy(lanes["ks"]), torch.from_numpy(lanes["ang"]),
        torch.from_numpy(live), h, w, P, CFG)
    desc = tdesc.finalize_descriptor(hist, CFG).numpy()
    assert live.sum() > 150
    # summation order and the f32 sin/cos/exp of XLA vs the port's
    # f64-rounded ones: the histograms agree to f32 rounding, the u8 bytes
    # may move by one at a rounding edge (the JAX package's own bound for its
    # kernels vs its XLA path, test_pallas_kernels.py:223-226)
    np.testing.assert_allclose(hist.numpy()[live], hist_j[live], rtol=1e-4,
                               atol=1e-5)
    diff = np.abs(desc[live].astype(int) - desc_j[live].astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02
    assert (desc[~live] == 0).all()


def test_batched_octave_matches_pallas_path(ref):
    det = ref["det"]
    got = tx._detect_octave_batched(torch.from_numpy(ref["g"]),
                                    torch.from_numpy(ref["d"]), 0, CFG,
                                    ref["hw"])
    for k in ("n_candidates", "n_survivors", "n_emitted"):
        np.testing.assert_array_equal(got[k].numpy(), det[k], err_msg=k)
    v = det["valid"]
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    assert v.sum() >= 80
    np.testing.assert_allclose(got["kps"].numpy()[v], det["kps"][v], rtol=0,
                               atol=1e-3)
    # K5/K6 vs the Pallas kernels: summation order and f32 vs f64-rounded
    # transcendentals move a u8 byte by at most one at a rounding edge (the
    # JAX package's own bound for its kernels, test_pallas_kernels.py:223-226)
    diff = np.abs(got["desc"].numpy()[v].astype(int) - det["desc"][v].astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02


# the port's modes, each held against the one JAX reference: the JAX
# package gives identical outputs in every mode (config.py:98, :115-116).
# One test runs them all: under pytest-xdist's --dist load, cases of a
# parametrised test land on several workers, and each would compute the
# ~60 s JAX reference again
MODES = {"default": {}, "region": {"refine_mode": "region"},
         "tile": {"refine_mode": "tile"}, "perkey": {"window_kernel": "perkey"}}


def test_extract_batch_matches_jax(ref):
    from sift_features_tpu_torch.parallel.stream import stream_extract

    want = ref["extract"]
    for mode, fields in MODES.items():
        got = {k: v.numpy() for k, v in tx.extract_batch(
            ref["imgs"], dataclasses.replace(CFG, **fields),
            device="cpu").items()}
        _check_extract(got, want, mode)
    # the slice as a whole: the two frames through the streaming executor
    streamed = list(stream_extract(iter([ref["imgs"]]), compact=False,
                                   device="cpu"))
    assert len(streamed) == 1
    _check_extract(streamed[0], want, "stream")


def _check_extract(got, want, mode):
    assert got["n_candidates"].shape[1] == 7
    for k in ("n_candidates", "n_survivors", "n_emitted"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{mode} {k}")
    for f in range(2):
        kt = got["kps"][f][got["valid"][f]]
        kj = want["kps"][f][want["valid"][f]]
        assert len(kt) == len(kj) >= 100, mode
        # same emission order (octave-major scan order): row for row.
        # Fields within 1e-3 and >= 95% of descriptor rows byte-exact: the
        # parity bar of ARCHITECTURE.md "Parity strategy" layer 2 (the JAX
        # CPU path uses f64 atan2/exp under x64, the kernels f32)
        np.testing.assert_allclose(kt, kj, rtol=0, atol=1e-3, err_msg=mode)
        dt = got["desc"][f][got["valid"][f]]
        dj = want["desc"][f][want["valid"][f]]
        assert (dt == dj).all(1).mean() >= 0.95, mode


def test_matcher_matches_jax():
    from sift_features_tpu.ops.matcher import _match_jit
    from sift_features_tpu_torch.ops.matcher import match_brute_force, match_dense

    rng = np.random.RandomState(9)
    train = rng.randint(0, 256, (300, 128)).astype(np.uint8)
    query = rng.randint(0, 256, (200, 128)).astype(np.uint8)
    query[:20] = train[40:60]               # exact matches
    query[20:25] = query[20]                # duplicate queries: ties
    train[100:103] = train[100]             # duplicate trains: ties
    bt, dist, keep = match_dense(torch.from_numpy(train), torch.from_numpy(query))
    jbt, jdist, jkeep = _match_jit(jnp.asarray(train, jnp.float32),
                                   jnp.asarray(query, jnp.float32), True)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(jbt))
    # squared distances are exact integers on both sides; the port's sqrt is
    # correctly rounded, XLA:CPU's jitted f32 sqrt may be 1 ulp off
    d2 = ((train[bt.numpy()].astype(np.int64) - query.astype(np.int64)) ** 2).sum(1)
    np.testing.assert_array_equal(dist.numpy(), np.sqrt(d2.astype(np.float32)))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=2.5e-7,
                               atol=0)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    m = match_brute_force(train, query, device="cpu")
    np.testing.assert_array_equal(m.query_idx, np.nonzero(np.asarray(jkeep))[0])
