"""The port's NumPy oracle (sift_features_tpu_torch/oracle/) against the
JAX package's, and the port's extractor against it, on the CPU:

- `oracle.sift` bit for bit equal to JAX `oracle.sift` on a seeded smooth
  64 x 80 texture with NumpyProcessing and (where cv2 imports) CvProcessing,
  with and without a features_limit; ImageprocProcessing and
  rust_round_f32 equal;
- the port's `sift(img, device="cpu")` against the port's oracle at the
  JAX package's extractor-to-oracle bar (tests/test_fuzz.py);
- the oracle imports, and runs with NumpyProcessing, where cv2 cannot be
  imported.
"""

import importlib
import sys

import numpy as np
import pytest

import sift_features_tpu_torch as port
from sift_features_tpu_torch.oracle import oracle as toracle
from sift_features_tpu_torch.oracle import processing as tproc

from test_torch_gpu import one_torch_thread  # noqa: F401



def _texture(seed=0, h=64, w=80):
    """A seeded smooth texture: uniform noise on a coarse grid, cubic
    zoom (the kind of image tests/test_fuzz.py draws, without cv2)."""
    from scipy.ndimage import zoom

    base = np.random.RandomState(seed).rand(h // 4 + 2, w // 4 + 2)
    img = zoom(base, (h / base.shape[0], w / base.shape[1]), order=3)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


IMG = _texture()


def _same(a, b):
    return all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("limit", [None, 40])
@pytest.mark.parametrize("backend", ["numpy", "cv2"])
def test_oracle_matches_jax_oracle(backend, limit):
    from sift_features_tpu.oracle import oracle as joracle
    from sift_features_tpu.oracle import processing as jproc

    if backend == "cv2":
        pytest.importorskip("cv2")
        procs = (toracle.CvProcessing, joracle.CvProcessing)
    else:
        procs = (tproc.NumpyProcessing, jproc.NumpyProcessing)
    got = toracle.sift(IMG, limit, proc=procs[0])
    want = joracle.sift(IMG, limit, proc=procs[1])
    assert len(got[0]) >= (40 if limit else 50)
    assert _same(got, want)


def test_imageproc_processing_and_rounding():
    """ImageprocProcessing's blur and resizes, NumpyProcessing's nearest
    resize, and rust_round_f32 (halves away from zero) equal the JAX
    package's."""
    from sift_features_tpu.oracle import oracle as joracle
    from sift_features_tpu.oracle import processing as jproc

    x = np.random.RandomState(3).rand(23, 31).astype(np.float32)
    for tp, jp in ((tproc.ImageprocProcessing, jproc.ImageprocProcessing),
                   (tproc.NumpyProcessing, jproc.NumpyProcessing)):
        assert _same([tp.gaussian_blur(x, 1.7), tp.resize_linear(x, 47, 19),
                      tp.resize_nearest(x, 15, 11)],
                     [jp.gaussian_blur(x, 1.7), jp.resize_linear(x, 47, 19),
                      jp.resize_nearest(x, 15, 11)])
    v = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49999997, -3.7, 7.2],
                 np.float32)
    assert _same([toracle.rust_round_f32(v)], [joracle.rust_round_f32(v)])
    assert toracle.rust_round_f32(v)[:6].tolist() == [-3, -2, -1, 1, 2, 3]


def test_port_sift_matches_oracle(one_torch_thread):
    """The port's extractor on the CPU against its oracle at
    tests/test_fuzz.py's bar: equal counts; x, y, size and response within
    2e-3; angles within 0.5 degrees; >= 90% of descriptor rows
    byte-exact."""
    kp, dp = port.sift(IMG, device="cpu")
    ko, do = toracle.sift(IMG, proc=tproc.NumpyProcessing)
    assert len(kp) == len(ko) >= 50
    np.testing.assert_allclose(kp[:, [0, 1, 2, 4]], ko[:, [0, 1, 2, 4]],
                               rtol=0, atol=2e-3)
    dang = np.abs(kp[:, 3] - ko[:, 3])
    assert np.minimum(dang, 360 - dang).max() < 0.5
    assert (dp == do).all(1).mean() >= 0.9


def test_oracle_needs_no_cv2(monkeypatch):
    """With cv2 unimportable, the oracle package imports afresh and runs
    with NumpyProcessing: cv2 is imported only inside CvProcessing."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    for name in [m for m in sys.modules
                 if m.startswith("sift_features_tpu_torch.oracle")]:
        monkeypatch.delitem(sys.modules, name)
    fresh = importlib.import_module("sift_features_tpu_torch.oracle")
    from sift_features_tpu_torch.oracle.processing import NumpyProcessing

    kps, desc = fresh.sift(IMG[:40, :48], proc=NumpyProcessing)
    assert kps.shape[1] == 5 and desc.shape == (len(kps), 128)
    with pytest.raises(ImportError):
        fresh.sift(IMG[:40, :48])
