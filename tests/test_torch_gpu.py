"""Card tests of the port: each CUDA kernel against its plain PyTorch version
at small shapes, and the port on the card against the port on the CPU.

They need an NVIDIA card with nvcc (the kernels build at first use) and skip
elsewhere. On the card machine, where JAX is not installed, run them without
the suite's conftest:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from sift_features_tpu_torch.config import DEFAULT_CONFIG as CFG
from sift_features_tpu_torch.ops.descriptor import PAD_DESC as P

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def smooth_images(seed, b, h, w, n_blobs=12, blur=2.0):
    """uint8 frames of blurred noise plus Gaussian blobs (keypoints at every
    octave)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    out = []
    for _ in range(b):
        n = gaussian_filter(rng.rand(h, w), blur)
        n = (n - n.min()) / (n.max() - n.min())
        for _ in range(n_blobs):
            cy, cx, s = rng.rand() * h, rng.rand() * w, 2 + rng.rand() * 10
            n = n + (rng.rand() - 0.5) * 1.5 * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        out.append(((n - n.min()) / (n.max() - n.min()) * 255).astype(np.uint8))
    return np.stack(out)


def _octave0(dev, b=2, h=96, w=128):
    """Seed-octave inputs of the batched path: (base, gauss, dog, (h, w))."""
    from sift_features_tpu_torch.models.extractor import padded_dims
    from sift_features_tpu_torch.ops.kernels.pyramid import (
        octave_fused_plain, reflect_pad_image)
    from sift_features_tpu_torch.ops.pyramid import create_seed_image

    seed = create_seed_image(torch.as_tensor(smooth_images(0, b, h, w)), CFG)
    sh, sw = seed.shape[-2:]
    hp, wp = padded_dims(sh, sw)
    base = reflect_pad_image(seed, P, wp - sw - 2 * P, hp - sh - 2 * P)
    g, d = octave_fused_plain(base, CFG)
    return base.to(dev), g.to(dev), d.to(dev), (sh, sw)


def test_k1_bit_exact(dev):
    from sift_features_tpu_torch.ops.kernels.pyramid import (
        octave_fused, octave_fused_plain)

    base, _, _, _ = _octave0(dev)
    g, d = octave_fused(base, CFG)
    torch.cuda.synchronize()
    gp, dp = octave_fused_plain(base, CFG)
    assert torch.equal(g, gp) and torch.equal(d, dp)


def test_k2_bit_exact(dev):
    from sift_features_tpu_torch.ops.kernels.extrema import (
        extrema_words, extrema_words_plain)

    _, _, d, (h, w) = _octave0(dev)
    b = CFG.image_border
    bounds = (P + b, P + h - b, P + b, P + w - b)
    words = extrema_words(d, bounds, CFG)
    torch.cuda.synchronize()
    assert torch.equal(words, extrema_words_plain(d, bounds, CFG))
    assert int((words != 0).sum()) > 10


def test_k3_k4_bit_exact(dev):
    from sift_features_tpu_torch.ops.extrema import find_candidates_words
    from sift_features_tpu_torch.ops.kernels.extrema import extrema_words
    from sift_features_tpu_torch.ops.kernels.refine import (
        refine_stepwise, refine_walk)
    from sift_features_tpu_torch.ops.extrema import refine

    _, _, d, (h, w) = _octave0(dev)
    b = CFG.image_border
    words = extrema_words(d, (P + b, P + h - b, P + b, P + w - b), CFG)
    s0, y0, x0, valid, _ = find_candidates_words(words, 512)
    B, n_dog = d.shape[:2]
    flat = d.reshape(B * n_dog, *d.shape[2:])
    poff = (torch.arange(B, device=dev, dtype=torch.int32)
            * n_dog).repeat_interleave(512)
    args = (flat, s0.reshape(-1), y0.reshape(-1), x0.reshape(-1),
            valid.reshape(-1), P, h, w, CFG)
    walk = refine_walk(*args, plane_off=poff)
    step = refine_stepwise(*args, plane_off=poff)
    torch.cuda.synchronize()
    plain = refine(*args, plane_off=poff)
    assert torch.equal(walk, plain) and torch.equal(step, plain)
    assert int((walk[:, 8] > 0).sum()) > 5


def _survivor_windows(dev, n=300):
    """Scattered-liveness lanes over the seed octave's Gaussian levels 1-3
    (the layout K5/K6 read on the main path)."""
    _, g, _, (h, w) = _octave0(dev)
    rng = np.random.RandomState(5)
    B, L = g.shape[:2]
    s = rng.randint(1, 4, n)
    lo = np.array([0.0, 1.6, 2.26, 2.85])[s]
    hi = np.array([0.0, 2.26, 2.85, 3.59])[s]
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
    return dict(
        gauss_flat=g.reshape(B * L, *g.shape[2:]),
        plane=t(rng.randint(0, B, n) * L + s - 1, torch.int32),
        y=t(rng.randint(2, h - 2, n), torch.int32),
        x=t(rng.randint(2, w - 2, n), torch.int32),
        kp_scale=t(lo + (hi - lo) * rng.rand(n), torch.float32),
        angle=t(rng.rand(n) * 360.0, torch.float32),
        live=t(rng.rand(n) > 0.25, torch.bool), h=h, w=w)


def test_k5_matches_plain(dev):
    from sift_features_tpu_torch.ops.kernels.orientation import (
        orientation_hist_peaks, orientation_plain)

    c = _survivor_windows(dev)
    args = (c["gauss_flat"], c["plane"], c["y"], c["x"], c["kp_scale"],
            c["live"], c["h"], c["w"], P, CFG)
    h1, a1, n1 = orientation_hist_peaks(*args)
    h2, a2, n2 = orientation_hist_peaks(*args)
    torch.cuda.synchronize()
    hp, ap, npk = orientation_plain(*args)
    # run to run: identical bytes (fixed summation order, no atomics)
    assert torch.equal(h1, h2) and torch.equal(a1, a2) and torch.equal(n1, n2)
    # against the plain version: same summation order; tolerance covers the
    # f64 exp / sin of two libraries (they round to the same f32 in practice)
    torch.testing.assert_close(h1, hp, rtol=1e-6, atol=1e-7)
    assert torch.equal(n1, npk)
    torch.testing.assert_close(a1, ap, rtol=1e-6, atol=1e-4)


def test_k6_matches_plain(dev):
    from sift_features_tpu_torch.ops.kernels.descriptor import (
        descriptor_hist, descriptor_plain)

    c = _survivor_windows(dev)
    args = (c["gauss_flat"], c["plane"], c["x"], c["y"], c["kp_scale"],
            c["angle"], c["live"], c["h"], c["w"], P, CFG)
    d1 = descriptor_hist(*args)
    d2 = descriptor_hist(*args)
    torch.cuda.synchronize()
    assert torch.equal(d1, d2)
    torch.testing.assert_close(d1, descriptor_plain(*args), rtol=1e-6,
                               atol=1e-7)


def test_card_matches_cpu(dev):
    from sift_features_tpu_torch.models.extractor import extract_batch

    imgs = smooth_images(1, 2, 96, 128)
    rc = extract_batch(imgs, device=dev)
    rh = extract_batch(imgs, device="cpu")
    for key in ("n_candidates", "n_survivors", "n_emitted", "valid"):
        assert torch.equal(rc[key].cpu(), rh[key]), key
    v = rh["valid"]
    assert int(v.sum()) > 100
    torch.testing.assert_close(rc["kps"].cpu()[v], rh["kps"][v], rtol=0,
                               atol=1e-3)
    rows_eq = (rc["desc"].cpu()[v] == rh["desc"][v]).all(1).float().mean()
    assert float(rows_eq) >= 0.99
