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


@pytest.fixture(scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one thread for a module of CPU tests. The suite
    runs in several pytest-xdist workers that share the host's cores, and
    the plain versions' many small ops, each spread over every core, then
    run tens of times slower than on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    g, d, _, _ = octave_fused_plain(base, CFG)
    return base.to(dev), g.to(dev), d.to(dev), (sh, sw)


def test_k1_bit_exact(dev):
    from sift_features_tpu_torch.ops.kernels.pyramid import (
        octave_fused, octave_fused_plain)

    base, _, _, _ = _octave0(dev)
    g, d, _, _ = octave_fused(base, CFG)
    torch.cuda.synchronize()
    gp, dp, _, _ = octave_fused_plain(base, CFG)
    assert torch.equal(g, gp) and torch.equal(d, dp)


FORMS = ({}, {"bf16": True}, {"split": True}, {"gather16": True})


@pytest.mark.parametrize("b", [1, 3])
def test_k1_k9_partial_tiles_bit_exact(dev, b):
    """K1 and a K9 chain in every storage form on planes that leave partial
    tiles on both axes (128-column tiles, 64-row tiles at the default
    taps), down to a plane shorter than one tile plus its halo; two
    launches byte-identical."""
    from sift_features_tpu_torch.ops.kernels.pyramid import (
        build_octave_padded_batched, build_octave_padded_batched_plain,
        octave_fused, octave_fused_plain)

    rng = np.random.RandomState(7)
    for hp, wp in ((72, 200), (136, 300), (200, 129), (40, 60)):
        base = torch.as_tensor(rng.rand(b, hp, wp).astype(np.float32) * 255,
                               device=dev)
        for form in FORMS:
            kw = {k: v for k, v in form.items() if k != "bf16"}
            x = base.to(torch.bfloat16) if form.get("bf16") else base
            for fn, plain in ((octave_fused, octave_fused_plain),
                              (build_octave_padded_batched,
                               build_octave_padded_batched_plain)):
                got, again = fn(x, CFG, **kw), fn(x, CFG, **kw)
                torch.cuda.synchronize()
                for a, a2, p in zip(got, again, plain(x, CFG, **kw)):
                    assert (a is None and p is None) or (
                        torch.equal(a, p) and torch.equal(a, a2)), (hp, wp, form)


def test_k1_other_radii_bit_exact(dev):
    """A configuration whose radii are not the default octave's runs the
    level kernel with run-time tap loops; bit-exact as well."""
    import dataclasses

    from sift_features_tpu_torch.ops.kernels.pyramid import (
        octave_fused, octave_fused_plain, octave_taps)

    cfg = dataclasses.replace(CFG, scales_per_octave=2)
    assert {len(t) for t in octave_taps(cfg)} - {11, 13, 17, 21, 27}
    base = torch.as_tensor(np.random.RandomState(8).rand(2, 136, 300)
                           .astype(np.float32), device=dev)
    for x in (base, base.to(torch.bfloat16)):
        got = octave_fused(x, cfg)
        torch.cuda.synchronize()
        for a, p in zip(got, octave_fused_plain(x, cfg)):
            assert (a is None and p is None) or torch.equal(a, p)


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


def _k2_edge_dog(rng, b, n_p, hp, wp, bounds):
    """A DoG with plateaus (values on a 0.5 grid: ties at the max and the
    min), exact zeros of both signs, and strict extrema planted on the first
    and last rows and columns of `bounds` and on columns 31, 32, 63 and 64
    of a word."""
    d = np.round(rng.randn(b, n_p, hp, wp) * 2) / 2
    d[rng.rand(*d.shape) < 0.1] = 0.0
    d[rng.rand(*d.shape) < 0.02] = -0.0
    y0, y1, x0, x1 = bounds
    ys, xs = (y0, y1 - 1, (y0 + y1) // 2), (x0, x1 - 1, 31, 32, 63, 64)
    for i, (y, x) in enumerate((y, x) for y in ys for x in xs):
        d[:, 1 + i % (n_p - 2), y, x] = 9.0 if i % 2 else -9.0
    return torch.as_tensor(d.astype(np.float32))


@pytest.mark.parametrize("b", [1, 3])
def test_k2_edges_bit_exact(dev, b):
    """K2 (and K2′ at b = 1) on plateaus, zeros and extrema at the bounds'
    edges and at word edges, with a plane height that is not a multiple of
    the kernel's 32-row strips and bounds inside or at the plane's edge, at
    S = 3 (one launch) and S = 2, 4 (scale groups), in f32 and bf16:
    bit-equal to the plain version, two launches identical."""
    import dataclasses

    from sift_features_tpu_torch.ops.kernels.extrema import (
        extrema_words, extrema_words_plain, extrema_words_single)

    rng = np.random.RandomState(11)
    for S in (3, 2, 4):
        cfg = dataclasses.replace(CFG, scales_per_octave=S)
        for hp, wp, bounds in ((70, 256, (3, 67, 1, 255)), (45, 384, (0, 45, 0, 384)),
                               (100, 128, (5, 96, 20, 120))):
            d = _k2_edge_dog(rng, b, S + 2, hp, wp, bounds).to(dev)
            for x in (d, d.to(torch.bfloat16)):
                got, again = extrema_words(x, bounds, cfg), extrema_words(x, bounds, cfg)
                torch.cuda.synchronize()
                want = extrema_words_plain(x, bounds, cfg)
                assert torch.equal(got, want) and torch.equal(got, again), (S, hp, x.dtype)
                assert int((got != 0).sum()) > 20
                if b == 1:
                    one = extrema_words_single(x[0], bounds, cfg)
                    torch.cuda.synchronize()
                    assert torch.equal(one, want[0])


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


def test_k3_edges_bit_exact(dev):
    """K3 at lane counts that are not multiples of 32 (1, 33 and 300: a
    last warp cut short), with the extractor's bool mask, an int32 one,
    every third lane dead and every lane dead: rows bit-equal to the plain
    refine's, dead lanes (0, s0, y0, x0, 0, ...), two launches identical."""
    from sift_features_tpu_torch.ops.extrema import refine
    from sift_features_tpu_torch.ops.kernels.refine import refine_walk

    flat, s0, y0, x0, valid, poff, (h, w) = _candidates(dev, k=150)
    n = s0.numel()
    assert n % 32 != 0
    third = valid & (torch.arange(n, device=dev) % 3 != 0)
    for mask in (valid, third, torch.zeros_like(valid)):
        for k in (1, 33, n):
            a = (flat, s0[:k], y0[:k], x0[:k], mask[:k], P, h, w, CFG)
            got = refine_walk(*a, plane_off=poff[:k])
            again = refine_walk(*a, plane_off=poff[:k])
            as_int = refine_walk(*a[:4], mask[:k].int(), *a[5:], plane_off=poff[:k])
            torch.cuda.synchronize()
            for other in (again, as_int, refine(*a, plane_off=poff[:k])):
                assert torch.equal(got, other), (k, int(mask.sum()))
            dead = ~mask[:k]
            assert not got[dead][:, [0, *range(4, 16)]].any()
            start = torch.stack([s0[:k], y0[:k], x0[:k]], 1)[dead].float()
            assert torch.equal(got[dead][:, 1:4], start)
        if mask.any():
            assert int((got[:, 8] > 0).sum()) > 5


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


def test_k9_bit_exact(dev):
    from sift_features_tpu_torch.ops.kernels.pyramid import (
        build_octave_padded, build_octave_padded_plain, octave_fused)

    base, _, _, _ = _octave0(dev, b=1)
    g, d = build_octave_padded(base[0], CFG)
    g2, d2 = build_octave_padded(base[0], CFG)
    torch.cuda.synchronize()
    gp, dp = build_octave_padded_plain(base[0], CFG)
    assert torch.equal(g, gp) and torch.equal(d, dp)
    assert torch.equal(g, g2) and torch.equal(d, d2)
    # a chain of K9 levels is the K1 octave
    g1, d1, _, _ = octave_fused(base, CFG)
    assert torch.equal(g[:CFG.scales_per_octave], g1[0]) and torch.equal(d, d1[0])


def test_k2_single_bit_exact(dev):
    from sift_features_tpu_torch.ops.kernels.extrema import (
        extrema_words_plain, extrema_words_single)

    _, _, d, (h, w) = _octave0(dev, b=1)
    b = CFG.image_border
    bounds = (P + b, P + h - b, P + b, P + w - b)
    words = extrema_words_single(d[0], bounds, CFG)
    torch.cuda.synchronize()
    assert torch.equal(words, extrema_words_plain(d, bounds, CFG)[0])
    assert int((words != 0).sum()) > 10


def test_k5_prefix_matches_plain(dev):
    from sift_features_tpu_torch.ops.kernels.orientation import (
        orientation_hist_prefix, orientation_plain)

    c = _survivor_windows(dev)
    count = torch.tensor(211, device=dev)
    args = (c["gauss_flat"], c["plane"], c["y"], c["x"], c["kp_scale"])
    tail = (c["h"], c["w"], P, CFG)
    h1, a1, n1 = orientation_hist_prefix(*args, count, *tail)
    h2, a2, n2 = orientation_hist_prefix(*args, count, *tail)
    torch.cuda.synchronize()
    live = torch.arange(c["plane"].numel(), device=dev) < count
    hp, ap, npk = orientation_plain(*args, live, *tail)
    assert torch.equal(h1, h2) and torch.equal(a1, a2) and torch.equal(n1, n2)
    torch.testing.assert_close(h1, hp, rtol=1e-6, atol=1e-7)
    assert torch.equal(n1, npk)
    torch.testing.assert_close(a1, ap, rtol=1e-6, atol=1e-4)
    assert not h1[211:].any() and not n1[211:].any()


def test_k5_edge_lanes_match_plain(dev):
    """K5 and K5′ (one kernel, a warp per lane) on lanes of radius 16 at the
    image border and of radius 0, with every lane dead, a lane count that is
    not a multiple of the lanes per block, scattered liveness, and the
    prefix form at count 0, 1 and K, on f32 and bf16 levels: raw rows, peak
    angles and counts equal to the plain version's bit for bit (the same
    summation order), two launches identical, and raw rows equal to K8's
    where K8 takes the same lanes."""
    from sift_features_tpu_torch.ops.kernels.orientation import (
        orientation_hist_peaks, orientation_hist_perkey, orientation_hist_prefix,
        orientation_plain)
    from sift_features_tpu_torch.ops.util import round_half_away

    c = _survivor_windows(dev, n=301)
    n = c["plane"].numel()
    h, w = c["h"], c["w"]
    L = CFG.scales_per_octave
    scale, plane = c["kp_scale"].clone(), c["plane"].clone()
    y, x, live = c["y"].clone(), c["x"].clone(), c["live"].clone()
    # radius 16 at the four borders and corners; radius 0
    scale[:8], plane[:8] = 3.59, plane[:8] - plane[:8] % L + 2
    y[:8] = torch.tensor([0, h - 1, 0, h - 1, 0, h // 2, h - 1, 1], device=dev)
    x[:8] = torch.tensor([0, w - 1, w - 1, 0, w // 2, 0, w // 2, w - 2], device=dev)
    scale[8:12] = 0.05
    live[:12] = True
    radii = round_half_away(scale[:12] * np.float32(3.0 * CFG.lambda_ori))
    assert int(radii[:8].min()) == 16 and int(radii[8:].max()) == 0
    tail = (h, w, P, CFG)
    for g in (c["gauss_flat"], c["gauss_flat"].to(torch.bfloat16)):
        lanes = (g, plane, y, x, scale)
        for lv in (live, torch.zeros_like(live)):
            got = orientation_hist_peaks(*lanes, lv, *tail)
            again = orientation_hist_peaks(*lanes, lv, *tail)
            torch.cuda.synchronize()
            for a, a2, p in zip(got, again, orientation_plain(*lanes, lv, *tail)):
                assert torch.equal(a, p) and torch.equal(a, a2)
            assert not got[0][~lv].any() and not got[2][~lv].any()
        for k in (0, 1, n):
            count = torch.tensor(k, device=dev)
            got = orientation_hist_prefix(*lanes, count, *tail)
            torch.cuda.synchronize()
            lv = torch.arange(n, device=dev) < count
            for a, p in zip(got, orientation_plain(*lanes, lv, *tail)):
                assert torch.equal(a, p)
            # K8 on the same lanes at the largest window bound
            k8 = orientation_hist_perkey(*lanes, count, h, w, P, 16, CFG)
            torch.cuda.synchronize()
            assert torch.equal(k8, got[0])


def test_k6_prefix_matches_plain(dev):
    from sift_features_tpu_torch.ops.kernels.descriptor import (
        descriptor_hist_prefix, descriptor_plain)

    c = _survivor_windows(dev)
    count = torch.tensor(173, device=dev)
    args = (c["gauss_flat"], c["plane"], c["x"], c["y"], c["kp_scale"],
            c["angle"])
    tail = (c["h"], c["w"], P, CFG)
    d1 = descriptor_hist_prefix(*args, count, *tail)
    d2 = descriptor_hist_prefix(*args, count, *tail)
    torch.cuda.synchronize()
    live = torch.arange(c["plane"].numel(), device=dev) < count
    assert torch.equal(d1, d2)
    torch.testing.assert_close(d1, descriptor_plain(*args, live, *tail),
                               rtol=1e-6, atol=1e-7)
    assert not d1[173:].any()


def test_k6_edge_lanes_match_plain(dev):
    """K6 and K6′ with dead lanes, count 0 and window radii at both ends of
    the main path's 17-38, on f32 and bf16 levels; two launches identical."""
    from sift_features_tpu_torch.ops.kernels.descriptor import (
        descriptor_hist, descriptor_hist_prefix, descriptor_plain)
    from sift_features_tpu_torch.ops.util import round_half_away

    c = _survivor_windows(dev)
    n = c["plane"].numel()
    L = CFG.scales_per_octave
    scale = c["kp_scale"].clone()
    plane = c["plane"].clone()
    # radius 17 on level 1, radius 38 on level 3
    scale[:20], plane[:20] = 1.6, plane[:20] - plane[:20] % L
    scale[20:40], plane[20:40] = 3.59, plane[20:40] - plane[20:40] % L + 2
    factor = CFG.lambda_descr * np.sqrt(2.0) * (CFG.descriptor_n_histograms + 1) / 2
    radii = round_half_away(scale[:40] * np.float32(factor))
    assert int(radii.min()) == 17 and int(radii.max()) == 38
    live = c["live"].clone()
    live[40:60] = False
    for g in (c["gauss_flat"], c["gauss_flat"].to(torch.bfloat16)):
        args = (g, plane, c["x"], c["y"], scale, c["angle"])
        tail = (c["h"], c["w"], P, CFG)
        d1, d2 = descriptor_hist(*args, live, *tail), descriptor_hist(*args, live, *tail)
        torch.cuda.synchronize()
        assert torch.equal(d1, d2) and not d1[40:60].any()
        torch.testing.assert_close(d1, descriptor_plain(*args, live, *tail),
                                   rtol=1e-6, atol=1e-7)
        for k in (0, 1, n):
            count = torch.tensor(k, device=dev)
            p1 = descriptor_hist_prefix(*args, count, *tail)
            p2 = descriptor_hist_prefix(*args, count, *tail)
            torch.cuda.synchronize()
            lv = torch.arange(n, device=dev) < count
            assert torch.equal(p1, p2) and not p1[k:].any()
            torch.testing.assert_close(p1, descriptor_plain(*args, lv, *tail),
                                       rtol=1e-6, atol=1e-7)


def test_budget_single_split_on_card(dev):
    """The budget, per-frame and split paths on the card against the port
    on the CPU."""
    from sift_features_tpu_torch.models import extractor as tx

    imgs = smooth_images(1, 2, 96, 128)
    rc = tx.extract_batch(imgs, features_limit=37, device=dev)
    rh = tx.extract_batch(imgs, features_limit=37, device="cpu")
    for key in ("valid", "src_idx", "n_emitted"):
        assert torch.equal(rc[key].cpu(), rh[key]), key
    torch.testing.assert_close(rc["kps"].cpu(), rh["kps"], rtol=0, atol=1e-3)
    n_oct = rh["n_emitted"].shape[1]
    one = tx._extract_single(torch.as_tensor(imgs[0], device=dev), n_oct, CFG)
    full = tx.extract_batch(imgs, device=dev)
    for key in ("n_candidates", "n_survivors", "n_emitted", "valid", "kps",
                "desc"):
        assert torch.equal(one[key], full[key][0]), key
    octs, dogs = tx.precompute(imgs, device=dev)
    sp = tx.extract_with_precomputed(octs, dogs, device=dev)
    assert torch.equal(sp["valid"].sum(1), full["valid"].sum(1))


def _candidates(dev, k=512):
    """Seed-octave candidates of the batched path, flattened over frames:
    (dog_flat, s0, y0, x0, valid, plane_off, (h, w))."""
    from sift_features_tpu_torch.ops.extrema import find_candidates_words
    from sift_features_tpu_torch.ops.kernels.extrema import extrema_words

    _, _, d, (h, w) = _octave0(dev)
    b = CFG.image_border
    words = extrema_words(d, (P + b, P + h - b, P + b, P + w - b), CFG)
    s0, y0, x0, valid, _ = find_candidates_words(words, k)
    B, n_dog = d.shape[:2]
    poff = (torch.arange(B, device=dev, dtype=torch.int32)
            * n_dog).repeat_interleave(k)
    return (d.reshape(B * n_dog, *d.shape[2:]), s0.reshape(-1), y0.reshape(-1),
            x0.reshape(-1), valid.reshape(-1), poff, (h, w))


def test_k10_matches_k4_and_plain(dev):
    from sift_features_tpu_torch.ops.kernels.refine import (
        refine_step, refine_step_region)

    flat, s0, y0, x0, valid, poff, _ = _candidates(dev)
    p = torch.clamp(s0, 1, CFG.scales_per_octave) + poff
    # a region with more candidates than a block has threads: 300 lanes on
    # one 8 x 128 band
    y = torch.cat([y0, torch.full((300,), 70, device=dev, dtype=y0.dtype)])
    x = torch.cat([x0, (60 + torch.arange(300, device=dev) % 120).to(x0.dtype)])
    p = torch.cat([p, torch.full((300,), 2, device=dev, dtype=p.dtype)])
    act = torch.cat([valid, torch.ones(300, device=dev, dtype=torch.bool)])
    k10 = refine_step_region(flat, p, y, x, act, CFG)
    k10b = refine_step_region(flat, p, y, x, act, CFG)
    k4 = refine_step(flat, p, y, x, act, CFG)
    torch.cuda.synchronize()
    plain = refine_step_region(flat.cpu(), p.cpu(), y.cpu(), x.cpu(), act.cpu(),
                               CFG)
    bits = lambda t: t.cpu().view(torch.int32)  # noqa: E731 (NaN-safe equality)
    assert torch.equal(bits(k10), bits(k10b))
    assert torch.equal(bits(k10), bits(k4))
    assert torch.equal(bits(k10), bits(plain))


def test_k11_matches_plain_and_k3(dev):
    from sift_features_tpu_torch.ops.kernels.refine import (
        refine_tile, refine_tile_plain, refine_tile_slots, refine_walk,
        tile_layout)

    flat, s0, y0, x0, valid, poff, (h, w) = _candidates(dev)
    g = tile_layout(flat, s0, y0, x0, valid, P, CFG, poff)
    slots = refine_tile_slots(flat, g, P, h, w, CFG)
    slots2 = refine_tile_slots(flat, g, P, h, w, CFG)
    torch.cuda.synchronize()
    assert torch.equal(slots, slots2)
    assert torch.equal(slots, refine_tile_plain(flat, g, P, h, w, CFG))
    args = (flat, s0, y0, x0, valid, P, h, w, CFG)
    assert torch.equal(refine_tile(*args, plane_off=poff),
                       refine_walk(*args, plane_off=poff))


def _ramp_case():
    """test_pallas_kernels.py:test_refine_tile_escape_fallback's input: a
    smooth ramp gives near-singular Hessians and long Newton steps."""
    rng = np.random.RandomState(9)
    h, w = 160, 200
    yg, xg = np.mgrid[0:h, 0:w].astype(np.float32)
    dog = np.stack([0.001 * xg + 0.0005 * yg + 0.03 * np.sin(i + xg / 40.0)
                    for i in range(5)]).astype(np.float32)
    dog += (rng.randn(5, h, w) * 1e-5).astype(np.float32)
    K = 128
    s = rng.randint(1, 4, K).astype(np.int32)
    y = rng.randint(20, h - 20, K).astype(np.int32)
    x = rng.randint(20, w - 20, K).astype(np.int32)
    return dog, s, y, x, np.ones(K, bool)


def _check_k11(dev, args, poff=None):
    """K11's slot rows on args = (flat, s0, y0, x0, valid, pad, h, w, cfg):
    two launches identical, equal to the plain version bit for bit (escape
    flags included), zero on empty slots, and the merged rows equal K3's.
    Returns (layout, slot rows)."""
    from sift_features_tpu_torch.ops.kernels.refine import (
        refine_tile, refine_tile_plain, refine_tile_slots, refine_walk,
        tile_layout)

    flat, _, _, _, _, pad, h, w, cfg = args
    g = tile_layout(*args[:5], pad, cfg, poff)
    slots = refine_tile_slots(flat, g, pad, h, w, cfg)
    slots2 = refine_tile_slots(flat, g, pad, h, w, cfg)
    torch.cuda.synchronize()
    assert torch.equal(slots, slots2)
    assert torch.equal(slots, refine_tile_plain(flat, g, pad, h, w, cfg))
    assert not slots[g.a_slot == 0].any()
    assert torch.equal(refine_tile(*args, plane_off=poff),
                       refine_walk(*args, plane_off=poff))
    return g, slots


def test_k11_ramp_escapes_bit_exact(dev):
    """The ramp makes walks leave their window: escape flags and rows as
    the plain version's, and the K4 loop's re-refinement merged as K3's."""
    dog, s, y, x, valid = _ramp_case()
    _, h, w = dog.shape
    hp = -(-(h + 2 * P) // 8) * 8
    wp = -(-(w + 2 * P) // 128) * 128
    dog_p = np.zeros((5, hp, wp), np.float32)
    dog_p[:, P:P + h, P:P + w] = dog
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    _, slots = _check_k11(dev, (t(dog_p), t(s), t(y + P), t(x + P), t(valid),
                                P, h, w, CFG))
    assert int((slots[:, 9] > 0).sum()) > 0


def test_k11_crowded_region_bit_exact(dev):
    """A region holding more candidates than a block of TILE_BK slots, so
    several blocks share one window origin, beside the seed octave's real
    candidates of two frames."""
    from sift_features_tpu_torch.ops.kernels.refine import TILE_BK

    flat, s0, y0, x0, valid, poff, (h, w) = _candidates(dev)
    rng = np.random.RandomState(4)
    n = 3 * TILE_BK + 5
    # one 32 x 64 region of frame 1 (rows 64-95, columns 128-191), inside
    # the image
    ys = torch.from_numpy(rng.randint(64, 96, n)).to(dev, y0.dtype)
    xs = torch.from_numpy(rng.randint(128, 192, n)).to(dev, x0.dtype)
    ss = torch.from_numpy(rng.randint(1, 4, n)).to(dev, s0.dtype)
    cat = lambda a, b: torch.cat([a, b])  # noqa: E731
    args = (flat, cat(s0, ss), cat(y0, ys), cat(x0, xs),
            cat(valid, torch.ones(n, device=dev, dtype=valid.dtype)), P, h, w,
            CFG)
    poff = cat(poff, torch.full((n,), CFG.scales_per_octave + 2, device=dev,
                                dtype=poff.dtype))
    g, slots = _check_k11(dev, args, poff)
    live = g.active_b > 0
    origin = torch.stack([g.pb_b, g.r0_b, g.c0_b], 1)[live]
    assert origin.unique(dim=0).shape[0] < origin.shape[0]
    assert int((slots[:, 0] > 0).sum()) > n // 4


def test_k10_edges_bit_exact(dev):
    """No active lane; K not a multiple of 128 with positions past the
    clamps; lanes on a flat patch of the DoG (singular Hessians: NaN
    offsets, zeroed in the rows) and on a patch of 1e-15 noise (near-
    singular: infinite offsets and NaN responses in the rows): rows equal
    K4's and the plain step's bit for bit."""
    from sift_features_tpu_torch.ops.extrema import newton_step
    from sift_features_tpu_torch.ops.kernels.refine import (
        refine_step, refine_step_region)

    flat, s0, y0, x0, valid, poff, _ = _candidates(dev, k=150)
    rng = np.random.RandomState(6)
    flat = flat.clone()
    flat[:, 60:80, 60:100] = 0.25
    flat[:, 100:120, 60:100] = torch.from_numpy(
        rng.randn(flat.shape[0], 20, 40).astype(np.float32) * 1e-15).to(dev)
    n = 48
    p = torch.clamp(s0, 1, CFG.scales_per_octave) + poff
    pp = torch.from_numpy(rng.randint(1, 4, n)).to(dev, p.dtype)
    yy = torch.from_numpy(np.r_[rng.randint(62, 78, n // 2),
                                rng.randint(102, 118, n // 2)]).to(dev, y0.dtype)
    xx = torch.from_numpy(rng.randint(62, 98, n)).to(dev, x0.dtype)
    # past the clamps: planes 0 and n_planes - 1, rows and columns outside
    n_p, hp, wp = flat.shape
    ep = torch.tensor([0, n_p - 1, 2, 2], device=dev, dtype=p.dtype)
    ey = torch.tensor([70, 70, 0, hp + 5], device=dev, dtype=y0.dtype)
    ex = torch.tensor([70, 70, wp - 1, -3], device=dev, dtype=x0.dtype)
    p, y, x = torch.cat([p, pp, ep]), torch.cat([y0, yy, ey]), torch.cat([x0, xx, ex])
    act = torch.cat([valid, torch.ones(n + 4, device=dev, dtype=valid.dtype)])
    assert p.numel() % 128 != 0
    bits = lambda t: t.view(torch.int32)  # noqa: E731 (NaN-safe equality)
    for a in (torch.zeros_like(act), act):
        k10 = refine_step_region(flat, p, y, x, a, CFG)
        k10b = refine_step_region(flat, p, y, x, a, CFG)
        k4 = refine_step(flat, p, y, x, a, CFG)
        plain = newton_step(flat, p, y, x, a, CFG)
        torch.cuda.synchronize()
        assert torch.equal(bits(k10), bits(k10b))
        assert torch.equal(bits(k10), bits(k4))
        assert torch.equal(bits(k10), bits(plain))
    # the flat patch: no convergence, no step, zeroed offsets
    on_flat = k10[-(n + 4):-(n // 2 + 4)]
    assert not on_flat[:, 0:7].any()
    assert not torch.isfinite(k10[:, 4:8]).all()


def test_k4_edges_bit_exact(dev):
    """K4 on an f32 and a bf16 DoG: inactive lanes holding positions far
    outside the stack (zero rows, nothing read), lanes on a flat patch, a
    patch of 1e-15 noise and patches of NaN and of infinities (non-finite
    offsets and responses), positions past the plane, row and column
    clamps, and K = 1, 129 and all lanes: rows bit-equal (NaN-safe) to the
    plain step and to K10's on the f32 widening of the same DoG, the same
    for the loop's bool mask and an int32 mask, two launches identical."""
    from sift_features_tpu_torch.ops.extrema import newton_step
    from sift_features_tpu_torch.ops.kernels.refine import (
        refine_step, refine_step_region)

    flat, s0, y0, x0, valid, poff, _ = _candidates(dev, k=150)
    rng = np.random.RandomState(12)
    flat = flat.clone()
    n_p, hp, wp = flat.shape
    flat[:, 60:80, 60:100] = 0.25
    flat[:, 100:120, 60:100] = torch.from_numpy(
        rng.randn(n_p, 20, 40).astype(np.float32) * 1e-15).to(dev)
    flat[:, 130:140, 60:80] = float("nan")
    flat[:, 130:140, 80:100] = float("inf")
    flat[1::2, 130:140, 90:100] = float("-inf")
    n = 64
    p = torch.clamp(s0, 1, CFG.scales_per_octave).int() + poff.int()
    pp = torch.from_numpy(rng.randint(1, 4, n)).to(dev, torch.int32)
    yy = torch.from_numpy(np.r_[rng.randint(62, 78, n // 4), rng.randint(102, 118, n // 4),
                                rng.randint(129, 141, n // 2)]).to(dev, torch.int32)
    xx = torch.from_numpy(rng.randint(58, 102, n)).to(dev, torch.int32)
    # past the clamps: planes 0 and n_planes - 1, rows and columns outside
    ep = torch.tensor([0, n_p - 1, 2, 2, 2], device=dev, dtype=torch.int32)
    ey = torch.tensor([70, 70, 0, hp + 5, -7], device=dev, dtype=torch.int32)
    ex = torch.tensor([70, 70, wp - 1, -3, wp + 9], device=dev, dtype=torch.int32)
    # inactive lanes with positions no stack holds
    big = torch.tensor([2 ** 30, -2 ** 30, 2 ** 31 - 1], device=dev, dtype=torch.int32)
    p = torch.cat([p, pp, ep, big])
    y = torch.cat([y0.int(), yy, ey, big.flip(0)])
    x = torch.cat([x0.int(), xx, ex, big])
    act = torch.cat([valid.bool(), torch.ones(n + 5, device=dev, dtype=torch.bool),
                     torch.zeros(3, device=dev, dtype=torch.bool)])
    bits = lambda t: t.view(torch.int32)  # noqa: E731 (NaN-safe equality)
    for dog in (flat, flat.to(torch.bfloat16)):
        for k in (1, 129, p.numel()):
            a = (p[:k], y[:k], x[:k], act[:k])
            got = refine_step(dog, *a, CFG)
            again = refine_step(dog, *a, CFG)
            as_int = refine_step(dog, *a[:3], a[3].int(), CFG)
            k10 = refine_step_region(dog.float(), *a, CFG)
            torch.cuda.synchronize()
            for other in (again, as_int, k10, newton_step(dog, *a, CFG)):
                assert torch.equal(bits(got), bits(other)), (dog.dtype, k)
            assert not got[~a[3]].any()
        assert not torch.isfinite(got[:, 4:8]).all(), dog.dtype
        assert int(got[:, 0].sum()) > 5


def test_k8_edges_bit_exact(dev):
    """K8 (K5's kernel without peaks) on f32 and bf16 levels at each bucket
    bound r_max: lanes on image rows and columns 0, 1, h-2 and h-1, lanes
    whose radius exceeds r_max (clamped to it), K = 1 and K = 301 (not a
    multiple of the 32 x 5 lanes a block's warps take in a round), count 0,
    1 and K: raw rows bit-equal to the plain version's (zero past the
    count), two launches identical, and equal to K5's raw rows on the live
    lanes whose radius is within r_max."""
    from sift_features_tpu_torch.ops.kernels.orientation import (
        bucket_radii_ori, orientation_hist_peaks, orientation_hist_perkey,
        orientation_raw_plain)
    from sift_features_tpu_torch.ops.util import round_half_away

    c = _survivor_windows(dev, n=301)
    n = c["plane"].numel()
    h, w = c["h"], c["w"]
    L = CFG.scales_per_octave
    scale, plane = c["kp_scale"].clone(), c["plane"].clone()
    y, x = c["y"].clone(), c["x"].clone()
    # every pair of rows 0, 1, h-2, h-1 and columns 0, 1, w-2, w-1, at
    # radius 16 on level 3; then radius 18 (past every bound), 0 and 11
    edge_y, edge_x = (0, 1, h - 2, h - 1), (0, 1, w - 2, w - 1)
    yx = torch.tensor([(a, b) for a in edge_y for b in edge_x], device=dev)
    y[:16], x[:16] = yx[:, 0].to(y.dtype), yx[:, 1].to(x.dtype)
    scale[:16], plane[:16] = 3.59, plane[:16] - plane[:16] % L + 2
    scale[16:20], scale[20:24], scale[24:28] = 4.0, 0.05, 2.5
    radii = round_half_away(scale * np.float32(3.0 * CFG.lambda_ori))
    assert int(radii[:16].min()) == 16 and int(radii[16:20].min()) == 18
    tail = (h, w, P)
    for g in (c["gauss_flat"], c["gauss_flat"].to(torch.bfloat16)):
        lanes = (g, plane, y, x, scale)
        k5 = orientation_hist_peaks(*lanes, torch.ones_like(c["live"]), *tail, CFG)[0]
        for r_max in sorted(set(bucket_radii_ori(CFG).values())):
            for k, counts in ((1, (0, 1)), (n, (0, 1, 173, n))):
                a = tuple(t[:k] for t in lanes[1:])
                for cnt in counts:
                    count = torch.tensor(cnt, device=dev)
                    got = orientation_hist_perkey(g, *a, count, *tail, r_max, CFG)
                    again = orientation_hist_perkey(g, *a, count, *tail, r_max, CFG)
                    torch.cuda.synchronize()
                    live = torch.arange(k, device=dev) < count
                    plain = orientation_raw_plain(g, *a, live, *tail, CFG, r_max)
                    assert torch.equal(got, plain) and torch.equal(got, again), (
                        g.dtype, r_max, k, cnt)
                    assert not got[cnt:].any()
                    inside = live & (radii[:k] <= r_max)
                    assert torch.equal(got[inside], k5[:k][inside])
            assert int((radii > r_max).sum()) >= 4


def test_k8_matches_plain_and_k5(dev):
    from sift_features_tpu_torch.ops.kernels.orientation import (
        bucket_radii_ori, orientation_hist_peaks, orientation_hist_perkey)

    c = _survivor_windows(dev)
    count = torch.tensor(211, device=dev)
    args = (c["gauss_flat"], c["plane"], c["y"], c["x"], c["kp_scale"], count,
            c["h"], c["w"], P, bucket_radii_ori(CFG)[3], CFG)
    h1 = orientation_hist_perkey(*args)
    h2 = orientation_hist_perkey(*args)
    live = torch.arange(c["plane"].numel(), device=dev) < count
    k5 = orientation_hist_peaks(*args[:5], live, c["h"], c["w"], P, CFG)[0]
    torch.cuda.synchronize()
    plain = orientation_hist_perkey(*(a.cpu() if torch.is_tensor(a) else a
                                      for a in args))
    assert torch.equal(h1, h2) and torch.equal(h1, k5)
    torch.testing.assert_close(h1.cpu(), plain, rtol=1e-6, atol=1e-7)
    assert not h1[211:].any()


def test_k7_matches_plain_and_k6(dev):
    from sift_features_tpu_torch.ops.kernels.descriptor import (
        bucket_radii, descriptor_hist, descriptor_hist_perkey)

    c = _survivor_windows(dev)
    count = torch.tensor(173, device=dev)
    args = (c["gauss_flat"], c["plane"], c["x"], c["y"], c["kp_scale"],
            c["angle"], count, c["h"], c["w"], P, bucket_radii(CFG)[3], CFG)
    d1 = descriptor_hist_perkey(*args)
    d2 = descriptor_hist_perkey(*args)
    live = torch.arange(c["plane"].numel(), device=dev) < count
    k6 = descriptor_hist(*args[:6], live, c["h"], c["w"], P, CFG)
    torch.cuda.synchronize()
    plain = descriptor_hist_perkey(*(a.cpu() if torch.is_tensor(a) else a
                                     for a in args))
    assert torch.equal(d1, d2) and torch.equal(d1, k6)
    torch.testing.assert_close(d1.cpu(), plain, rtol=1e-6, atol=1e-7)
    assert not d1[173:].any()


def test_modes_on_card_equal_default(dev):
    import dataclasses

    from sift_features_tpu_torch.models import extractor as tx
    from sift_features_tpu_torch.ops.kernels import build

    imgs = smooth_images(1, 2, 96, 128)
    want = tx.extract_batch(imgs, device=dev)
    for kw, kernels in (({"refine_mode": "region"}, ("K10",)),
                        ({"refine_mode": "tile"}, ("K11",)),
                        ({"window_kernel": "perkey"}, ("K7", "K8"))):
        build.reset_launches()
        got = tx.extract_batch(imgs, dataclasses.replace(CFG, **kw), device=dev)
        torch.cuda.synchronize()
        assert all(build.LAUNCHES.get(k) for k in kernels), build.LAUNCHES
        for key in want:
            assert torch.equal(got[key], want[key]), (kw, key)


STORAGE = {"bfloat16": {"storage_dtype": "bfloat16"},
           "split": {"storage_dtype": "split"},
           "gather16": {"gather_dtype": "bfloat16"}}


def test_storage_pyramid_forms_bit_exact(dev):
    """K1 and K9 in each storage form, K2 and K4 on a bf16 DoG: bit-equal
    to their plain versions, each counted under its form's name."""
    from sift_features_tpu_torch.ops.extrema import find_candidates_words, newton_step
    from sift_features_tpu_torch.ops.kernels import build
    from sift_features_tpu_torch.ops.kernels.extrema import (
        extrema_words, extrema_words_plain)
    from sift_features_tpu_torch.ops.kernels.pyramid import (
        build_octave_padded_batched, build_octave_padded_batched_plain,
        octave_fused, octave_fused_plain)
    from sift_features_tpu_torch.ops.kernels.refine import refine_step

    base, _, _, (h, w) = _octave0(dev)
    base16 = base.to(torch.bfloat16)
    build.reset_launches()
    for b, kw in ((base16, {}), (base, {"split": True}),
                  (base, {"gather16": True})):
        got = octave_fused(b, CFG, **kw)
        got9 = build_octave_padded_batched(b, CFG, **kw)
        torch.cuda.synchronize()
        for a, p in zip(got + got9, octave_fused_plain(b, CFG, **kw)
                        + build_octave_padded_batched_plain(b, CFG, **kw)):
            assert (a is None and p is None) or torch.equal(a, p), kw
    n_lv = CFG.scales_per_octave + 2
    # gather16 copies levels 1..S: its deeper K9 levels are plain f32 ones
    assert build.LAUNCHES == {"K1:bf16": 1, "K1:split": 1, "K1:g16": 1,
                              "K9:bf16": n_lv, "K9:split": n_lv,
                              "K9:g16": n_lv - 2, "K9": 2}
    _, d16, _, _ = octave_fused(base16, CFG)
    b = CFG.image_border
    bounds = (P + b, P + h - b, P + b, P + w - b)
    words = extrema_words(d16, bounds, CFG)
    assert torch.equal(words, extrema_words_plain(d16, bounds, CFG))
    s0, y0, x0, valid, _ = find_candidates_words(words, 512)
    flat = d16.reshape(-1, *d16.shape[2:])
    p = (torch.clamp(s0, 1, CFG.scales_per_octave)
         + (torch.arange(2, device=dev) * n_lv)[:, None]).reshape(-1)
    args = (flat, p, y0.reshape(-1), x0.reshape(-1), valid.reshape(-1), CFG)
    rows = refine_step(*args)
    torch.cuda.synchronize()
    bits = lambda t: t.view(torch.int32)  # noqa: E731 (NaN-safe equality)
    assert torch.equal(bits(rows), bits(newton_step(*args)))
    assert int(valid.sum()) > 10
    assert build.LAUNCHES["K2:bf16"] == 1 and build.LAUNCHES["K4:bf16"] == 1


def test_storage_window_kernels_match_plain(dev):
    """K5, K5′, K6, K6′, K8 and K7 on bf16 Gaussian levels against their
    plain versions, with the f32 tests' tolerances."""
    from sift_features_tpu_torch.ops.kernels import build
    from sift_features_tpu_torch.ops.kernels import descriptor as k6
    from sift_features_tpu_torch.ops.kernels import orientation as k5

    c = _survivor_windows(dev)
    g16 = c["gauss_flat"].to(torch.bfloat16)
    count = torch.tensor(173, device=dev)
    live = torch.arange(c["plane"].numel(), device=dev) < count
    close = dict(rtol=1e-6, atol=1e-7)
    build.reset_launches()
    lanes = (c["plane"], c["y"], c["x"], c["kp_scale"])
    tail = (c["h"], c["w"], P, CFG)
    h1, a1, n1 = k5.orientation_hist_peaks(g16, *lanes, c["live"], *tail)
    hp, ap, npk = k5.orientation_plain(g16, *lanes, c["live"], *tail)
    torch.testing.assert_close(h1, hp, **close)
    assert torch.equal(n1, npk)
    h2 = k5.orientation_hist_prefix(g16, *lanes, count, *tail)[0]
    torch.testing.assert_close(h2, k5.orientation_plain(g16, *lanes, live, *tail)[0],
                               **close)
    r3 = k5.bucket_radii_ori(CFG)[3]
    h3 = k5.orientation_hist_perkey(g16, *lanes, count, *tail[:3], r3, CFG)
    torch.testing.assert_close(h3, k5.orientation_raw_plain(
        g16, *lanes, live, *tail[:3], CFG, r3), **close)
    dl = (c["plane"], c["x"], c["y"], c["kp_scale"], c["angle"])
    d1 = k6.descriptor_hist(g16, *dl, c["live"], *tail)
    torch.testing.assert_close(d1, k6.descriptor_plain(g16, *dl, c["live"], *tail),
                               **close)
    d2 = k6.descriptor_hist_prefix(g16, *dl, count, *tail)
    torch.testing.assert_close(d2, k6.descriptor_plain(g16, *dl, live, *tail),
                               **close)
    r6 = k6.bucket_radii(CFG)[3]
    d3 = k6.descriptor_hist_perkey(g16, *dl, count, *tail[:3], r6, CFG)
    torch.testing.assert_close(d3, k6.descriptor_plain(
        g16, *dl, live, *tail[:3], CFG, r_max=r6), **close)
    torch.cuda.synchronize()
    assert sorted(build.LAUNCHES) == sorted(
        ["K5:bf16", "K5′:bf16", "K8:bf16", "K6:bf16", "K6′:bf16", "K7:bf16"])
    # the bf16 levels are read as such: not the f32 levels' histograms
    assert not torch.equal(d1, k6.descriptor_hist(c["gauss_flat"], *dl, c["live"],
                                                  *tail))


def test_storage_modes_card_matches_cpu(dev):
    """Each storage mode's extract_batch on the card against its CPU run,
    with its kernel forms launched; the gather16 budget equal to its
    truncated unbudgeted output."""
    import dataclasses

    from sift_features_tpu_torch.models import extractor as tx
    from sift_features_tpu_torch.ops.kernels import build

    imgs = smooth_images(1, 2, 96, 128)
    need = {"bfloat16": ("K1:bf16", "K2:bf16", "K4:bf16", "K5:bf16", "K6:bf16"),
            "split": ("K1:split", "K3", "K5:bf16", "K6:bf16"),
            "gather16": ("K1:g16", "K3", "K5:bf16", "K6:bf16")}
    for mode, fields in STORAGE.items():
        cfg = dataclasses.replace(CFG, **fields)
        build.reset_launches()
        rc = tx.extract_batch(imgs, cfg, device=dev)
        torch.cuda.synchronize()
        assert all(build.LAUNCHES.get(k) for k in need[mode]), build.LAUNCHES
        assert not build.LAUNCHES.get("K3") or mode != "bfloat16"
        rh = tx.extract_batch(imgs, cfg, device="cpu")
        for key in ("n_candidates", "n_survivors", "n_emitted", "valid"):
            assert torch.equal(rc[key].cpu(), rh[key]), (mode, key)
        v = rh["valid"]
        assert int(v.sum()) > 100
        torch.testing.assert_close(rc["kps"].cpu()[v], rh["kps"][v], rtol=0,
                                   atol=1e-3)
        rows_eq = (rc["desc"].cpu()[v] == rh["desc"][v]).all(1).float().mean()
        assert float(rows_eq) >= 0.99, mode
        if mode == "gather16":
            rb = tx.extract_batch(imgs, cfg, features_limit=37, device=dev)
            want = tx._truncate_result(rc, 37)
            assert all(torch.equal(rb[k], want[k]) for k in want)


def _stream_reference(dev, frames, b, cfg=CFG):
    """Per-frame (kps, desc) of extract_batch on the card, b frames a call."""
    from sift_features_tpu_torch.models.extractor import extract_batch

    want = []
    for lo in range(0, len(frames), b):
        r = extract_batch(frames[lo:lo + b], cfg, device=dev)
        v = r["valid"].cpu().numpy()
        want += [(r["kps"][f].cpu().numpy()[v[f]],
                  r["desc"][f].cpu().numpy()[v[f]]) for f in range(len(v))]
    return want


def _check_stream(got, want):
    """Streamed batches (per-frame pairs, or compact=False dicts, masked
    here) against _stream_reference's pairs."""
    got = [pair for batch in got for pair in (
        batch if isinstance(batch, list) else
        [(k[v], d[v]) for k, d, v in zip(batch["kps"], batch["desc"],
                                         batch["valid"])])]
    assert len(got) == len(want)
    for (kps, desc), (wk, wd) in zip(got, want):
        assert len(kps) > 20
        assert kps.tobytes() == wk.tobytes() and desc.tobytes() == wd.tobytes()


def test_stream_pinned_rotation_on_card(dev):
    """The streaming executor on the card gives every frame equal to
    extract_batch: a producer that rewrites one pinned buffer as soon as
    copy_done's event has completed (producer_rotates, depth=2), and a
    producer that rewrites one pageable buffer at once (the snapshot
    path); also with window_kernel="perkey", whose extraction takes no
    host sync of its own. The default compact=True: the compaction needs no
    native tier."""
    import dataclasses

    from sift_features_tpu_torch.parallel.stream import stream_extract

    frames = smooth_images(4, 6, 96, 128)
    for cfg in (CFG, dataclasses.replace(CFG, window_kernel="perkey")):
        want = _stream_reference(dev, frames, 2, cfg)
        pinned = torch.empty((2, 96, 128), dtype=torch.uint8,
                             pin_memory=True).numpy()
        events = []

        def rotating():
            for i in range(3):
                if events:
                    events[-1].synchronize()
                pinned[:] = frames[2 * i:2 * i + 2]
                yield pinned

        _check_stream(stream_extract(rotating(), cfg, depth=2,
                                     producer_rotates=True,
                                     device=dev, copy_done=events.append),
                      want)
        assert len(events) == 3
        pageable = np.empty((2, 96, 128), np.uint8)

        def reusing():
            for i in range(3):
                pageable[:] = frames[2 * i:2 * i + 2]
                yield pageable

        _check_stream(stream_extract(reusing(), cfg, depth=2, compact=False,
                                     device=dev), want)
        _check_stream(stream_extract(reusing(), cfg, depth=2, device=dev),
                      want)


def test_stream_paths_on_card(dev, tmp_path):
    """JPEG files through the native decode pool's rotating pinned buffers
    (stream_extract_paths, ragged tail) equal extract_batch on their
    decode_gray frames. Needs libjpeg's header (the native tier builds
    with it)."""
    import subprocess

    from sift_features_tpu_torch.io.native_loader import decode_gray
    from sift_features_tpu_torch.io.native_output import write_jpeg
    from sift_features_tpu_torch.parallel.stream import stream_extract_paths

    probe = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                           input="#include <jpeglib.h>\n", text=True,
                           capture_output=True)
    if probe.returncode != 0:
        pytest.skip("g++ finds no jpeglib.h: the native tier cannot build")
    frames = smooth_images(4, 5, 96, 128)
    paths = []
    for i, img in enumerate(frames):
        paths.append(str(tmp_path / f"f{i}.jpg"))
        write_jpeg(paths[-1], img, quality=92)
    decoded = np.stack([decode_gray(p) for p in paths])
    _check_stream(stream_extract_paths(paths, 2, (96, 128), depth=2,
                                       device=dev),
                  _stream_reference(dev, decoded, 2))


def test_one_rank_nccl_step_on_card(dev):
    """extract_match_step on a one-rank NCCL group at 240 x 320 (B=2):
    its extraction equals extract_batch's, its matches the tagged dense
    reference, and its ring launches no collective."""
    import socket

    import torch.distributed as dist

    from sift_features_tpu_torch.models import extractor
    from sift_features_tpu_torch.parallel import mesh as tmesh
    from sift_features_tpu_torch.parallel import pipeline, ring
    from sift_features_tpu_torch.parallel.runner import init_distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert init_distributed(f"127.0.0.1:{port}", 1, 0, device=dev) == 0
    try:
        assert dist.get_backend() == "nccl"
        mesh = tmesh.make_mesh(device=dev)
        frames = smooth_images(5, 2, 240, 320)
        n_oct = extractor._n_octaves(240, 320, CFG)
        for limit in (None, 300):
            got = pipeline.extract_match_step(frames, n_oct, CFG, mesh, 128,
                                              limit)
            want = extractor.extract_batch(frames, CFG, limit, device=dev)
            for k in ("kps", "desc", "valid", "n_candidates", "n_survivors",
                      "n_emitted"):
                assert torch.equal(got[k], want[k]), k
            _, q, qv, qt, t, tv, tt = pipeline.queries_and_database(got, 0, 128)
            ref = ring.match_tagged_dense(t, tv, tt, q, qv, qt)
            for k, r in zip(("match_train", "match_dist", "match_keep"), ref):
                assert torch.equal(got[k].reshape(-1), r), k
            assert int(got["match_keep"].sum()) > 20
    finally:
        dist.destroy_process_group()


def test_int8_matcher_on_card(dev, monkeypatch):
    """SIFT_INT8_MATCH=1 on the card (torch._int_mm) equals the f64 path
    bit for bit, in one chunk and in chunks whose last one is padded, with
    a query of fewer than 17 rows (padded for _int_mm) and of many."""
    from sift_features_tpu_torch.ops import matcher

    rng = np.random.RandomState(6)
    train = torch.from_numpy(rng.randint(0, 256, (1003, 128)).astype(np.uint8)).to(dev)
    for n_q in (5, 300):
        query = torch.from_numpy(rng.randint(0, 256, (n_q, 128)).astype(np.uint8)).to(dev)
        query[:3] = train[[7, 500, 1002]]
        for temp in (matcher.TEMP_BYTES, 4 * n_q * 200):
            monkeypatch.setattr(matcher, "TEMP_BYTES", temp)
            for cc in (True, False):
                a = matcher.match_dense(train, query, cc)
                b = matcher.match_dense(train, query, cc, int8=True)
                for x, y in zip(a, b):
                    assert torch.equal(x, y)


def test_matcher_stage_clock_on_card(dev, monkeypatch):
    """Under torch.profiler on the card, match_dense leaves
    `matcher.distance` / `matcher.select` spans with stream time, one per
    stage, and the answer equals the untraced one bit for bit; outside a
    session no stage clock is taken. u8 rows take M1 (one launch, route
    "kernel"), f32 rows the chunk loop (six chunks, route "plain")."""
    from sift_features_tpu_torch.ops import matcher
    from sift_features_tpu_torch.utils import profiling

    rng = np.random.RandomState(8)
    train = torch.from_numpy(rng.randint(0, 256, (5003, 128)).astype(np.uint8)).to(dev)
    query = torch.from_numpy(rng.randint(0, 256, (300, 128)).astype(np.uint8)).to(dev)
    monkeypatch.setattr(matcher, "TEMP_BYTES", 8 * 300 * 1000)
    for rows, chunks, route in ((train, 1, "kernel"), (train.float(), 6, "plain")):
        q = query if rows.dtype == torch.uint8 else query.float()
        profiling.clear()
        plain = matcher.match_dense(rows, q)
        assert {s.name for s in profiling.spans()} == {"matcher.prepare", "matcher.chunks"}
        profiling.clear()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            traced = matcher.match_dense(rows, q)
            torch.cuda.synchronize()
        for a, b in zip(plain, traced):
            assert torch.equal(a, b)
        spans = {s.name: s for s in profiling.spans()}
        ch = spans["matcher.chunks"]
        assert ch.attrs == {"chunks": chunks, "pairs": 300 * 5003, "route": route}
        for name in matcher.STAGES:
            s = spans[name]
            assert s.parent == ch.id and s.attrs == {"chunks": chunks}
            assert s.stream_ms > 0
    profiling.clear()


def _loop_match(monkeypatch, train, query, cc=True):
    """match_dense's chunk loop on the card: the route M1 replaces."""
    from sift_features_tpu_torch.ops import matcher

    with monkeypatch.context() as m:
        m.setattr(matcher, "kernel_route", lambda *a: False)
        return matcher.match_dense(train, query, cc)


def _check_m1(monkeypatch, train, query):
    """M1 (one launch a call) against the chunk loop, bit for bit, with and
    without the cross-check; returns M1's cross-checked answer."""
    from sift_features_tpu_torch.ops import matcher
    from sift_features_tpu_torch.ops.kernels import build

    out = None
    for cc in (True, False):
        want = _loop_match(monkeypatch, train, query, cc)
        n = build.LAUNCHES.get("M1", 0)
        got = matcher.match_dense(train, query, cc)
        assert build.LAUNCHES.get("M1", 0) == n + 1
        for name, a, b in zip(("best_train", "distance", "keep"), got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (
                name, tuple(train.shape), tuple(query.shape), cc)
        out = got if cc else out
    return out


def _u8_rows(gen, n, dev, width=128):
    return torch.randint(0, 256, (n, width), generator=gen, dtype=torch.uint8,
                         device=dev)


M1_SHAPES = ([(q, t) for q in (1, 17, 1000, 8192)
              for t in (1, 129, 100003, 1048576)]
             + [(1024, 1100), (20000, 100003), (8191, 100003)])


def test_m1_matches_loop_on_card(dev, monkeypatch):
    """M1 equals the chunk loop bit for bit (best_train, distance, keep, with
    and without the cross-check) at Q in {1, 17, 1000, 8192} x T in {1, 129,
    100003, 1048576}, the video step's ~1k x ~1k, a query of 20,000 rows
    (ten passes of the kernel's 2,048), an odd Q against a ragged T
    (8,191 x 100,003: the last operand packs a query row beside a padding
    row) and rows of 64 bytes; a quarter of
    the queries are copies of train rows, so the cross-check keeps some.
    Rows of 130 bytes, wider than M1's keys hold, take the loop (no launch)
    and equal the CPU's answer."""
    from sift_features_tpu_torch.ops import matcher
    from sift_features_tpu_torch.ops.kernels import build

    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    for n_q, n_t in M1_SHAPES:
        train, query = _u8_rows(gen, n_t, dev), _u8_rows(gen, n_q, dev)
        k = n_q // 4
        if k:
            idx = torch.randint(0, n_t, (k,), generator=gen, device=dev)
            query[:k] = train[idx]
        _, _, keep = _check_m1(monkeypatch, train, query)
        assert not k or keep.any()
    train, query = _u8_rows(gen, 1000, dev, 64), _u8_rows(gen, 300, dev, 64)
    query[:50] = train[200:250]
    _check_m1(monkeypatch, train, query)
    train, query = _u8_rows(gen, 500, dev, 130), _u8_rows(gen, 200, dev, 130)
    query[:50] = train[100:150]
    n = build.LAUNCHES.get("M1", 0)
    got = matcher.match_dense(train, query)
    assert build.LAUNCHES.get("M1", 0) == n
    for a, b in zip(got, matcher.match_dense(train.cpu(), query.cpu())):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


def test_m1_ties_on_card(dev, monkeypatch):
    """Planted ties: the lowest index wins on both sides, across tiles,
    blocks of queries, blocks of the grid and passes. Duplicated train
    rows (the first copy wins a query), duplicated query rows (the first
    copy keeps the cross-check), and all-equal rows (every distance tied:
    train row 0 wins every query, query 0 every train row). Then the ends
    of the packed fields: all-255 queries against all-0 train rows (every
    d^2 128 x 255^2) and against all-255 rows (every d^2 0), and all-0
    queries against all-255 rows beside them (the largest field)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(61)
    train, query = _u8_rows(gen, 132 * 64 * 2 + 5, dev), _u8_rows(gen, 9000, dev)
    for dup in (70, 8000, 16000, 16900):
        train[dup] = train[3]
    query[:8] = train[3]
    query[20] = train[100]
    dups = [130, 4000, 8191, 8192, 8999]
    query[dups] = query[20].clone()
    bt, dist, keep = _check_m1(monkeypatch, train, query)
    assert bt[:8].eq(3).all() and dist[:8].eq(0).all()
    assert keep[0] and not keep[1:8].any()
    assert bt[20] == 100 and bt[dups].eq(100).all()
    assert keep[20] and not keep[dups].any()
    row = _u8_rows(gen, 1, dev)
    for n_t, n_q in ((130, 260), (1, 9000), (9000, 1)):
        train = row.expand(n_t, -1).contiguous()
        query = _u8_rows(gen, 1, dev).expand(n_q, -1).contiguous()
        bt, _, keep = _check_m1(monkeypatch, train, query)
        assert bt.eq(0).all() and keep[0] and keep.sum() == 1
    full = torch.full((1, 128), 255, dtype=torch.uint8, device=dev)
    zero = torch.zeros_like(full)
    for t_row, d2 in ((zero, 128 * 255 ** 2), (full, 0)):
        train = t_row.expand(9000, -1).contiguous()
        query = full.expand(8999, -1).contiguous()
        bt, dist, keep = _check_m1(monkeypatch, train, query)
        assert bt.eq(0).all() and keep[0] and keep.sum() == 1
        assert torch.equal(dist, torch.full_like(dist, d2 ** 0.5))
    train = torch.cat([zero.expand(4000, -1), full.expand(5000, -1)])
    query = torch.cat([full.expand(300, -1), zero.expand(200, -1)])
    bt, dist, keep = _check_m1(monkeypatch, train, query)
    assert bt[:300].eq(4000).all() and bt[300:].eq(0).all()
    assert dist.eq(0).all() and keep[0] and keep[300] and keep.sum() == 2


def test_m1_service_query_on_card(dev, monkeypatch):
    """DescriptorIndex.query on a small seeded map takes M1 (one launch a
    query) and gives the chunk loop's QueryResult."""
    from sift_features_tpu_torch.ops import matcher
    from sift_features_tpu_torch.ops.kernels import build
    from sift_features_tpu_torch.service import DescriptorIndex

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    n_f, per = 24, 700
    desc = _u8_rows(gen, n_f * per, dev).view(n_f, per, 128)
    kps = torch.rand((n_f, per, 5), generator=gen, device=dev)
    valid = torch.rand((n_f, per), generator=gen, device=dev) < 0.9
    idx = DescriptorIndex(device=dev)
    idx.add_batch_result({"kps": kps, "desc": desc, "valid": valid},
                         np.arange(100, 100 + n_f, dtype=np.int64))
    q = desc[3][:500].cpu().numpy().copy()
    q[250:] = _u8_rows(gen, 250, dev).cpu().numpy()
    for _ in range(2):
        n = build.LAUNCHES.get("M1", 0)
        got = idx.query(q)
        assert build.LAUNCHES.get("M1", 0) == n + 1
    with monkeypatch.context() as m:
        m.setattr(matcher, "kernel_route", lambda *a: False)
        want = idx.query(q)
    for f in ("query_idx", "frame_id", "keypoint_idx", "distance"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert len(got.query_idx) > 100 and (got.frame_id == 103).sum() > 100
