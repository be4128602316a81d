"""The plain reference (h100_bench/reference/) against the program's CPU
path at a small shape, and the frozen bound arithmetic against the
program's own. The reference SIFT is a frozen copy of the program's NumPy
oracle made to stand alone, so it is held bit for bit against that oracle;
the program's `device="cpu"` path is held to the reference by the
comparison that decides `correct` (reference/compare.py)."""

import numpy as np
import pytest

import sift_features_tpu_torch as port
from h100_bench.reference import compare, frame_rows, matcher
from h100_bench.reference.pixel_ops import SiftParams
from h100_bench.rooflines import k1_pyramid, k2_extrema, octaves


def _texture(seed=0, h=64, w=80):
    from scipy.ndimage import zoom

    base = np.random.RandomState(seed).rand(h // 4 + 2, w // 4 + 2)
    img = zoom(base, (h / base.shape[0], w / base.shape[1]), order=3)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


SIFT = {f: getattr(port.SiftConfig(), f) for f in port.SiftConfig.__dataclass_fields__}


@pytest.mark.parametrize("limit", [None, 40])
def test_reference_equals_program_oracle(limit):
    from sift_features_tpu_torch.oracle import sift as oracle_sift
    from sift_features_tpu_torch.oracle.processing import NumpyProcessing

    img = _texture(1)
    got = frame_rows(img, SIFT, limit)
    want = oracle_sift(img, limit, proc=NumpyProcessing)
    assert len(got[0]) >= 40
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("limit", [None, 40])
@pytest.mark.parametrize("seed", [0, 3])
def test_program_cpu_path_against_reference(seed, limit):
    img = _texture(seed)
    kp, desc = port.sift(img, features_limit=limit, device="cpu")
    kr, dr = frame_rows(img, SIFT, limit)
    assert len(kr) >= 40
    r = compare.rows_readings(kp, desc, kr, dr)
    assert r["rows_unpaired"] == 0.0, r
    assert r["kp_xy_size_err"] < 1e-3 and r["kp_angle_off"] <= 0.05, r
    assert r["desc_rows_unequal"] <= 0.1, r


def test_pairing_finds_moved_and_missing_rows():
    rng = np.random.default_rng(0)
    kp = np.column_stack([rng.uniform(0, 100, (50, 2)), rng.uniform(1, 5, 50),
                          rng.uniform(0, 360, 50), rng.uniform(0, 1, 50)]).astype(np.float32)
    desc = rng.integers(0, 255, (50, 128)).astype(np.uint8)
    same = compare.rows_readings(kp[::-1].copy(), desc[::-1].copy(), kp, desc)
    assert same["rows_unpaired"] == 0.0 and same["desc_rows_unequal"] == 0.0
    moved = kp.copy()
    moved[:5, 0] += 2.0
    r = compare.rows_readings(moved[1:], desc[1:], kp, desc)
    # rows 1-4 moved (unpaired on both sides), row 0 missing
    assert r["rows_unpaired"] == pytest.approx(9 / 50)


@pytest.mark.parametrize("cross_check", [True, False])
def test_matcher_equals_program(cross_check, monkeypatch):
    rng = np.random.default_rng(5)
    train = rng.integers(0, 90, (700, 128)).astype(np.uint8)
    train[350:360] = train[340:350]            # ties go to the lowest index
    query = np.concatenate([train[rng.choice(700, 100)],
                            rng.integers(0, 90, (60, 128)).astype(np.uint8)])
    m = port.match_descriptors(train, query, cross_check, device="cpu")
    monkeypatch.setattr(matcher, "CHUNK_ROWS", 128)
    qi, ti, d = matcher.match(train, query, cross_check)
    assert np.array_equal(qi, m.query_idx) and np.array_equal(ti, m.train_idx)
    assert np.array_equal(d, m.distance)
    assert compare.matches_readings(m, train, query, cross_check) == 0


def test_rooflines_follow_the_program():
    from sift_features_tpu_torch.models import extractor
    from sift_features_tpu_torch.ops.descriptor import PAD_DESC
    from sift_features_tpu_torch.ops.kernels import pyramid

    cfg, params = port.SiftConfig(), SiftParams.from_dict(SIFT)
    assert octaves.PAD_DESC == PAD_DESC
    for a, b in zip(k1_pyramid.octave_taps(params), pyramid.octave_taps(cfg)):
        assert np.array_equal(a, b)
    fused = octaves.fused_octaves(1080, 1920, params)
    assert [o for o, *_ in fused] == [0, 1, 2, 3, 4, 5, 6]
    for _, h, w, hp, wp in fused:
        assert (hp, wp) == extractor.padded_dims(h, w)
    nbytes, ops = k2_extrema.work(4, 2160, 3840, 2304, 4096, params)
    assert ops == 4 * 3 * (2160 - 10) * (3840 - 10) * 27
    assert nbytes == 4 * 5 * 2152 * 3832 * 4 + 4 * 3 * 2304 * 4096 // 32 * 4
