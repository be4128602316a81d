"""The port's other refine and window modes against the JAX package and
against the port's default path, on the CPU:

- the plain version of K10 (region-grouped Newton step) against the Pallas
  refine_step_region kernel in interpret mode, and against K4's;
- the tile refinement (grouping, the plain version of K11, the merge of the
  escaped walks) against ops/extrema.py:refine, on strided real candidates
  and on a ramp that makes walks escape. The JAX refine_tile_tpu in
  interpret mode is left out: it compiles for ~36 s, and the JAX package
  holds it against the same refine (test_pallas_kernels.py);
- the grouping against JAX group_by_region at the TPU's geometry;
- the plain versions of K8 and K7 against the Pallas per-keypoint kernels
  in interpret mode on one scale bucket each (one compile each, ~13 s and,
  at a 2 x 2 x 4 descriptor, ~6 s), and against K5's and K6's raw rows on
  every bucket;
- the budget and single-frame paths in each mode byte-equal to the default
  configuration's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_features_tpu.config import DEFAULT_CONFIG as JCFG
from sift_features_tpu.ops import descriptor as jdesc
from sift_features_tpu.ops import extrema as jext
from sift_features_tpu_torch.config import DEFAULT_CONFIG as CFG
from sift_features_tpu_torch.models import extractor as tx
from sift_features_tpu_torch.ops.extrema import newton_step, refine, refine_loop
from sift_features_tpu_torch.ops.kernels import descriptor as tk6
from sift_features_tpu_torch.ops.kernels import orientation as tk5
from sift_features_tpu_torch.ops.kernels import refine as tkr
from sift_features_tpu_torch.utils.region_group import group_by_region

from test_torch_gpu import _ramp_case, one_torch_thread, smooth_images  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

P = jdesc.PAD_DESC
MODES = {"region": {"refine_mode": "region"}, "tile": {"refine_mode": "tile"},
         "perkey": {"window_kernel": "perkey"}}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_k10_plain_matches_pallas_region():
    """The inputs of test_pallas_kernels.py:test_refine_region_step_matches_
    perstep: shared regions, 128-column straddlers, inactive lanes."""
    from sift_features_tpu.ops.pallas.refine_region_kernel import (
        refine_step_region)

    rng = np.random.RandomState(7)
    S, Hp, Wp = 5, 64, 384
    dog = (rng.randn(S, Hp, Wp) * 0.05).astype(np.float32)
    K, count = 32, 27
    s = rng.randint(1, 4, K).astype(np.int32)
    cy = rng.randint(18, Hp - 20, 4)
    cx = rng.randint(18, Wp - 20, 4)
    ci = rng.randint(0, 4, K)
    y = np.clip(cy[ci] + rng.randint(-6, 7, K), 1, Hp - 17).astype(np.int32)
    x = np.clip(cx[ci] + rng.randint(-6, 7, K), 1, Wp - 3).astype(np.int32)
    x[:4] = 126 + (np.arange(4) % 3) + 128 * rng.randint(0, 2, 4)
    active = (np.arange(K) < count).astype(np.int32)

    want = np.asarray(refine_step_region(
        jnp.asarray(dog), jnp.asarray(s), jnp.asarray(y), jnp.asarray(x),
        jnp.asarray(active), Wp, JCFG, True))
    args = (_t(dog), _t(s), _t(y), _t(x), _t(active))
    got = tkr.refine_step_region(*args, CFG).numpy()
    # the region kernel's contract (test_pallas_kernels.py:509-515): ok,
    # steps and keep exact; offsets and response compared wherever finite
    # (the TPU kernel zeroes non-finite fields, the port keeps K4's values).
    # XLA:CPU compiles the interpret-mode kernel with some multiply-adds
    # contracted, so those carry test_k4_plain_matches_pallas_step's
    # tolerance (the JAX package's own for its step kernel)
    a = slice(0, count)
    for c in (0, 1, 2, 3, 8):
        np.testing.assert_array_equal(got[a, c], want[a, c])
    fin = np.isfinite(got[a, 4:8]).all(1)
    assert fin.sum() > count // 2
    np.testing.assert_allclose(got[a, 4:7][fin], want[a, 4:7][fin], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[a, 7][fin], want[a, 7][fin], rtol=1e-5,
                               atol=1e-7)
    assert (got[count:] == 0).all()
    # and K4's rows bit for bit, non-finite values included
    k4 = newton_step(*args, CFG).numpy()
    np.testing.assert_array_equal(got.view(np.int32), k4.view(np.int32))
    # several candidates share a region: fewer region runs in the sorted
    # keys of the active lanes than active lanes, and more than one
    g = tkr.region_order(*args[1:], S, Hp, Wp)
    keys = g["key"][:int(g["n_active"])]
    n_runs = 1 + int((keys[1:] != keys[:-1]).sum())
    assert int(g["n_active"]) == count
    assert 1 < n_runs < count


def _strided_case():
    """test_pallas_kernels.py:test_refine_tile_kernel_matches_xla's input:
    real candidates strided over the scan order of a noise DoG."""
    rng = np.random.RandomState(5)
    h, w = 180, 200
    dog = (rng.randn(5, h, w) * 0.05).astype(np.float32)
    mask = np.asarray(jext.extrema_mask(jnp.asarray(dog), JCFG))
    s0, y0, x0 = np.nonzero(mask.reshape(3, h, w))
    K = 256
    k = min(K, len(s0))
    pick = np.linspace(0, len(s0) - 1, k).astype(int)
    s = np.ones(K, np.int32)
    y = np.full(K, 0, np.int32)
    x = np.full(K, 0, np.int32)
    s[:k], y[:k], x[:k] = s0[pick] + 1, y0[pick], x0[pick]
    return dog, s, y, x, np.arange(K) < k


@pytest.mark.parametrize("case", [_strided_case, _ramp_case])
def test_tile_refine_matches_xla_refine(case):
    dog, s, y, x, valid = case()
    _, h, w = dog.shape
    Hp = -(-(h + 2 * P) // 8) * 8
    Wp = -(-(w + 2 * P) // 128) * 128
    dog_p = np.zeros((5, Hp, Wp), np.float32)
    dog_p[:, P:P + h, P:P + w] = dog
    args = (_t(dog_p), _t(s), _t(y + P), _t(x + P), _t(valid), P, h, w, CFG)
    rows = tkr.refine_tile(*args)
    # the tile rows equal the port's plain refine (K3's plain version) bit
    # for bit, escaped walks included
    assert torch.equal(rows, refine(*args))
    g = tkr.tile_layout(*args[:5], P, CFG)
    slots = tkr.refine_tile_slots(args[0], g, P, h, w, CFG)
    n_esc = int((slots[:, 9] > 0).sum())
    # and ops/extrema.py:refine of the JAX package, op by op (no jit: XLA
    # contracts multiply-adds under jit), on the unpadded stack
    ref = {k: np.asarray(v) for k, v in jext.refine(
        jnp.asarray(dog), jnp.asarray(s), jnp.asarray(y), jnp.asarray(x),
        jnp.asarray(valid), JCFG).items()}
    ok = rows[:, 0].numpy() > 0
    np.testing.assert_array_equal(ok & valid, ref["ok"] & valid)
    conv = ok & valid
    for c, key, off in ((1, "s", 0), (2, "y", P), (3, "x", P)):
        np.testing.assert_array_equal(rows[:, c].numpy()[conv] - off,
                                      ref[key][conv], err_msg=key)
    for c, key in ((4, "off_s"), (5, "off_y"), (6, "off_x"), (7, "response")):
        np.testing.assert_array_equal(rows[:, c].numpy()[conv], ref[key][conv],
                                      err_msg=key)
    np.testing.assert_array_equal((rows[:, 8].numpy() > 0) & conv,
                                  ref["keep"] & valid)
    if case is _ramp_case:
        assert n_esc > 0, "the ramp must make some walks escape the window"
    else:
        assert conv.sum() > 20


def test_k3_wrapper_takes_bool_or_int_mask():
    """K3's wrapper takes the extractor's bool mask as it is (the kernel
    reads one byte a lane) and an int32 mask alike: the same rows, those of
    the plain refine; dead lanes keep their start positions."""
    dog, s, y, x, valid = _strided_case()
    valid = valid & (np.arange(valid.size) % 5 != 0)
    _, h, w = dog.shape
    Hp = -(-(h + 2 * P) // 8) * 8
    Wp = -(-(w + 2 * P) // 128) * 128
    dog_p = np.zeros((5, Hp, Wp), np.float32)
    dog_p[:, P:P + h, P:P + w] = dog
    base = (_t(dog_p), _t(s), _t(y + P), _t(x + P))
    rows = [tkr.refine_walk(*base, _t(v), P, h, w, CFG)
            for v in (valid, valid.astype(np.int32))]
    assert rows[0].dtype == torch.float32
    assert torch.equal(rows[0], rows[1])
    assert torch.equal(rows[0], refine(*base, _t(valid), P, h, w, CFG))
    dead = ~valid
    assert not rows[0][dead][:, [0, *range(4, 16)]].any()
    np.testing.assert_array_equal(rows[0][dead][:, 1:4].numpy(),
                                  np.stack([s, y + P, x + P], 1)[dead])
    assert int((rows[0][:, 0] > 0).sum()) > 20


def test_tile_plain_counts_walks_per_step():
    """refine_tile_plain's per-step counts (chip_smoke.py's K11 bound reads
    them): on strided candidates no walk escapes its window, so the tile
    walks going at each step are the plain refine loop's active lanes."""
    dog, s, y, x, valid = _strided_case()
    _, h, w = dog.shape
    Hp = -(-(h + 2 * P) // 8) * 8
    Wp = -(-(w + 2 * P) // 128) * 128
    dog_p = np.zeros((5, Hp, Wp), np.float32)
    dog_p[:, P:P + h, P:P + w] = dog
    args = (_t(dog_p), _t(s), _t(y + P), _t(x + P), _t(valid), P, h, w)
    g = tkr.tile_layout(*args[:6], CFG)
    walks, active = [], []
    slots = tkr.refine_tile_plain(args[0], g, P, h, w, CFG, counts=walks)
    assert int((slots[:, 9] > 0).sum()) == 0

    def step(p, y_, x_, act):
        active.append(int(act.sum()))
        return newton_step(args[0], p, y_, x_, act, CFG)
    refine_loop(step, *args[1:], CFG)
    assert walks == active
    assert len(walks) == CFG.max_interpolation_steps
    assert walks[0] == int(valid.sum()) and walks[1] > 0


def test_grouping_matches_jax_group_by_region():
    """Two frames, clustered candidates (a region with more candidates than
    a block holds, neighbouring regions whose blocks are adjacent), invalid
    lanes; the TPU's geometry, and K11's on a small block."""
    from sift_features_tpu.ops.pallas.region_group import (
        group_by_region as jgroup)

    rng = np.random.RandomState(3)
    Hp, Wp, n_dog, K = 384, 1024, 5, 300
    s = rng.randint(1, 4, K).astype(np.int32)
    y = rng.randint(60, Hp - 60, K).astype(np.int32)
    x = rng.randint(60, Wp - 60, K).astype(np.int32)
    y[:40], x[:40] = rng.randint(130, 140, 40), rng.randint(520, 540, 40)
    y[40:50], x[40:50] = 131, rng.randint(500, 511, 10)
    valid = rng.rand(K) > 0.1
    poff = np.repeat(np.arange(2, dtype=np.int32) * n_dog, K // 2)
    geom = (128, 512, 160, 768, 16, 128, 128)
    jl = jgroup(jnp.asarray(s), jnp.asarray(y), jnp.asarray(x),
                jnp.asarray(valid), P, Hp, Wp, n_dog, 2, jnp.asarray(poff),
                *geom)
    tl = group_by_region(_t(s), _t(y), _t(x), _t(valid), P, Hp, Wp, n_dog, 2,
                         _t(poff), *geom)
    assert tl.T_cap == jl.T_cap and tl.nb == jl.nb
    for f in ("s_slot", "y_slot", "x_slot", "a_slot", "seg_b", "r0_b", "c0_b",
              "pb_b", "active_b"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      np.asarray(getattr(jl, f)), err_msg=f)
    a = tl.a_slot.numpy() > 0
    np.testing.assert_array_equal(tl.src.numpy()[a], np.asarray(jl.src)[a])
    np.testing.assert_array_equal(tl.slot_k.numpy()[valid],
                                  np.asarray(jl.slot_k)[valid])
    # K11's geometry: every valid candidate has a slot of its own, that
    # slot holds its position, and its block's window holds it
    g = tkr.tile_layout(torch.zeros((2 * n_dog, Hp, Wp)), _t(s), _t(y), _t(x),
                        _t(valid), P, CFG, _t(poff))
    sk = g.slot_k.numpy()[valid]
    assert len(set(sk.tolist())) == valid.sum()
    assert (g.a_slot.numpy()[sk] == 1).all()
    np.testing.assert_array_equal(g.y_slot.numpy()[sk], y[valid])
    np.testing.assert_array_equal(g.x_slot.numpy()[sk], x[valid])
    blk = sk // tkr.TILE_BK
    r0, c0 = g.r0_b.numpy()[blk], g.c0_b.numpy()[blk]
    lr, lw = tkr.TILE_R + 2 * tkr.TILE_MARGIN, tkr.TILE_C + 2 * tkr.TILE_MARGIN
    assert ((y[valid] - r0 >= 1) & (y[valid] - r0 <= lr - 2)).all()
    assert ((x[valid] - c0 >= 1) & (x[valid] - c0 <= lw - 2)).all()
    # the dense cluster fills more than one block of its region
    active_b = g.active_b.numpy()
    assert (active_b == tkr.TILE_BK).any() and (active_b == 0).any()


@pytest.mark.parametrize("geom", ["1080p_octave0", "window_covers_plane"])
def test_tile_windows_inside_stack(geom):
    """K11 reads a live slot's cubes from the DoG in global memory: planes
    pb_b + clamp(s, 1, S) +- 1, rows r0_b + [0, LR) and columns c0_b +
    [0, LW) of its block (the walk clamps each cube centre into the
    window's interior). So every block's window must lie inside the stack,
    and a live slot's block must read the candidate's own frame. At the
    1080p B=4 octave 0 (K = 131,072 candidates) and at a plane no taller
    than the window (LR = Hp)."""
    S, b = CFG.scales_per_octave, CFG.image_border
    n_dog = S + 2
    if geom == "1080p_octave0":
        B, pad, h, w, K = 4, P, 2160, 3840, 131072
        Hp, Wp = tx.padded_dims(h, w)
        assert (Hp, Wp) == (2304, 4096)
    else:
        B, pad, h, w, K = 2, 8, 24, 368, 600
        Hp, Wp = h + 2 * pad, w + 2 * pad
    rng = np.random.RandomState(17)
    s = rng.randint(1, S + 1, K).astype(np.int32)
    y = rng.randint(pad + b, pad + h - b, K).astype(np.int32)
    x = rng.randint(pad + b, pad + w - b, K).astype(np.int32)
    # candidates on the corners of the image's interior
    y[:4] = [pad + b, pad + b, pad + h - b - 1, pad + h - b - 1]
    x[:4] = [pad + b, pad + w - b - 1, pad + b, pad + w - b - 1]
    valid = rng.rand(K) < 0.25
    valid[:4] = True
    poff = (np.arange(K) // (K // B) * n_dog).astype(np.int32)
    n_planes = B * n_dog
    dog = torch.zeros(()).expand(n_planes, Hp, Wp)   # the shape alone
    g = tkr.tile_layout(dog, _t(s), _t(y), _t(x), _t(valid), pad, CFG, _t(poff))
    lr, lw = tkr._window(dog)
    assert (lr == Hp) == (geom == "window_covers_plane")
    pb, r0, c0 = g.pb_b.numpy(), g.r0_b.numpy(), g.c0_b.numpy()
    assert ((pb >= 0) & (pb + S + 1 <= n_planes - 1)).all()
    assert ((r0 >= 0) & (r0 <= Hp - lr)).all()
    assert ((c0 >= 0) & (c0 <= Wp - lw)).all()
    live = g.a_slot.numpy() > 0
    assert live.sum() == valid.sum()
    blk = np.nonzero(live)[0] // tkr.TILE_BK
    np.testing.assert_array_equal(pb[blk], poff[g.src.numpy()[live]])
    assert (g.active_b.numpy()[blk] > 0).all()


def _perkey_lanes(seed, n, h, w, si):
    """n live lanes of scale level si, kp_scale spread over the level's
    range (test_torch_extract.py:_window_lanes)."""
    rng = np.random.RandomState(seed)
    lo = [0.0, 1.6, 2.26, 2.85][si]
    hi = [0.0, 2.26, 2.85, 3.59][si]
    return dict(s=np.full(n, si, np.int32),
                ks=(lo + (hi - lo) * rng.rand(n)).astype(np.float32),
                y=rng.randint(2, h - 2, n).astype(np.int32),
                x=rng.randint(2, w - 2, n).astype(np.int32),
                ang=(rng.rand(n) * 360.0).astype(np.float32))


def _gauss_padded(h=96, w=128):
    rng = np.random.RandomState(5)
    return np.array(jdesc.pad_stack_for_kernels(
        jnp.asarray(rng.rand(6, h, w).astype(np.float32)))), h, w


def test_k8_plain_matches_pallas_perkey():
    from sift_features_tpu.ops.pallas.orientation_kernel import (
        orientation_histograms_pallas)

    gp, h, w = _gauss_padded()
    n, count, si = 40, 33, 1
    r_max = tk5.bucket_radii_ori(CFG)[si]
    ln = _perkey_lanes(11, n, h, w, si)
    want = np.asarray(orientation_histograms_pallas(
        jnp.asarray(gp), ln["s"], ln["y"], ln["x"], ln["ks"], count, h, w, P,
        JCFG, True, r_max, False))
    got = tk5.orientation_hist_perkey(
        _t(gp), _t(ln["s"]), _t(ln["y"]), _t(ln["x"]), _t(ln["ks"]),
        torch.tensor(count), h, w, P, r_max, CFG).numpy()
    # K5's tolerance against the TPU kernel (test_torch_extract.py:
    # test_k5_plain_matches_pallas_bucketed): summation order, f32 vs
    # f64-rounded exp
    np.testing.assert_allclose(got[:count], want[:count], rtol=2e-4, atol=2e-5)
    assert (got[count:] == 0).all() and (got[:count].sum(1) > 0).all()


def test_k7_plain_matches_pallas_perkey():
    """At a 2 x 2 x 4 descriptor: the TPU kernel unrolls one reduction per
    bin and keypoint, and its interpret-mode compile at the default 4 x 4 x
    8 takes ~50 s here against ~6 s. The port's code is the same for every
    size; at the default size K7 equals K6 (test_perkey_raw_rows_equal_
    packed), which test_torch_extract.py holds against the TPU kernel."""
    from sift_features_tpu.ops.pallas.descriptor_kernel import (
        descriptor_hist_pallas)

    small = dict(descriptor_n_histograms=2, descriptor_n_bins=4)
    cfg, jcfg = (dataclasses.replace(c, **small) for c in (CFG, JCFG))
    gp, h, w = _gauss_padded()
    n, count, si = 24, 19, 1
    r_max = tk6.bucket_radii(cfg)[si]
    ln = _perkey_lanes(12, n, h, w, si)
    want = np.asarray(descriptor_hist_pallas(
        jnp.asarray(gp), ln["s"], ln["x"], ln["y"], ln["ks"], ln["ang"],
        count, h, w, P, jcfg, True, r_max))
    got = tk6.descriptor_hist_perkey(
        _t(gp), _t(ln["s"]), _t(ln["x"]), _t(ln["y"]), _t(ln["ks"]),
        _t(ln["ang"]), torch.tensor(count), h, w, P, r_max, cfg).numpy()
    assert got.shape == (n, 16)
    # K6's tolerance against the TPU kernel (test_torch_extract.py:
    # test_k6_plain_matches_pallas_masked)
    np.testing.assert_allclose(got[:count], want[:count], rtol=1e-4, atol=1e-5)
    assert (got[count:] == 0).all() and (got[:count].sum(1) > 0).all()


@pytest.mark.parametrize("si", [1, 2, 3])
def test_perkey_raw_rows_equal_packed(si):
    """On every bucket, the plain K8 / K7 rows at the bucket's window bound
    equal K5's / K6's raw rows bit for bit (the kernels' contract)."""
    gp, h, w = _gauss_padded()
    n = 30
    ln = _perkey_lanes(20 + si, n, h, w, si)
    live = torch.ones(n, dtype=torch.bool)
    a = (_t(gp), _t(ln["s"]))
    r8 = tk5.orientation_hist_perkey(*a, _t(ln["y"]), _t(ln["x"]),
                                     _t(ln["ks"]), torch.tensor(n), h, w, P,
                                     tk5.bucket_radii_ori(CFG)[si], CFG)
    r5 = tk5.orientation_hist_peaks(*a, _t(ln["y"]), _t(ln["x"]), _t(ln["ks"]),
                                    live, h, w, P, CFG)[0]
    assert torch.equal(r8, r5)
    d7 = tk6.descriptor_hist_perkey(*a, _t(ln["x"]), _t(ln["y"]), _t(ln["ks"]),
                                    _t(ln["ang"]), torch.tensor(n), h, w, P,
                                    tk6.bucket_radii(CFG)[si], CFG)
    d6 = tk6.descriptor_hist(*a, _t(ln["x"]), _t(ln["y"]), _t(ln["ks"]),
                             _t(ln["ang"]), live, h, w, P, CFG)
    assert torch.equal(d7, d6)


@pytest.fixture(scope="module")
def default_runs():
    """The default configuration's budget and single-frame outputs on one
    96 x 128 frame."""
    imgs = smooth_images(0, 1, 96, 128)
    budget = tx.extract_batch(imgs, features_limit=41, device="cpu")
    single = tx._extract_single(torch.as_tensor(imgs[0]),
                                tx._n_octaves(96, 128, CFG), CFG)
    return imgs, budget, single


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_budget_and_single_equal_default(mode, default_runs):
    imgs, budget, single = default_runs
    cfg = dataclasses.replace(CFG, **MODES[mode])
    got = tx.extract_batch(imgs, cfg, features_limit=41, device="cpu")
    assert got.keys() == budget.keys()
    for k in budget:
        assert torch.equal(got[k], budget[k]), k
    one = tx._extract_single(torch.as_tensor(imgs[0]),
                             tx._n_octaves(96, 128, CFG), cfg)
    for k in single:
        assert torch.equal(one[k], single[k]), k
    assert int(single["valid"].sum()) > 100
