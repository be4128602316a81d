"""The storage modes of the port (storage_dtype "bfloat16" and "split",
gather_dtype "bfloat16") against the JAX package on the CPU:

- (a) the plain K1 forms against `build_octave_fused(interpret=True)`;
- (b) the plain K9 chain forms against
  `build_octave_padded_batched(interpret=True)`;
- (c) the port's batched octave against JAX `_detect_octave_batched(...,
  gauss_win=g16, interpret=True)`, both fed JAX's own K1 output of the
  mode, so both sides read the same bf16 stacks;
- (d) end to end without a JAX fused extract (XLA:CPU takes minutes to
  compile one in bf16): split and gather16 detect what the f32 run
  detects, and the bf16 tiny octave against JAX `_detect_octave` on its
  f32-widened levels.

The f32 outputs keep test_torch_pyramid.py's tolerances. A bf16 output is
the rounding of an f32 value that XLA:CPU computes with some multiply-adds
of the interpret-mode kernel contracted to FMA, which moves it by ulps and
can flip its bf16 rounding. So each bf16 value must lie within one bf16
ulp of JAX's, or within the f32 tolerance of the same output (a DoG near
zero, where bf16 ulps are finer than the f32 differences), and at least
99.9% of the Gaussian values must be bit-equal (measured: 99.999%). The
bf16 DoG flips more often, since its f32 values differ in more than half
of their last bits and lie near zero: at least 99% bit-equal (measured:
99.6% for K1, 99.7% for K9). The JAX arrays in bf16 reach torch through
their bits.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_features_tpu.config import DEFAULT_CONFIG as JCFG
from sift_features_tpu.ops import pyramid as jpyr
from sift_features_tpu.ops.pallas.pyramid_kernel import (
    build_octave_fused, build_octave_padded_batched, reflect_pad_image)
from sift_features_tpu_torch.config import DEFAULT_CONFIG as CFG
from sift_features_tpu_torch.models import extractor as tx
from sift_features_tpu_torch.ops.descriptor import PAD_DESC as P
from sift_features_tpu_torch.ops.kernels import pyramid as tk

from test_torch_gpu import one_torch_thread, smooth_images  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BF16 = torch.bfloat16
MODES = {"bfloat16": {"storage_dtype": "bfloat16"},
         "split": {"storage_dtype": "split"},
         "gather16": {"gather_dtype": "bfloat16"}}
# the f32 tolerances of test_torch_pyramid.py (the JAX package's own for
# its kernel against its tap-sum path, test_pallas_kernels.py:130-135)
ATOL_GAUSS, ATOL_DOG = 3e-7, 6e-7


def to_torch(a) -> torch.Tensor:
    """A JAX array as a torch tensor of the same type (bf16 by its bits)."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a).view(np.uint16).copy()).view(BF16)
    return torch.from_numpy(np.array(a))


def ordered_bf16(t: torch.Tensor) -> np.ndarray:
    """bf16 values as integers in the order of the values: neighbouring
    bf16 values differ by 1, +0 and -0 are both 0."""
    b = t.contiguous().view(torch.int16).numpy().astype(np.int32)
    return np.where(b >= 0, b, -(b & 0x7FFF))


def assert_matches(got: torch.Tensor, want, atol: float, what: str,
                   share: float = 0.999):
    """got (torch) against want (JAX) on the image interior: f32 within
    atol; bf16 each within one ulp or atol, at least `share` bit-equal."""
    want = to_torch(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=atol, err_msg=what)
        return
    ulps = np.abs(ordered_bf16(got) - ordered_bf16(want))
    close = (ulps <= 1) | ((got.float() - want.float()).abs() <= atol).numpy()
    assert close.all(), (what, ulps[~close].max())
    assert (ulps == 0).mean() >= share, (what, (ulps == 0).mean())


@functools.lru_cache(maxsize=None)
def _base(mode: str | None):
    """test_torch_pyramid.py's 96 x 128 seed pair, reflect-padded to the
    fused path's 256 x 256 plane by the JAX package: (JAX base, port base,
    (h, w)), both bf16 in bfloat16 storage (rounded after the f32 seed, as
    the extractor does)."""
    seed = jax.jit(jpyr.create_seed_image, static_argnums=1)(
        jnp.asarray(smooth_images(2, 2, 48, 64)), JCFG)
    h, w = seed.shape[1:]
    hp, wp = tx.padded_dims(h, w)
    base = jax.vmap(lambda im: reflect_pad_image(
        im, P, wp - w - 2 * P, hp - h - 2 * P))(seed)
    base_t = torch.from_numpy(np.array(base))
    if mode == "bfloat16":
        base, base_t = base.astype(jnp.bfloat16), base_t.to(BF16)
    return base, base_t, (h, w)


def _flags(mode: str) -> dict:
    return {"gather16": mode == "gather16", "split": mode == "split"}


@pytest.mark.parametrize("mode", list(MODES))
def test_k1_storage_plain_matches_pallas(mode):
    base_j, base_t, (h, w) = _base(mode)
    # the seed's bf16 rounding is torch's and XLA's alike (nearest even)
    assert torch.equal(to_torch(base_j), base_t)
    g_j, d_j, g16_j, l3_j = build_octave_fused(base_j, JCFG, interpret=True,
                                               **_flags(mode))
    g, d, g16, l3 = tk.octave_fused_plain(base_t, CFG, **_flags(mode))
    sl = (Ellipsis, slice(P, P + h), slice(P, P + w))
    assert (g16 is None) == (g16_j is None) and (l3 is None) == (l3_j is None)
    for got, want, atol, share, what in (
            (g, g_j, ATOL_GAUSS, 0.999, "gauss"), (d, d_j, ATOL_DOG, 0.99, "dog"),
            (g16, g16_j, ATOL_GAUSS, 0.999, "g16"),
            (l3, l3_j, ATOL_GAUSS, 0.999, "l3")):
        if got is not None:
            assert_matches(got[sl], want[sl], atol, f"{mode} {what}", share)
    # the port's own identities against its f32 K1, bit for bit
    g32, d32, _, _ = tk.octave_fused_plain(_base(None)[1], CFG)
    if mode == "split":
        assert g.dtype == BF16 and d.dtype == l3.dtype == torch.float32
        assert torch.equal(d, d32)
        assert torch.equal(l3, g32[:, -1])
        assert torch.equal(g, g32.to(BF16))
    if mode == "gather16":
        assert torch.equal(g, g32) and torch.equal(d, d32)
        assert torch.equal(g16, g32.to(BF16))
    if mode == "bfloat16":
        assert g.dtype == d.dtype == BF16


@pytest.mark.parametrize("mode", list(MODES))
def test_k9_storage_chain_matches_pallas(mode):
    base_j, base_t, (h, w) = _base(mode)
    g_j, d_j, g16_j = build_octave_padded_batched(base_j, JCFG, interpret=True,
                                                  **_flags(mode))
    g, d, g16 = tk.build_octave_padded_batched_plain(base_t, CFG,
                                                     **_flags(mode))
    assert g.shape == (2, 5, 256, 256) and (g16 is None) == (g16_j is None)
    sl = (Ellipsis, slice(P, P + h), slice(P, P + w))
    for got, want, atol, share, what in (
            (g, g_j, ATOL_GAUSS, 0.999, "gauss"), (d, d_j, ATOL_DOG, 0.99, "dog"),
            (g16, g16_j, ATOL_GAUSS, 0.999, "g16")):
        if got is not None:
            assert_matches(got[sl], want[sl], atol, f"{mode} {what}", share)
    if mode == "split":
        # the chain rounds between levels: level k+1 blurs the stored bf16
        # level k, and the f32 DoG is taken against that rounded level
        assert g.dtype == BF16 and d.dtype == torch.float32
        nxt, dog1 = tk.level_plain(g[:, 0].float(), tk.octave_taps(CFG)[1])
        assert torch.equal(g[:, 1], nxt.to(BF16)) and torch.equal(d[:, 1], dog1)
    if mode == "gather16":
        g32, d32, _ = tk.build_octave_padded_batched_plain(_base(None)[1], CFG)
        assert torch.equal(g, g32) and torch.equal(d, d32)
        assert torch.equal(g16, g32[:, :3].to(BF16))


@functools.lru_cache(maxsize=None)
def _octave_input():
    """test_torch_extract.py's octave input: one 48 x 64 frame (96 x 128
    seed) with keypoints enough for the octave test's bar."""
    seed = jpyr.create_seed_image(
        jnp.asarray(smooth_images(3, 1, 48, 64, blur=1.0)), JCFG)
    h, w = seed.shape[1], seed.shape[2]
    hp, wp = tx.padded_dims(h, w)
    base = jax.vmap(lambda im: reflect_pad_image(
        im, P, wp - w - 2 * P, hp - h - 2 * P))(seed)
    return base, (h, w)


@pytest.mark.parametrize("mode", list(MODES))
def test_batched_octave_storage_matches_pallas_path(mode):
    base, hw = _octave_input()
    if mode == "bfloat16":
        base = base.astype(jnp.bfloat16)
    g, d, g16, _ = build_octave_fused(base, JCFG, interpret=True,
                                      **_flags(mode))
    jcfg = dataclasses.replace(JCFG, refine_mode="step", **MODES[mode])
    det = _detect_octave_batched_jax(g, d, hw, g16, jcfg)
    cfg = dataclasses.replace(CFG, **MODES[mode])
    got = tx._detect_octave_batched(to_torch(g), to_torch(d), 0, cfg, hw,
                                    gauss_win=None if g16 is None
                                    else to_torch(g16))
    # the bar of test_torch_extract.py:test_batched_octave_matches_pallas_path
    for k in ("n_candidates", "n_survivors", "n_emitted"):
        np.testing.assert_array_equal(got[k].numpy(), det[k], err_msg=k)
    v = det["valid"]
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    assert v.sum() >= 80
    np.testing.assert_allclose(got["kps"].numpy()[v], det["kps"][v], rtol=0,
                               atol=1e-3)
    diff = np.abs(got["desc"].numpy()[v].astype(int) - det["desc"][v].astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02


def _detect_octave_batched_jax(g, d, hw, g16, jcfg):
    from sift_features_tpu.models.extractor import _detect_octave_batched

    det = _detect_octave_batched(g, d, 0, jcfg, hw, gauss_win=g16,
                                 interpret=True)
    return {k: np.asarray(v) for k, v in det.items()}


def detection_set(res, f: int) -> set:
    """Frame f's detected (x, y, size, response) rows, as bytes: the set the
    JAX package holds equal between split and f32 storage
    (test_pallas_kernels.py:841-880). Orientation emission may repeat a
    row a different number of times, since the windows read bf16."""
    kps = res["kps"][f][res["valid"][f]][:, [0, 1, 2, 4]].numpy()
    return {row.tobytes() for row in kps}


@functools.lru_cache(maxsize=None)
def _f32_run():
    imgs = smooth_images(0, 2, 96, 128)
    return imgs, tx.extract_batch(imgs, device="cpu")


@pytest.mark.parametrize("mode", ["split", "gather16"])
def test_split_and_gather16_detect_as_f32(mode):
    imgs, full = _f32_run()
    res = tx.extract_batch(imgs, dataclasses.replace(CFG, **MODES[mode]),
                           device="cpu")
    for k in ("n_candidates", "n_survivors"):
        assert torch.equal(res[k], full[k]), k
    for f in range(2):
        want = detection_set(full, f)
        assert len(want) >= 100 and detection_set(res, f) == want


def _tiny_bases(b: int, hw: int = 16) -> torch.Tensor:
    """(b, hw, hw) bf16 bases of a tiny octave (padded side < 256, so hw <=
    16): a textured level with two broad blobs each, which the octave's
    few scales can still find at this size."""
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[:hw, :hw]
    out = []
    for _ in range(b):
        im = 0.5 + 0.1 * rng.rand(hw, hw)
        for _ in range(2):
            cy, cx = 4 + rng.rand(2) * (hw - 8)
            s = 2.5 + rng.rand() * 2
            amp = rng.choice([-1, 1]) * (0.3 + 0.4 * rng.rand())
            im = im + amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        out.append(im)
    return torch.from_numpy(np.stack(out).astype(np.float32)).to(BF16)


def test_bf16_tiny_octave_matches_jax():
    """The tiny octave in bf16 storage: its levels in f32 from the widened
    base, as the JAX extractor's `levels = [im.astype(F32)]`, and the next
    base rounded back to bf16."""
    from sift_features_tpu.models.extractor import _detect_octave
    from sift_features_tpu.ops.gaussian import gaussian_blur
    from sift_features_tpu.ops.resize import resize_nearest_half

    init = _tiny_bases(4)
    assert tx.padded_dims(16, 16)[0] < 256        # the tiny branch
    octave = 3
    res, nxt = tx._tiny_octave(
        init, octave, dataclasses.replace(CFG, storage_dtype="bfloat16"))
    assert nxt.dtype == BF16 and nxt.shape == (4, 8, 8)
    jcfg = dataclasses.replace(JCFG, storage_dtype="bfloat16", use_pallas=False)
    n_kps = 0
    for f in range(init.shape[0]):
        # op by op: under jit XLA:CPU contracts multiply-adds to FMA
        with jax.disable_jit():
            levels = [jnp.asarray(init[f].float().numpy())]
            for sig in JCFG.octave_sigmas()[1:]:
                levels.append(gaussian_blur(levels[-1], sig))
            want = _detect_octave(jnp.stack(levels), None, octave, jcfg)
            nxt_j = resize_nearest_half(levels[len(levels) - 3]).astype(
                jnp.bfloat16)
        assert torch.equal(nxt[f], to_torch(nxt_j))
        for k in ("n_candidates", "n_survivors", "n_emitted"):
            assert int(res[k][f]) == int(want[k]), k
        v = np.asarray(want["valid"])
        np.testing.assert_array_equal(res["valid"][f].numpy(), v)
        n_kps += int(v.sum())
        # the parity bar of test_torch_extract.py:_check_extract (the JAX
        # XLA path takes f64 atan2 / exp)
        np.testing.assert_allclose(res["kps"][f].numpy()[v],
                                   np.asarray(want["kps"])[v], rtol=0, atol=1e-3)
        rows = (res["desc"][f].numpy()[v] == np.asarray(want["desc"])[v]).all(1)
        assert rows.size == 0 or rows.mean() >= 0.95
    assert n_kps >= 3
