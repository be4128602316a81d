"""Port detection vs the JAX package: the plain version of K2 against the
Pallas extrema_words kernel in interpret mode, compaction (order, zero fill,
true count, overflow prefix), and the plain versions of K3 / K4 against
ops/extrema.py:refine and the Pallas refine_step_pallas kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_features_tpu.config import DEFAULT_CONFIG as JCFG
from sift_features_tpu.ops import descriptor as jdesc
from sift_features_tpu.ops import extrema as jext
from sift_features_tpu.utils import compact as jcompact
from sift_features_tpu_torch.config import DEFAULT_CONFIG as CFG
from sift_features_tpu_torch.ops import extrema as text
from sift_features_tpu_torch.ops import pyramid as tpyr
from sift_features_tpu_torch.ops.gaussian import gaussian_blur
from sift_features_tpu_torch.ops.kernels import extrema as tk2
from sift_features_tpu_torch.ops.kernels import refine as tk34
from sift_features_tpu_torch.utils import compact as tcompact

from test_torch_gpu import smooth_images


def test_k2_plain_matches_pallas():
    from sift_features_tpu.ops.pallas.extrema_kernel import extrema_words

    rng = np.random.RandomState(8)
    hp, wp = 128, 256
    dog = (rng.randn(5, hp, wp) * 0.05).astype(np.float32)
    P, h, w = 30, 60, 180
    b = CFG.image_border
    bounds = (P + b, P + h - b, P + b, P + w - b)
    want = np.asarray(extrema_words(jnp.asarray(dog), bounds, 3, True))
    got = tk2.extrema_words_plain(torch.from_numpy(dog)[None], bounds, CFG)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).sum() > 20
    # candidate order from the words == the JAX package's
    sj = jext.find_candidates_words(jnp.asarray(want), 256)
    st = text.find_candidates_words(got, 256)
    for a, c in zip(st, sj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


@pytest.mark.parametrize("n,density,capacity", [
    (300, 0.1, 64), (5000, 0.02, 40), (20000, 0.01, 512), (20000, 0.01, 64)])
def test_compaction_contract(n, density, capacity):
    mask = np.random.RandomState(n + capacity).rand(n) < density
    idx, valid, count = tcompact.compact_indices(torch.from_numpy(mask),
                                                 capacity)
    ji, jv, jc = jax.jit(jcompact.compact_indices, static_argnums=1)(
        jnp.asarray(mask), capacity)
    assert int(count) == int(jc) == mask.sum()
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    # scan-order prefix on overflow, zero fill past the count
    true_pos = np.nonzero(mask)[0][:capacity]
    np.testing.assert_array_equal(idx.numpy()[:len(true_pos)], true_pos)
    assert (idx.numpy()[len(true_pos):] == 0).all()
    # bit-packed form of the same mask
    pad = (-n) % 32
    bits = np.concatenate([mask, np.zeros(pad, bool)]).reshape(-1, 32)
    words = (bits.astype(np.int64) << np.arange(32)).sum(1)
    words = np.where(words >= 2 ** 31, words - 2 ** 32, words).astype(np.int32)
    wi, wv, wc = tcompact.compact_words(torch.from_numpy(words), capacity)
    ji, jv, jc = jax.jit(jcompact.compact_words, static_argnums=1)(
        jnp.asarray(words), capacity)
    assert int(wc) == int(jc)
    np.testing.assert_array_equal(wi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(wv.numpy(), np.asarray(jv))


def _dog_stack(seed, b, h, w):
    """(B, 5, 2h, 2w) DoG of a seed octave (input data only: the port's seed
    and blur are bit-equal to the JAX package's, test_torch_pyramid.py)."""
    lv = [tpyr.create_seed_image(torch.from_numpy(smooth_images(seed, b, h, w)),
                                 CFG)]
    for sigma in CFG.octave_sigmas()[1:]:
        lv.append(gaussian_blur(lv[-1], sigma))
    g = torch.stack(lv, 1)
    return (g[:, 1:] - g[:, :-1]).numpy()


def test_k3_plain_matches_refine():
    dog = _dog_stack(4, 2, 40, 56)
    B, n_dog, h, w = dog.shape
    K = 512
    mask = jax.jit(jext.extrema_mask, static_argnums=1)(jnp.asarray(dog), JCFG)
    # refine runs op by op: under jit XLA:CPU contracts some multiply-adds
    # to FMA, which the port (like the TPU kernels) never does
    j_find = jax.jit(jext.find_candidates, static_argnums=1)
    ts0, ty0, tx0, tv, _ = text.find_candidates(
        text.extrema_mask(torch.from_numpy(dog), CFG), K)
    poff = (torch.arange(B, dtype=torch.int32) * n_dog).repeat_interleave(K)
    rows = tk34.refine_walk(torch.from_numpy(dog).reshape(B * n_dog, h, w),
                            ts0.reshape(-1), ty0.reshape(-1), tx0.reshape(-1),
                            tv.reshape(-1), 0, h, w, CFG, plane_off=poff)
    f = text.rows_to_fields(rows)
    n_conv = 0
    for i in range(B):
        s0, y0, x0, v, _ = j_find(mask[i], K)
        np.testing.assert_array_equal(ts0[i].numpy(), np.asarray(s0))
        ref = {k: np.asarray(a) for k, a in
               jext.refine(jnp.asarray(dog[i]), s0, y0, x0, v, JCFG).items()}
        sl = slice(i * K, (i + 1) * K)
        ok = ref["ok"] & np.asarray(v)
        n_conv += ok.sum()
        np.testing.assert_array_equal(f["ok"][sl].numpy() & np.asarray(v), ok)
        for k in ("s", "y", "x"):          # integer fields: exact
            np.testing.assert_array_equal(f[k][sl].numpy()[ok], ref[k][ok])
        np.testing.assert_array_equal(f["keep"][sl].numpy()[ok], ref["keep"][ok])
        for k in ("off_s", "off_y", "off_x", "response"):
            # same f32 operations in the same order: 0 ulp
            np.testing.assert_array_equal(f[k][sl].numpy()[ok], ref[k][ok])
    assert n_conv > 30


def test_k4_plain_matches_pallas_step():
    from sift_features_tpu.ops.pallas.refine_kernel import refine_step_pallas

    rng = np.random.RandomState(2)
    h, w = 96, 160
    dog = rng.randn(5, h, w).astype(np.float32) * 0.05
    gp = np.array(jdesc.pad_stack_for_kernels(jnp.asarray(dog)))
    P = jdesc.PAD_DESC
    K, count = 32, 23
    s = rng.randint(1, 4, K).astype(np.int32)
    y = rng.randint(6, h - 6, K).astype(np.int32) + P
    x = rng.randint(6, w - 6, K).astype(np.int32) + P
    active = (np.arange(K) < count).astype(np.int32)
    want = np.asarray(refine_step_pallas(
        jnp.asarray(gp), jnp.asarray(s), jnp.asarray(y), jnp.asarray(x),
        jnp.asarray(active), gp.shape[2], JCFG, interpret=True))
    got = tk34.refine_step(torch.from_numpy(gp), torch.from_numpy(s),
                           torch.from_numpy(y), torch.from_numpy(x),
                           torch.from_numpy(active), CFG).numpy()
    # ok, steps and keep: exact. Offsets and response run the same f32
    # operations in the same order, but XLA:CPU compiles the interpret-mode
    # kernel with some multiply-adds contracted, and near-singular Hessians
    # of this random DoG amplify those last bits; the tolerance is the JAX
    # package's own for this kernel (test_pallas_kernels.py:94-98). The port
    # equals ops/extrema.py:refine bit for bit (test_k3_plain_matches_refine)
    # (inactive rows: the Pallas kernel leaves stale values there, the port
    # zeros)
    a = slice(0, count)
    for c in (0, 1, 2, 3, 8):
        np.testing.assert_array_equal(got[a, c], want[a, c])
    np.testing.assert_allclose(got[a, 4:7], want[a, 4:7], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[a, 7], want[a, 7], rtol=1e-5, atol=1e-7)
    assert (got[count:] == 0).all()
