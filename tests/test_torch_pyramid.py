"""Port scale space vs the JAX package: the seed image and the tiny-octave
blur (bit-equal to ops/pyramid.py and ops/gaussian.py), the reflect pad, and
the plain version of K1 against the Pallas kernel build_octave_fused run in
interpret mode, on the image interior."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_features_tpu.config import DEFAULT_CONFIG as JCFG
from sift_features_tpu.ops import gaussian as jg
from sift_features_tpu.ops import pyramid as jpyr
from sift_features_tpu.ops.pallas.pyramid_kernel import (build_octave_fused,
                                                         reflect_pad_image)
from sift_features_tpu_torch.config import DEFAULT_CONFIG as CFG
from sift_features_tpu_torch.models.extractor import padded_dims
from sift_features_tpu_torch.ops import gaussian as tg
from sift_features_tpu_torch.ops import pyramid as tpyr
from sift_features_tpu_torch.ops.descriptor import PAD_DESC as P
from sift_features_tpu_torch.ops.kernels import pyramid as tk

from test_torch_gpu import smooth_images


def test_seed_image_and_blur_bit_equal():
    imgs = smooth_images(0, 2, 40, 52)
    got = tpyr.create_seed_image(torch.from_numpy(imgs), CFG).numpy()
    # op by op: under jit XLA:CPU contracts some multiply-adds to FMA,
    # which the port never does
    want = np.asarray(jpyr.create_seed_image(jnp.asarray(imgs), JCFG))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # tiny-octave blur: reflect-101 iterated past the image size
    small = got[:, :9, :11]
    for sigma in CFG.octave_sigmas()[1:]:
        b = tg.gaussian_blur(torch.from_numpy(small), sigma).numpy()
        bj = np.asarray(jg.gaussian_blur(jnp.asarray(small), sigma))
        np.testing.assert_array_equal(b.view(np.int32), bj.view(np.int32))


@pytest.fixture(scope="module")
def octave_case():
    """A 96 x 128 seed pair, reflect-padded to the fused path's (256, 256)
    plane by both packages."""
    seed = np.array(jax.jit(jpyr.create_seed_image, static_argnums=1)(
        jnp.asarray(smooth_images(2, 2, 48, 64)), JCFG))
    h, w = seed.shape[1:]
    hp, wp = padded_dims(h, w)
    base_j = jax.vmap(lambda im: reflect_pad_image(
        im, P, wp - w - 2 * P, hp - h - 2 * P))(jnp.asarray(seed))
    base_t = tk.reflect_pad_image(torch.from_numpy(seed), P, wp - w - 2 * P,
                                  hp - h - 2 * P)
    return np.asarray(base_j), base_t, (h, w)


def test_reflect_pad_bit_equal(octave_case):
    base_j, base_t, _ = octave_case
    np.testing.assert_array_equal(base_t.numpy(), base_j)


def test_k1_plain_matches_pallas_interior(octave_case):
    base_j, base_t, (h, w) = octave_case
    g_j, d_j, _, _ = build_octave_fused(jnp.asarray(base_j), JCFG,
                                        interpret=True)
    g_t, d_t = tk.octave_fused_plain(base_t, CFG)
    assert g_t.shape == g_j.shape and d_t.shape == d_j.shape
    sl = (slice(None), slice(None), slice(P, P + h), slice(P, P + w))
    # the JAX tests' own tolerances for the kernel vs the tap-sum path
    # (test_pallas_kernels.py:130-135); the ascending tap order is the same
    np.testing.assert_allclose(g_t.numpy()[sl], np.asarray(g_j)[sl], rtol=0,
                               atol=3e-7)
    np.testing.assert_allclose(d_t.numpy()[sl], np.asarray(d_j)[sl], rtol=0,
                               atol=6e-7)
