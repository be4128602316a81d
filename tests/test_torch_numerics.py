"""Port numeric primitives vs the JAX package's (ops/pallas/util.py,
ops/extrema.py:rust_round): random values and edge values (+-0, exact
halves, quadrant boundaries), bit-equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sift_features_tpu.ops.extrema import rust_round as j_rust_round
from sift_features_tpu.ops.pallas import util as jutil
from sift_features_tpu_torch.ops import util as tutil


def _values(seed):
    rng = np.random.RandomState(seed)
    halves = np.arange(-8, 8) + 0.5
    edges = [0.0, -0.0, 0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.49999997,
             -0.49999997, 1e-30, -1e-30, 1e9, -1e9, 4.5, 16.5, -16.5]
    rand = np.concatenate([rng.randn(2000) * 3, rng.randn(500) * 1e4,
                           rng.rand(500) - 0.5])
    return np.concatenate([halves, edges, rand]).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("name", ["round_half_away", "rust_round"])
def test_rounding_bit_equal(name):
    x = _values(0)
    jf = jutil.round_half_away if name == "round_half_away" else j_rust_round
    got = getattr(tutil, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(jf(jnp.asarray(x))))


def test_atan2_bit_equal():
    rng = np.random.RandomState(1)
    y = np.concatenate([rng.randn(3000), rng.randn(300) * 1e3])
    x = np.concatenate([rng.randn(3000), rng.randn(300) * 1e-3])
    # quadrant boundaries and zeros of both signs
    ey = np.array([0.0, 0.0, -0.0, -0.0, 1.0, -1.0, 1.0, -1.0, 0.0, 1.0,
                   2.414213562373095, 0.4142135623730950, 3.0, -3.0])
    ex = np.array([1.0, -1.0, 1.0, -1.0, 0.0, 0.0, 1.0, -1.0, 0.0, -1.0,
                   1.0, 1.0, -0.0, 0.0])
    y = np.concatenate([y, ey]).astype(np.float32)
    x = np.concatenate([x, ex]).astype(np.float32)
    got = tutil.atan2_f32(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    want = np.asarray(jutil.atan2_f32(jnp.asarray(y), jnp.asarray(x)))
    # f32 IEEE operations in the same order on both sides: bit-equal
    # (XLA:CPU does not contract these multiply-adds to FMA here)
    np.testing.assert_array_equal(_bits(got), _bits(want))
