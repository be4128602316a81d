"""The port's features_limit budget vs the JAX package on the CPU.

- `stable_top_k` against `jax.lax.top_k`, ties and -inf lanes included;
- `_truncate_result` against JAX `_truncate_result` byte for byte, with a
  budget that cuts through a group of tied responses;
- the budgeted fused path (`_assemble_budget`, K6′ on the chosen subset)
  against the port's truncation of the unbudgeted output, byte for byte,
  and against JAX `_truncate_result` of the JAX package's result;
- `extract(features_limit=...)` as tests/test_extractor.py checks it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_features_tpu.config import DEFAULT_CONFIG as JCFG
from sift_features_tpu_torch.models import extractor as tx

from test_torch_gpu import one_torch_thread, smooth_images  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIELDS = ("kps", "desc", "valid", "src_idx")


def _jax_truncate(res: dict, budget: int) -> dict:
    from sift_features_tpu.models.extractor import _truncate_result

    out = _truncate_result({k: jnp.asarray(np.asarray(v)) for k, v in res.items()},
                           budget)
    return {k: np.asarray(v) for k, v in out.items()}


def _tied_result(seed: int, b: int = 2, n: int = 60) -> dict:
    """A padded result with responses drawn from a few values (every group
    tied), some invalid rows and two-orientation keypoints."""
    rng = np.random.RandomState(seed)
    kps = rng.rand(b, n, 5).astype(np.float32)
    kps[..., 4] = rng.choice(np.float32([0.03, 0.05, 0.05, 0.07, 0.11]), (b, n))
    kps[:, 1::7, 4] = kps[:, 0::7, 4][:, :kps[:, 1::7].shape[1]]
    valid = rng.rand(b, n) > 0.2
    desc = rng.randint(0, 256, (b, n, 128)).astype(np.uint8)
    counters = {k: rng.randint(0, 9, (b, 4)) for k in
                ("n_candidates", "n_survivors", "n_emitted")}
    return {"kps": kps, "desc": desc, "valid": valid, **counters}


def test_stable_top_k_matches_lax_top_k():
    rng = np.random.RandomState(0)
    v = rng.choice(np.float32([-np.inf, 0.1, 0.2, 0.2, 0.3]), (3, 200))
    for k in (1, 17, 64, 200):
        tv, ti = tx.stable_top_k(torch.from_numpy(v), k)
        jv, ji = jax.lax.top_k(jnp.asarray(v), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_truncation_cutting_ties_matches_jax():
    res = _tied_result(1)
    resp = np.where(res["valid"], res["kps"][..., 4], -np.inf)
    for budget in (7, 23, 40, 500):
        got = tx._truncate_result({k: torch.from_numpy(v) for k, v in res.items()},
                                  budget)
        want = _jax_truncate(res, budget)
        if budget < resp.shape[1]:
            # the budget cuts through a group of equal responses
            srt = np.sort(resp, axis=1)[:, ::-1]
            assert (srt[:, budget - 1] == srt[:, budget]).any()
        for k in (*FIELDS, "n_emitted"):
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_budget_equals_truncation_and_jax():
    """The fused budget path describes only the chosen keypoints (K6′) and
    must equal the truncated full output byte for byte (the card analogue is
    chip_smoke.py's budget phase); both equal JAX `_truncate_result` of the
    port's full output, and match JAX `_truncate_result` of the JAX result
    to the parity bar of test_torch_extract.py."""
    from sift_features_tpu.models.extractor import extract_batch

    imgs = smooth_images(0, 2, 48, 64)
    budget = 20
    full = tx.extract_batch(imgs, device="cpu")
    bud = tx.extract_batch(imgs, features_limit=budget, device="cpu")
    trunc = tx._truncate_result(full, budget)
    mine_j = _jax_truncate(full, budget)
    assert bud["kps"].shape == (2, budget, 5) and bud["src_idx"].dtype == torch.int32
    for k in (*FIELDS, "n_candidates", "n_survivors", "n_emitted"):
        assert torch.equal(bud[k], trunc[k]), k
        np.testing.assert_array_equal(bud[k].numpy(), mine_j[k], err_msg=k)
    want = _jax_truncate(extract_batch(imgs, JCFG), budget)
    np.testing.assert_array_equal(bud["valid"].numpy(), want["valid"])
    np.testing.assert_array_equal(bud["src_idx"].numpy(), want["src_idx"])
    np.testing.assert_allclose(bud["kps"].numpy(), want["kps"], rtol=0, atol=1e-3)
    rows_eq = (bud["desc"].numpy() == want["desc"]).all(-1).mean()
    assert rows_eq >= 0.95


def test_extract_features_limit():
    """tests/test_extractor.py:59-73 for the port."""
    img = smooth_images(7, 1, 96, 128)[0]
    k_all, d_all = tx.extract(img, device="cpu")
    assert len(k_all) > 20
    kps, desc = tx.extract(img, features_limit=5, device="cpu")
    assert kps.shape == (5, 5) and desc.shape == (5, 128)
    assert np.all(np.diff(kps[:, 4]) <= 0)
    order = np.argsort(-k_all[:, 4], kind="stable")[:5]
    np.testing.assert_array_equal(kps, k_all[order])
    np.testing.assert_array_equal(desc, d_all[order])
    # a limit at or above N keeps the emission order (the reference sorts
    # only when the limit truncates, lib.rs:156-161)
    for limit in (len(k_all), 10 ** 6):
        k_big, d_big = tx.extract(img, features_limit=limit, device="cpu")
        np.testing.assert_array_equal(k_big, k_all)
        np.testing.assert_array_equal(d_big, d_all)
