"""Brute-force L2 descriptor matching with cross-check.

Counterpart of sift_features_tpu/ops/matcher.py (`_match_jit`, f32 path, and
`match_brute_force`): BFMatcher(NORM_L2, crossCheck=True) semantics, with
||a - b||^2 = ||a||^2 + ||b||^2 - 2 a.b. The distance product is one
`torch.matmul` (the JAX package leaves it to XLA, not to a kernel of its
own). Ties resolve to the lowest index, as `torch.argmin` does.

The distances run in float64 and are rounded once to f32. No TF32
setting touches a float64 product, so the result is the same whatever the
caller has set (the legacy `torch.backends.cuda.matmul.allow_tf32` or the
current `fp32_precision`, globally or for `cuda.matmul`), and the matcher
reads and writes none of those process-wide switches: it is safe to call
from several threads. On u8 descriptors (what the extractor emits) every
product and partial sum is an integer below 2^24 (128 x 255^2 =
8,323,200), exact in float64 as in f32; on f32 input each product of two
values is exact in float64 and only the sums round.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device
from .util import sqrt_f32


@dataclasses.dataclass
class Matches:
    """query index / train index / L2 distance for each retained match."""

    query_idx: np.ndarray
    train_idx: np.ndarray
    distance: np.ndarray


def match_dense(d_train: torch.Tensor, d_query: torch.Tensor,
                cross_check: bool = True):
    """(T, D), (Q, D) -> (best_train (Q,) int64, distance (Q,) f32, keep (Q,)
    bool); keep marks mutual nearest neighbours when cross_check."""
    a = d_train.to(torch.float64)
    b = d_query.to(torch.float64)
    aa = torch.sum(a * a, dim=1)
    bb = torch.sum(b * b, dim=1)
    d2 = (bb[:, None] + aa[None, :] - 2.0 * (b @ a.T)).to(torch.float32)
    d2 = torch.clamp_min(d2, 0.0)
    best_train = torch.argmin(d2, dim=1)
    best_d2 = torch.gather(d2, 1, best_train[:, None])[:, 0]
    if cross_check:
        best_query = torch.argmin(d2, dim=0)
        keep = best_query[best_train] == torch.arange(d2.shape[0],
                                                      device=d2.device)
    else:
        keep = torch.ones(d2.shape[0], dtype=torch.bool, device=d2.device)
    return best_train, sqrt_f32(best_d2), keep


def match_brute_force(d_train, d_query, cross_check: bool = True,
                      device: str | torch.device = "cuda") -> Matches:
    """BFMatcher.match(query) analog: d_train was 'add'ed, d_query matched.
    Arrays are (N, 128) u8 or f32; the match runs on `device`."""
    dev = resolve_device(device)
    dt = torch.as_tensor(np.asarray(d_train), device=dev)
    dq = torch.as_tensor(np.asarray(d_query), device=dev)
    bt, dist, keep = match_dense(dt, dq, cross_check)
    bt, dist, keep = bt.cpu().numpy(), dist.cpu().numpy(), keep.cpu().numpy()
    qi = np.nonzero(keep)[0]
    return Matches(query_idx=qi, train_idx=bt[qi], distance=dist[qi])
