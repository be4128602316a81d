"""Plain brute-force L2 matcher with cross-check, in PyTorch.

BFMatcher(NORM_L2, crossCheck=True) on u8 rows: each query row's nearest
train row, kept where that train row's nearest query row is the query
itself; ties go to the lowest index on both sides. On u8 rows every
squared distance and every partial sum of one is an integer below 2**24,
so float32 products (TF32 off) are exact whatever the order they are
summed in. The train rows go in chunks, and two augmented products give,
per chunk,

    2 q.t - |t|^2   (query x train: its argmax is the query's nearest row)
    |q|^2 - 2 q.t   (train x query: its argmin is the train row's nearest)

each an exact integer, so no (Q, T) distance matrix is ever held. The
distance of a kept pair is recomputed in int64 and rounded once to f32,
then square-rooted in f32 (correctly rounded). It runs on the host or on
a card; a lower `dtype` makes the control.
"""

from __future__ import annotations

import numpy as np

CHUNK_ROWS = 1 << 16


def match(train, query, cross_check: bool = True, device="cpu", dtype=None):
    """(T, D), (Q, D) u8 -> (query_idx, train_idx, distance f32) of the
    kept matches, query_idx ascending, computed on `device`. train is an
    array or a tensor on any device (moved a chunk at a time). dtype
    (default float32, exact) is what the products are computed in; below
    it, a kept pair's distance is the products' own."""
    import torch

    dtype = dtype or torch.float32
    t_n, q_n = len(train), len(query)
    if t_n == 0 or q_n == 0:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        q = torch.as_tensor(np.asarray(query), device=device).to(dtype)
        qq = (q * q).sum(1)
        q_aug = torch.cat([2.0 * q, -torch.ones((q_n, 1), dtype=dtype, device=device)], 1)
        q_aug2 = torch.cat([q, qq[:, None]], 1)
        best = torch.full((q_n,), -float("inf"), dtype=dtype, device=device)
        best_t = torch.zeros(q_n, dtype=torch.int64, device=device)
        best_q = []
        for t0 in range(0, t_n, CHUNK_ROWS):
            t = torch.as_tensor(train[t0:t0 + CHUNK_ROWS], device=device).to(dtype)
            tt = (t * t).sum(1)
            score = q_aug @ torch.cat([t, tt[:, None]], 1).T            # (Q, n)
            val, arg = torch.max(score, 1)
            better = val > best
            best_t = torch.where(better, arg + t0, best_t)
            best = torch.where(better, val, best)
            del score
            if cross_check:
                back = torch.cat([-2.0 * t, torch.ones((len(t), 1), dtype=dtype,
                                                       device=device)], 1) @ q_aug2.T
                best_q.append(torch.argmin(back, 1))
                del back
        qi = torch.arange(q_n, device=device)
        keep = (torch.cat(best_q)[best_t] == qi if cross_check
                else torch.ones(q_n, dtype=torch.bool, device=device))
        qi, ti = qi[keep].cpu().numpy(), best_t[keep].cpu().numpy()
        if dtype == torch.float32:
            tr = (train[ti] if isinstance(train, np.ndarray) else
                  train[torch.as_tensor(ti, device=train.device)].cpu().numpy())
            diff = tr.astype(np.int64) - np.asarray(query)[qi].astype(np.int64)
            d2 = np.einsum("ij,ij->i", diff, diff).astype(np.float32)
        else:
            # |q|^2 - (2 q.t - |t|^2), in dtype as the products gave it
            d2 = (qq - best)[keep].float().clamp_min(0).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return qi.astype(np.int64), ti.astype(np.int64), np.sqrt(d2).astype(np.float32)
