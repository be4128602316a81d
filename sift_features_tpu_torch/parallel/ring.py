"""Ring-streamed brute-force matcher over the ranks of a mesh.

Counterpart of sift_features_tpu/parallel/ring.py. At database scale the
train rows no longer fit one device, so the database is sharded over the
ranks of one mesh axis and streamed round the ring as ring attention
streams its KV blocks: each rank keeps its query shard; train blocks move
one hop per step to rank (i + 1) % n, each carrying its running per-train
(column) minima with it, while the per-query (row) minima stay. After n
hops every block has met every query and is home again, and one all_gather
of the column winners resolves the cross-check.

Semantics of ops/matcher.py:match_brute_force (cv2.BFMatcher(NORM_L2,
crossCheck)): each block's distances are the dense matcher's own
(`_chunk_d2`: f64, rounded once to f32, clamped at 0), its train rows in
the dense matcher's chunks, and ties go to the lowest global index by the
(<, == & lower index) update rule, which does not depend on the order the
blocks arrive in. So the ring equals the dense matcher bit for bit on u8
and on integer-valued f32 descriptors, whose sums are exact in any order.

The ring keeps the chunk loop's `_chunk_d2` on the card too, where the dense
matcher takes M1 (ops/kernels/matcher.py): each hop masks the distances
by frame tags and valid rows and carries running column minima from rank
to rank, and M1 takes neither masks nor minima from outside. Its result
is the same either way: M1 equals the chunk loop bit for bit.

u8 blocks travel as u8 (a quarter of f32's bytes). A hop is one u8 buffer
per rank (`mesh.shift`): the column minima, the column winners, the frame
tags if any, the rows and their valid mask, packed 4-byte fields first.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import matcher
from ..ops.util import sqrt_f32
from ..utils.profiling import span
from .mesh import Mesh, all_gather, make_mesh, shift

F32 = torch.float32
I32 = torch.int32
INF = float("inf")


def _pack(t, tv, col_d, col_q, t_tag) -> torch.Tensor:
    """One hop's payload as a u8 buffer, 4-byte fields first so that every
    field's view of the received buffer is aligned."""
    parts = [col_d, col_q] + ([t_tag] if t_tag is not None else [])
    parts += [t, tv]
    return torch.cat([p.contiguous().view(torch.uint8).reshape(-1) for p in parts])


def _unpack(buf, t, tv, col_d, col_q, t_tag):
    """The fields of a received buffer, shaped like the ones sent."""
    out, off = [], 0
    for p in [col_d, col_q] + ([t_tag] if t_tag is not None else []) + [t, tv]:
        n = p.numel() * p.element_size()
        out.append(buf[off:off + n].view(p.dtype).reshape(p.shape))
        off += n
    if t_tag is None:
        out.insert(2, None)
    col_d, col_q, t_tag, t, tv = out
    return t, tv, col_d, col_q, t_tag


def _ring_body(q, qv, t, tv, mesh: Mesh, axis_name: str, t_blk: int,
               q_tag=None, t_tag=None):
    """This rank's part of the ring. q (Qd, D), qv (Qd,), t (Td, D), tv
    (Td,): its query shard and its train block, on its device; t_blk: the
    rows of a block, so that row r of the block owned by rank k has global
    index k * t_blk + r. Optional q_tag (Qd,) / t_tag (Td,) int32: a train
    row whose tag equals the query's is no candidate for it (self-frame
    exclusion). -> (best_t (Qd,) int32 global train index, distance (Qd,)
    f32, keep (Qd,) bool: the match is mutual, valid and finite)."""
    me = mesh.coords[axis_name]
    n = mesh.shape[axis_name]
    n_q, n_t = q.shape[0], t.shape[0]
    dev = q.device
    b = q.to(torch.float64)
    bb = torch.sum(b * b, dim=1)
    best_d = torch.full((n_q,), INF, dtype=F32, device=dev)
    best_t = torch.zeros((n_q,), dtype=I32, device=dev)
    # the column state travels with the block
    col_d = torch.full((n_t,), INF, dtype=F32, device=dev)
    col_q = torch.zeros((n_t,), dtype=I32, device=dev)
    my_q = me * n_q + torch.arange(n_q, dtype=I32, device=dev)
    rows = max(1, matcher.TEMP_BYTES // (8 * max(n_q, 1)))
    owner = me
    for _ in range(n):
        for c0 in range(0, n_t, rows):
            sl = slice(c0, c0 + rows)
            d2 = matcher._chunk_d2(t[sl], b, bb)
            if q_tag is not None:
                d2.masked_fill_(t_tag[sl][None, :] == q_tag[:, None], INF)
            # rows: an invalid train row never wins
            d2.masked_fill_(~tv[sl][None, :], INF)
            arg = torch.argmin(d2, dim=1)
            low = torch.gather(d2, 1, arg[:, None])[:, 0]
            g_t = (owner * t_blk + c0 + arg).to(I32)
            take = (low < best_d) | ((low == best_d) & (g_t < best_t))
            best_d = torch.where(take, low, best_d)
            best_t = torch.where(take, g_t, best_t)
            # columns: an invalid query never wins. The columns of invalid
            # train rows now read inf; no kept match reads their winner
            d2.masked_fill_(~qv[:, None], INF)
            carg = torch.argmin(d2, dim=0)
            cmin = torch.gather(d2, 0, carg[None, :])[0]
            del d2
            g_q = my_q[carg]
            cd, cq = col_d[sl], col_q[sl]
            ctake = (cmin < cd) | ((cmin == cd) & (g_q < cq))
            col_d[sl] = torch.where(ctake, cmin, cd)
            col_q[sl] = torch.where(ctake, g_q, cq)
        if n > 1:   # the block and its column state to the next rank
            t, tv, col_d, col_q, t_tag = _unpack(
                shift(mesh, axis_name, _pack(t, tv, col_d, col_q, t_tag)),
                t, tv, col_d, col_q, t_tag)
        owner = (owner - 1) % n
    # after n hops each block is home: col_q is complete for this rank's
    all_col_q = all_gather(mesh, axis_name, col_q)
    keep = ((all_col_q[best_t.long()] == my_q) & qv & torch.isfinite(best_d))
    return best_t, sqrt_f32(best_d), keep


def match_tagged_dense(d_train, t_valid, t_tag, d_query, q_valid, q_tag,
                       cross_check: bool = True):
    """The plain form of the tagged ring on one device, one distance matrix:
    (best_t int32, distance f32, keep bool) per query, train rows whose tag
    equals the query's excluded, invalid rows and queries never winning.
    The reference the ring and extract_match_step are held against."""
    b = d_query.to(torch.float64)
    d2 = matcher._chunk_d2(d_train, b, torch.sum(b * b, dim=1))
    d2.masked_fill_(t_tag[None, :] == q_tag[:, None], INF)
    d2_rows = d2.masked_fill(~t_valid[None, :], INF)
    d2_cols = d2.masked_fill(~q_valid[:, None], INF)
    best_t = torch.argmin(d2_rows, dim=1)
    best_d = torch.gather(d2_rows, 1, best_t[:, None])[:, 0]
    keep = q_valid & torch.isfinite(best_d)
    if cross_check:
        arange = torch.arange(d2.shape[0], device=d2.device)
        keep &= torch.argmin(d2_cols, dim=0)[best_t] == arange
    return best_t.to(I32), sqrt_f32(best_d), keep


def _block(x, n: int, i: int, dt, dev):
    """Block i of n of the rows of x (an array, or a tensor on any device),
    zero-padded to ceil(len / n) rows, as dt on dev; and its valid mask."""
    size = -(-max(len(x), 1) // n)
    lo = min(i * size, len(x))
    hi = min(lo + size, len(x))
    out = torch.zeros((size, x.shape[1]), dtype=dt, device=dev)
    out[:hi - lo] = matcher._on(x[lo:hi], dev).to(dt)
    valid = torch.arange(size, device=dev) < hi - lo
    return out, valid, size


def ring_match(d_train, d_query, mesh: Mesh | None = None,
               axis_name: str = "data", cross_check: bool = True):
    """Sharded BFMatcher.match analog: every rank of the mesh calls it with
    the same d_train (T, D) / d_query (Q, D), u8 or f32 (arrays, or tensors
    on any device), and gets the same (query_idx, train_idx, distance)
    numpy arrays of the retained matches, those of
    ops.matcher.match_brute_force. mesh defaults to make_mesh(): the
    world's ranks on the card."""
    mesh = mesh if mesh is not None else make_mesh()
    n, me, dev = mesh.shape[axis_name], mesh.coords[axis_name], mesh.device
    d_train, d_query = (x if isinstance(x, torch.Tensor) else np.asarray(x)
                        for x in (d_train, d_query))
    # u8 descriptors stay u8 on the wire; anything else is f32
    u8 = all(str(x.dtype).endswith("uint8") for x in (d_train, d_query))
    dt = torch.uint8 if u8 else F32
    with span("matcher.ring", ranks=n):
        q, qv, _ = _block(d_query, n, me, dt, dev)
        t, tv, t_blk = _block(d_train, n, me, dt, dev)
        bt, bd, keep = _ring_body(q, qv, t, tv, mesh, axis_name, t_blk)
        if not cross_check:
            keep = qv & torch.isfinite(bd)
        bt, bd, keep = (all_gather(mesh, axis_name, x).cpu().numpy()
                        for x in (bt, bd, keep))
        qi = np.nonzero(keep[:len(d_query)])[0]
        return qi, bt[qi], bd[qi]
