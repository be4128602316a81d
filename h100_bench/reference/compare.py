"""The comparisons that decide `correct`.

`rows_readings` pairs the program's keypoint rows of one frame with the
reference's: both lists come in the reference crate's order, but a
candidate near a threshold can fall on the other side in one of them, so
rows are paired by value, not by index. A program row pairs with the
closest unpaired reference row within PAIR_TOL (x, y and size in pixels,
angle in degrees); rows left without a partner on either side count as
unpaired. The readings are the worst of the frame:

    rows_unpaired      unpaired rows of both sides / reference rows
    kp_xy_size_err     largest |dx|, |dy|, |dsize| of a pair (pixels)
    kp_angle_off       share of pairs whose angles differ by more than
                       ANGLE_OFF_DEG (a share, not the largest difference:
                       a histogram with two near-equal peak bins moves its
                       interpolated angle by degrees on the last ulp)
    kp_response_err    largest |dresponse| of a pair
    desc_rows_unequal  share of pairs whose 128 bytes differ

`matches_readings` and `query_readings` count the rows in which the
program's matches differ from the reference matcher's in any field.
"""

from __future__ import annotations

import numpy as np

PAIR_TOL = {"xy": 0.5, "size": 0.5, "angle": 5.0}
ANGLE_OFF_DEG = 0.01

ROW_READINGS = ("rows_unpaired", "kp_xy_size_err", "kp_angle_off",
                "kp_response_err", "desc_rows_unequal")


def _angle_diff(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) % 360.0
    return np.minimum(d, 360.0 - d)


def pair_rows(kp_prog: np.ndarray, kp_ref: np.ndarray):
    """Greedy pairing by value: (program index, reference index) arrays of
    the pairs, in program-row order."""
    order = np.argsort(kp_ref[:, 0], kind="stable")
    ref_x = kp_ref[order, 0]
    used = np.zeros(len(kp_ref), bool)
    pi, ri = [], []
    tol = PAIR_TOL
    for i, row in enumerate(kp_prog):
        lo = np.searchsorted(ref_x, row[0] - tol["xy"], "left")
        hi = np.searchsorted(ref_x, row[0] + tol["xy"], "right")
        if lo == hi:
            continue
        cand = order[lo:hi]
        cand = cand[~used[cand]]
        if not len(cand):
            continue
        c = kp_ref[cand]
        dxy = np.maximum(np.abs(c[:, 0] - row[0]), np.abs(c[:, 1] - row[1]))
        dsz = np.abs(c[:, 2] - row[2])
        dang = _angle_diff(c[:, 3], row[3])
        ok = (dxy <= tol["xy"]) & (dsz <= tol["size"]) & (dang <= tol["angle"])
        if not ok.any():
            continue
        score = np.where(ok, dxy + dsz + dang / tol["angle"], np.inf)
        j = cand[int(np.argmin(score))]
        used[j] = True
        pi.append(i)
        ri.append(j)
    return np.asarray(pi, np.int64), np.asarray(ri, np.int64)


def rows_readings(kp_prog, desc_prog, kp_ref, desc_ref) -> dict:
    """The readings of one frame (module note)."""
    pi, ri = pair_rows(kp_prog, kp_ref)
    n_pairs = len(pi)
    unpaired = (len(kp_prog) - n_pairs) + (len(kp_ref) - n_pairs)
    out = {"rows_unpaired": unpaired / max(len(kp_ref), 1),
           "kp_xy_size_err": 0.0, "kp_angle_off": 0.0,
           "kp_response_err": 0.0, "desc_rows_unequal": 0.0}
    if n_pairs:
        a, b = kp_prog[pi].astype(np.float64), kp_ref[ri].astype(np.float64)
        out["kp_xy_size_err"] = float(np.abs(a[:, :3] - b[:, :3]).max())
        out["kp_angle_off"] = float((_angle_diff(a[:, 3], b[:, 3])
                                     > ANGLE_OFF_DEG).mean())
        out["kp_response_err"] = float(np.abs(a[:, 4] - b[:, 4]).max())
        out["desc_rows_unequal"] = float(
            (desc_prog[pi] != desc_ref[ri]).any(1).mean())
    return out


def _rows_differ(got: tuple, want: tuple) -> int:
    """Rows of two match lists (query_idx first, then fields) that differ:
    query rows kept by one side only, plus shared rows whose fields
    differ."""
    g = {int(q): tuple(f[i] for f in got[1:]) for i, q in enumerate(got[0])}
    w = {int(q): tuple(f[i] for f in want[1:]) for i, q in enumerate(want[0])}
    if len(g) != len(got[0]):
        return max(len(got[0]), len(want[0]), 1)
    return sum(1 for q in g.keys() | w.keys() if g.get(q) != w.get(q))


def matches_readings(m_prog, train_desc, query_desc, cross_check=True) -> int:
    """Rows in which the program's matches (query_idx, train_idx, distance)
    of query_desc against train_desc differ from the reference's."""
    from .matcher import match

    want = match(train_desc, query_desc, cross_check)
    got = (np.asarray(m_prog.query_idx), np.asarray(m_prog.train_idx),
           np.asarray(m_prog.distance, np.float32))
    return _rows_differ(got, want)


def query_readings(r_prog, train_desc, row_frame, row_kp, query_desc,
                   cross_check=True, device="cpu") -> int:
    """Rows in which the service's answer (query_idx, frame_id,
    keypoint_idx, distance) differs from the reference's."""
    from .matcher import match

    qi, ti, dist = match(train_desc, query_desc, cross_check, device)
    want = (qi, row_frame[ti], row_kp[ti], dist)
    got = (np.asarray(r_prog.query_idx), np.asarray(r_prog.frame_id),
           np.asarray(r_prog.keypoint_idx),
           np.asarray(r_prog.distance, np.float32))
    return _rows_differ(got, want)
