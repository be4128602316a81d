"""Parser for the reference crate's insta YAML snapshot goldens.

The port's own copy of sift_features_tpu/io/snapshots.py. The reference
pins correctness end-to-end against 4 committed snapshots (the crate's
src/snapshots/, test at lib.rs:1009-1056): keypoints sorted by (x, y, size)
and byte-exact u8 descriptors in the same order. The files are simple enough
(199k lines) that a hand-rolled line parser is ~100x faster than PyYAML and
has no dependencies.
"""

from __future__ import annotations

import numpy as np

KEYPOINT_FIELDS = ("x", "y", "size", "angle", "response")


def parse_keypoint_snapshot(path: str) -> np.ndarray:
    """Parse a keypoint snapshot into a structured (N,5) float32 array with
    columns (x, y, size, angle, response)."""
    rows: list[list[float]] = []
    cur: list[float] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("- x:"):
                if cur:
                    rows.append(cur)
                cur = [float(line.split(":", 1)[1])]
            elif line.startswith(("y:", "size:", "angle:", "response:")):
                cur.append(float(line.split(":", 1)[1]))
        if cur:
            rows.append(cur)
    arr = np.asarray(rows, dtype=np.float64).astype(np.float32)
    assert arr.ndim == 2 and arr.shape[1] == 5, arr.shape
    return arr


def parse_descriptor_snapshot(path: str) -> np.ndarray:
    """Parse a descriptor snapshot into an (N,128) uint8 array."""
    rows: list[list[int]] = []
    cur: list[int] = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if s.startswith("- - "):  # new descriptor row
                if cur:
                    rows.append(cur)
                cur = [int(s[4:])]
            elif s.startswith("- ") and s[2:].lstrip("-").isdigit():
                cur.append(int(s[2:]))
        if cur:
            rows.append(cur)
    arr = np.asarray(rows, dtype=np.int64)
    assert arr.ndim == 2 and arr.shape[1] == 128, arr.shape
    assert arr.min() >= 0 and arr.max() <= 255
    return arr.astype(np.uint8)


# Mapping of snapshot index -> (image, kind); see lib.rs:1038-1055.
SNAPSHOT_FILES = {
    "tree_small": ("sift__sift_end2end.snap", "sift__sift_end2end-2.snap"),
    "bird_small": ("sift__sift_end2end-3.snap", "sift__sift_end2end-4.snap"),
}


def load_golden(reference_root: str, image_name: str):
    """Return (keypoints (N,5) f32 sorted by (x,y,size), descriptors (N,128) u8)."""
    import os

    kp_file, desc_file = SNAPSHOT_FILES[image_name]
    snap_dir = os.path.join(reference_root, "src", "snapshots")
    kps = parse_keypoint_snapshot(os.path.join(snap_dir, kp_file))
    descs = parse_descriptor_snapshot(os.path.join(snap_dir, desc_file))
    assert kps.shape[0] == descs.shape[0]
    return kps, descs
