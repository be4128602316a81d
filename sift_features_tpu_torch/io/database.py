"""Descriptor-database persistence, in NumPy.

The port's own copy of sift_features_tpu/io/database.py (`DescriptorDB`):
a serving deployment keeps its descriptor database (keypoints and u8
descriptors per frame) across restarts and shards it across hosts. The
format is a compressed .npz per shard with the keys frame_ids, offsets,
keypoints and descriptors, shards named shard_{s:05d}.npz: the JAX
package's, so shards written by either package load in the other.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..utils.profiling import span


def _host(x) -> np.ndarray:
    """A torch tensor on any device, or an array, as a NumPy array."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


@dataclasses.dataclass
class DescriptorDB:
    """Ragged per-frame keypoint/descriptor store.

    frame_ids: (F,) int64; offsets: (F+1,) int64 into the row axis;
    keypoints: (N, 5) f32 [x, y, size, angle, response]; descriptors:
    (N, 128) u8.
    """

    frame_ids: np.ndarray
    offsets: np.ndarray
    keypoints: np.ndarray
    descriptors: np.ndarray

    @classmethod
    def empty(cls) -> "DescriptorDB":
        return cls(np.zeros(0, np.int64), np.zeros(1, np.int64),
                   np.zeros((0, 5), np.float32), np.zeros((0, 128), np.uint8))

    @classmethod
    def from_batch(cls, res, frame_ids=None) -> "DescriptorDB":
        """Build from an extract_batch result dict (padded rows kps / desc
        and their valid mask): torch tensors on any device, or arrays. The
        valid rows are selected where the tensors lie, then copied to the
        host (span `db.from_batch`)."""
        with span("db.from_batch"):
            valid = res["valid"]
            kps = _host(res["kps"][valid])
            desc = _host(res["desc"][valid])
            counts = _host(valid.sum(1))
            b = counts.shape[0]
            if frame_ids is None:
                frame_ids = np.arange(b, dtype=np.int64)
            offsets = np.zeros(b + 1, np.int64)
            np.cumsum(counts, out=offsets[1:])
            return cls(np.asarray(frame_ids, np.int64), offsets,
                       kps.astype(np.float32), desc)

    def frame(self, i: int):
        lo, hi = self.offsets[i], self.offsets[i + 1]
        return self.keypoints[lo:hi], self.descriptors[lo:hi]

    def extend(self, other: "DescriptorDB") -> "DescriptorDB":
        """This database with other's frames after its own (span
        `db.extend`)."""
        with span("db.extend"):
            off = np.concatenate([self.offsets,
                                  other.offsets[1:] + self.offsets[-1]])
            return DescriptorDB(
                np.concatenate([self.frame_ids, other.frame_ids]), off,
                np.concatenate([self.keypoints, other.keypoints]),
                np.concatenate([self.descriptors, other.descriptors]))

    def save(self, path: str) -> None:
        np.savez_compressed(path, frame_ids=self.frame_ids,
                            offsets=self.offsets, keypoints=self.keypoints,
                            descriptors=self.descriptors)

    @classmethod
    def load(cls, path: str) -> "DescriptorDB":
        with np.load(path) as z:
            return cls(z["frame_ids"], z["offsets"], z["keypoints"],
                       z["descriptors"])

    # --- sharded persistence for multi-host serving -----------------------

    def save_sharded(self, directory: str, n_shards: int) -> None:
        """Frame-contiguous shards, one .npz each (shard i owns frames
        i*F/n .. (i+1)*F/n); each host loads only its shard."""
        os.makedirs(directory, exist_ok=True)
        f = len(self.frame_ids)
        bounds = np.linspace(0, f, n_shards + 1).astype(np.int64)
        for s in range(n_shards):
            lo_f, hi_f = bounds[s], bounds[s + 1]
            lo, hi = self.offsets[lo_f], self.offsets[hi_f]
            shard = DescriptorDB(
                self.frame_ids[lo_f:hi_f],
                self.offsets[lo_f:hi_f + 1] - self.offsets[lo_f],
                self.keypoints[lo:hi], self.descriptors[lo:hi])
            shard.save(os.path.join(directory, f"shard_{s:05d}.npz"))

    @classmethod
    def load_shard(cls, directory: str, shard: int) -> "DescriptorDB":
        return cls.load(os.path.join(directory, f"shard_{shard:05d}.npz"))

    @classmethod
    def load_all(cls, directory: str) -> "DescriptorDB":
        names = sorted(n for n in os.listdir(directory)
                       if n.startswith("shard_") and n.endswith(".npz"))
        db = cls.empty()
        for n in names:
            db = db.extend(cls.load(os.path.join(directory, n)))
        return db
