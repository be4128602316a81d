"""Descriptor-database service: extract -> index -> query.

The port's counterpart of sift_features_tpu/service.py: the deployment the
JAX package names for this system. Frames are extracted into a persistent
database (`io.database.DescriptorDB`) and new frames are matched against
all of it (loop closure, retrieval), with BFMatcher(NORM_L2, crossCheck)
semantics over the concatenated database. Extraction runs the port's
`extract_batch` / `extract` (the main path's CUDA kernels on the card);
matching runs the dense single-device matcher (`ops.matcher`, the train
rows in chunks) or, given a mesh, the ring matcher (`parallel.ring`: the
database sharded over the mesh's ranks, streamed round the ring). Results
are identical.

    idx = DescriptorIndex(device="cuda")
    idx.add_frames(frame_batch)                  # extract + index
    m = idx.query(desc_q)                        # global best matches
    idx.save("/data/db"); DescriptorIndex.load("/data/db", mesh=mesh)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import DEFAULT_CONFIG, SiftConfig
from .io.database import DescriptorDB
from .utils.device import resolve_device
from .utils.profiling import span


@dataclasses.dataclass
class QueryResult:
    """Per retained query row: global DB row, owning frame, keypoint index
    within that frame, and L2 distance."""

    query_idx: np.ndarray     # (M,) int64 — query descriptor rows
    frame_id: np.ndarray      # (M,) int64 — DB frame owning the best match
    keypoint_idx: np.ndarray  # (M,) int64 — keypoint index within that frame
    distance: np.ndarray      # (M,) f32


class DescriptorIndex:
    """Queryable descriptor index with host-side persistence. The database
    lives on the host; extraction and matching run on `device` (the
    mesh's device with a mesh, else the card unless the caller asks for the
    CPU). The database's descriptors go to the device once per mutation of
    the database, not once per query.

    mesh: an optional parallel.mesh.Mesh; queries then run the ring matcher
    over its `axis_name` ranks (every rank of the mesh queries together),
    u8 descriptors on the wire. A device that differs from the mesh's
    raises ValueError.

    Spans (utils/profiling.py): `service.query` around a query, with the
    matcher's spans, `service.train_upload` (a new database's descriptors
    to the device; attribute `bytes`), `service.row_maps` (attribute
    `cache_hit`) and `service.result` inside; `service.ingest` around
    `add_batch_result`, with `db.from_batch` and `db.extend` inside."""

    def __init__(self, db: DescriptorDB | None = None, mesh=None,
                 axis_name: str = "data", *,
                 device: str | torch.device | None = None):
        if mesh is not None and device is not None:
            from .parallel.mesh import rank_device

            if rank_device(device) != mesh.device:
                raise ValueError(f"device {device} differs from the mesh's "
                                 f"{mesh.device}")
        self.mesh = mesh
        self.axis_name = axis_name
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device or "cuda"))
        self.db = db if db is not None else DescriptorDB.empty()
        self._row_maps_cache = None
        self._train_cache = None

    # --- build ------------------------------------------------------------

    def add_frames(self, imgs_u8, frame_ids=None,
                   config: SiftConfig = DEFAULT_CONFIG,
                   features_limit: int | None = None) -> None:
        """Extract a (B, H, W) u8 frame batch on the index's device
        (budgeted when features_limit is set: truncate before describe) and
        append it to the index."""
        from .models.extractor import extract_batch

        res = extract_batch(imgs_u8, config, features_limit,
                            device=self.device)
        self.add_batch_result(res, frame_ids)

    def add_batch_result(self, res, frame_ids=None) -> None:
        """Append an extract_batch result dict (tensors on any device, or
        arrays); frame ids default to the next free ones."""
        with span("service.ingest", frames=int(res["valid"].shape[0])):
            if frame_ids is None:
                n = len(self.db.frame_ids)
                frame_ids = np.arange(n, n + res["valid"].shape[0],
                                      dtype=np.int64)
            self.db = self.db.extend(DescriptorDB.from_batch(res, frame_ids))

    # --- query ------------------------------------------------------------

    def _row_maps(self):
        """row -> (frame id, keypoint index) maps, cached per database:
        queries are O(matches), not O(frames) + O(rows)."""
        cached = self._row_maps_cache
        hit = cached is not None and cached[0] is self.db
        with span("service.row_maps", cache_hit=hit):
            if hit:
                return cached[1], cached[2]
            offs = self.db.offsets
            n = int(offs[-1])
            lens = np.diff(offs).astype(np.int64)
            row_frame = np.repeat(np.asarray(self.db.frame_ids, np.int64), lens)
            row_kp = np.arange(n, dtype=np.int64) - np.repeat(
                offs[:-1].astype(np.int64), lens)
            self._row_maps_cache = (self.db, row_frame, row_kp)
            return row_frame, row_kp

    def _train(self) -> torch.Tensor:
        """The database's descriptors on the index's device, cached per
        database."""
        cached = self._train_cache
        if cached is None or cached[0] is not self.db:
            with span("service.train_upload",
                      bytes=int(self.db.descriptors.nbytes)):
                cached = self._train_cache = (
                    self.db,
                    torch.as_tensor(self.db.descriptors, device=self.device))
        return cached[1]

    def query(self, desc_q, cross_check: bool = True) -> QueryResult:
        """Match (Q, 128) u8 query descriptors (an array, or a tensor on any
        device) against the whole database on the index's device. Same
        semantics as BFMatcher(NORM_L2, crossCheck) over the concatenated
        database (examples/sift-match.rs:30-39)."""
        from .ops.matcher import match_brute_force

        if len(self.db.descriptors) == 0 or len(desc_q) == 0:
            z = np.zeros(0, np.int64)
            return QueryResult(z, z, z, np.zeros(0, np.float32))
        with span("service.query", rows=len(desc_q)):
            if self.mesh is not None:
                from .parallel.ring import ring_match

                qi, ti, dist = ring_match(self.db.descriptors, desc_q,
                                          self.mesh, self.axis_name,
                                          cross_check)
            else:
                m = match_brute_force(self._train(), desc_q, cross_check,
                                      device=self.device)
                qi, ti, dist = m.query_idx, m.train_idx, m.distance
            row_frame, row_kp = self._row_maps()
            with span("service.result"):
                return QueryResult(qi.astype(np.int64), row_frame[ti],
                                   row_kp[ti], dist.astype(np.float32))

    def query_image(self, img_u8, config: SiftConfig = DEFAULT_CONFIG,
                    features_limit: int | None = None,
                    cross_check: bool = True):
        """Extract one (H, W) u8 image on the index's device and query it:
        returns (keypoints, descriptors, QueryResult)."""
        from .models.extractor import extract

        kps, desc = extract(img_u8, features_limit, config, device=self.device)
        return kps, desc, self.query(desc, cross_check)

    # --- persistence ------------------------------------------------------

    def save(self, directory: str, n_shards: int | None = None) -> None:
        """Frame-contiguous .npz shards, one per serving host; n_shards
        defaults to the mesh's axis size, or 1."""
        if n_shards is None:
            n_shards = (self.mesh.shape[self.axis_name]
                        if self.mesh is not None else 1)
        self.db.save_sharded(directory, n_shards)

    @classmethod
    def load(cls, directory: str, mesh=None, axis_name: str = "data", *,
             device: str | torch.device | None = None) -> "DescriptorIndex":
        return cls(DescriptorDB.load_all(directory), mesh, axis_name,
                   device=device)
