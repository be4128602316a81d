"""The distributed step: sharded extraction, then a ring match of the batch.

Counterpart of sift_features_tpu/parallel/pipeline.py:extract_match_step.
A frame batch splits over the mesh's `data` axis; each rank pushes its
frames through the fused batched extractor (`_extract_batch_fused`, the main
path's kernels on the card), takes each frame's top `queries_per_frame`
keypoints by response as queries, and matches them against every row of
the whole batch (frame-major) with the ring matcher (`ring._ring_body`),
frame tags riding the ring so that a query never matches its own frame
(loop closure / retrieval within a batch). The result is gathered over
`data`: every rank returns the whole batch's.

With `space` > 1 each data rank's frames go one after another through the
spatial path (`extract._extract_single_spatial`: rows over `space`,
halo-exchange blurs, detection by row band); the members' buffers are
gathered over `space` along the keypoint axis in member order, the layout
of JAX's `out_specs P("data", "space")`, and their counters summed.
"""

from __future__ import annotations

import torch

from ..config import SiftConfig, check_supported
from .extract import _extract_single_spatial, data_shard, gather_frames
from .mesh import Mesh, all_gather, make_mesh, psum
from .ring import _ring_body

OUTPUT_KEYS = ("kps", "desc", "valid", "n_candidates", "n_survivors",
               "n_emitted", "match_train", "match_dist", "match_keep",
               "query_idx")


def queries_and_database(res: dict, frame0: int, queries_per_frame: int):
    """The ring's inputs from a padded batch result of frames frame0, ...:
    each frame's top `queries_per_frame` rows by response (jax.lax.top_k's
    tie rule) and every row of the batch, frame-major, each with its valid
    mask and frame tag. -> (top_idx (b, K), q, qv, q_tag, t, tv, t_tag)."""
    from ..models.extractor import stable_top_k

    kps, desc, valid = res["kps"], res["desc"], res["valid"]
    b, n = valid.shape
    resp = torch.where(valid, kps[..., 4],
                       torch.full((), float("-inf"), device=kps.device))
    top_val, top_idx = stable_top_k(resp, queries_per_frame)
    k = top_idx.shape[1]
    q = torch.gather(desc, 1, top_idx[..., None].expand(b, k, desc.shape[2]))
    tags = torch.arange(frame0, frame0 + b, dtype=torch.int32, device=kps.device)
    return (top_idx.to(torch.int32), q.reshape(b * k, -1),
            torch.isfinite(top_val).reshape(b * k), tags.repeat_interleave(k),
            desc.reshape(b * n, -1), valid.reshape(b * n),
            tags.repeat_interleave(n))


def _spatial_shard(frames: torch.Tensor, n_octaves: int, cfg: SiftConfig,
                   mesh: Mesh, features_limit: int | None) -> dict:
    """The extraction of extract_match_step at space > 1: this data rank's
    (b, H, W) frames, one after another, through _extract_single_spatial
    (JAX's lax.map); each member's (b, M, ...) buffers gathered over
    `space` along the keypoint axis in member order and the counters
    summed over `space`. With features_limit, the member-concatenated
    axis is compressed back to the frame's top min(limit, rows) by
    response (jax.lax.top_k's tie rule; parallel/pipeline.py:79-94)."""
    from ..models.extractor import COUNTERS, _gather_rows, _top_rows

    per = [_extract_single_spatial(f, n_octaves, cfg, mesh, features_limit)
           for f in frames]
    res = {k: all_gather(mesh, "space", torch.stack([r[k] for r in per]), 1)
           for k in ("kps", "desc", "valid")}
    res.update({k: psum(mesh, "space", torch.stack([r[k] for r in per]))
                for k in COUNTERS})
    if features_limit is not None:
        # the rows a member did not choose are zero, as _top_rows leaves
        # the empty ones
        kps, top_idx, tvalid = _top_rows(res["kps"], res["valid"],
                                         features_limit)
        res.update({"kps": kps, "desc": _gather_rows(res["desc"], top_idx),
                    "valid": tvalid})
    return res


def extract_match_step(imgs_u8, n_octaves: int, cfg: SiftConfig,
                       mesh: Mesh | None = None, queries_per_frame: int = 128,
                       features_limit: int | None = None) -> dict:
    """imgs_u8: the whole (B, H, W) u8 batch, B divisible by the mesh's data
    size; every rank calls it with the same batch.

    Returns, on this rank's device, per-frame keypoints / descriptors /
    valid / stage counters (as extract_batch, without src_idx) plus, for
    the top `queries_per_frame` keypoints of every frame (query_idx (B, K)
    int32), the best cross-checked match in the batch database outside the
    query's own frame: match_train (B, K) int32, the global row frame * N +
    keypoint; match_dist (B, K) f32; match_keep (B, K) bool.

    features_limit: each frame's response budget, taken before the
    descriptors (lib.rs:156-161): it shrinks the descriptor stage and the
    database the ring circulates. mesh defaults to make_mesh(): the world's
    ranks on the card."""
    from ..models.extractor import _extract_batch_fused

    check_supported(cfg)
    mesh = mesh if mesh is not None else make_mesh()
    mine = data_shard(imgs_u8, mesh)
    b = mine.shape[0]
    if mesh.shape["space"] > 1:
        res = _spatial_shard(mine, n_octaves, cfg, mesh, features_limit)
    else:
        res = _extract_batch_fused(mine, n_octaves, cfg, budget=features_limit)
        res.pop("src_idx", None)
    n = res["valid"].shape[1]
    frame0 = mesh.coords["data"] * b
    top_idx, q, qv, q_tag, t, tv, t_tag = queries_and_database(
        res, frame0, queries_per_frame)
    bt, bd, keep = _ring_body(q, qv, t, tv, mesh, "data", b * n,
                              q_tag=q_tag, t_tag=t_tag)
    k = top_idx.shape[1]
    res.update({"match_train": bt.reshape(b, k), "match_dist": bd.reshape(b, k),
                "match_keep": keep.reshape(b, k), "query_idx": top_idx})
    return gather_frames(mesh, {key: res[key] for key in OUTPUT_KEYS})
