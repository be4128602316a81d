"""Data-parallel (frames) extraction over a mesh.

Counterpart of sift_features_tpu/parallel/extract.py:extract_batch_dp. A
batch of frames splits over the mesh's `data` axis; each data rank runs the
port's batched extractor (`models.extractor.extract_batch`, the main path's
kernels on the card) on its frames, with no collective between them, and
all_gathers the padded result over `data`, so that every rank returns the
whole batch, as the JAX package's global array holds it. Ranks of one data
index along `space` compute the same shard, as JAX's `P("data")` body does.

The spatial form (rows over `space`, halo-exchange blurs:
`_build_octaves_spatial`, `_extract_single_spatial`) is not ported
(ROADMAP Queue A item 3).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, SiftConfig
from .mesh import Mesh, all_gather, make_mesh


def data_shard(imgs_u8, mesh: Mesh) -> torch.Tensor:
    """This rank's frames of a whole (B, H, W) batch, as u8 on its device;
    B must divide over the data axis."""
    n_d, d = mesh.shape["data"], mesh.coords["data"]
    b = imgs_u8.shape[0]
    if b % n_d:
        raise ValueError(f"batch {b} not divisible by data={n_d}")
    per = b // n_d
    part = imgs_u8[d * per:(d + 1) * per]
    if isinstance(part, torch.Tensor):
        return part.to(device=mesh.device, dtype=torch.uint8)
    return torch.as_tensor(np.asarray(part, dtype=np.uint8), device=mesh.device)


def gather_frames(mesh: Mesh, res: dict) -> dict:
    """Every rank's per-frame result tensors concatenated over `data`, in
    frame order."""
    return {k: all_gather(mesh, "data", v) for k, v in res.items()}


def extract_batch_dp(imgs_u8, mesh: Mesh | None = None,
                     config: SiftConfig = DEFAULT_CONFIG) -> dict:
    """(B, H, W) u8, B divisible by the mesh's data size -> the padded
    result dict of models.extractor.extract_batch for the whole batch, on
    this rank's device, its frames extracted over the data axis. Every
    rank calls it with the same batch. mesh defaults to make_mesh(): the
    world's ranks on the card."""
    from ..models.extractor import extract_batch

    mesh = mesh if mesh is not None else make_mesh()
    mine = data_shard(imgs_u8, mesh)
    return gather_frames(mesh, extract_batch(mine, config, device=mesh.device))
