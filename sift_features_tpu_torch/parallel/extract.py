"""Sharded extraction over a mesh: frames over `data`, rows over `space`.

Counterpart of sift_features_tpu/parallel/extract.py. A batch of frames
splits over the mesh's `data` axis; each data rank runs the port's batched
extractor (`models.extractor.extract_batch`, the main path's kernels on the
card) on its frames, with no collective between them, and all_gathers the
padded result over `data`, so that every rank returns the whole batch, as
the JAX package's global array holds it. Ranks of one data index along
`space` compute the same shard, as JAX's `P("data")` body does.

The spatial form (`_extract_single_spatial`) also splits one frame's rows
over `space`: while an octave's rows split into even shards taller than
every blur radius (`shards_rows`), its blurs exchange halos
(parallel/halo.py) and its Gaussian stack is all_gathered over `space`;
the smaller octaves are blurred whole on every member. Each member then
detects, refines, orients and describes only the candidates of its own
row band (K3 or the refine_mode's kernels, K5′ or K8, K6′ or K7; the
band's extremum scan is the plain mask, never K2′). Concatenated over the
members, the bands' rows are the frame's keypoint set: that of
precompute + extract_with_precomputed, whose blurs are the same
reflect-101 chain (the batched path's K1 blurs the padded plane, ulps
apart near the borders).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, SiftConfig
from ..ops.gaussian import cv_ksize
from ..ops.pyramid import create_seed_image, octave_levels
from ..ops.resize import resize_nearest_half
from ..utils.compact import compact_indices
from .halo import gaussian_blur_sharded
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


# ---------------------------------------------------------------------------
# The spatial form: one frame's rows over `space`
# ---------------------------------------------------------------------------

def shards_rows(h: int, n_space: int, cfg: SiftConfig) -> bool:
    """Whether an octave of h rows is built row-sharded over n_space
    members: h splits into even shards (the local ::2 downsample then takes
    the globally even rows) taller than every blur radius of the octave
    (JAX's test reads >= there; see halo.blur_rows_halo)."""
    h_loc = h // n_space
    return (h % (2 * n_space) == 0 and h_loc >= 2
            and all(h_loc > cv_ksize(s) // 2 for s in cfg.octave_sigmas()[1:]))


def _build_octaves_spatial(seed: torch.Tensor, n_octaves: int,
                           cfg: SiftConfig, mesh: Mesh) -> list:
    """seed: (H, W) f32, the whole frame's seed on every member. Returns the
    n_octaves whole (S+3, H_o, W_o) Gaussian stacks: an octave that
    `shards_rows` is blurred on this member's rows with halo exchanges and
    gathered over `space`; the others are blurred whole on every member
    (parallel/extract.py:_build_octaves_spatial)."""
    n, i = mesh.shape["space"], mesh.coords["space"]
    sigmas = cfg.octave_sigmas()
    octaves = []
    cur, local = seed, False         # local: cur holds this member's rows
    h = seed.shape[-2]
    for _ in range(n_octaves):
        if shards_rows(h, n, cfg):
            h_loc = h // n
            if not local:
                cur = cur[i * h_loc:(i + 1) * h_loc]
            levels = [cur]
            for sig in sigmas[1:]:
                levels.append(gaussian_blur_sharded(levels[-1], sig, mesh))
            octaves.append(all_gather(mesh, "space", torch.stack(levels), 1))
            local = True
        else:
            if local:
                cur = all_gather(mesh, "space", cur)
            levels = octave_levels(cur, cfg)
            octaves.append(torch.stack(levels))
            local = False
        cur = resize_nearest_half(levels[cfg.scales_per_octave])
        h //= 2
    return octaves


def _extract_single_spatial(img_u8: torch.Tensor, n_octaves: int,
                            cfg: SiftConfig, mesh: Mesh,
                            budget: int | None = None) -> dict:
    """One frame through the spatial path: every member of `space` calls it
    with the same (H, W) u8 frame and returns its own buffers: kps (M, 5),
    valid (M,), desc (M, 128), octave-major over its row band (rows [s *
    hb, (s + 1) * hb) of each octave, hb = ceil(h / n_space)), and the
    band's counters (n_octaves,). Concatenated in member order, the
    members' valid rows are the frame's keypoint set
    (parallel/extract.py:_extract_single_spatial).

    budget (lib.rs:156-161): the members all_gather their emission
    responses over `space`, take the frame's response top-K over the
    member-major concatenation (jax.lax.top_k's tie rule), and describe
    only their own chosen rows; buffers are then (K,) long, with only this
    member's chosen rows valid."""
    from ..models.extractor import (COUNTERS, _describe_octave_subset,
                                    _detect_octave, stable_top_k)

    n, idx = mesh.shape["space"], mesh.coords["space"]
    seed = create_seed_image(img_u8[None], cfg)[0]
    octs = _build_octaves_spatial(seed, n_octaves, cfg, mesh)
    out, hw_list = [], []
    for o, gauss in enumerate(octs):
        h = gauss.shape[-2]
        hb = -(-h // n)
        y0 = idx * hb
        out.append(_detect_octave(gauss, None, o, cfg,
                                  row_range=(y0, min(y0 + hb, h)),
                                  describe=budget is None))
        hw_list.append((h, gauss.shape[-1]))
    res = {k: torch.cat([r[k] for r in out]) for k in ("kps", "valid")}
    res.update({k: torch.stack([r[k] for r in out]) for k in COUNTERS})
    if budget is None:
        res["desc"] = torch.cat([r["desc"] for r in out])
        return res

    kps, valid = res["kps"], res["valid"]
    dev = kps.device
    m_tot = valid.shape[0]
    neg_inf = torch.full((), float("-inf"), device=dev)
    resp_all = all_gather(mesh, "space", torch.where(valid, kps[:, 4], neg_inf))
    kb = min(budget, n * m_tot)
    top_val, top_idx = stable_top_k(resp_all, kb)
    mine = ((top_val > neg_inf) & (top_idx >= idx * m_tot)
            & (top_idx < (idx + 1) * m_tot))
    loc = torch.clamp(top_idx - idx * m_tot, 0, m_tot - 1)
    out_kps = torch.where(mine[:, None], kps[loc], torch.zeros((), device=dev))
    out_desc = torch.zeros((kb, cfg.descriptor_size), dtype=torch.uint8,
                           device=dev)
    off = 0
    for r, (h, w) in zip(out, hw_list):
        m_o = r["valid"].shape[0]
        in_o = mine & (loc >= off) & (loc < off + m_o)
        c_cap = min(kb, m_o)
        midx, mvalid, _ = compact_indices(in_o, c_cap)
        sel = torch.clamp(loc[midx] - off, 0, m_o - 1)
        fields = {k: v[sel] for k, v in r["desc_in"].items()}
        desc_c = _describe_octave_subset(r["win_ctx"], fields, mvalid, cfg,
                                         h, w)
        rank = torch.clamp(torch.cumsum(in_o, 0) - 1, 0, c_cap - 1)
        out_desc = torch.where(in_o[:, None], desc_c[rank], out_desc)
        off += m_o
    res.update({"kps": out_kps, "desc": out_desc, "valid": mine})
    return res
