"""K3, K4, K10 and K11: Newton refinement of DoG extrema.

K3 (`refine_walk`) replaces sift_features_tpu/ops/pallas/refine_walk_kernel.py:
refine_walk_tpu (`_kernel`): the whole <= max_interpolation_steps loop in
one launch. K4 (`refine_step`) replaces ops/pallas/refine_kernel.py:
refine_step_pallas (`_kernel`): one masked step, which `refine_stepwise`
drives step by step (refine_mode="step"). K10 (`refine_step_region`)
replaces ops/pallas/refine_region_kernel.py:_region_call: the same step,
one thread per lane with the lanes in region order (`region_order`), so a
region's cube loads share cache lines; `refine_region` runs it for the
first region_steps steps and K4 after (refine_mode="region").
K11 (`refine_tile_slots`) replaces ops/pallas/refine_tile_kernel.py:
_refine_tile_call: the whole walk of tile-grouped candidates, one thread
per slot, each walk held inside its block's window (cubes read from the
DoG in global memory, nothing staged); `refine_tile` groups, launches it
and re-refines the escaped walks with the K4 loop (refine_mode="tile").
All four CUDA entries live in csrc/refine.cu and share one __device__
Newton function (K3 and K11 also one walk); the notes there give each
kernel's bound and design.

Rows are (K, 16) f32 in the layout of ops/extrema.py (ROW_COLS).

K4 also takes a bf16 DoG (storage_dtype "bfloat16", counted as `K4:bf16`):
`_refine_auto` (models/extractor.py) sends a non-f32 stack to the step loop
in every refine_mode, as ops/extrema.py:refine_tpu_auto does. K3, K10 and
K11 take f32 only and raise otherwise, as their JAX kernels assert.
"""

from __future__ import annotations

import ctypes

import torch

from ...config import SiftConfig
from ...utils.region_group import RegionLayout, group_by_region, merge_escaped
from ..extrema import ROW_COLS, newton_step, refine, refine_loop
from . import build

# K10's region: the JAX region key's 8-row x 128-column bands
# (refine_region_kernel.py:250-253)
REGION_ROWS, REGION_COLS = 8, 128
# K11's geometry: 32 x 64 regions, an 8-cell margin, blocks of 16 slots.
# The window (48 x 80) decides which walks escape to the K4 loop; the kernel
# reads no window into shared memory (csrc/refine.cu gives the reason)
TILE_R, TILE_C, TILE_MARGIN, TILE_BK = 32, 64, 8, 16


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _require_f32(name: str, dog_flat: torch.Tensor) -> None:
    """K3, K10 and K11 read f32 stacks only (refine_walk_kernel.py:356,
    refine_region_kernel.py:239, refine_tile_kernel.py:337 assert it)."""
    if dog_flat.dtype != torch.float32:
        raise ValueError(f"{name}: the DoG must be float32, not "
                         f"{dog_flat.dtype} (a bf16 stack takes the K4 loop)")


def refine_step(dog_flat: torch.Tensor, p, y, x, active,
                cfg: SiftConfig) -> torch.Tensor:
    """K4 wrapper: one masked Newton step at plane p / row y / column x of
    dog_flat (P, Hp, Wp), f32 or bf16. The plain version
    (ops/extrema.py:newton_step) for a CPU tensor; the CUDA kernel for a
    CUDA tensor (or an error). The kernel reads the mask as one byte a
    lane, so the refine loop's int32 positions and bool mask pass as they
    are and the call launches that kernel alone; another mask is converted
    with .bool(), as the plain version reads it."""
    if dog_flat.device.type == "cpu":
        return newton_step(dog_flat, p, y, x, active, cfg)
    p, y, x = _i32(p), _i32(y), _i32(x)
    active = (active if active.dtype == torch.bool else active.bool()).contiguous()
    build.require_cuda("refine_step", dog_flat, p, y, x, active)
    dog_t = build.dtype_code("refine_step", dog_flat)
    n_planes, hp, wp = dog_flat.shape
    k = p.shape[0]
    out = torch.empty((k, ROW_COLS), dtype=torch.float32, device=dog_flat.device)
    fn = build.bind("refine", "sift_refine_step",
                    [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
                    + [ctypes.c_int] + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    rc = fn(build.ptr(dog_flat), dog_t, n_planes, hp, wp, build.ptr(p),
            build.ptr(y), build.ptr(x), build.ptr(active), build.ptr(out), k,
            float(cfg.contrast_threshold), float(cfg.edge_threshold),
            float(cfg.scales_per_octave), build.stream_ptr(dog_flat))
    name = build.form("K4", dog_flat)
    build.check(rc, f"{name} refine_step")
    build.count_launch(name)
    return out


def refine_stepwise(dog_flat: torch.Tensor, s0, y0, x0, valid, pad: int,
                    h: int, w: int, cfg: SiftConfig,
                    plane_off=None) -> torch.Tensor:
    """refine_mode="step": the Newton loop driven from Python, one K4 launch
    per step (ops/extrema.py:refine_tpu)."""
    def step(p, y, x, active):
        return refine_step(dog_flat, p, y, x, active, cfg)

    return refine_loop(step, s0, y0, x0, valid, pad, h, w, cfg, plane_off)


def refine_walk(dog_flat: torch.Tensor, s0, y0, x0, valid, pad: int, h: int,
                w: int, cfg: SiftConfig, plane_off=None) -> torch.Tensor:
    """K3 wrapper: the whole refinement loop. The plain version
    (ops/extrema.py:refine) for a CPU tensor; the CUDA kernel for a CUDA
    tensor (or an error). Positions are padded coordinates; plane_off (K,)
    is the per-candidate DoG plane offset (frame * planes). The kernel reads
    the mask as one byte a lane, so the extractor's int32 positions and bool
    mask pass as they are and the call launches that kernel alone; another
    mask is converted with .bool(), as the plain version reads it."""
    _require_f32("refine_walk", dog_flat)
    if dog_flat.device.type == "cpu":
        return refine(dog_flat, s0, y0, x0, valid, pad, h, w, cfg, plane_off)
    k = s0.shape[0]
    if plane_off is None:
        plane_off = torch.zeros(k, dtype=torch.int32, device=dog_flat.device)
    s0, y0, x0, plane_off = _i32(s0), _i32(y0), _i32(x0), _i32(plane_off)
    valid = (valid if valid.dtype == torch.bool else valid.bool()).contiguous()
    build.require_cuda("refine_walk", dog_flat, s0, y0, x0, valid, plane_off)
    n_planes, hp, wp = dog_flat.shape
    out = torch.empty((k, ROW_COLS), dtype=torch.float32, device=dog_flat.device)
    fn = build.bind("refine", "sift_refine_walk",
                    [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
                    + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                    + [ctypes.c_void_p])
    rc = fn(build.ptr(dog_flat), n_planes, hp, wp, build.ptr(s0), build.ptr(y0),
            build.ptr(x0), build.ptr(valid), build.ptr(plane_off),
            build.ptr(out), k, pad, h, w, cfg.image_border,
            cfg.scales_per_octave, cfg.max_interpolation_steps,
            float(cfg.contrast_threshold), float(cfg.edge_threshold),
            build.stream_ptr(dog_flat))
    build.check(rc, "K3 refine_walk")
    build.count_launch("K3")
    return out


def region_order(p, y, x, active, n_planes: int, hp: int, wp: int) -> dict:
    """K10's lane order, on the lanes' device with no host sync: the clamped
    positions (K4's clamps, int32) sorted stably by the JAX region key
    (inactive lanes last), the original index of each sorted lane (int32),
    the sorted keys (inactive lanes: n_regions) and the active count as a
    0-d int32 tensor."""
    p = torch.clamp(p.long(), 1, n_planes - 2)
    y = torch.clamp(y.long(), 1, hp - 2)
    x = torch.clamp(x.long(), 1, wp - 2)
    active = active.bool()
    nry, nrx = -(-hp // REGION_ROWS), -(-wp // REGION_COLS)
    n_regions = n_planes * nry * nrx
    key = (p * nry + (y - 1) // REGION_ROWS) * nrx + (x - 1) // REGION_COLS
    key = torch.where(active, key, torch.full_like(key, n_regions))
    key_s, perm = torch.sort(key, stable=True)
    return {"p": _i32(p[perm]), "y": _i32(y[perm]), "x": _i32(x[perm]),
            "active": active[perm], "perm": _i32(perm), "key": key_s,
            "n_active": active.sum(dtype=torch.int32)}


def region_step_plain(dog_flat: torch.Tensor, g: dict,
                      cfg: SiftConfig) -> torch.Tensor:
    """Plain version of K10: newton_step on the region order of
    `region_order`, the rows put back in the original order by the
    permutation."""
    out = torch.zeros((g["perm"].shape[0], ROW_COLS), dtype=torch.float32,
                      device=dog_flat.device)
    out[g["perm"].long()] = newton_step(dog_flat, g["p"], g["y"], g["x"],
                                        g["active"], cfg)
    return out


def region_step(dog_flat: torch.Tensor, g: dict, cfg: SiftConfig) -> torch.Tensor:
    """K10 on lanes in the order of `region_order`: the plain version for a
    CPU tensor; the CUDA kernel for a CUDA tensor (or an error)."""
    _require_f32("refine_step_region", dog_flat)
    if dog_flat.device.type == "cpu":
        return region_step_plain(dog_flat, g, cfg)
    _, hp, wp = dog_flat.shape
    sp, yp, xp, perm, n_act = (_i32(g[k]) for k in ("p", "y", "x", "perm",
                                                     "n_active"))
    n_act = n_act.reshape(1)
    build.require_cuda("refine_step_region", dog_flat, sp, yp, xp, perm, n_act)
    k = perm.shape[0]
    # the kernel writes every row
    out = torch.empty((k, ROW_COLS), dtype=torch.float32, device=dog_flat.device)
    fn = build.bind("refine", "sift_refine_region",
                    [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                    + [ctypes.c_int] + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    rc = fn(build.ptr(dog_flat), hp, wp, build.ptr(sp), build.ptr(yp),
            build.ptr(xp), build.ptr(perm), build.ptr(n_act), build.ptr(out), k,
            float(cfg.contrast_threshold), float(cfg.edge_threshold),
            float(cfg.scales_per_octave), build.stream_ptr(dog_flat))
    build.check(rc, "K10 refine_step_region")
    build.count_launch("K10")
    return out


def refine_step_region(dog_flat: torch.Tensor, p, y, x, active,
                       cfg: SiftConfig) -> torch.Tensor:
    """K10 wrapper: one masked Newton step, rows in the original lane order,
    equal to K4's (`refine_step`): the lanes grouped by region, then
    `region_step`."""
    return region_step(dog_flat, region_order(p, y, x, active, *dog_flat.shape),
                       cfg)


def refine_region(dog_flat: torch.Tensor, s0, y0, x0, valid, pad: int,
                  h: int, w: int, cfg: SiftConfig,
                  plane_off=None) -> torch.Tensor:
    """refine_mode="region": the Newton loop with K10 for the first
    cfg.region_steps steps and K4 after them (ops/extrema.py:refine_tpu)."""
    steps = iter(range(cfg.max_interpolation_steps))

    def step(p, y, x, active):
        fn = refine_step_region if next(steps) < cfg.region_steps else refine_step
        return fn(dog_flat, p, y, x, active, cfg)

    return refine_loop(step, s0, y0, x0, valid, pad, h, w, cfg, plane_off)


def tile_layout(dog_flat: torch.Tensor, s0, y0, x0, valid, pad: int, cfg,
                plane_off=None) -> RegionLayout:
    """The candidates grouped at K11's geometry."""
    n_dog = cfg.scales_per_octave + 2
    n_planes, hp, wp = dog_flat.shape
    m = TILE_MARGIN
    return group_by_region(s0, y0, x0, valid, pad, hp, wp, n_dog,
                           n_planes // n_dog, plane_off, TILE_R, TILE_C,
                           TILE_R + 2 * m, TILE_C + 2 * m, m, m, TILE_BK)


def _window(dog_flat: torch.Tensor) -> tuple[int, int]:
    hp, wp = dog_flat.shape[-2:]
    return min(TILE_R + 2 * TILE_MARGIN, hp), min(TILE_C + 2 * TILE_MARGIN, wp)


def refine_tile_plain(dog_flat: torch.Tensor, g: RegionLayout, pad: int,
                      h: int, w: int, cfg: SiftConfig,
                      counts: list | None = None) -> torch.Tensor:
    """Plain version of K11: every slot's walk with K3's bookkeeping, its
    cubes read at positions clamped into its block's window interior, and
    the walk stopped and flagged (column 9) when it moves outside that
    interior. -> (T_cap, 16) rows, zero on empty slots. With `counts`, the
    number of walks still going at each step is appended to it (one host
    sync a step)."""
    S, b = cfg.scales_per_octave, cfg.image_border
    lr, lw = _window(dog_flat)
    blk = torch.arange(g.T_cap, device=dog_flat.device) // TILE_BK
    r0, c0, pb = g.r0_b[blk], g.c0_b[blk], g.pb_b[blk]
    s, y, x = g.s_slot, g.y_slot, g.x_slot
    live = g.a_slot.bool()
    conv = torch.zeros_like(live)
    dead = ~live
    esc = torch.zeros_like(live)
    fields = torch.zeros((g.T_cap, 5), dtype=torch.float32,
                         device=dog_flat.device)
    for _ in range(cfg.max_interpolation_steps):
        active = ~(conv | dead | esc)
        if counts is not None:
            counts.append(int(active.sum()))
        out = newton_step(dog_flat, torch.clamp(s, 1, S) + pb,
                          torch.clamp(y - r0, 1, lr - 2) + r0,
                          torch.clamp(x - c0, 1, lw - 2) + c0, active, cfg)
        ok = out[:, 0] > 0
        newly = active & ok
        conv |= newly
        fields = torch.where(newly[:, None], out[:, 4:9], fields)
        mv = active & ~ok
        s = torch.where(mv, s + out[:, 1].int(), s)
        y = torch.where(mv, y + out[:, 2].int(), y)
        x = torch.where(mv, x + out[:, 3].int(), x)
        bad = ((s < 1) | (s > S) | (x - pad < b) | (x - pad >= w - b)
               | (y - pad < b) | (y - pad >= h - b))
        dead |= mv & bad
        esc |= mv & ~bad & ((y - r0 < 1) | (y - r0 > lr - 2)
                            | (x - c0 < 1) | (x - c0 > lw - 2))
    rows = torch.zeros((g.T_cap, ROW_COLS), dtype=torch.float32,
                       device=dog_flat.device)
    rows[:, 0] = conv.float()
    rows[:, 1] = s.float()
    rows[:, 2] = y.float()
    rows[:, 3] = x.float()
    rows[:, 4:9] = fields
    rows[:, 9] = esc.float()
    return torch.where(live[:, None], rows, torch.zeros_like(rows))


def refine_tile_slots(dog_flat: torch.Tensor, g: RegionLayout, pad: int,
                      h: int, w: int, cfg: SiftConfig) -> torch.Tensor:
    """K11 wrapper -> (T_cap, 16) slot rows (column 9: escaped). The plain
    version for a CPU tensor; the CUDA kernel for a CUDA tensor (or an
    error)."""
    _require_f32("refine_tile_slots", dog_flat)
    if dog_flat.device.type == "cpu":
        return refine_tile_plain(dog_flat, g, pad, h, w, cfg)
    slots = [_i32(t) for t in (g.s_slot, g.y_slot, g.x_slot, g.a_slot, g.r0_b,
                               g.c0_b, g.pb_b, g.active_b)]
    build.require_cuda("refine_tile_slots", dog_flat, *slots)
    _, hp, wp = dog_flat.shape
    lr, lw = _window(dog_flat)
    # the kernel writes every slot row, zero on empty slots
    out = torch.empty((g.T_cap, ROW_COLS), dtype=torch.float32,
                      device=dog_flat.device)
    fn = build.bind("refine", "sift_refine_tile",
                    [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
                    + [ctypes.c_int] * 10 + [ctypes.c_float] * 2
                    + [ctypes.c_void_p])
    rc = fn(build.ptr(dog_flat), hp, wp, *(build.ptr(t) for t in slots),
            build.ptr(out), g.nb, TILE_BK, lr, lw, pad, h, w, cfg.image_border,
            cfg.scales_per_octave, cfg.max_interpolation_steps,
            float(cfg.contrast_threshold), float(cfg.edge_threshold),
            build.stream_ptr(dog_flat))
    build.check(rc, "K11 refine_tile")
    build.count_launch("K11")
    return out


def refine_tile(dog_flat: torch.Tensor, s0, y0, x0, valid, pad: int, h: int,
                w: int, cfg: SiftConfig, plane_off=None) -> torch.Tensor:
    """refine_mode="tile" (ops/pallas/refine_tile_kernel.py:refine_tile_tpu):
    group, walk in K11, gather the slot rows back to the candidates, and
    re-refine the escaped walks from their original positions with the K4
    loop. The rows equal the plain `refine`'s."""
    g = tile_layout(dog_flat, s0, y0, x0, valid, pad, cfg, plane_off)
    slots = refine_tile_slots(dog_flat, g, pad, h, w, cfg)
    rows = slots[torch.clamp(g.slot_k.long(), 0, g.T_cap - 1)]
    return merge_escaped(rows, valid, lambda esc: refine_stepwise(
        dog_flat, s0, y0, x0, esc, pad, h, w, cfg, plane_off=plane_off))
