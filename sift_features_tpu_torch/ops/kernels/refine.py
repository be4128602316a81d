"""K3 and K4: Newton refinement of DoG extrema.

K3 (`refine_walk`) replaces sift_features_tpu/ops/pallas/refine_walk_kernel.py:
refine_walk_tpu (`_kernel`): the whole <= max_interpolation_steps loop in
one launch. K4 (`refine_step`) replaces ops/pallas/refine_kernel.py:
refine_step_pallas (`_kernel`): one masked step, which `refine_stepwise`
drives step by step (refine_mode="step"). Both CUDA entries live in
csrc/refine.cu and share one __device__ Newton function; its note gives the
bound (latency of ~27 scattered reads per candidate step) and why the port's
K3 never escapes to K4.

Rows are (K, 16) f32 in the layout of ops/extrema.py (ROW_COLS).
"""

from __future__ import annotations

import ctypes

import torch

from ...config import SiftConfig
from ..extrema import ROW_COLS, newton_step, refine, refine_loop
from . import build


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def refine_step(dog_flat: torch.Tensor, p, y, x, active,
                cfg: SiftConfig) -> torch.Tensor:
    """K4 wrapper: one masked Newton step at plane p / row y / column x of
    dog_flat (P, Hp, Wp). The plain version (ops/extrema.py:newton_step) for
    a CPU tensor; the CUDA kernel for a CUDA tensor (or an error)."""
    if dog_flat.device.type == "cpu":
        return newton_step(dog_flat, p, y, x, active, cfg)
    p, y, x, active = _i32(p), _i32(y), _i32(x), _i32(active)
    build.require_cuda("refine_step", dog_flat, p, y, x, active)
    n_planes, hp, wp = dog_flat.shape
    k = p.shape[0]
    out = torch.empty((k, ROW_COLS), dtype=torch.float32, device=dog_flat.device)
    fn = build.bind("refine", "sift_refine_step",
                    [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
                    + [ctypes.c_int] + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    rc = fn(build.ptr(dog_flat), n_planes, hp, wp, build.ptr(p), build.ptr(y),
            build.ptr(x), build.ptr(active), build.ptr(out), k,
            float(cfg.contrast_threshold), float(cfg.edge_threshold),
            float(cfg.scales_per_octave), build.stream_ptr(dog_flat))
    build.check(rc, "K4 refine_step")
    build.count_launch("K4")
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
    is the per-candidate DoG plane offset (frame * planes)."""
    if dog_flat.device.type == "cpu":
        return refine(dog_flat, s0, y0, x0, valid, pad, h, w, cfg, plane_off)
    k = s0.shape[0]
    if plane_off is None:
        plane_off = torch.zeros(k, dtype=torch.int32, device=dog_flat.device)
    s0, y0, x0, valid, plane_off = (_i32(s0), _i32(y0), _i32(x0), _i32(valid),
                                    _i32(plane_off))
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
