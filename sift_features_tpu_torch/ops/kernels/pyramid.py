"""K1: whole-octave Gaussian blur chain + DoG over the padded plane; K9: one
level of that chain per launch.

K1 (`octave_fused`, a frame batch) replaces
sift_features_tpu/ops/pallas/pyramid_kernel.py:build_octave_fused
(`_octave_kernel`). K9 (`octave_level`, driven by `build_octave_padded`)
replaces pyramid_kernel.py:_call_level as build_octave_padded drives it on
the per-frame path (f32 storage only; the bf16, split and gather16 modes are
not ported). The CUDA kernels is csrc/pyramid.cu; its note gives the
bound on the H100 (memory: ~1.36 GB must move at octave 0 of a 1080p B=4
batch) and what this first design moves instead.

The chain runs over the padded plane of the octave base, as the TPU kernel
does: level k+1 blurs all of level k, pad ring included, and
DoG_k = L_{k+1} - L_k. Edge rule of the port: a tap that falls outside the
padded plane reads 0. The TPU kernel's strip-roll wrap poisons the outer
ring instead; both agree everywhere within PAD_DESC - (sum of tap radii)
of the image, which covers every pixel a consumer reads (the image
interior), so comparisons with the JAX kernel run on [P:P+h, P:P+w].
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ...config import SiftConfig
from ..gaussian import cv_ksize, gaussian_kernel, reflect101_pad, tap_sum
from . import build

MAX_TAPS = 64   # csrc/pyramid.cu


def reflect_pad_image(img: torch.Tensor, pad: int, extra_right: int,
                      extra_bottom: int = 0) -> torch.Tensor:
    """Reflect-101-extend (..., H, W) by `pad` on every side, then zero-fill
    `extra_bottom` rows and `extra_right` columns (pyramid_kernel.py:443)."""
    out = reflect101_pad(img, pad, img.dim() - 2)
    out = reflect101_pad(out, pad, img.dim() - 1)
    if extra_right or extra_bottom:
        out = F.pad(out, (0, extra_right, 0, extra_bottom))
    return out


def octave_taps(cfg: SiftConfig) -> list[np.ndarray]:
    """f32 Gaussian taps of levels 1..S+2 of an octave."""
    return [gaussian_kernel(s, cv_ksize(s)) for s in cfg.octave_sigmas()[1:]]


def level_plain(prev: torch.Tensor, taps: np.ndarray):
    """One level of the chain over (..., Hp, Wp): (next level, its DoG
    next - prev). Ascending tap sums, a tap outside the plane reads 0."""
    hp, wp = prev.shape[-2], prev.shape[-1]
    r = len(taps) // 2
    hsum = tap_sum(F.pad(prev, (r, r)), taps, wp, prev.dim() - 1)
    nxt = tap_sum(F.pad(hsum, (0, 0, r, r)), taps, hp, prev.dim() - 2)
    return nxt, nxt - prev


def octave_fused_plain(base: torch.Tensor, cfg: SiftConfig):
    """Plain version of K1: base (B, Hp, Wp) f32 -> (gauss (B, S, Hp, Wp) =
    levels 1..S, dog (B, S+2, Hp, Wp)). Same ascending tap sums and the same
    zero-outside-the-plane edge rule as the kernel, so the two are
    bit-equal."""
    gauss, dog = [], []
    cur = base
    for lv, taps in enumerate(octave_taps(cfg)):
        cur, d = level_plain(cur, taps)
        dog.append(d)
        if lv < cfg.scales_per_octave:
            gauss.append(cur)
    return torch.stack(gauss, 1), torch.stack(dog, 1)


def build_octave_padded_plain(base: torch.Tensor, cfg: SiftConfig):
    """Plain version of a K9 chain: base (Hp, Wp) -> (gauss slots (S+2, Hp,
    Wp) = levels 1..S+2, dog (S+2, Hp, Wp))."""
    gauss, dog = [], []
    cur = base
    for taps in octave_taps(cfg):
        cur, d = level_plain(cur, taps)
        gauss.append(cur)
        dog.append(d)
    return torch.stack(gauss), torch.stack(dog)


def octave_fused(base: torch.Tensor, cfg: SiftConfig):
    """K1 wrapper: the plain version for a CPU tensor; the CUDA kernel for a
    CUDA tensor (or an error)."""
    if base.device.type == "cpu":
        return octave_fused_plain(base, cfg)
    build.require_cuda("octave_fused", base)
    if base.dtype != torch.float32 or base.dim() != 3:
        raise ValueError("octave_fused: base must be (B, Hp, Wp) float32")
    b, hp, wp = base.shape
    taps = octave_taps(cfg)
    n_levels, n_keep = len(taps), cfg.scales_per_octave
    if max(len(t) for t in taps) > MAX_TAPS:
        raise ValueError(f"octave_fused: more than {MAX_TAPS} taps")
    taps_arr = (ctypes.c_float * (n_levels * MAX_TAPS))()
    ksizes = (ctypes.c_int * n_levels)()
    for lv, t in enumerate(taps):
        ksizes[lv] = len(t)
        for j, v in enumerate(t):
            taps_arr[lv * MAX_TAPS + j] = float(v)
    kw = dict(dtype=torch.float32, device=base.device)
    gauss = torch.empty((b, n_keep, hp, wp), **kw)
    extra = torch.empty((b, n_levels - n_keep, hp, wp), **kw)
    dog = torch.empty((b, n_levels, hp, wp), **kw)
    tmp = torch.empty((b, hp, wp), **kw)
    fn = build.bind("pyramid", "sift_octave_fused",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                    + [ctypes.c_void_p] * 3)
    rc = fn(build.ptr(base), build.ptr(gauss), build.ptr(extra),
            build.ptr(dog), build.ptr(tmp), b, hp, wp, n_keep, n_levels,
            ctypes.cast(taps_arr, ctypes.c_void_p),
            ctypes.cast(ksizes, ctypes.c_void_p), build.stream_ptr(base))
    build.check(rc, "K1 octave_fused")
    build.count_launch("K1")
    return gauss, dog


def octave_level(src: torch.Tensor, gauss: torch.Tensor, dog: torch.Tensor,
                 k: int, taps: np.ndarray) -> None:
    """K9 wrapper: one blur level. src (Hp, Wp) is the octave base or
    gauss[k - 1]; writes gauss[k] (level k + 1) and dog[k] = gauss[k] - src
    in place. The plain version for a CPU tensor; the CUDA kernel for a
    CUDA tensor (or an error)."""
    if src.device.type == "cpu":
        gauss[k], dog[k] = level_plain(src, taps)
        return
    build.require_cuda("octave_level", src, gauss, dog)
    if src.dtype != torch.float32 or src.dim() != 2:
        raise ValueError("octave_level: src must be (Hp, Wp) float32")
    if len(taps) > MAX_TAPS:
        raise ValueError(f"octave_level: more than {MAX_TAPS} taps")
    hp, wp = src.shape
    taps_arr = (ctypes.c_float * len(taps))(*(float(v) for v in taps))
    tmp = torch.empty((hp, wp), dtype=torch.float32, device=src.device)
    fn = build.bind("pyramid", "sift_octave_level",
                    [ctypes.c_void_p, ctypes.c_longlong] * 3
                    + [ctypes.c_void_p] + [ctypes.c_int] * 3
                    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    plane = hp * wp
    rc = fn(build.ptr(src), plane, build.ptr(gauss[k]), plane, build.ptr(dog[k]),
            plane, build.ptr(tmp), 1, hp, wp,
            ctypes.cast(taps_arr, ctypes.c_void_p), len(taps),
            build.stream_ptr(src))
    build.check(rc, "K9 octave_level")
    build.count_launch("K9")


def build_octave_padded(base: torch.Tensor, cfg: SiftConfig):
    """The per-frame octave (pyramid_kernel.py:build_octave_padded): base
    (Hp, Wp) f32, reflect-padded -> (gauss slots (S+2, Hp, Wp) = levels
    1..S+2, dog (S+2, Hp, Wp), dog[k] = level k+1 - level k), one K9 launch
    per level."""
    taps = octave_taps(cfg)
    gauss = torch.empty((len(taps), *base.shape), dtype=torch.float32,
                        device=base.device)
    dog = torch.empty_like(gauss)
    for k, t in enumerate(taps):
        octave_level(base if k == 0 else gauss[k - 1], gauss, dog, k, t)
    return gauss, dog
