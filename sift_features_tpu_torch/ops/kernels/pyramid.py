"""K1: whole-octave Gaussian blur chain + DoG over the padded plane.

Replaces sift_features_tpu/ops/pallas/pyramid_kernel.py:build_octave_fused
(`_octave_kernel`). The CUDA kernel is csrc/pyramid.cu; its note gives the
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


def octave_fused_plain(base: torch.Tensor, cfg: SiftConfig):
    """Plain version of K1: base (B, Hp, Wp) f32 -> (gauss (B, S, Hp, Wp) =
    levels 1..S, dog (B, S+2, Hp, Wp)). Same ascending tap sums and the same
    zero-outside-the-plane edge rule as the kernel, so the two are
    bit-equal."""
    _, hp, wp = base.shape
    gauss, dog = [], []
    cur = base
    for lv, taps in enumerate(octave_taps(cfg)):
        r = len(taps) // 2
        hsum = tap_sum(F.pad(cur, (r, r)), taps, wp, 2)
        nxt = tap_sum(F.pad(hsum, (0, 0, r, r)), taps, hp, 1)
        dog.append(nxt - cur)
        if lv < cfg.scales_per_octave:
            gauss.append(nxt)
        cur = nxt
    return torch.stack(gauss, 1), torch.stack(dog, 1)


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
