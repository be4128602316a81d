"""K2: 3x3x3 DoG extremum test packed into int32 words.

Replaces sift_features_tpu/ops/pallas/extrema_kernel.py:extrema_words_batched
(`_kernel`). The CUDA kernel is csrc/extrema.cu; its note gives the bound
(memory: one read of the DoG stack) and the design (one thread per pixel, a
warp ballot per 32 columns).
"""

from __future__ import annotations

import ctypes

import torch

from ...config import SiftConfig
from ..extrema import extrema_mask
from . import build


def pack_words(mask: torch.Tensor) -> torch.Tensor:
    """(..., W) bool, W % 32 == 0 -> (..., W // 32) int32 with bit j of word
    w = element 32w + j (bit 31 is the sign bit)."""
    bits = mask.reshape(*mask.shape[:-1], -1, 32).to(torch.int64)
    shifts = torch.arange(32, device=mask.device, dtype=torch.int64)
    v = (bits << shifts).sum(-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def extrema_words_plain(dog: torch.Tensor, bounds, cfg: SiftConfig):
    """Plain version of K2: dog (B, S+2, Hp, Wp) f32 -> (B, S, Hp, Wp // 32)
    int32, the extremum mask inside bounds = (y0, y1, x0, x1)."""
    return pack_words(extrema_mask(dog, cfg, bounds=bounds))


def extrema_words(dog: torch.Tensor, bounds, cfg: SiftConfig):
    """K2 wrapper: the plain version for a CPU tensor; the CUDA kernel for a
    CUDA tensor (or an error)."""
    if dog.device.type == "cpu":
        return extrema_words_plain(dog, bounds, cfg)
    build.require_cuda("extrema_words", dog)
    b, n_p, hp, wp = dog.shape
    n_s = cfg.scales_per_octave
    if dog.dtype != torch.float32 or n_p != n_s + 2 or wp % 128:
        raise ValueError("extrema_words: dog must be (B, S+2, Hp, Wp) float32 "
                         "with Wp % 128 == 0")
    words = torch.empty((b, n_s, hp, wp // 32), dtype=torch.int32,
                        device=dog.device)
    fn = build.bind("extrema", "sift_extrema_words",
                    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                    + [ctypes.c_void_p])
    y0, y1, x0, x1 = (int(v) for v in bounds)
    rc = fn(build.ptr(dog), build.ptr(words), b, n_s, hp, wp, y0, y1, x0, x1,
            build.stream_ptr(dog))
    build.check(rc, "K2 extrema_words")
    build.count_launch("K2")
    return words
