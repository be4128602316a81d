"""K2 and K2′: 3x3x3 DoG extremum test packed into int32 words.

K2 (`extrema_words`, a frame batch) replaces
sift_features_tpu/ops/pallas/extrema_kernel.py:extrema_words_batched and K2′
(`extrema_words_single`, one frame) replaces extrema_kernel.py:extrema_words;
both are one `_kernel` on the TPU. The CUDA kernel is csrc/extrema.cu; its
note gives the bound (bytes: one read of the DoG stack) and the design (a
warp per 128 columns, 256 in bf16, walks a strip of rows, reading each DoG
value once and keeping each scale's running 3x3x3 max and min in
registers). The DoG may be f32 or bf16 (storage_dtype "bfloat16"; launches
count as `K2:bf16`), compared in bf16 there, which orders values as their
exact f32 widening does.
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
    """Plain version of K2: dog (B, S+2, Hp, Wp) f32 or bf16 (widened to f32
    first) -> (B, S, Hp, Wp // 32) int32, the extremum mask inside bounds =
    (y0, y1, x0, x1)."""
    return pack_words(extrema_mask(dog.float(), cfg, bounds=bounds))


def _launch(dog: torch.Tensor, bounds, cfg: SiftConfig, name: str):
    build.require_cuda(name, dog)
    b, n_p, hp, wp = dog.shape
    n_s = cfg.scales_per_octave
    dog_t = build.dtype_code(name, dog)
    if n_p != n_s + 2 or wp % 128:
        raise ValueError(f"{name}: dog must be (S+2, Hp, Wp) per frame "
                         "with Wp % 128 == 0")
    words = torch.empty((b, n_s, hp, wp // 32), dtype=torch.int32,
                        device=dog.device)
    fn = build.bind("extrema", "sift_extrema_words",
                    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                    + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    y0, y1, x0, x1 = (int(v) for v in bounds)
    rc = fn(build.ptr(dog), dog_t, build.ptr(words), b, n_s, hp, wp, y0, y1,
            x0, x1, build.stream_ptr(dog))
    return words, rc


def extrema_words(dog: torch.Tensor, bounds, cfg: SiftConfig):
    """K2 wrapper: dog (B, S+2, Hp, Wp). The plain version for a CPU tensor;
    the CUDA kernel for a CUDA tensor (or an error)."""
    if dog.device.type == "cpu":
        return extrema_words_plain(dog, bounds, cfg)
    words, rc = _launch(dog, bounds, cfg, "extrema_words")
    name = build.form("K2", dog)
    build.check(rc, f"{name} extrema_words")
    build.count_launch(name)
    return words


def extrema_words_single(dog: torch.Tensor, bounds, cfg: SiftConfig):
    """K2′ wrapper: one frame's dog (S+2, Hp, Wp) -> (S, Hp, Wp // 32)
    int32, served by the K2 kernel as a batch of one. The plain version for
    a CPU tensor; the CUDA kernel for a CUDA tensor (or an error)."""
    if dog.device.type == "cpu":
        return extrema_words_plain(dog[None], bounds, cfg)[0]
    words, rc = _launch(dog[None], bounds, cfg, "extrema_words_single")
    name = build.form("K2′", dog)
    build.check(rc, f"{name} extrema_words_single")
    build.count_launch(name)
    return words[0]
