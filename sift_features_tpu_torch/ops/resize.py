"""OpenCV-semantics resizes in plain PyTorch (counterpart of
sift_features_tpu/ops/resize.py): INTER_LINEAR with edge clamping for the
2x seed upsample, and the exact-1/2 INTER_NEAREST downsample."""

from __future__ import annotations

import functools

import numpy as np
import torch

from .util import f32


@functools.lru_cache(maxsize=None)
def _linear_coeffs_on(src: int, dst: int, device: torch.device):
    sx, fx = _linear_coeffs(src, dst)
    return torch.as_tensor(sx, device=device), torch.as_tensor(fx, device=device)


def _linear_coeffs(src: int, dst: int):
    scale = src / dst
    fx = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    fx[sx < 0] = 0.0
    sx[sx < 0] = 0
    fx[sx >= src - 1] = 1.0
    sx[sx >= src - 1] = src - 2
    return sx, fx.astype(np.float32)


def resize_linear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of (..., H, W) f32: horizontal pass, then vertical,
    f32 weights (cv INTER_LINEAR)."""
    h, w = img.shape[-2], img.shape[-1]
    sx, fx = _linear_coeffs_on(w, out_w, img.device)
    sy, fy = _linear_coeffs_on(h, out_h, img.device)
    one = f32(1.0, img)
    hor = img[..., sx] * (one - fx) + img[..., sx + 1] * fx
    return (hor[..., sy, :] * (one - fy)[:, None]
            + hor[..., sy + 1, :] * fy[:, None])


def resize_nearest_half(img: torch.Tensor) -> torch.Tensor:
    """Exact-1/2 INTER_NEAREST downsample == stride-2 slice (lib.rs:247)."""
    h, w = img.shape[-2], img.shape[-1]
    return img[..., : (h // 2) * 2: 2, : (w // 2) * 2: 2]
