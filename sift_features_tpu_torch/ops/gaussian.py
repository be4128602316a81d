"""OpenCV-semantics Gaussian blur in plain PyTorch.

Counterpart of sift_features_tpu/ops/gaussian.py: auto kernel size
cvRound(8*sigma+1)|1, taps from getGaussianKernel (f64, cast f32,
normalised in f64), BORDER_REFLECT_101. The blur is an ascending tap sum
of separate f32 multiplies and adds (not a convolution call), H pass then
V pass, so results are bit-equal to the JAX package's XLA path. Only the
tiny top octaves and the seed image use this; the octave chain on the main
path runs in the K1 kernel (ops/kernels/pyramid.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .util import f32


def cv_ksize(sigma: float) -> int:
    """OpenCV's auto kernel size for float images: cvRound(sigma*8+1) | 1
    (cvRound rounds half to even)."""
    return int(np.rint(sigma * 4 * 2 + 1)) | 1


def gaussian_kernel(sigma: float, ksize: int | None = None) -> np.ndarray:
    """getGaussianKernel(ksize, sigma, CV_32F): exp in f64, cast f32, sum
    of the f32 values in f64, normalise in f64, cast f32."""
    if ksize is None:
        ksize = cv_ksize(sigma)
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * xs * xs)
    cf = t.astype(np.float32)
    s = 1.0 / np.sum(cf.astype(np.float64))
    return (cf.astype(np.float64) * s).astype(np.float32)


def reflect101_indices(n: int, r: int) -> np.ndarray:
    """Index map of length n + 2r for BORDER_REFLECT_101 (iterated when
    r >= n)."""
    idx = np.arange(-r, n + r)
    if n == 1:
        return np.zeros(n + 2 * r, np.int64)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - idx, idx)


@functools.lru_cache(maxsize=None)
def _reflect101_index(n: int, r: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(reflect101_indices(n, r), device=device)


def reflect101_pad(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Reflect-101 pad of x by r along dim (iterated reflection included)."""
    if r == 0:
        return x
    idx = _reflect101_index(x.shape[dim], r, x.device)
    return torch.index_select(x, dim, idx)


def tap_sum(xp: torch.Tensor, taps: np.ndarray, n: int, dim: int) -> torch.Tensor:
    """out[i] = sum_j taps[j] * xp[i + j] along dim, j ascending, one f32
    multiply and one f32 add per tap (the order every blur of the port
    keeps, kernels included)."""
    out = None
    for j, t in enumerate(taps):
        term = xp.narrow(dim, j, n) * f32(t, xp)
        out = term if out is None else out + term
    return out


def blur_1d(x: torch.Tensor, kernel: np.ndarray, dim: int) -> torch.Tensor:
    """Separable blur pass along dim with the reflect-101 border."""
    r = len(kernel) // 2
    return tap_sum(reflect101_pad(x, r, dim), kernel, x.shape[dim], dim)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur of (..., H, W) f32: horizontal pass, then vertical."""
    kern = gaussian_kernel(sigma)
    out = blur_1d(img, kern, img.dim() - 1)
    return blur_1d(out, kern, img.dim() - 2)
