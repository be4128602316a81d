"""The reference's own SIFT parameters and pixel operations, in NumPy.

A frozen copy of what the plain SIFT reference needs, so that it imports
nothing of the program: the parameter set (`SiftParams`, filled from the
`sift` fields of a configuration file), OpenCV's Gaussian taps
(getGaussianKernel: exp in f64, cast f32, normalised in f64), the
BORDER_REFLECT_101 index map, INTER_LINEAR coefficients with edge
clamping, and the exact-1/2 INTER_NEAREST downsample. The blur is an
ascending tap sum of separate f32 multiplies and adds, H pass then V pass.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

F32 = np.float32


@dataclasses.dataclass(frozen=True)
class SiftParams:
    """The OpenCV SIFT constants of one configuration (the names of the
    configuration file's `sift` object; fields the reference does not read
    are ignored)."""

    scales_per_octave: int = 3
    sigma_in: float = 0.5
    sigma_min: float = 0.8
    inv_delta_min: int = 2
    delta_min: float = 0.5
    contrast_threshold: float = 0.04
    edge_threshold: float = 10.0
    image_border: int = 5
    max_interpolation_steps: int = 5
    n_orientation_bins: int = 36
    lambda_ori: float = 1.5
    orientation_localmax_ratio: float = 0.8
    lambda_descr: float = 3.0
    descriptor_n_histograms: int = 4
    descriptor_n_bins: int = 8
    descriptor_magnitude_cap: float = 0.2
    descriptor_l2_norm: float = 512.0

    @classmethod
    def from_dict(cls, d: dict) -> "SiftParams":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @property
    def descriptor_size(self) -> int:
        return self.descriptor_n_histograms ** 2 * self.descriptor_n_bins

    @property
    def seed_sigma(self) -> float:
        return math.sqrt(self.sigma_min ** 2 - self.sigma_in ** 2) * self.inv_delta_min

    def octave_sigmas(self) -> list[float]:
        """Incremental blur sigmas within an octave, m.powi(s - 1) by
        square-and-multiply as LLVM's powi computes it; index 0 unused."""

        def powi(x: float, n: int) -> float:
            if n < 0:
                return 1.0 / powi(x, -n)
            r, b = 1.0, x
            while n:
                if n & 1:
                    r = r * b
                b = b * b
                n >>= 1
            return r

        m = 2.0 ** (2.0 / self.scales_per_octave)
        out = []
        for s in range(self.scales_per_octave + 3):
            a = powi(m, s - 1)
            out.append(math.sqrt(a * m - a) * self.sigma_min * self.inv_delta_min)
        return out

    def n_octaves(self, height: int, width: int) -> int:
        """Octaves of a seed image of (height, width): f32 log2 and
        round-half-away."""
        min_axis = np.float32(min(width, height))
        v = np.float32(np.log2(min_axis)) - np.float32(2.0)
        return int(np.floor(v + np.float32(0.5))) + 1


def cv_ksize(sigma: float) -> int:
    """OpenCV's auto kernel size for float images: cvRound(8 sigma + 1) | 1."""
    return int(np.rint(sigma * 4 * 2 + 1)) | 1


def gaussian_kernel(sigma: float, ksize: int | None = None) -> np.ndarray:
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


def linear_coeffs(src: int, dst: int):
    """INTER_LINEAR source indices and f32 weights, clamped at the edges."""
    scale = src / dst
    fx = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    fx[sx < 0] = 0.0
    sx[sx < 0] = 0
    fx[sx >= src - 1] = 1.0
    sx[sx >= src - 1] = src - 2
    return sx, fx.astype(np.float32)


class NumpyProcessing:
    """Blur and resizes with OpenCV's semantics (the reference crate's
    `Processing` seam)."""

    @staticmethod
    def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
        kern = gaussian_kernel(sigma)
        k = len(kern)
        r = k // 2

        def pass_along(x, axis):
            n = x.shape[axis]
            xp = np.take(x, reflect101_indices(n, r), axis=axis)
            out = None
            for i in range(k):
                sl = [slice(None)] * x.ndim
                sl[axis] = slice(i, i + n)
                term = F32(kern[i]) * xp[tuple(sl)]
                out = term if out is None else out + term
            return out

        out = pass_along(img.astype(F32), img.ndim - 1)
        return pass_along(out, img.ndim - 2)

    @staticmethod
    def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
        h, w = img.shape
        sx, fx = linear_coeffs(w, width)
        sy, fy = linear_coeffs(h, height)
        img = img.astype(F32)
        hor = img[:, sx] * (1 - fx) + img[:, sx + 1] * fx
        out = hor[sy, :] * (1 - fy)[:, None] + hor[sy + 1, :] * fy[:, None]
        return out.astype(F32)

    @staticmethod
    def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
        h, w = img.shape
        sx = np.minimum(np.floor(np.arange(width) * (w / width)), w - 1).astype(np.int64)
        sy = np.minimum(np.floor(np.arange(height) * (h / height)), h - 1).astype(np.int64)
        return img[sy[:, None], sx[None, :]]
