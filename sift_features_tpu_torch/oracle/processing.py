"""NumPy twin of the port's pixel ops.

The port's own copy of sift_features_tpu/oracle/processing.py.
NumpyProcessing has the semantics of ops/gaussian.py and ops/resize.py
(same tap order, same index and weight tables), so the oracle's scale
space is bit-equal to the port's plain one. This mirrors the reference's
`Processing` trait seam (lib.rs:86-90): CvProcessing (oracle.py) is the
cross-library oracle, NumpyProcessing the in-framework reference
semantics."""

from __future__ import annotations

import numpy as np

from ..ops.gaussian import gaussian_kernel, reflect101_indices

F32 = np.float32


class NumpyProcessing:
    @staticmethod
    def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
        kern = gaussian_kernel(sigma)
        k = len(kern)
        r = k // 2

        def pass_along(x, axis):
            n = x.shape[axis]
            idx = reflect101_indices(n, r)
            xp = np.take(x, idx, axis=axis)
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
        from ..ops.resize import _linear_coeffs

        h, w = img.shape
        sx, fx = _linear_coeffs(w, width)
        sy, fy = _linear_coeffs(h, height)
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


class ImageprocProcessing:
    """Best-effort twin of the reference's PRODUCTION backend
    (`ImageprocProcessing`, lib.rs:992-1007): imageproc
    `gaussian_blur_f32` + `image::imageops::resize` Triangle / Nearest.

    Provenance caveat: the imageproc/image crate sources are not available
    in this environment (zero egress; the reference only *depends* on
    them), so these semantics come from the crates' documented behavior
    (imageproc 0.25 / image 0.25) and cannot be byte-verified here:

    - gaussian_blur_f32: separable f32 Gaussian, kernel half-width
      ceil(2*sigma), REPLICATE border (coordinate clamp) — unlike OpenCV's
      ksize rule + reflect-101 used by the golden path.
    - resize Triangle: linear resampling with pixel-center mapping
      src = (dst + 0.5) * ratio - 0.5 and edge clamp.
    - resize Nearest: src = floor(dst * ratio) with clamp.

    The golden snapshots were produced with the OpenCV backend
    (lib.rs:1019), so this twin is NOT used for parity tests — it exists
    so the reference's default-path numerics have an analog (SURVEY C19).
    """

    @staticmethod
    def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
        r = int(np.ceil(2.0 * float(sigma)))
        xs = np.arange(-r, r + 1, dtype=np.float64)
        kern = np.exp(-(xs * xs) / (2.0 * float(sigma) ** 2))
        kern = (kern / kern.sum()).astype(F32)
        k = len(kern)

        def pass_along(x, axis):
            n = x.shape[axis]
            idx = np.clip(np.arange(-r, n + r), 0, n - 1)  # replicate border
            xp = np.take(x, idx, axis=axis)
            out = None
            for i in range(k):
                sl = [slice(None)] * x.ndim
                sl[axis] = slice(i, i + n)
                term = kern[i] * xp[tuple(sl)]
                out = term if out is None else out + term
            return out

        out = pass_along(img.astype(F32), img.ndim - 1)
        return pass_along(out, img.ndim - 2)

    @staticmethod
    def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
        h, w = img.shape

        def coeffs(n_src, n_dst):
            src = (np.arange(n_dst, dtype=np.float64) + 0.5) * (n_src / n_dst) - 0.5
            lo = np.floor(src).astype(np.int64)
            f = (src - lo).astype(F32)
            lo0 = np.clip(lo, 0, n_src - 1)
            lo1 = np.clip(lo + 1, 0, n_src - 1)
            return lo0, lo1, f

        x0, x1, fx = coeffs(w, width)
        y0, y1, fy = coeffs(h, height)
        img = img.astype(F32)
        hor = img[:, x0] * (1 - fx) + img[:, x1] * fx
        return (hor[y0, :] * (1 - fy)[:, None]
                + hor[y1, :] * fy[:, None]).astype(F32)

    @staticmethod
    def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
        h, w = img.shape
        sx = np.minimum(np.floor(np.arange(width) * (w / width)), w - 1).astype(np.int64)
        sy = np.minimum(np.floor(np.arange(height) * (h / height)), h - 1).astype(np.int64)
        return img[sy[:, None], sx[None, :]]
