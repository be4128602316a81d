"""Image loading / grayscale conversion.

The port's own copy of sift_features_tpu/io/image.py. The reference's
golden fixtures were produced from JPEGs decoded by the Rust `image` crate
0.25 (zune-jpeg) and converted to luma with BT.709 coefficients
(`DynamicImage::grayscale()`), whereas OpenCV decodes with libjpeg-turbo and
converts with BT.601. The decoder + luma choice is therefore part of the
golden contract; `load_gray` exposes the variants so parity tests can select
the one matching each oracle. cv2 is imported only by the methods that use
it.
"""

from __future__ import annotations

import numpy as np


def _decode_rgb(path: str) -> np.ndarray:
    """Decode to RGB uint8 (H,W,3) using libjpeg-turbo (via OpenCV)."""
    import cv2

    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    if bgr is None:
        raise FileNotFoundError(path)
    return bgr[:, :, ::-1].copy()


def rgb_to_luma709_int(rgb: np.ndarray) -> np.ndarray:
    """Integer BT.709 luma with round-half-up, as used by the Rust `image`
    crate (color.rs: SRGB_LUMA = [2126, 7152, 722] / 10000)."""
    r = rgb[..., 0].astype(np.uint32)
    g = rgb[..., 1].astype(np.uint32)
    b = rgb[..., 2].astype(np.uint32)
    l = 2126 * r + 7152 * g + 722 * b
    return ((l + 5000) // 10000).astype(np.uint8)


def rgb_to_luma709_trunc(rgb: np.ndarray) -> np.ndarray:
    """Integer BT.709 luma, truncating variant."""
    r = rgb[..., 0].astype(np.uint32)
    g = rgb[..., 1].astype(np.uint32)
    b = rgb[..., 2].astype(np.uint32)
    return ((2126 * r + 7152 * g + 722 * b) // 10000).astype(np.uint8)


def rgb_to_luma709_f32(rgb: np.ndarray) -> np.ndarray:
    """Float BT.709 luma with rust-style rounding."""
    l = (
        np.float32(0.2126) * rgb[..., 0].astype(np.float32)
        + np.float32(0.7152) * rgb[..., 1].astype(np.float32)
        + np.float32(0.0722) * rgb[..., 2].astype(np.float32)
    )
    return np.clip(np.floor(l + 0.5), 0, 255).astype(np.uint8)


def load_gray(path: str, method: str = "cv2") -> np.ndarray:
    """Load an image as (H,W) uint8 grayscale.

    methods:
      cv2              — cv2.imread(..., IMREAD_GRAYSCALE): BT.601 fixed point
      image-crate      — libjpeg decode + BT.709 integer luma (truncating),
                         the closest approximation of Rust image 0.25's
                         grayscale() (exact equality is unattainable because
                         the crate decodes with zune-jpeg, not libjpeg)
      image-crate-round / image-crate-f32 — alternative luma roundings
      golden           — the native decoder: libjpeg float DCT + fancy
                         chroma upsampling + BT.709 truncating luma, the
                         JAX package's pinned golden-test variant
    """
    if method == "cv2":
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
        return img
    if method == "golden":
        from .native_loader import decode_gray

        return decode_gray(path, luma="bt709", dct="float",
                           fancy_upsampling=True)
    rgb = _decode_rgb(path)
    if method == "image-crate":
        return rgb_to_luma709_trunc(rgb)
    if method == "image-crate-round":
        return rgb_to_luma709_int(rgb)
    if method == "image-crate-f32":
        return rgb_to_luma709_f32(rgb)
    raise ValueError(f"unknown method {method!r}")


def to_f32(img_u8: np.ndarray) -> np.ndarray:
    """u8 -> f32 in [0,1]: v / 255.0 in f32, matching the `image` crate's
    Luma<u8> -> Luma<f32> conversion used at lib.rs:198."""
    return img_u8.astype(np.float32) / np.float32(255.0)
