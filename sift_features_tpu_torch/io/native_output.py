"""ctypes binding for the native (C++) output tier, native/sift_output.cpp.

Multi-threaded compaction of padded result arrays, match rendering (the
reference's draw_matches output, examples/sift-match.rs:21-39, without
OpenCV), and libjpeg encode. The library is built on first use
(io/native_build.py); a failed build raises NativeOutputUnavailable with
g++'s output, and no NumPy or cv2 path takes over.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .native_build import NATIVE_DIR, build

SOURCE = os.path.join(NATIVE_DIR, "sift_output.cpp")

_lib = None
_lib_lock = threading.Lock()


class NativeOutputUnavailable(RuntimeError):
    pass


def _get_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build(SOURCE, NativeOutputUnavailable))
            vp, ip = ctypes.c_void_p, ctypes.c_int
            lib.so_compact.restype = ip
            lib.so_compact.argtypes = [vp, vp, vp, ip, ip, ip, vp, vp, vp, ip]
            lib.so_render_matches.restype = ip
            lib.so_render_matches.argtypes = [
                vp, ip, ip, vp, ip, ip, vp, ip, vp, ip, vp, ip, vp]
            lib.so_encode_jpeg.restype = ip
            lib.so_encode_jpeg.argtypes = [vp, ip, ip, ip, ip,
                                           ctypes.c_char_p]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def compact_batch(kps, desc, valid, n_threads: int = 4):
    """Padded (B, K, 5) f32 + (B, K, D) u8 + (B, K) mask -> per-frame
    (kps_i, desc_i) pairs (copies; order preserved). The multi-threaded
    native analog of `kps[i][valid[i]]` per frame."""
    lib = _get_lib()
    kps = np.ascontiguousarray(kps, np.float32)
    desc = np.ascontiguousarray(desc, np.uint8)
    v = np.ascontiguousarray(valid, np.uint8)
    b, k = v.shape
    d = desc.shape[-1]
    out_kps = np.empty_like(kps)
    out_desc = np.empty_like(desc)
    counts = np.zeros(b, np.int32)
    rc = lib.so_compact(_ptr(kps), _ptr(desc), _ptr(v), b, k, d,
                        _ptr(out_kps), _ptr(out_desc), _ptr(counts),
                        n_threads)
    if rc != 0:
        raise RuntimeError(f"so_compact failed ({rc})")
    return [(out_kps[f, :counts[f]].copy(), out_desc[f, :counts[f]].copy())
            for f in range(b)]


def render_matches(img1, kps1, img2, kps2, pairs) -> np.ndarray:
    """Side-by-side match render (img1 left, img2 right): keypoint circles
    + colored match lines, matched keypoints only (the reference example's
    draw_matches flags=NOT_DRAW_SINGLE_POINTS look). Returns (H, W, 3) u8."""
    lib = _get_lib()
    img1 = np.ascontiguousarray(img1, np.uint8)
    img2 = np.ascontiguousarray(img2, np.uint8)
    if img1.ndim != 2 or img2.ndim != 2:
        raise ValueError("render_matches takes grayscale (H, W) images")
    kps1 = np.ascontiguousarray(kps1, np.float32).reshape(-1, 5)
    kps2 = np.ascontiguousarray(kps2, np.float32).reshape(-1, 5)
    pairs = np.ascontiguousarray(pairs, np.int32).reshape(-1, 2)
    h = max(img1.shape[0], img2.shape[0])
    w = img1.shape[1] + img2.shape[1]
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.so_render_matches(
        _ptr(img1), img1.shape[0], img1.shape[1],
        _ptr(img2), img2.shape[0], img2.shape[1],
        _ptr(kps1), len(kps1), _ptr(kps2), len(kps2),
        _ptr(pairs), len(pairs), _ptr(out))
    if rc != 0:
        raise RuntimeError(f"so_render_matches failed ({rc}): "
                           "match index out of range")
    return out


def write_jpeg(path: str, img: np.ndarray, quality: int = 92) -> None:
    """Encode (H, W) gray or (H, W, 3) RGB u8 to a JPEG file (libjpeg)."""
    lib = _get_lib()
    img = np.ascontiguousarray(img, np.uint8)
    comps = 1 if img.ndim == 2 else img.shape[2]
    rc = lib.so_encode_jpeg(_ptr(img), img.shape[0], img.shape[1], comps,
                            quality, path.encode())
    if rc != 0:
        raise RuntimeError(f"so_encode_jpeg failed ({rc}): {path}")
