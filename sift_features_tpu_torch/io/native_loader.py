"""ctypes binding for the native (C++) data loader, native/sift_loader.cpp.

libjpeg decode, three grayscale semantics, and a multi-threaded
prefetching batch pool producing fixed-shape (B, H, W) u8 batches for the
device feed. The library is built on first use (io/native_build.py,
g++ + system libjpeg); a failed build raises NativeLoaderUnavailable with
g++'s output, and no other decoder takes over.

Luma modes:
  "jpeg-gray" — libjpeg JCS_GRAYSCALE (cv2.imread(IMREAD_GRAYSCALE) path)
  "bt601"     — OpenCV cvtColor fixed-point RGB->GRAY
  "bt709"     — Rust image 0.25 grayscale() (truncating integer BT.709)
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .native_build import NATIVE_DIR, build

SOURCE = os.path.join(NATIVE_DIR, "sift_loader.cpp")

_LUMA = {"jpeg-gray": 0, "bt601": 1, "bt709": 2}
_DCT = {"islow": 0, "ifast": 1, "float": 2}

_lib = None
_lib_lock = threading.Lock()


class NativeLoaderUnavailable(RuntimeError):
    pass


def _get_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build(SOURCE, NativeLoaderUnavailable))
            lib.sl_decode_gray.restype = ctypes.c_int
            lib.sl_decode_gray.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.sl_pool_create.restype = ctypes.c_void_p
            lib.sl_pool_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.sl_pool_next.restype = ctypes.c_int
            lib.sl_pool_next.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_void_p]
            lib.sl_pool_destroy.restype = None
            lib.sl_pool_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


def decode_gray(path: str, max_hw: tuple[int, int] = (8192, 8192),
                luma: str = "jpeg-gray", dct: str = "islow",
                fancy_upsampling: bool = True) -> np.ndarray:
    """Decode a JPEG to (h, w) u8 grayscale with the native decoder.

    dct / fancy_upsampling select libjpeg decode variants (sift_loader.cpp
    option bits); dct="float" + fancy is the golden-test variant
    (image.load_gray(method="golden"))."""
    lib = _get_lib()
    mh, mw = max_hw
    buf = np.zeros((mh, mw), np.uint8)
    h = ctypes.c_int()
    w = ctypes.c_int()
    opts = (_DCT[dct] | (0 if fancy_upsampling else 4)) << 8
    rc = lib.sl_decode_gray(path.encode(), buf.ctypes.data_as(ctypes.c_void_p),
                            ctypes.byref(h), ctypes.byref(w), mh, mw,
                            _LUMA[luma] | opts)
    if rc != 0:
        raise IOError(f"decode failed ({rc}): {path}")
    return buf[:h.value, :w.value].copy()


class BatchLoader:
    """Threaded prefetching loader: iterates fixed-shape (B, H, W) u8
    batches (frames cropped / zero-padded to (H, W); the last batch holds
    the remaining frames). Decoding of the whole file list starts
    immediately on background threads."""

    def __init__(self, paths: list[str], batch: int, hw: tuple[int, int],
                 luma: str = "jpeg-gray", n_threads: int = 4,
                 n_buffers: int = 1, pin_memory: bool = False):
        """n_buffers > 1 ROTATES the yielded batch arrays: the array yielded
        for batch t is not rewritten until batch t + n_buffers, so a
        consumer may hand it to an asynchronous copy without a snapshot
        (parallel.stream sets n_buffers = depth + 2 and skips its copy).

        pin_memory=True puts the buffers in page-locked host memory (torch,
        needs a CUDA card), so a copy to the card from them runs
        asynchronously. The consumer then reports each batch's copy with
        copy_done(event), and a buffer is rewritten only once the event
        recorded after its last copy has completed."""
        self._lib = _get_lib()
        self.paths = list(paths)
        self.batch = batch
        self.h, self.w = hw
        self.n_buffers = max(1, n_buffers)
        self.pin_memory = pin_memory
        self._copies = [None] * self.n_buffers
        self._slot = None
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        self._pool = self._lib.sl_pool_create(
            arr, len(self.paths), batch, self.h, self.w, _LUMA[luma],
            n_threads)
        if not self._pool:
            raise NativeLoaderUnavailable("pool creation failed")

    def __len__(self):
        return -(-len(self.paths) // self.batch)

    def _buffers(self) -> list[np.ndarray]:
        shape = (self.batch, self.h, self.w)
        if not self.pin_memory:
            return [np.zeros(shape, np.uint8) for _ in range(self.n_buffers)]
        import torch

        # the tensors stay referenced by the arrays' base
        return [torch.empty(shape, dtype=torch.uint8, pin_memory=True).numpy()
                for _ in range(self.n_buffers)]

    def copy_done(self, event) -> None:
        """The consumer's copy of the batch last yielded completes with
        `event` (a torch.cuda.Event): its buffer is not rewritten before."""
        self._copies[self._slot] = event

    def _wait(self, slot: int) -> None:
        ev, self._copies[slot] = self._copies[slot], None
        if ev is not None:
            ev.synchronize()

    def __iter__(self):
        bufs = self._buffers()
        for b in range(len(self)):
            self._slot = b % self.n_buffers
            self._wait(self._slot)
            out = bufs[self._slot]
            n = self._lib.sl_pool_next(
                self._pool, b, out.ctypes.data_as(ctypes.c_void_p))
            if n == -2:
                raise RuntimeError(
                    f"batch {b} already consumed: BatchLoader frees frame "
                    "buffers after the first pass; create a new loader to "
                    "iterate again")
            if n < 0:
                raise IOError(f"decode failed in batch {b}")
            if n == 0:
                return
            yield out[:n] if n < self.batch else out

    def close(self):
        """Stop the decode threads, after every reported copy from the
        buffers has completed."""
        for slot in range(len(getattr(self, "_copies", ()))):
            self._wait(slot)
        if getattr(self, "_pool", None):
            self._lib.sl_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        self.close()
