"""Streaming executor: decode -> H2D -> extract -> readback, overlapped.

The port of sift_features_tpu/parallel/stream.py. What overlaps on one
card is the host pipeline around the extraction:

    C++ decode pool   ──► pinned host batch t+1      (native/sift_loader.cpp
    side stream h2d   ──► H2D copy of t+1              threads, prefetching)
    current stream    ──► extract_batch on t+1
    side stream d2h   ──► readback of t into pinned host tensors

The extractor blocks the host once per fused octave (a capacity test read
on the host, models/extractor.py:_detect_octave_batched), so a call to
extract_batch returns only when most of its batch's device work is done:
unlike JAX's asynchronous dispatch, batches do not queue up on the card.
The stream hides the decode, the H2D copy of the next batch and the
readback of the last one behind that work. `depth` bounds the results
held before they are handed out.

Device buffers change hands between streams by events: the current stream
waits on the event recorded after a batch's H2D copy, and the readback
stream waits on the current stream. A host buffer is rewritten only once
the event recorded after its last copy has completed (`copy_done`).
Nothing here relies on the extractor's own host syncs, which
`window_kernel="perkey"` does not take.

This is the serving-loop counterpart of the reference's per-image `sift()`
call (lib.rs:71-81): the same per-frame outputs, produced by a continuously
fed card.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, SiftConfig
from ..utils.device import resolve_device


def compact_frames(host: dict) -> list:
    """Per-frame (kps (n, 5) f32, desc (n, 128) u8) pairs of a padded host
    result of NumPy arrays: each frame's valid rows, copied, in order (the
    pairs of the JAX package's compact_batch, byte for byte)."""
    return [(k[v], d[v]) for k, d, v in
            zip(host["kps"], host["desc"], host["valid"])]


def _fetch(res, n_frames: int, compact: bool, done=None):
    """Host results of one batch, its readback complete.

    res: the batch's result dict of host tensors (pinned on the card's
    path); done: the event recorded after their readback, waited on first.
    compact=True: per-frame (kps (n, 5) f32, desc (n, 128) u8) pairs, like
    models.extractor.extract (compact_frames); compact=False: the padded
    arrays as NumPy, cut to n_frames."""
    if done is not None:
        done.synchronize()
    host = {k: v.numpy()[:n_frames] for k, v in res.items()}
    return compact_frames(host) if compact else host


def _to_card(frames: np.ndarray, dev: torch.device, h2d, snapshot: bool):
    """Queue the copy of a host batch to the card on side stream h2d and
    make the current stream wait for it. snapshot=True first copies the
    frames into a pinned host tensor (the producer may reuse its array as
    soon as this returns). Returns the card tensor and the event recorded
    after the copy."""
    src = torch.from_numpy(frames)
    if snapshot:
        src = torch.empty(frames.shape, dtype=torch.uint8,
                          pin_memory=True).copy_(src)
    with torch.cuda.stream(h2d):
        imgs = torch.empty(frames.shape, dtype=torch.uint8, device=dev)
        imgs.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record(h2d)
    compute = torch.cuda.current_stream(dev)
    compute.wait_event(done)
    imgs.record_stream(compute)
    return imgs, done


def _to_host(res: dict, d2h):
    """Queue the readback of a batch's results into pinned host tensors on
    side stream d2h, after the current stream's work. Returns the host
    dict and the event recorded after the copies."""
    d2h.wait_stream(torch.cuda.current_stream(d2h.device))
    host = {}
    with torch.cuda.stream(d2h):
        for k, v in res.items():
            host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[k].copy_(v, non_blocking=True)
            v.record_stream(d2h)
        done = torch.cuda.Event()
        done.record(d2h)
    return host, done


def stream_extract(batches, config: SiftConfig = DEFAULT_CONFIG,
                   features_limit: int | None = None, depth: int = 2,
                   compact: bool = True, producer_rotates: bool = False,
                   device="cuda", copy_done=None):
    """Iterate host (b, H, W) u8 batches through `device` with `depth`
    results held; yields per-batch host results (see _fetch). Raises at
    the call, not at the first batch, when the device is missing.

    Every batch is padded to the first batch's frame count, as the JAX
    package does to keep one compiled program; padded frames are dropped
    from the yielded results. A batch larger than the first raises.

    producer_rotates=True declares that the producer yields ROTATING batch
    buffers (io.native_loader.BatchLoader with n_buffers >= depth + 2): the
    snapshot copy into pinned memory before the asynchronous H2D copy is
    then skipped. copy_done, if given, is called with the event recorded
    after each batch's H2D copy; the producer must not rewrite that
    batch's buffer before the event completes (BatchLoader.copy_done
    waits on it). A rotating producer whose buffers are not pinned is safe
    without it: a copy from pageable memory has read the buffer when it
    returns.
    """
    dev = resolve_device(device)
    return _stream(iter(batches), config, features_limit, depth, compact,
                   producer_rotates, dev, copy_done)


def _stream(batches, config, features_limit, depth, compact,
            producer_rotates, dev, copy_done):
    from ..models import extractor

    card = dev.type == "cuda"
    if card:
        h2d, d2h = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    inflight: deque = deque()
    batch_size = None
    for frames in batches:
        frames = np.asarray(frames, np.uint8)
        n = frames.shape[0]
        if batch_size is None:
            batch_size = n
        if n < batch_size:
            frames = np.concatenate(
                [frames, np.zeros((batch_size - n,) + frames.shape[1:],
                                  np.uint8)])
        elif n > batch_size:
            raise ValueError(
                f"batch grew from {batch_size} to {n}; streams must start "
                "with the largest batch (pad upstream)")
        if card:
            imgs, copied = _to_card(frames, dev, h2d,
                                    snapshot=n < batch_size
                                    or not producer_rotates)
            if copy_done is not None:
                copy_done(copied)
        else:
            # the CPU path computes before it returns: no copy in flight
            imgs = torch.from_numpy(frames)
        res = extractor.extract_batch(imgs, config, features_limit,
                                      device=dev)
        inflight.append((_to_host(res, d2h) if card else (res, None), n))
        if len(inflight) > depth:
            (res0, done0), n0 = inflight.popleft()
            yield _fetch(res0, n0, compact, done0)
    while inflight:
        (res0, done0), n0 = inflight.popleft()
        yield _fetch(res0, n0, compact, done0)


def stream_extract_paths(paths, batch: int, hw: tuple[int, int],
                         config: SiftConfig = DEFAULT_CONFIG,
                         features_limit: int | None = None, depth: int = 2,
                         compact: bool = True, luma: str = "jpeg-gray",
                         n_threads: int = 4, device="cuda"):
    """JPEG files -> streamed features, end to end: the native threaded
    decode pool feeds the card from rotating pinned buffers. Yields
    per-batch results (see stream_extract); frames are cropped /
    zero-padded to `hw` by the loader. Raises at the call when the device
    is missing or the native decode tier cannot be built."""
    from ..io import native_loader

    dev = resolve_device(device)
    native_loader._get_lib()
    return _stream_paths(list(paths), batch, hw, config, features_limit,
                         depth, compact, luma, n_threads, dev)


def _stream_paths(paths, batch, hw, config, features_limit, depth, compact,
                  luma, n_threads, dev):
    from ..io.native_loader import BatchLoader

    loader = BatchLoader(paths, batch, hw, luma, n_threads,
                         n_buffers=depth + 2,
                         pin_memory=dev.type == "cuda")
    try:
        yield from _stream(iter(loader), config, features_limit, depth,
                           compact, True, dev, loader.copy_done)
    finally:
        loader.close()
