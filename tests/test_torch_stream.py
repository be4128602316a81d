"""The port's streaming executor on the CPU (`device="cpu"`): tests/test_stream.py's
cases held against the port's own `extract_batch` (no JAX at all). The
stream keeps `depth` results held and pads a ragged tail batch; its
outputs must equal direct extract_batch calls byte for byte on every valid
lane. tests/test_torch_extract.py holds the stream against JAX
`extract_batch`; tests/test_torch_gpu.py runs the card's pinned, rotating
path.
"""

import numpy as np
import pytest

from sift_features_tpu_torch.models.extractor import extract_batch
from sift_features_tpu_torch.parallel.stream import (stream_extract,
                                                     stream_extract_paths)

from test_torch_gpu import one_torch_thread, smooth_images  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H, W = 64, 96
COUNTERS = ("n_candidates", "n_survivors", "n_emitted")


def _direct(frames, **kw):
    return {k: v.numpy() for k, v in
            extract_batch(frames, device="cpu", **kw).items()}


def _check_padded(got, want):
    """A streamed compact=False batch against a direct call on the same
    frames: the valid lanes and the counters are the contract (invalid
    lanes hold unspecified values)."""
    wv = want["valid"]
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"], wv)
    for k in COUNTERS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["kps"][wv], want["kps"][wv])
    np.testing.assert_array_equal(got["desc"][wv], want["desc"][wv])


def _check_compact(got, want):
    """Streamed per-frame (kps, desc) pairs against a direct result's
    valid rows, frame for frame."""
    assert len(got) == want["valid"].shape[0]
    for f, (kps, desc) in enumerate(got):
        v = want["valid"][f]
        assert kps.dtype == np.float32 and desc.dtype == np.uint8
        assert kps.tobytes() == want["kps"][f][v].tobytes()
        assert desc.tobytes() == want["desc"][f][v].tobytes()


def test_stream_matches_direct():
    frames = smooth_images(0, 3, H, W)
    batches = [frames[0:2], frames[2:3]]   # ragged tail
    streamed = list(stream_extract(iter(batches), depth=2, compact=False,
                                   device="cpu"))
    assert len(streamed) == 2
    for got, batch in zip(streamed, batches):
        assert got["valid"].shape[0] == batch.shape[0]
        assert got["valid"].sum() > 20
        _check_padded(got, _direct(batch))


def test_stream_compact_and_buffer_reuse():
    """compact=True yields per-frame (kps, desc); a producer that reuses
    its buffer (like the native BatchLoader) does not corrupt held
    batches."""
    frames = smooth_images(1, 2, H, W)
    buf = np.empty_like(frames[0:1])

    def producer():
        for i in range(2):
            buf[:] = frames[i:i + 1]
            yield buf  # same object every time

    got = list(stream_extract(producer(), depth=2, device="cpu"))
    assert len(got) == 2
    for i, batch in enumerate(got):
        _check_compact(batch, _direct(frames[i:i + 1]))


def test_stream_growth_error():
    frames = smooth_images(2, 3, H, W)
    with pytest.raises(ValueError, match="batch grew"):
        list(stream_extract(iter([frames[0:1], frames[1:3]]), device="cpu"))


def test_stream_budget():
    frames = smooth_images(2, 2, H, W)
    got = list(stream_extract(iter([frames[0:1], frames[1:2]]),
                              features_limit=8, device="cpu"))
    assert len(got) == 2
    for i, batch in enumerate(got):
        want = _direct(frames[i:i + 1], features_limit=8)
        _check_compact(batch, want)
        assert len(batch[0][0]) == 8 and batch[0][1].shape == (8, 128)


def test_stream_paths_end_to_end(tmp_path):
    """JPEG files -> native decode pool -> streamed features equal
    extract_batch on the decode_gray frames, cropped / zero-padded to hw."""
    from sift_features_tpu_torch.io.native_loader import decode_gray
    from sift_features_tpu_torch.io.native_output import write_jpeg

    src = smooth_images(3, 3, 70, 90)
    paths = []
    for i, img in enumerate(src):
        paths.append(str(tmp_path / f"f{i}.jpg"))
        write_jpeg(paths[-1], img, quality=92)
    got = [r for batch in stream_extract_paths(paths, batch=2, hw=(H, W),
                                               device="cpu")
           for r in batch]
    assert len(got) == 3
    for path, pair in zip(paths, got):
        img = decode_gray(path, luma="jpeg-gray")[:H, :W]
        pad = np.zeros((H, W), np.uint8)
        pad[:img.shape[0], :img.shape[1]] = img
        _check_compact([pair], _direct(pad[None]))
        assert len(pair[0]) > 10
