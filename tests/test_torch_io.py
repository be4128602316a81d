"""The port's I/O tier and profiling helpers against the JAX package's own
modules, on the CPU (no JAX compile):

- native decode (`decode_gray` in every luma, DCT and upsampling mode),
  `load_gray` in every method and `to_f32`, byte-equal;
- `BatchLoader`: crop / zero-pad, the ragged tail, `n_buffers` rotation
  and the "already consumed" error, equal;
- the output tier: `compact_batch`, `render_matches`, `write_jpeg` (files
  byte-equal, gray and RGB);
- the snapshot parsers and `load_golden` on a synthetic reference tree;
- `extraction_metrics` on one port result; a `span` in `device_trace`;
- a failed native build raises, never falls back.

The JPEGs are written by the tests with cv2 (about 96 x 128, one RGB, one
grayscale).
"""

import os
import pathlib

import numpy as np
import pytest
import torch

from sift_features_tpu.io import image as jimage
from sift_features_tpu.io import native_loader as jloader
from sift_features_tpu.io import native_output as joutput
from sift_features_tpu.io import snapshots as jsnap
from sift_features_tpu_torch.io import image, native_loader, native_output
from sift_features_tpu_torch.io import snapshots

from test_torch_gpu import one_torch_thread, smooth_images  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
LUMAS = ("jpeg-gray", "bt601", "bt709")
DCTS = ("islow", "ifast", "float")
METHODS = ("cv2", "image-crate", "image-crate-round", "image-crate-f32",
           "golden")


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """The JAX package's native bindings, built by its own code into a
    directory of this module's: its shared native/build is written by its
    own tests without a lock, and a process that loads a library another
    is still writing fails."""
    d = tmp_path_factory.mktemp("jax_native")
    for name in ("sift_loader.cpp", "sift_output.cpp"):
        os.symlink(ROOT / "native" / name, d / name)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jloader, joutput):
            mp.setattr(mod, "_NATIVE_DIR", str(d))
            mp.setattr(mod, "_lib", None)
        yield


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """{"rgb": path, "gray": path}: seeded 96 x 128 JPEGs written with cv2."""
    import cv2

    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.RandomState(0)
    gray = smooth_images(1, 1, 96, 128)[0]
    rgb = np.stack([gray, np.roll(gray, 9, 1), (rng.rand(96, 128) * 255)
                    .astype(np.uint8)], -1)
    out = {"rgb": str(d / "rgb.jpg"), "gray": str(d / "gray.jpg")}
    assert cv2.imwrite(out["rgb"], rgb[:, :, ::-1])
    assert cv2.imwrite(out["gray"], gray)
    return out


@pytest.mark.parametrize("kind", ["rgb", "gray"])
def test_decode_gray_matches_jax(jpegs, kind):
    path = jpegs[kind]
    for luma in LUMAS:
        for dct in DCTS:
            for fancy in (True, False):
                kw = dict(luma=luma, dct=dct, fancy_upsampling=fancy)
                got = native_loader.decode_gray(path, **kw)
                want = jloader.decode_gray(path, **kw)
                assert got.shape == (96, 128) and got.dtype == np.uint8
                assert got.tobytes() == want.tobytes(), kw
    # max_hw crops
    got = native_loader.decode_gray(path, max_hw=(50, 70))
    np.testing.assert_array_equal(got, jloader.decode_gray(path, (50, 70)))
    assert got.shape == (50, 70)
    with pytest.raises(IOError, match="decode failed"):
        native_loader.decode_gray(path + ".missing")


@pytest.mark.parametrize("kind", ["rgb", "gray"])
def test_load_gray_matches_jax(jpegs, kind):
    path = jpegs[kind]
    for method in METHODS:
        got = image.load_gray(path, method)
        want = jimage.load_gray(path, method)
        assert got.dtype == np.uint8 and got.tobytes() == want.tobytes(), method
        assert np.array_equal(image.to_f32(got), jimage.to_f32(want))
    with pytest.raises(ValueError, match="unknown method"):
        image.load_gray(path, "pillow")
    with pytest.raises(FileNotFoundError):
        image.load_gray(path + ".missing")


def _loader_passes(mod, paths, batch, hw, n_buffers):
    """Every batch a loader yields (copies), the batches' buffer identities
    and the error of a second pass."""
    bl = mod.BatchLoader(paths, batch, hw, "bt601", 3, n_buffers=n_buffers)
    views = list(bl)
    bases = [id(v.base if v.base is not None else v) for v in views]
    copies = []
    bl2 = mod.BatchLoader(paths, batch, hw, "bt601", 3, n_buffers=n_buffers)
    for v in bl2:
        copies.append(v.copy())
    with pytest.raises(RuntimeError, match="already consumed") as err:
        next(iter(bl2))
    bl.close()
    bl2.close()
    assert len(bl) == len(copies)
    return copies, [bases.index(b) for b in bases], str(err.value)


@pytest.mark.parametrize("n_buffers", [1, 3])
def test_batch_loader_matches_jax(jpegs, n_buffers):
    """Crop (rows) and zero-pad (columns), 5 frames at B=2: a ragged tail,
    the rotation of the yielded arrays, the second-pass error."""
    paths = [jpegs["rgb"], jpegs["gray"]] * 2 + [jpegs["rgb"]]
    got = _loader_passes(native_loader, paths, 2, (80, 150), n_buffers)
    want = _loader_passes(jloader, paths, 2, (80, 150), n_buffers)
    assert [b.shape for b in got[0]] == [(2, 80, 150), (2, 80, 150),
                                         (1, 80, 150)]
    for g, w in zip(got[0], want[0]):
        assert g.tobytes() == w.tobytes()
    assert got[1] == want[1] == [i % n_buffers for i in range(3)]
    assert got[2] == want[2]
    one = native_loader.decode_gray(paths[0], luma="bt601")
    np.testing.assert_array_equal(got[0][0][0, :, :128], one[:80])
    assert (got[0][0][:, :, 128:] == 0).all()


def test_compact_batch_matches_jax():
    rng = np.random.RandomState(0)
    b, k, d = 5, 193, 128
    kps = rng.rand(b, k, 5).astype(np.float32)
    desc = (rng.rand(b, k, d) * 255).astype(np.uint8)
    valid = rng.rand(b, k) > 0.6
    valid[2] = False
    valid[3] = True
    got = native_output.compact_batch(kps, desc, valid, n_threads=3)
    want = joutput.compact_batch(kps, desc, valid, n_threads=3)
    assert len(got) == len(want) == b
    for (gk, gd), (wk, wd), v, kk, dd in zip(got, want, valid, kps, desc):
        assert gk.tobytes() == wk.tobytes() and gd.tobytes() == wd.tobytes()
        np.testing.assert_array_equal(gk, kk[v])
        np.testing.assert_array_equal(gd, dd[v])


def test_stream_compaction_needs_no_output_tier(monkeypatch, tmp_path,
                                                one_torch_thread):
    """With the native output tier unable to build, the stream's default
    compact=True still yields per-frame pairs, byte-equal to JAX
    compact_batch and to JAX _fetch's NumPy branch on the same padded
    results; compact_frames likewise on a synthetic batch with an empty and
    a full frame."""
    from sift_features_tpu.parallel import stream as jstream
    from sift_features_tpu_torch.io import native_build
    from sift_features_tpu_torch.parallel.stream import (compact_frames,
                                                         stream_extract)

    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "out"))
    broken = tmp_path / "broken.cpp"
    broken.write_text("int main( {\n")
    monkeypatch.setattr(native_output, "_lib", None)
    monkeypatch.setattr(native_output, "SOURCE", str(broken))
    frames = smooth_images(3, 1, 32, 32)
    [pairs] = list(stream_extract(iter([frames]), device="cpu"))
    [host] = list(stream_extract(iter([frames]), compact=False, device="cpu"))
    with pytest.raises(native_output.NativeOutputUnavailable):
        native_output._get_lib()
    rng = np.random.RandomState(2)
    valid = rng.rand(3, 57) > 0.5
    valid[1], valid[2] = False, True
    synthetic = {"kps": rng.rand(3, 57, 5).astype(np.float32),
                 "desc": (rng.rand(3, 57, 128) * 255).astype(np.uint8),
                 "valid": valid}
    cases = [(pairs, host), (compact_frames(synthetic), synthetic)]
    wants = [joutput.compact_batch(h["kps"], h["desc"], h["valid"])
             for _, h in cases]

    def unavailable(*a, **kw):
        raise joutput.NativeOutputUnavailable("not built")

    monkeypatch.setattr(joutput, "compact_batch", unavailable)
    for (got, h), want in zip(cases, wants):
        numpy_branch = jstream._fetch(h, len(h["valid"]), True)
        assert len(got) == len(want) == len(numpy_branch)
        for (gk, gd), (wk, wd), (nk, nd) in zip(got, want, numpy_branch):
            assert gk.dtype == wk.dtype == np.float32 and gd.dtype == np.uint8
            assert gk.tobytes() == wk.tobytes() == nk.tobytes()
            assert gd.tobytes() == wd.tobytes() == nd.tobytes()
    assert sum(len(k) for k, _ in pairs) > 0


def test_render_matches_and_write_jpeg_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    img1 = (rng.rand(60, 80) * 255).astype(np.uint8)
    img2 = (rng.rand(50, 70) * 255).astype(np.uint8)
    k1 = np.array([[10, 10, 6, 0, 1], [60, 40, 4, 0, 1]], np.float32)
    k2 = np.array([[30, 20, 8, 0, 1]], np.float32)
    pairs = np.array([[0, 0], [1, 0]], np.int32)
    out = native_output.render_matches(img1, k1, img2, k2, pairs)
    np.testing.assert_array_equal(
        out, joutput.render_matches(img1, k1, img2, k2, pairs))
    assert out.shape == (60, 150, 3)
    with pytest.raises(RuntimeError, match="out of range"):
        native_output.render_matches(img1, k1, img2, k2,
                                     np.array([[5, 0]], np.int32))
    with pytest.raises(ValueError, match="grayscale"):
        native_output.render_matches(out, k1, img2, k2, pairs)
    for name, img, q in (("rgb", out, 92), ("gray", img1, 75)):
        a, b = str(tmp_path / f"port_{name}.jpg"), str(tmp_path / f"jax_{name}.jpg")
        native_output.write_jpeg(a, img, quality=q)
        joutput.write_jpeg(b, img, quality=q)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), name
        assert native_loader.decode_gray(a).shape == img.shape[:2]


def _write_snapshots(root):
    """A synthetic reference tree: each SNAPSHOT_FILES entry with a few
    keypoints and descriptor rows in the insta YAML layout."""
    rng = np.random.RandomState(4)
    snap = root / "src" / "snapshots"
    snap.mkdir(parents=True)
    for n, (kp_file, desc_file) in zip((3, 5), snapshots.SNAPSHOT_FILES.values()):
        kp = ["---", "source: src/lib.rs", "expression: keypoints", "---"]
        for _ in range(n):
            x, y, s, a, r = map(float, rng.rand(5) * [640, 480, 20, 360, 0.1])
            kp += [f"- x: {x!r}", f"  y: {y!r}", f"  size: {s!r}",
                   f"  angle: {a!r}", f"  response: {r!r}"]
        (snap / kp_file).write_text("\n".join(kp) + "\n")
        ds = ["---", "source: src/lib.rs", "expression: descriptors", "---"]
        for _ in range(n):
            row = rng.randint(0, 256, 128)
            ds += [f"- - {row[0]}"] + [f"  - {v}" for v in row[1:]]
        (snap / desc_file).write_text("\n".join(ds) + "\n")


def test_snapshot_parsers_match_jax(tmp_path):
    _write_snapshots(tmp_path)
    assert snapshots.SNAPSHOT_FILES == jsnap.SNAPSHOT_FILES
    assert snapshots.KEYPOINT_FIELDS == jsnap.KEYPOINT_FIELDS
    for name, n in (("tree_small", 3), ("bird_small", 5)):
        kps, desc = snapshots.load_golden(str(tmp_path), name)
        jkps, jdesc = jsnap.load_golden(str(tmp_path), name)
        assert kps.shape == (n, 5) and desc.shape == (n, 128)
        assert kps.dtype == np.float32 and desc.dtype == np.uint8
        assert kps.tobytes() == jkps.tobytes()
        assert desc.tobytes() == jdesc.tobytes()
        kp_file, desc_file = snapshots.SNAPSHOT_FILES[name]
        path = str(tmp_path / "src" / "snapshots" / kp_file)
        assert (snapshots.parse_keypoint_snapshot(path).tobytes()
                == jsnap.parse_keypoint_snapshot(path).tobytes())


def test_extraction_metrics_match_jax(one_torch_thread):
    from sift_features_tpu.config import DEFAULT_CONFIG as JCFG
    from sift_features_tpu.utils.profiling import extraction_metrics as jmetrics
    from sift_features_tpu_torch.config import DEFAULT_CONFIG as CFG
    from sift_features_tpu_torch.models.extractor import extract_batch
    from sift_features_tpu_torch.utils.profiling import extraction_metrics

    frames = smooth_images(2, 1, 48, 64)
    res = extract_batch(frames, device="cpu")
    host = {k: v.numpy() for k, v in res.items()}
    for hw in (None, (48, 64)):
        got = extraction_metrics(res, hw, CFG if hw else None)
        want = jmetrics(host, hw, JCFG if hw else None)
        assert got == want, hw
        assert sum(got["keypoints_per_frame"]) > 0
    # a buffer's worth of candidates flags its octave
    host["n_candidates"][0, 1] = 10 ** 6
    flags = extraction_metrics(host, (48, 64), CFG)["capacity_overflow_per_octave"]
    assert flags == jmetrics(host, (48, 64), JCFG)["capacity_overflow_per_octave"]
    assert flags[1] and not flags[0]


def test_stage_timer_and_trace(tmp_path):
    """`span` (which replaced the synchronising stage timer) inside
    `device_trace`: the span is kept with its attributes, its stamps
    enclose its block, and the Chrome trace holds it as a range."""
    from sift_features_tpu_torch.utils import profiling

    profiling.clear()
    with profiling.device_trace(str(tmp_path)):
        with profiling.span("matmul", rows=8) as sp:
            y = torch.ones(8, 8) @ torch.ones(8, 8)
    assert float(y[0, 0]) == 8.0
    got, = profiling.spans()
    assert got is sp and sp.attrs == {"rows": 8} and sp.parent is None
    assert 0 < sp.start_ns < sp.end_ns
    assert profiling.totals() == {"matmul": (1, (sp.end_ns - sp.start_ns) * 1e-9)}
    assert os.path.getsize(tmp_path / "trace.json") > 0
    with open(tmp_path / "trace.json") as f:
        assert '"matmul"' in f.read()
    profiling.clear()


@pytest.mark.parametrize("module,error", [
    ("native_loader", "NativeLoaderUnavailable"),
    ("native_output", "NativeOutputUnavailable")])
def test_failed_native_build_raises(monkeypatch, tmp_path, module, error):
    """A source that does not compile raises with g++'s message, a missing
    one with the OS error; neither falls back to another decoder or to
    NumPy, and nothing is written to the build directory."""
    from sift_features_tpu_torch.io import native_build

    mod = {"native_loader": native_loader, "native_output": native_output}[module]
    exc = getattr(mod, error)
    # the stream call below loads the real decode tier: build it where it
    # belongs first, so that this test does not depend on an earlier test
    # of its process having loaded it
    native_loader._get_lib()
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "out"))
    broken = tmp_path / "broken.cpp"
    broken.write_text("int main( {\n")
    for src, msg in ((str(broken), "error"),
                     (str(tmp_path / "missing.cpp"), "No such file")):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "SOURCE", src)
        with pytest.raises(exc, match=msg) as err:
            mod._get_lib()
        assert "build failed" in str(err.value) or "cannot read" in str(err.value)
        assert mod._lib is None
    monkeypatch.setattr(mod, "SOURCE", str(broken))
    with pytest.raises(exc, match="error"):
        if module == "native_loader":
            native_loader.decode_gray(str(broken))
        else:
            native_output.compact_batch(np.zeros((1, 1, 5), np.float32),
                                        np.zeros((1, 1, 128), np.uint8),
                                        np.ones((1, 1), bool))
    # the stream needs the decode tier at the call, before it reads a
    # batch; its compaction needs no native tier
    from sift_features_tpu_torch.parallel.stream import (stream_extract,
                                                         stream_extract_paths)

    if module == "native_loader":
        with pytest.raises(exc, match="error"):
            stream_extract_paths([str(broken)], 1, (8, 8), device="cpu")
    else:
        stream_extract_paths([str(broken)], 1, (8, 8), device="cpu")
        for compact in (True, False):
            assert list(stream_extract(iter(()), compact=compact,
                                       device="cpu")) == []
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "out"))
