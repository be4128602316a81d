"""Cheap guards of the port's boundaries: it imports nothing of JAX or the
JAX package, its entry points run on the card unless the caller asks for
the CPU, its kernel wrappers never fall back silently, and unknown modes
raise while every mode of the JAX config runs."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import sift_features_tpu_torch as port
from sift_features_tpu_torch.config import DEFAULT_CONFIG as CFG
from sift_features_tpu_torch.models import extractor
from sift_features_tpu_torch.service import DescriptorIndex

from test_torch_gpu import one_torch_thread, smooth_images  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "sift_features_tpu_torch").rglob("*.py"))
    files += sorted((ROOT / "probes").rglob("*.py"))   # chip_smoke.py imports them
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "sift_features_tpu"), (f, mod)


def _module_level_imports(path):
    """Modules imported by the statements of a file's top level (not
    inside a function or class)."""
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_cv2_at_module_level():
    """No module of the port imports cv2 when it is imported: the oracle's
    CvProcessing, the image loaders and the examples import it where they
    use it (the card's machine has no cv2). The spatial path, the oracle
    and the examples are among the files read."""
    pkg = ROOT / "sift_features_tpu_torch"
    files = sorted(pkg.rglob("*.py"))
    names = {f.relative_to(pkg).as_posix() for f in files}
    assert {"parallel/halo.py", "parallel/extract.py", "oracle/oracle.py",
            "oracle/processing.py", "examples/run_sift.py",
            "examples/sift_match.py", "examples/opencv_cross_match.py",
            "examples/build_index.py"} <= names
    for f in files:
        assert "cv2" not in {m.split(".")[0] for m in _module_level_imports(f)}, f


def test_entry_points_need_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((32, 32), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        extractor.extract(img)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.sift(img)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.match_descriptors(np.zeros((4, 128), np.uint8),
                               np.zeros((4, 128), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA"):
        port.descriptor_index()
    with pytest.raises(RuntimeError, match="CUDA"):
        DescriptorIndex()
    from sift_features_tpu_torch.parallel import (extract_match_step,
                                                  make_mesh, ring_match)
    from sift_features_tpu_torch.parallel.runner import init_distributed

    d = np.zeros((4, 128), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        ring_match(d, d)
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_match_step(img[None], 1, CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_distributed()
    assert init_distributed(device="cpu") == 0
    assert len(ring_match(d, d, make_mesh(device="cpu"))[0]) == 1
    assert port.descriptor_index(device="cpu").device.type == "cpu"
    kps, desc = port.sift(img, device="cpu")
    assert kps.shape == (0, 5) and desc.shape == (0, 128)


def test_stream_needs_the_card(monkeypatch, tmp_path):
    """The streaming entry points raise at the call without a card, and run
    with device="cpu"."""
    from sift_features_tpu_torch.io.native_output import write_jpeg
    from sift_features_tpu_torch.parallel.stream import stream_extract

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((32, 32), np.uint8)
    path = str(tmp_path / "flat.jpg")
    write_jpeg(path, img)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.stream([path], 1, (32, 32))
    with pytest.raises(RuntimeError, match="CUDA"):
        stream_extract(iter([img[None]]))
    [[(kps, desc)]] = list(port.stream([path], 1, (32, 32), device="cpu"))
    assert kps.shape == (0, 5) and desc.shape == (0, 128)
    [host] = list(stream_extract(iter([img[None]]), compact=False,
                                 device="cpu"))
    assert host["valid"].shape[0] == 1 and not host["valid"].any()


def test_wrappers_never_fall_back():
    """A tensor that is neither on the CPU nor on a CUDA card reaches the
    kernel path, which refuses it: no silent plain-version fallback."""
    from sift_features_tpu_torch.ops.kernels.pyramid import octave_fused

    with pytest.raises(ValueError, match="CUDA"):
        octave_fused(torch.empty((1, 256, 256), device="meta"), CFG)


def test_unported_paths_raise(one_torch_thread):
    """Unknown mode names raise ValueError at the entry points. Every
    storage mode runs through extract_batch, with and without
    features_limit; the entry points that ignore the storage modes, as the
    JAX package's do (_extract_single, precompute and
    extract_with_precomputed), give the f32 result in each."""
    import dataclasses

    img = smooth_images(3, 1, 32, 32)
    for field, value in (("storage_dtype", "float16"),
                         ("gather_dtype", "split"), ("refine_mode", "walks")):
        cfg = dataclasses.replace(CFG, **{field: value})
        with pytest.raises(ValueError):
            extractor.extract_batch(img, cfg, features_limit=10, device="cpu")
        with pytest.raises(ValueError):
            extractor.precompute(img, cfg, device="cpu")
    n_oct = extractor._n_octaves(32, 32, CFG)
    frame = torch.from_numpy(img[0])
    one32 = extractor._extract_single(frame, n_oct, CFG)
    sp32 = extractor.extract_with_precomputed(
        *extractor.precompute(img, CFG, device="cpu"), CFG, device="cpu")
    assert int(one32["valid"].sum()) > 0
    for fields in ({"storage_dtype": "bfloat16"}, {"storage_dtype": "split"},
                   {"gather_dtype": "bfloat16"}):
        cfg = dataclasses.replace(CFG, **fields)
        full = extractor.extract_batch(img, cfg, device="cpu")
        lim = extractor.extract_batch(img, cfg, features_limit=10, device="cpu")
        want = extractor._truncate_result(full, 10)
        assert all(torch.equal(lim[k], want[k]) for k in want), fields
        one = extractor._extract_single(frame, n_oct, cfg)
        assert all(torch.equal(one[k], one32[k]) for k in one32), fields
        octs, dogs = extractor.precompute(img, cfg, device="cpu")
        assert octs[0].dtype == dogs[0].dtype == torch.float32
        sp = extractor.extract_with_precomputed(octs, dogs, cfg, device="cpu")
        assert all(torch.equal(sp[k], sp32[k]) for k in sp32), fields


@pytest.mark.parametrize("probe,kernel_file", [("k5_const_math", "orientation.cu")])
def test_probe_sources_follow_kernels(probe, kernel_file):
    """A probe built from a copy of a kernel's source finds there, once, each
    run of lines it replaces (it raises otherwise), and the copy differs
    from the kernel's source only by those lines: a kernel edited so that a
    probe no longer fits fails here, without a card."""
    import probes

    src = (ROOT / "sift_features_tpu_torch" / "csrc" / kernel_file).read_text()
    copy = getattr(probes, f"_{probe}_source")()
    assert copy != src
    kept = set(src.split("\n")) & set(copy.split("\n"))
    assert len(kept) > 0.9 * len(set(src.split("\n")))
