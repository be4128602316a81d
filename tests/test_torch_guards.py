"""Cheap guards of the port's boundaries: it imports nothing of JAX or the
JAX package, its entry points run on the card unless the caller asks for
the CPU, its kernel wrappers never fall back silently, and the parts not
ported yet say so."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import sift_features_tpu_torch as port
from sift_features_tpu_torch.config import DEFAULT_CONFIG as CFG
from sift_features_tpu_torch.models import extractor

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
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "sift_features_tpu"), (f, mod)


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
    kps, desc = port.sift(img, device="cpu")
    assert kps.shape == (0, 5) and desc.shape == (0, 128)


def test_wrappers_never_fall_back():
    """A tensor that is neither on the CPU nor on a CUDA card reaches the
    kernel path, which refuses it: no silent plain-version fallback."""
    from sift_features_tpu_torch.ops.kernels.pyramid import octave_fused

    with pytest.raises(ValueError, match="CUDA"):
        octave_fused(torch.empty((1, 256, 256), device="meta"), CFG)


def test_unported_paths_raise():
    img = np.zeros((1, 32, 32), np.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        extractor.extract_batch(img, features_limit=10, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        extractor.precompute(img)
