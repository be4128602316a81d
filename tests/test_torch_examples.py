"""The port's examples (sift_features_tpu_torch/examples/) run through
their `main` with --device cpu on synthetic PNGs and print what the JAX
package's examples print. They read images with cv2, so they skip without
it (sift_match and opencv_cross_match also without cv2's SIFT)."""

import os
import re

import numpy as np
import pytest

from test_torch_gpu import one_torch_thread, smooth_images  # noqa: F401

cv2 = pytest.importorskip("cv2")
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """Two PNGs: a seeded smooth 64 x 80 frame and a shifted crop of it."""
    d = tmp_path_factory.mktemp("examples")
    img = smooth_images(7, 1, 64, 80)[0]
    a, b = str(d / "a.png"), str(d / "b.png")
    cv2.imwrite(a, img)
    cv2.imwrite(b, np.ascontiguousarray(img[4:, 6:]))
    return a, b, img


def test_run_sift(pngs, capsys):
    from sift_features_tpu_torch.examples import run_sift

    a, _, _ = pngs
    assert run_sift.main([a, "--device", "cpu"]) == 0
    assert run_sift.main([a, "10", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    m = re.fullmatch(r"found (\d+) keypoints", out[0])
    assert m and int(m.group(1)) > 10 and out[1] == "found 10 keypoints"


def test_sift_match(pngs, tmp_path, capsys):
    from sift_features_tpu_torch.examples import sift_match

    if not hasattr(cv2, "SIFT_create"):
        pytest.skip("cv2 has no SIFT")
    a, b, _ = pngs
    assert sift_match.main([a, b, str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"ours: \d+ / \d+ keypoints", out[0])
    m = re.fullmatch(rf"wrote {re.escape(str(tmp_path))}/matches.jpg "
                     r"\((\d+) matches\)", out[1])
    assert m and int(m.group(1)) > 5
    assert re.fullmatch(r"cv2 : \d+ / \d+ keypoints", out[2])
    assert out[3].startswith(f"wrote {tmp_path}/cv_matches.jpg (")
    for name in ("matches.jpg", "cv_matches.jpg"):
        assert os.path.getsize(tmp_path / name) > 0


def test_opencv_cross_match(pngs, tmp_path, capsys):
    from sift_features_tpu_torch.examples import opencv_cross_match

    if not hasattr(cv2, "SIFT_create"):
        pytest.skip("cv2 has no SIFT")
    a, b, _ = pngs
    path = str(tmp_path / "x.jpg")
    assert opencv_cross_match.main([a, b, path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"cv2: \d+ keypoints, ours: \d+", out[0])
    m = re.fullmatch(r"mutual cross-implementation matches: (\d+)", out[1])
    assert m and int(m.group(1)) > 5
    assert out[2] == f"wrote {path}" and os.path.getsize(path) > 0


def test_build_index(pngs, tmp_path, capsys):
    from sift_features_tpu_torch.examples import build_index

    a, _, _ = pngs
    save = str(tmp_path / "db")
    assert build_index.main([a, "--device", "cpu", "--save", save]) == 0
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"indexed a\.png: \d+ rows total \(\d+\.\ds\)", out[0])
    m = re.fullmatch(r"query crop of a\.png: \d+ kps, (\d+) cross-checked "
                     r"matches, per-frame \{0: (\d+)\}", out[1])
    assert m and int(m.group(1)) == int(m.group(2)) > 5
    assert out[2] == "fraction matched into its own frame: 1.000"
    assert out[3] == f"saved shards to {save}"
    assert any(f.startswith("shard_") for f in os.listdir(save))
