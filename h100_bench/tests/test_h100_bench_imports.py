"""What the harness loads: nothing of JAX or of the JAX package anywhere
(top-level module names compared whole, since the program's name begins
with the JAX package's), and nothing of the program in the reference. Each
check runs in a fresh process, so that what the tests themselves load does
not count; `run.py` refuses to run without a card."""

import glob
import json
import os
import subprocess
import sys

from h100_bench_support import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "sift_features_tpu"}


def _loaded_after(code: str) -> set:
    """Top-level names of the modules loaded after running code."""
    prog = (f"import sys\nsys.path.insert(0, {REPO!r})\n{code}\n"
            "import json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=300, cwd=REPO,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = [os.path.splitext(os.path.relpath(f, REPO))[0].replace(os.sep, ".")
            for f in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)
            if "tests" not in os.path.relpath(f, BENCH).split(os.sep)
            and "." not in os.path.basename(f)[:-3]]
    readers = glob.glob(os.path.join(BENCH, "metrics", "*.py"))
    code = "\n".join(f"import {m}" for m in sorted(mods)) + "\n"
    code += "import importlib.util\n"
    for i, r in enumerate(readers):
        code += (f"s = importlib.util.spec_from_file_location('r{i}', {r!r}); "
                 "m = importlib.util.module_from_spec(s); s.loader.exec_module(m)\n")
    code += "import sift_features_tpu_torch, sift_features_tpu_torch.service\n"
    code += "import sift_features_tpu_torch.models.extractor\n"
    loaded = _loaded_after(code)
    assert "h100_bench" in loaded and "sift_features_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    code = ("import numpy as np\n"
            "from h100_bench.reference import compare, frame_rows, matcher\n"
            "from h100_bench.reference.pixel_ops import SiftParams\n"
            "img = (np.random.default_rng(0).random((48, 64)) * 255).astype(np.uint8)\n"
            "kp, d = frame_rows(img, {})\n"
            "matcher.match(d, d)\n")
    loaded = _loaded_after(code)
    assert "h100_bench" in loaded
    assert not loaded & (FORBIDDEN | {"sift_features_tpu_torch"})


def test_run_refuses_without_a_card():
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "index_query", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=REPO,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
