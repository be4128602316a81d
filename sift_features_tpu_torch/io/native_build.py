"""Build the native C++ tiers (`native/*.cpp` at the repo root) for the port.

Each source is compiled by g++ with the flags of the JAX package's bindings
into `build/torch_native/` of the checkout, at the first call that needs
it. The library is named by a hash of its source and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is; it is written
under a temporary name and moved into place, so processes that build at
once never load a half-written file. A failed build raises with g++'s
output: nothing falls back to another decoder or to NumPy.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
NATIVE_DIR = os.path.join(_ROOT, "native")
BUILD_DIR = os.path.join(_ROOT, "build", "torch_native")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-ljpeg", "-lpthread")


def build(src: str, error: type[Exception]) -> str:
    """The path of the shared library of C++ source `src`, compiled if it
    is missing. Raises `error` with g++'s output if the build fails, or
    with the OS error if the source cannot be read."""
    try:
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read())
    except OSError as e:
        raise error(f"cannot read {src}: {e}") from e
    digest.update(" ".join(CXX_FLAGS + LIBS).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    so = os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, src, *LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except OSError as e:
        raise error(f"build failed: {e}") from e
    except subprocess.CalledProcessError as e:
        raise error(f"build failed: {e.stderr}") from e
    os.replace(tmp, so)
    return so
