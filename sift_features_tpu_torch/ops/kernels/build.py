"""Build, load and count the port's CUDA kernels.

Every kernel lives in one `csrc/<name>.cu` file with a plain C interface
and is compiled by `nvcc` into its own shared library under
`build/torch_kernels/` of the checkout, at the first call that needs it,
and loaded with ctypes (no PyTorch headers, so a build takes seconds).
The extractor's sources (`SOURCES`) build together, one `nvcc` process
each, so a fresh checkout pays for one parallel build; the matcher's
(`matcher.cu`, M1) builds alone, since a query runs no extractor kernel.
Libraries are named by a hash of their sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. A failed build raises with nvcc's output; nothing
runs without its kernel.

`LAUNCHES` counts, per kernel, the calls of its wrapper that launched it
on the card (the CPU path of a wrapper counts nothing). A launch on bf16
planes (the storage modes) counts under its own name, the kernel's name
with a suffix (`K2:bf16`, `K1:split`, ...).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                         "torch_kernels")
SOURCES = ("pyramid", "extrema", "refine", "orientation", "descriptor")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-ftz=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {}

# the plane types a kernel takes, as the C entries code them
# (csrc/common.cuh: SIFT_F32, SIFT_BF16)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_launches() -> None:
    LAUNCHES.clear()


def dtype_code(name: str, t: torch.Tensor) -> int:
    """The C code of t's dtype; raises for a type no kernel takes."""
    code = DTYPE_CODE.get(t.dtype)
    if code is None:
        raise ValueError(f"{name}: planes must be float32 or bfloat16, not "
                         f"{t.dtype}")
    return code


def form(kernel: str, t: torch.Tensor) -> str:
    """The launch-count name of `kernel` on planes t: the name itself for
    f32, with ":bf16" for bf16."""
    return kernel if t.dtype == torch.float32 else f"{kernel}:bf16"


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for fn in (f"{name}.cu", "common.cuh"):
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library at once (one nvcc per source, all
    started together); returns {name: nvcc output} for those built.
    Raises RuntimeError with nvcc's output if any build fails."""
    todo = [n for n in names if not os.path.exists(_lib_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = _lib_path(n) + f".tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        logs[n] = out
        if p.returncode != 0:
            failed.append(n)
        else:
            os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it first if it is
    missing: with every missing extractor source if it is one of them."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not os.path.exists(_lib_path(name)):
                build_all(SOURCES if name in SOURCES else (name,))
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib


def bind(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry of library `name` with its argument types; every entry
    returns a cudaError_t as int."""
    f = getattr(library(name), fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError_t {rc}")


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one
    device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
