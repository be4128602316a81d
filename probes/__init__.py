"""Measurement probes of the port's kernels: built on demand, on no path.

`chip_smoke.py` prints their times beside the kernels they probe; no
entry point of `sift_features_tpu_torch` reaches them and no launch of
theirs is counted. Each is compiled with the package's nvcc flags into
`build/probes/` of the checkout, named by a hash of its source.

- `k2_stream(dog, bounds, cfg)`: probes/k2_stream.cu, a kernel that reads
  once the DoG values K2 needs and writes K2's words with no stencil. Its
  time is what K2's reads cost at the rate the card gives this pattern.
- `k5_const_math(*args, **kw)`: K5 (csrc/orientation.cu) with the
  per-sample math (the Gaussian weight table, magnitude, angle and bin)
  replaced by constants. It keeps the window reads, the loop and the
  ordered adds, and its outputs mean nothing. It is built from a copy of
  K5's source with two blocks of lines replaced, and raises if K5's source
  no longer holds them as written here.

K3's probe line (`chip_smoke.py:k3_probe_line`) needs no copy of a
kernel: it times K3's own wrapper with every lane dead and with the walk
cut to one and to two Newton steps.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from unittest import mock

import torch

from sift_features_tpu_torch.ops.kernels import build
from sift_features_tpu_torch.ops.kernels import orientation as k5

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(os.path.dirname(build.BUILD_DIR), "probes")

_libs: dict[str, ctypes.CDLL] = {}

# K5's per-sample math, as csrc/orientation.cu writes it (compared line by
# line, stripped), and what the probe puts in its place
K5_WEIGHT_TABLE = """\
for (int i = lane; i < (ri + 1) * (ri + 2) / 2; i += 32) {
int b = (int)((sqrtf(8.0f * (float)i + 1.0f) - 1.0f) * 0.5f);
int a = i - b * (b + 1) / 2;
tab[i] = exp_f32_via_f64((float)(a * a + b * b) * gws);
}"""
K5_SAMPLE = """\
int ay = abs(dy), ax = abs(dx);
int lo = ay < ax ? ay : ax, hi = ay < ax ? ax : ay;
float weight = tab[hi * (hi + 1) / 2 + lo];
float mag = sqrtf(gx * gx + gy * gy);
int b = (int)round_half_away(bstep * atan2_f32<true>(gy, gx));
if (b >= n_bins) b -= n_bins;
if (b < 0) b += n_bins;
v = weight * mag;
bn = (unsigned)b;"""
K5_SAMPLE_CONST = """\
v = gx + gy;
bn = c < n_bins ? c : n_bins - 1;"""


def _replace_lines(src: str, old: str, new: str) -> str:
    """src with the one run of lines equal to old's (each stripped)
    replaced by new's lines, at the first old line's indentation."""
    lines = src.split("\n")
    want = old.split("\n")
    hits = [i for i in range(len(lines) - len(want) + 1)
            if all(lines[i + j].strip() == w for j, w in enumerate(want))]
    if len(hits) != 1:
        raise RuntimeError(f"probes: {len(hits)} matches in K5's source for "
                           f"{want[0]!r}; update probes/__init__.py")
    i = hits[0]
    pad = lines[i][:len(lines[i]) - len(lines[i].lstrip())]
    rep = [pad + ln for ln in new.split("\n")] if new else []
    return "\n".join(lines[:i] + rep + lines[i + len(want):])


def _library(name: str, source) -> ctypes.CDLL:
    """The probe `name`, built at its first call from the text source()
    returns (it may include common.cuh), loaded; later calls return it
    without reading any file, so a timed call costs its launch only."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = source()
    with open(os.path.join(build.CSRC, "common.cuh"), "rb") as f:
        h = hashlib.sha256(src.encode() + f.read()
                           + " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(OUT_DIR, f"lib{name}_{h}.so")
    if not os.path.exists(so):
        os.makedirs(OUT_DIR, exist_ok=True)
        cu = os.path.join(OUT_DIR, f"{name}_{h}.cu")
        with open(cu, "w") as f:
            f.write(src)
        tmp = f"{so}.tmp{os.getpid()}"
        p = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC,
                            "-o", tmp, cu], capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for probe {name}:\n{p.stdout}{p.stderr}")
        os.replace(tmp, so)
    lib = _libs[name] = ctypes.CDLL(so)
    return lib


def _k2_stream_source() -> str:
    with open(os.path.join(HERE, "k2_stream.cu")) as f:
        return f.read()


def _k5_const_math_source() -> str:
    with open(os.path.join(build.CSRC, "orientation.cu")) as f:
        src = f.read()
    src = _replace_lines(src, K5_WEIGHT_TABLE, "")
    return _replace_lines(src, K5_SAMPLE, K5_SAMPLE_CONST)


def k2_stream(dog: torch.Tensor, bounds, cfg) -> torch.Tensor:
    """dog (B, S+2, Hp, Wp) on the card, K2's bounds (y0, y1, x0, x1) ->
    (B, S, Hp, Wp // 32) int32 words, written at the rows read."""
    build.require_cuda("k2_stream", dog)
    lib = _library("k2_stream", _k2_stream_source)
    fn = lib.sift_k2_stream_probe
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    b, _, hp, wp = dog.shape
    n_s = cfg.scales_per_octave
    words = torch.empty((b, n_s, hp, wp // 32), dtype=torch.int32, device=dog.device)
    y0, y1, x0, x1 = (int(v) for v in bounds)
    build.check(fn(build.ptr(dog), build.dtype_code("k2_stream", dog), build.ptr(words),
                   b, n_s, hp, wp, y0, y1, x0, x1, build.stream_ptr(dog)),
                "k2_stream probe")
    return words


def k5_const_math(gauss_flat, plane, y, x, kp_scale, live, *args, **kw):
    """K5's arguments (those of orientation_hist_peaks) -> its three
    outputs from the constant-math copy of its kernel (meaningless)."""
    lib = _library("k5_const_math", _k5_const_math_source)
    # K5's own wrapper code, bound to the copy's library
    with mock.patch.dict(build._libs, {"orientation": lib}):
        out, rc = k5._launch(gauss_flat, plane, y, x, kp_scale, live, None, *args,
                             name="k5_const_math", **kw)
    build.check(rc, "k5_const_math probe")
    return out
