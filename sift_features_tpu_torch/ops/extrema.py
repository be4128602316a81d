"""DoG extrema detection and subpixel refinement in plain PyTorch.

Counterpart of sift_features_tpu/ops/extrema.py (reference
point_is_local_extremum, interpolate_extremum, extremum_contrast and
extremum_is_on_edge, lib.rs:437-653). Quirks kept: the |v| > 0 prefilter
with ties allowed (`v > 0 & v >= max`, `v < 0 & v <= min`), the edge test
at the refined integer position, Rust half-away rounding of the steps.

`newton_from_cubes` keeps the JAX op order exactly; the K3/K4 CUDA kernels
(csrc/refine.cu) carry the same sequence. `refine` is the plain version of
K3 and also the tiny-octave path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DEFAULT_CONFIG, SiftConfig
from ..utils.compact import compact_indices, compact_words
from .util import f32, rust_round

F32 = torch.float32

# Output row layout of the refine kernels (K3 walk / the K4-driven loop),
# the 16 columns of the JAX walk kernel (refine_walk_kernel.py:37-40):
#   0 ok | 1 s | 2 y | 3 x | 4 off_s | 5 off_y | 6 off_x | 7 response |
#   8 keep | 9 escaped (always 0 here) | 10.. unused
# Result columns 4-8 are zero on lanes that did not converge.
ROW_COLS = 16


def extrema_mask(dog: torch.Tensor, cfg: SiftConfig = DEFAULT_CONFIG,
                 bounds=None) -> torch.Tensor:
    """(..., S+2, H, W) f32 -> (..., S, H, W) bool discrete-extremum mask
    inside bounds = (y0, y1, x0, x1) (default: the image_border interior)."""
    *lead, n_p, H, W = dog.shape
    n_s = cfg.scales_per_octave
    b = cfg.image_border
    y0, y1, x0, x1 = bounds if bounds is not None else (b, H - b, b, W - b)
    out_shape = (*lead, n_s, H, W)
    if y1 <= y0 or x1 <= x0:
        return torch.zeros(out_shape, dtype=torch.bool, device=dog.device)
    d = dog.reshape(-1, 1, n_p, H, W)
    mx = F.max_pool3d(d, 3, stride=1, padding=(0, 1, 1)).reshape(out_shape)
    mn = -F.max_pool3d(-d, 3, stride=1, padding=(0, 1, 1)).reshape(out_shape)
    v = dog[..., 1:n_s + 1, :, :]
    m = ((v > 0.0) & (v >= mx)) | ((v < 0.0) & (v <= mn))
    ys = torch.arange(H, device=dog.device)
    xs = torch.arange(W, device=dog.device)
    m &= ((ys >= y0) & (ys < y1))[:, None]
    m &= ((xs >= x0) & (xs < x1))[None, :]
    return m


def _decode(idx: torch.Tensor, H: int, W: int):
    s = (idx // (H * W) + 1).to(torch.int32)
    rem = idx % (H * W)
    return s, (rem // W).to(torch.int32), (rem % W).to(torch.int32)


def find_candidates(mask: torch.Tensor, k_max: int):
    """(..., S, H, W) bool -> scan-order candidate buffers s, y, x (...,
    k_max) int32 (s is the DoG plane index, 1-based), valid, true count."""
    *lead, S, H, W = mask.shape
    idx, valid, count = compact_indices(mask.reshape(*lead, -1), k_max)
    return (*_decode(idx, H, W), valid, count)


def find_candidates_words(words: torch.Tensor, k_max: int):
    """find_candidates from the bit-packed mask of K2: words (..., S, H,
    W // 32) int32, bit j of word (s, y, w) = mask at (s, y, 32w + j)."""
    *lead, S, H, W32 = words.shape
    idx, valid, count = compact_words(words.reshape(*lead, -1), k_max)
    return (*_decode(idx, H, W32 * 32), valid, count)



def newton_from_cubes(c: torch.Tensor, cfg: SiftConfig):
    """Newton offsets, interval flag, interpolated contrast and edge-test
    keep from (K, 27) cubes, cube index (ds*3 + dy)*3 + dx (lib.rs:525-653,
    the JAX op order)."""
    def q(ds, dy, dx):
        return c[:, (ds * 3 + dy) * 3 + dx]

    two, four = f32(2.0, c), f32(4.0, c)
    v = q(1, 1, 1)
    v2 = v * two
    g1 = (q(2, 1, 1) - q(0, 1, 1)) / two
    g2 = (q(1, 2, 1) - q(1, 0, 1)) / two
    g3 = (q(1, 1, 2) - q(1, 1, 0)) / two
    h11 = q(2, 1, 1) + q(0, 1, 1) - v2
    h12 = (q(2, 2, 1) - q(2, 0, 1) - q(0, 2, 1) + q(0, 0, 1)) / four
    h13 = (q(2, 1, 2) - q(2, 1, 0) - q(0, 1, 2) + q(0, 1, 0)) / four
    h22 = q(1, 2, 1) + q(1, 0, 1) - v2
    h33 = q(1, 1, 2) + q(1, 1, 0) - v2
    h23 = (q(1, 2, 2) - q(1, 2, 0) - q(1, 0, 2) + q(1, 0, 0)) / four

    det = (h11 * h22 * h33 - h11 * h23 * h23 - h12 * h12 * h33
           + two * h12 * h13 * h23 - h13 * h13 * h22)
    hinv11 = (h22 * h33 - h23 * h23) / det
    hinv12 = (h13 * h23 - h12 * h33) / det
    hinv13 = (h12 * h23 - h13 * h22) / det
    hinv22 = (h11 * h33 - h13 * h13) / det
    hinv23 = (h12 * h13 - h11 * h23) / det
    hinv33 = (h11 * h22 - h12 * h12) / det
    off_s = -(hinv11 * g1 + hinv12 * g2 + hinv13 * g3)
    off_x = -(hinv13 * g1 + hinv23 * g2 + hinv33 * g3)
    off_y = -(hinv12 * g1 + hinv22 * g2 + hinv23 * g3)
    ok = (torch.abs(off_s) < 0.5) & (torch.abs(off_x) < 0.5) & (torch.abs(off_y) < 0.5)
    zero = f32(0.0, c)
    off_s = torch.where(torch.isnan(off_s), zero, off_s)
    off_y = torch.where(torch.isnan(off_y), zero, off_y)
    off_x = torch.where(torch.isnan(off_x), zero, off_x)

    interp = off_s * g1 + off_y * g2 + off_x * g3
    contrast = v + interp / two
    keep_contrast = (torch.abs(contrast) * f32(cfg.scales_per_octave, c)
                     > f32(cfg.contrast_threshold, c))
    tr = h33 + h22
    edet = h33 * h22 - h23 * h23
    thr = f32(cfg.edge_threshold, c)
    thr1 = thr + f32(1.0, c)
    on_edge = (edet <= 0.0) | ((tr * tr * thr) > (thr1 * thr1) * edet)

    big = f32(1e9, c)

    def step(o):
        return torch.clamp(rust_round(o), -big, big).to(torch.int32)

    return {
        "off_s": off_s, "off_y": off_y, "off_x": off_x, "ok": ok,
        "response": torch.abs(contrast), "keep": keep_contrast & ~on_edge,
        "step_s": step(off_s), "step_y": step(off_y), "step_x": step(off_x),
    }


_CUBE = [(ds, dy, dx) for ds in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


@functools.lru_cache(maxsize=None)
def _cube_offsets(H: int, W: int, device: torch.device) -> torch.Tensor:
    return torch.tensor([(ds * H + dy) * W + dx for ds, dy, dx in _CUBE],
                        device=device)


def gather_cubes(dog_flat: torch.Tensor, p, y, x) -> torch.Tensor:
    """(K,) plane/row/column indices -> (K, 27) cubes from dog_flat (P, H,
    W); positions are clamped to [1, P-2] x [1, H-2] x [1, W-2]."""
    P, H, W = dog_flat.shape
    p = torch.clamp(p.long(), 1, P - 2)
    y = torch.clamp(y.long(), 1, H - 2)
    x = torch.clamp(x.long(), 1, W - 2)
    off = _cube_offsets(H, W, dog_flat.device)
    lin = ((p * H + y) * W + x)[:, None] + off
    return dog_flat.reshape(-1)[lin]


def newton_step(dog_flat, p, y, x, active, cfg: SiftConfig) -> torch.Tensor:
    """One masked Newton step (plain version of K4): (K, 16) rows
    ok | step_s | step_y | step_x | off_s | off_y | off_x | response | keep,
    zero on inactive lanes. p is the plane index into dog_flat."""
    f = newton_from_cubes(gather_cubes(dog_flat, p, y, x), cfg)
    cols = [f["ok"].to(F32), f["step_s"].to(F32), f["step_y"].to(F32),
            f["step_x"].to(F32), f["off_s"], f["off_y"], f["off_x"],
            f["response"], f["keep"].to(F32)]
    out = torch.zeros((p.shape[0], ROW_COLS), dtype=F32, device=dog_flat.device)
    out[:, :len(cols)] = torch.stack(cols, dim=1)
    return torch.where(active.bool()[:, None], out, torch.zeros_like(out))


def refine_loop(step_fn, s0, y0, x0, valid, pad: int, h: int, w: int,
                cfg: SiftConfig, plane_off=None) -> torch.Tensor:
    """The <=max_interpolation_steps Newton loop (lib.rs:508-603) over a
    one-step function, with the bookkeeping of the JAX refine: `ok` before
    the NaN offsets are zeroed, steps applied to active lanes that did not
    converge, a lane dies when it leaves [border, size-border) or the scale
    range [1, S]. Positions are in padded coordinates (unpadded + pad);
    plane_off (K,) offsets the DoG plane index (frame * planes). Returns
    (K, 16) rows in the ROW_COLS layout."""
    S = cfg.scales_per_octave
    b = cfg.image_border
    s, y, x = s0.int(), y0.int(), x0.int()
    K = s.shape[0]
    dev = s.device
    converged = torch.zeros(K, dtype=torch.bool, device=dev)
    dead = ~valid.bool()
    fields = torch.zeros((K, 5), dtype=F32, device=dev)
    for _ in range(cfg.max_interpolation_steps):
        active = ~(converged | dead)
        p = torch.clamp(s, 1, S)
        if plane_off is not None:
            p = p + plane_off
        out = step_fn(p, y, x, active)
        ok_here = out[:, 0] > 0
        newly = active & ok_here
        converged |= newly
        fields = torch.where(newly[:, None], out[:, 4:9], fields)
        mv = active & ~ok_here
        s = torch.where(mv, s + out[:, 1].int(), s)
        y = torch.where(mv, y + out[:, 2].int(), y)
        x = torch.where(mv, x + out[:, 3].int(), x)
        bad = ((s < 1) | (s > S)
               | (x - pad < b) | (x - pad >= w - b)
               | (y - pad < b) | (y - pad >= h - b))
        dead |= mv & bad
    rows = torch.zeros((K, ROW_COLS), dtype=F32, device=dev)
    rows[:, 0] = converged.to(F32)
    rows[:, 1] = s.to(F32)
    rows[:, 2] = y.to(F32)
    rows[:, 3] = x.to(F32)
    rows[:, 4:9] = fields
    return rows


def refine(dog_flat: torch.Tensor, s0, y0, x0, valid, pad: int, h: int,
           w: int, cfg: SiftConfig = DEFAULT_CONFIG,
           plane_off=None) -> torch.Tensor:
    """Plain refinement (the plain version of K3, and the tiny-octave
    path): dog_flat (P, H_pad, W_pad), positions in padded coordinates."""
    def step(p, y, x, active):
        return newton_step(dog_flat, p, y, x, active, cfg)

    return refine_loop(step, s0, y0, x0, valid, pad, h, w, cfg, plane_off)


def rows_to_fields(rows: torch.Tensor) -> dict:
    """Split (K, 16) refine rows into named fields (s/y/x as int32)."""
    return {
        "ok": rows[:, 0] > 0, "s": rows[:, 1].int(), "y": rows[:, 2].int(),
        "x": rows[:, 3].int(), "off_s": rows[:, 4], "off_y": rows[:, 5],
        "off_x": rows[:, 6], "response": rows[:, 7],
        "keep": (rows[:, 8] > 0) & (rows[:, 0] > 0),
    }
