"""K5: 36-bin orientation histograms with in-kernel peaks.

Replaces sift_features_tpu/ops/pallas/orientation_packed.py:
orientation_histograms_packed_masked (`_kernel`), dispatched per scale
bucket by ops/pallas/orientation_kernel.py:orientation_histograms_masked.
One launch serves every scale: the bucket radius {1: 10, 2: 13, 3: 16} is
only a buffer bound, and the per-keypoint radius round_half_away(4.5 *
scale) is at most R_ORI_MAX = 16 on the main path. The CUDA kernel is
csrc/orientation.cu; its note gives the bound and the design.

Outputs per lane: the RAW histogram (smoothing runs outside, as `_smooth`
does in the JAX extractor), the first N_PEAKS_CAP peak angles of the smoothed
histogram in ascending-bin order, and the true (uncapped) peak count. Dead
lanes are all zero.

Summation order, kernel and plain version alike: window row r sums its
samples over columns in ascending order, then each bin sums the rows in
ascending order. Masked samples add nothing (the plain version adds exact
zeros). With f32 arithmetic and no FMA contraction the two agree bit for
bit on the card; the JAX kernel sums in another order and uses an f32 exp,
so the port holds it to a stated tolerance instead.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...config import SiftConfig
from ..orientation import R_ORI_MAX, orientation_peaks, smooth, window_index
from ..util import atan2_f32, f32, round_half_away, sqrt_f32
from . import build

F32 = torch.float32
N_PEAKS_CAP = 4   # orientation_packed.py:65


def _params(cfg: SiftConfig):
    """(radius factor 3 * lambda_ori, bin step n_bins / 2pi) as f32."""
    return (np.float32(3.0) * np.float32(cfg.lambda_ori),
            np.float32(cfg.n_orientation_bins)
            / (np.float32(np.pi) * np.float32(2.0)))



def first_peaks(hist_smoothed: torch.Tensor, cfg: SiftConfig):
    """(K, n_bins) smoothed histograms -> (angles (K, N_PEAKS_CAP) of the
    first emitted bins in ascending order, zero past the count; true peak
    count (K,) int32)."""
    angles, emit = orientation_peaks(hist_smoothed, cfg)
    rank = torch.cumsum(emit.to(torch.int32), dim=1)
    out = []
    for t in range(N_PEAKS_CAP):
        sel = emit & (rank == t + 1)
        out.append(torch.where(sel, angles, torch.zeros_like(angles)).sum(1))
    return torch.stack(out, 1), rank[:, -1].to(torch.int32)


def orientation_plain(gauss_flat: torch.Tensor, plane, y, x, kp_scale, live,
                      h: int, w: int, pad: int, cfg: SiftConfig,
                      chunk: int = 8192):
    """Plain version of K5. gauss_flat (L, Hp, Wp); plane/y/x (K,) (y, x
    unpadded octave coordinates); kp_scale (K,) f32; live (K,) bool."""
    n_bins = cfg.n_orientation_bins
    raw = torch.zeros((plane.shape[0], n_bins), dtype=F32,
                      device=gauss_flat.device)
    idx = torch.nonzero(live.bool())[:, 0]      # dead lanes stay zero
    for c0 in range(0, idx.shape[0], chunk):
        sel = idx[c0:c0 + chunk]
        raw[sel] = _raw_hist(gauss_flat, plane[sel], y[sel], x[sel],
                             kp_scale[sel], live[sel], h, w, pad, cfg)
    angles, n_peaks = first_peaks(smooth(raw), cfg)
    dead = ~live.bool()
    angles = torch.where(dead[:, None], torch.zeros_like(angles), angles)
    n_peaks = torch.where(dead, torch.zeros_like(n_peaks), n_peaks)
    return raw, angles, n_peaks


def _raw_hist(gauss_flat, plane, y, x, kp_scale, live, h, w, pad, cfg):
    R = R_ORI_MAX
    n_bins = cfg.n_orientation_bins
    L, hp, wp = gauss_flat.shape
    radius_factor, bstep = _params(cfg)
    plane = torch.clamp(plane.long(), 0, L - 1)
    y = torch.clamp(y.long(), 0, h - 1)
    x = torch.clamp(x.long(), 0, w - 1)
    radius = round_half_away(f32(radius_factor, kp_scale) * kp_scale)
    sigma = f32(cfg.lambda_ori, kp_scale) * kp_scale
    gws = f32(-1.0, sigma) / (f32(2.0, sigma) * sigma * sigma)

    lin = window_index(y, x, pad, R, wp) + plane[:, None, None] * hp * wp
    win = gauss_flat.reshape(-1)[lin]                       # (K, 2R+3, 2R+3)
    gx = win[:, 1:-1, 2:] - win[:, 1:-1, :-2]
    gy = win[:, :-2, 1:-1] - win[:, 2:, 1:-1]

    offs = torch.arange(-R, R + 1, device=plane.device)
    dyy = offs[None, :, None]
    dxx = offs[None, None, :]
    y_img = y[:, None, None] + dyy
    x_img = x[:, None, None] + dxx
    rad = radius[:, None, None]
    ok = ((dyy.abs().to(F32) <= rad) & (dxx.abs().to(F32) <= rad)
          & (y_img >= 1) & (y_img <= h - 2) & (x_img >= 1) & (x_img <= w - 2)
          & live.bool()[:, None, None])
    d2 = (dyy * dyy + dxx * dxx).to(F32)
    weights = torch.exp((d2 * gws[:, None, None]).double()).to(F32)
    mags = sqrt_f32(gx * gx + gy * gy)
    b = round_half_away(f32(bstep, gx) * atan2_f32(gy, gx)).long()
    b = torch.where(b >= n_bins, b - n_bins, b)
    b = torch.where(b < 0, b + n_bins, b)
    contrib = torch.where(ok, weights * mags, torch.zeros_like(mags))

    n = 2 * R + 1
    rowhist = torch.zeros((plane.shape[0], n, n_bins), dtype=F32,
                          device=plane.device)
    for c in range(n):                       # ascending columns per row
        rowhist.scatter_add_(2, b[:, :, c:c + 1], contrib[:, :, c:c + 1])
    raw = rowhist[:, 0]
    for r in range(1, n):                    # ascending rows per bin
        raw = raw + rowhist[:, r]
    return raw


def orientation_hist_peaks(gauss_flat: torch.Tensor, plane, y, x, kp_scale,
                           live, h: int, w: int, pad: int, cfg: SiftConfig):
    """K5 wrapper -> (raw hist (K, n_bins) f32, angles (K, N_PEAKS_CAP) f32,
    n_peaks (K,) int32). The plain version for a CPU tensor; the CUDA kernel
    for a CUDA tensor (or an error)."""
    if gauss_flat.device.type == "cpu":
        return orientation_plain(gauss_flat, plane, y, x, kp_scale, live, h, w,
                                 pad, cfg)
    L, hp, wp = gauss_flat.shape
    plane = torch.clamp(plane, 0, L - 1).to(torch.int32).contiguous()
    y = torch.clamp(y, 0, h - 1).to(torch.int32).contiguous()
    x = torch.clamp(x, 0, w - 1).to(torch.int32).contiguous()
    live = live.to(torch.int32).contiguous()
    kp_scale = kp_scale.to(F32).contiguous()
    build.require_cuda("orientation_hist_peaks", gauss_flat, plane, y, x,
                       kp_scale, live)
    K = plane.shape[0]
    n_bins = cfg.n_orientation_bins
    kw = dict(device=gauss_flat.device)
    hist = torch.empty((K, n_bins), dtype=F32, **kw)
    ang = torch.empty((K, N_PEAKS_CAP), dtype=F32, **kw)
    npk = torch.empty((K,), dtype=torch.int32, **kw)
    radius_factor, bstep = _params(cfg)
    fn = build.bind("orientation", "sift_orientation",
                    [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                    + [ctypes.c_int] * 6 + [ctypes.c_float] * 4
                    + [ctypes.c_void_p])
    rc = fn(build.ptr(gauss_flat), hp, wp, build.ptr(plane), build.ptr(y),
            build.ptr(x), build.ptr(kp_scale), build.ptr(live), build.ptr(hist),
            build.ptr(ang), build.ptr(npk), K, h, w, pad, n_bins, N_PEAKS_CAP,
            float(radius_factor), float(np.float32(cfg.lambda_ori)),
            float(np.float32(cfg.orientation_localmax_ratio)), float(bstep),
            build.stream_ptr(gauss_flat))
    build.check(rc, "K5 orientation")
    build.count_launch("K5")
    return hist, ang, npk
