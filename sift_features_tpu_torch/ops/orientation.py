"""Orientation assignment in plain PyTorch.

Counterpart of sift_features_tpu/ops/orientation.py (reference
gradient_direction_histogram and the peak loop, lib.rs:371-433,655-757):
36-bin gradient histogram over radius round(4.5 * kp_scale), Gaussian
weighted, smoothed once with [1,4,6,4,1]/16, one keypoint per bin that is a
strict local maximum and >= 0.8 x the global maximum, parabolic
interpolation, angle = 360 - 10 * bin.

`orientation_histograms` is the tiny-octave path and keeps the JAX XLA
path's numerics (f64 atan2 and exp, as under x64). The main path's window
math is the K5 kernel (ops/kernels/orientation.py), which uses the Cephes
f32 atan2 like the TPU kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, SiftConfig
from .util import f32, rust_round, sqrt_f32

F32 = torch.float32

R_ORI_MAX = 16



def kp_scale_of(s, off_s, cfg: SiftConfig = DEFAULT_CONFIG):
    """Keypoint sigma in octave coords (lib.rs:372-374):
    sigma_min * 2^((s + off) / S) * 2, the power through f64 exp2."""
    e = (s.to(F32) + off_s) / f32(cfg.scales_per_octave, off_s)
    pw = torch.exp2(e.double()).to(F32)
    return f32(cfg.sigma_min, off_s) * pw * f32(2.0, off_s)


def window_index(y, x, pad: int, r: int, wp: int):
    """Flat in-plane offsets (K, 2r+3, 2r+3) of the window centred on the
    unpadded (y, x), including the one-pixel gradient halo."""
    offs = torch.arange(-r - 1, r + 2, device=y.device)
    rows = y.long()[:, None] + pad + offs
    cols = x.long()[:, None] + pad + offs
    return rows[:, :, None] * wp + cols[:, None, :]


def smooth(raw: torch.Tensor) -> torch.Tensor:
    """OpenCV's circular [1,4,6,4,1]/16 smoothing, applied once
    (lib.rs:737-756), in the JAX op order."""
    rm2 = torch.roll(raw, 2, dims=1)
    rm1 = torch.roll(raw, 1, dims=1)
    rp1 = torch.roll(raw, -1, dims=1)
    rp2 = torch.roll(raw, -2, dims=1)
    return ((rm2 + rp2) * f32(1.0 / 16.0, raw)
            + (rm1 + rp1) * f32(4.0 / 16.0, raw)
            + raw * f32(6.0, raw) / f32(16.0, raw))


def orientation_histograms(gauss_padded: torch.Tensor, h: int, w: int,
                           s, y, x, kp_scale, valid,
                           cfg: SiftConfig = DEFAULT_CONFIG, pad: int = 17):
    """Smoothed (K, 36) histograms. gauss_padded (L, H+2pad.., W+2pad..),
    s the level index into it, (y, x) unpadded octave coordinates."""
    n_bins = cfg.n_orientation_bins
    R = R_ORI_MAX
    L, hp, wp = gauss_padded.shape
    s = torch.clamp(s.long(), 0, L - 1)
    y = torch.clamp(y.long(), 0, h - 1)
    x = torch.clamp(x.long(), 0, w - 1)
    radius = rust_round(f32(np.float32(3.0) * np.float32(cfg.lambda_ori), kp_scale)
                        * kp_scale)
    sigma = f32(cfg.lambda_ori, kp_scale) * kp_scale
    gws = f32(-1.0, sigma) / (f32(2.0, sigma) * sigma * sigma)

    lin = window_index(y, x, pad, R, wp) + s.long()[:, None, None] * hp * wp
    win = gauss_padded.reshape(-1)[lin]                    # (K, Wn, Wn)
    dx = win[:, 1:-1, 2:] - win[:, 1:-1, :-2]
    dy = win[:, :-2, 1:-1] - win[:, 2:, 1:-1]

    offs = torch.arange(-R, R + 1, device=s.device)
    dyy = offs[None, :, None]
    dxx = offs[None, None, :]
    y_img = y.long()[:, None, None] + dyy
    x_img = x.long()[:, None, None] + dxx
    rad = radius[:, None, None]
    ok = ((dyy.abs() <= rad) & (dxx.abs() <= rad)
          & (y_img >= 1) & (y_img <= h - 2) & (x_img >= 1) & (x_img <= w - 2)
          & valid.bool()[:, None, None])
    d2 = (dyy * dyy + dxx * dxx).to(F32)
    weights = torch.exp((d2 * gws[:, None, None]).double()).to(F32)
    mags = sqrt_f32(dx * dx + dy * dy)
    oris = torch.atan2(dy.double(), dx.double()).to(F32)
    bstep = np.float32(n_bins) / (np.float32(np.pi) * np.float32(2.0))
    b = rust_round(f32(bstep, oris) * oris).long()
    b = torch.where(b >= n_bins, b - n_bins, b)
    b = torch.where(b < 0, b + n_bins, b)
    contrib = torch.where(ok, weights * mags, torch.zeros_like(mags))
    raw = torch.zeros((s.shape[0], n_bins), dtype=F32, device=s.device)
    raw.scatter_add_(1, b.reshape(s.shape[0], -1), contrib.reshape(s.shape[0], -1))
    return smooth(raw)


def orientation_peaks(hist: torch.Tensor, cfg: SiftConfig = DEFAULT_CONFIG):
    """(K, n_bins) smoothed histograms -> (angles (K, n_bins) f32, emit
    (K, n_bins) bool), one keypoint per qualifying bin (lib.rs:394-431)."""
    n_bins = cfg.n_orientation_bins
    hmax = torch.amax(hist, dim=1, keepdim=True)
    thr = hmax * f32(cfg.orientation_localmax_ratio, hist)
    hm = torch.roll(hist, 1, dims=1)
    hp = torch.roll(hist, -1, dims=1)
    emit = (hist > hm) & (hist > hp) & (hist >= thr)
    interp = (hm - hp) / (hm - f32(2.0, hist) * hist + hp)
    k = torch.arange(n_bins, dtype=F32, device=hist.device)[None, :]
    bin_f = k + f32(0.5, hist) * interp
    nb = f32(n_bins, hist)
    bin_f = torch.where(bin_f < 0, nb + bin_f,
                        torch.where(bin_f >= n_bins, bin_f - nb, bin_f))
    angles = f32(360.0, hist) - (f32(360.0, hist) / nb) * bin_f
    return angles, emit
