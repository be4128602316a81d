"""K5, K5′ and K8: 36-bin orientation histograms (K5 / K5′ with in-kernel
peaks).

K5 (`orientation_hist_peaks`, a per-lane live flag) replaces
sift_features_tpu/ops/pallas/orientation_packed.py:
orientation_histograms_packed_masked, dispatched per scale bucket by
ops/pallas/orientation_kernel.py:orientation_histograms_masked. K5′
(`orientation_hist_prefix`, lane i live iff i < count, the count a device
tensor) replaces orientation_packed.py:orientation_histograms_packed,
dispatched per bucket by orientation_kernel.py:
orientation_histograms_bucketed; `orientation_histograms_bucketed` here is
that dispatcher's counterpart for count-prefix input. Both are one
`_kernel` on the TPU and one CUDA kernel here. One launch serves every
scale: the bucket radius {1: 10, 2: 13, 3: 16} is only a buffer bound, and the per-keypoint radius round_half_away(4.5 *
scale) is at most R_ORI_MAX = 16 on the main path. The CUDA kernel is
csrc/orientation.cu; its note gives the bound and the design.

K8 (`orientation_hist_perkey`, count prefix, no peaks) replaces
ops/pallas/orientation_kernel.py:orientation_histograms_pallas, which the
JAX dispatcher launches per scale bucket with the bucket's static window
bound when window_kernel="perkey"; `orientation_histograms_bucketed` here
does the same then. It runs the same CUDA kernel as K5, instantiated
without the peak code and with the bucket's bound for the window
half-width, so its raw rows equal K5's wherever a lane's radius is within
that bound.

The Gaussian stack may be f32 or bf16 (the storage modes; launches count
as `K5:bf16`, `K5′:bf16`, `K8:bf16`): the kernels widen each sample to f32
at the load, the plain versions each gathered window, both exactly.

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
from ...utils.compact import per_bucket
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
    raw = orientation_raw_plain(gauss_flat, plane, y, x, kp_scale, live, h, w,
                                pad, cfg, R_ORI_MAX, chunk)
    angles, n_peaks = first_peaks(smooth(raw), cfg)
    dead = ~live.bool()
    angles = torch.where(dead[:, None], torch.zeros_like(angles), angles)
    n_peaks = torch.where(dead, torch.zeros_like(n_peaks), n_peaks)
    return raw, angles, n_peaks


def orientation_raw_plain(gauss_flat: torch.Tensor, plane, y, x, kp_scale,
                          live, h: int, w: int, pad: int, cfg: SiftConfig,
                          r_max: int, chunk: int = 8192) -> torch.Tensor:
    """Raw (K, n_bins) histograms over windows of half-width <= r_max (the
    plain version of K8; K5's raw rows with r_max = R_ORI_MAX). Dead lanes
    are zero."""
    raw = torch.zeros((plane.shape[0], cfg.n_orientation_bins), dtype=F32,
                      device=gauss_flat.device)
    idx = torch.nonzero(live.bool())[:, 0]      # dead lanes stay zero
    for c0 in range(0, idx.shape[0], chunk):
        sel = idx[c0:c0 + chunk]
        raw[sel] = _raw_hist(gauss_flat, plane[sel], y[sel], x[sel],
                             kp_scale[sel], live[sel], h, w, pad, cfg, r_max)
    return raw


def _raw_hist(gauss_flat, plane, y, x, kp_scale, live, h, w, pad, cfg, R):
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
    win = gauss_flat.reshape(-1)[lin].to(F32)               # (K, 2R+3, 2R+3)
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


def _as(t: torch.Tensor, dtype) -> torch.Tensor:
    """t as a contiguous tensor of dtype, itself when it is one already."""
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def _launch(gauss_flat, plane, y, x, kp_scale, live, count, h, w, pad, cfg,
            name):
    """One launch of the CUDA kernel: liveness from `live` (K5) or from
    the device int `count` (K5′)."""
    L, hp, wp = gauss_flat.shape
    # the kernel clamps plane / y / x as the plain version does; the lane
    # tensors pass as they come when already of the kernel's types
    plane, y, x = (_as(t, torch.int32) for t in (plane, y, x))
    flag = (_as(live, torch.bool) if count is None
            else _as(count.reshape(1), torch.int32))
    kp_scale = _as(kp_scale, F32)
    build.require_cuda(name, gauss_flat, plane, y, x, kp_scale, flag)
    gauss_t = build.dtype_code(name, gauss_flat)
    K = plane.shape[0]
    n_bins = cfg.n_orientation_bins
    kw = dict(device=gauss_flat.device)
    hist = torch.empty((K, n_bins), dtype=F32, **kw)
    ang = torch.empty((K, N_PEAKS_CAP), dtype=F32, **kw)
    npk = torch.empty((K,), dtype=torch.int32, **kw)
    radius_factor, bstep = _params(cfg)
    entry = "sift_orientation" if count is None else "sift_orientation_prefix"
    fn = build.bind("orientation", entry,
                    [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 8
                    + [ctypes.c_int] * 6 + [ctypes.c_float] * 4
                    + [ctypes.c_void_p])
    rc = fn(build.ptr(gauss_flat), gauss_t, L, hp, wp, build.ptr(plane), build.ptr(y),
            build.ptr(x), build.ptr(kp_scale), build.ptr(flag), build.ptr(hist),
            build.ptr(ang), build.ptr(npk), K, h, w, pad, n_bins, N_PEAKS_CAP,
            float(radius_factor), float(np.float32(cfg.lambda_ori)),
            float(np.float32(cfg.orientation_localmax_ratio)), float(bstep),
            build.stream_ptr(gauss_flat))
    return (hist, ang, npk), rc


def orientation_hist_peaks(gauss_flat: torch.Tensor, plane, y, x, kp_scale,
                           live, h: int, w: int, pad: int, cfg: SiftConfig):
    """K5 wrapper -> (raw hist (K, n_bins) f32, angles (K, N_PEAKS_CAP) f32,
    n_peaks (K,) int32). The plain version for a CPU tensor; the CUDA kernel
    for a CUDA tensor (or an error)."""
    if gauss_flat.device.type == "cpu":
        return orientation_plain(gauss_flat, plane, y, x, kp_scale, live, h, w,
                                 pad, cfg)
    out, rc = _launch(gauss_flat, plane, y, x, kp_scale, live, None, h, w, pad,
                      cfg, "orientation_hist_peaks")
    name = build.form("K5", gauss_flat)
    build.check(rc, f"{name} orientation")
    build.count_launch(name)
    return out


def orientation_hist_prefix(gauss_flat: torch.Tensor, plane, y, x, kp_scale,
                            count, h: int, w: int, pad: int, cfg: SiftConfig):
    """K5′ wrapper: orientation_hist_peaks with lane i live iff i < count, a
    0-d integer tensor on gauss_flat's device
    (orientation_packed.py:orientation_histograms_packed). The plain version
    for a CPU tensor; the CUDA kernel, which reads the count on the card,
    for a CUDA tensor (or an error)."""
    if gauss_flat.device.type == "cpu":
        live = torch.arange(plane.shape[0]) < count
        return orientation_plain(gauss_flat, plane, y, x, kp_scale, live, h, w,
                                 pad, cfg)
    out, rc = _launch(gauss_flat, plane, y, x, kp_scale, None, count, h, w, pad,
                      cfg, "orientation_hist_prefix")
    name = build.form("K5′", gauss_flat)
    build.check(rc, f"{name} orientation_prefix")
    build.count_launch(name)
    return out


def bucket_radii_ori(cfg: SiftConfig) -> dict[int, int]:
    """Per-scale-level window bound of the orientation histograms
    (ops/pallas/orientation_kernel.py:bucket_radii_ori): radius
    round(3 lambda_ori kp_scale) with kp_scale < sigma_min inv_delta_min
    2^((s + 0.5) / S)."""
    factor = 3.0 * cfg.lambda_ori
    out = {}
    for s in range(1, cfg.scales_per_octave + 1):
        scl_max = (cfg.sigma_min * cfg.inv_delta_min
                   * 2.0 ** ((s + 0.5) / cfg.scales_per_octave))
        out[s] = int(round(factor * scl_max))
    if max(out.values()) > R_ORI_MAX:
        raise ValueError(f"orientation window radius {max(out.values())} "
                         f"exceeds the kernel bound R_ORI_MAX={R_ORI_MAX}")
    return out


def orientation_hist_perkey(gauss_flat: torch.Tensor, plane, y, x, kp_scale,
                            count, h: int, w: int, pad: int, r_max: int,
                            cfg: SiftConfig) -> torch.Tensor:
    """K8 wrapper -> raw (K, n_bins) f32 histograms over windows of
    half-width <= r_max (<= R_ORI_MAX), zero for lanes >= count; lane i is
    live iff i < count, a 0-d integer tensor on gauss_flat's device. The
    plain version for a CPU tensor; for a CUDA tensor (or an error) K5's
    kernel without peaks (csrc/orientation.cu), which reads the count on
    the card. The plane, row and column are clamped here, as the plain
    version clamps them."""
    if gauss_flat.device.type == "cpu":
        live = torch.arange(plane.shape[0]) < count
        return orientation_raw_plain(gauss_flat, plane, y, x, kp_scale, live,
                                     h, w, pad, cfg, r_max)
    L, hp, wp = gauss_flat.shape
    plane = torch.clamp(plane, 0, L - 1).to(torch.int32).contiguous()
    y = torch.clamp(y, 0, h - 1).to(torch.int32).contiguous()
    x = torch.clamp(x, 0, w - 1).to(torch.int32).contiguous()
    count = count.reshape(1).to(torch.int32).contiguous()
    kp_scale = kp_scale.to(F32).contiguous()
    build.require_cuda("orientation_hist_perkey", gauss_flat, plane, y, x,
                       kp_scale, count)
    gauss_t = build.dtype_code("orientation_hist_perkey", gauss_flat)
    K = plane.shape[0]
    hist = torch.empty((K, cfg.n_orientation_bins), dtype=F32,
                       device=gauss_flat.device)
    radius_factor, bstep = _params(cfg)
    fn = build.bind("orientation", "sift_orientation_perkey",
                    [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
                    + [ctypes.c_int] * 6 + [ctypes.c_float] * 3
                    + [ctypes.c_void_p])
    rc = fn(build.ptr(gauss_flat), gauss_t, hp, wp, build.ptr(plane), build.ptr(y),
            build.ptr(x), build.ptr(kp_scale), build.ptr(count),
            build.ptr(hist), K, h, w, pad, cfg.n_orientation_bins, r_max,
            float(radius_factor), float(np.float32(cfg.lambda_ori)),
            float(bstep), build.stream_ptr(gauss_flat))
    name = build.form("K8", gauss_flat)
    build.check(rc, f"{name} orientation_perkey")
    build.count_launch(name)
    return hist


def orientation_histograms_bucketed(gauss_flat: torch.Tensor, s_img, s_level,
                                    y, x, kp_scale, count, h: int, w: int,
                                    pad: int, cfg: SiftConfig,
                                    with_peaks: bool = False, live=None):
    """Counterpart of ops/pallas/orientation_kernel.py:
    orientation_histograms_bucketed -> the SMOOTHED (K, n_bins) histograms,
    and with `with_peaks` also (angles (K, N_PEAKS_CAP), n_peaks (K,)).
    s_img (K,) is the plane to sample, s_level (K,) the scale level in
    [1, S] (the JAX bucket key: lanes outside it stay zero); lane i is live
    iff i < count, or (perkey) `live` (K,) bool when given.

    window_kernel="packed": one K5′ launch serves every radius (count
    prefix only). "perkey": the JAX rule, each scale bucket compacted
    (count kept on the device) and served by K8 at the bucket's window
    bound, rows restored by rank; K8 has no peaks, so with_peaks is refused
    there (callers take orientation_peaks of the histograms). Per-keypoint
    output is the same either way."""
    K = s_img.shape[0]
    in_range = (s_level >= 1) & (s_level <= cfg.scales_per_octave)
    zero = torch.zeros((), dtype=F32, device=gauss_flat.device)
    if cfg.window_kernel == "perkey":
        if with_peaks:
            raise ValueError("K8 has no peaks: take orientation_peaks of "
                             "the histograms")
        if live is None:
            live = torch.arange(K, device=s_img.device) < count
        raw = per_bucket(live, s_level, bucket_radii_ori(cfg),
                         lambda idx, n, r_max: orientation_hist_perkey(
                             gauss_flat, s_img[idx], y[idx], x[idx],
                             kp_scale[idx], n, h, w, pad, r_max, cfg),
                         torch.zeros((K, cfg.n_orientation_bins), dtype=F32,
                                     device=gauss_flat.device))
        return smooth(raw)
    if live is not None:
        raise ValueError("the packed dispatcher takes a count prefix")
    raw, ang, npk = orientation_hist_prefix(gauss_flat, s_img, y, x, kp_scale,
                                            count, h, w, pad, cfg)
    hist = smooth(torch.where(in_range[:, None], raw, zero))
    if not with_peaks:
        return hist
    return (hist, torch.where(in_range[:, None], ang, zero),
            torch.where(in_range, npk, torch.zeros_like(npk)))
