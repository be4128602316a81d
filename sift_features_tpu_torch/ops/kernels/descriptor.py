"""K6: 4x4x8 descriptor histograms over a rotated window.

Replaces sift_features_tpu/ops/pallas/descriptor_packed.py:
descriptor_hist_packed_masked (`_kernel`), dispatched per scale bucket by
ops/pallas/descriptor_kernel.py:descriptor_hist_masked. One launch serves
every scale; the window bound R_DESC_MAX = 39 is asserted in the kernel
(the radius is at most 38 on the main path). The CUDA kernel is
csrc/descriptor.cu; its note gives the bound and the design.
`finalize_descriptor` (ops/descriptor.py) turns the raw histograms into u8.

Per-sample math follows the TPU kernel in f32 (Cephes atan2, the
(u_row * u_col) * (m * u_ori) product order); sin, cos and exp round once
from f64. Summation order, kernel and plain version alike: window row r
sums its samples over columns in ascending order, then each bin sums the
rows in ascending order; a sample adds to each of its (at most 8) bins
once. The JAX kernel sums in another order, so the port holds it to a
stated tolerance.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...config import SiftConfig
from ..descriptor import DEG2RAD_F32, R_DESC_MAX
from ..orientation import window_index
from ..util import atan2_f32, f32, round_half_away, sqrt_f32
from . import build

F32 = torch.float32


def _params(cfg: SiftConfig) -> dict:
    n_hist, n_bins = cfg.descriptor_n_histograms, cfg.descriptor_n_bins
    return dict(
        sqrt2=np.float32(np.sqrt(np.float32(2.0))),
        deg2rad=DEG2RAD_F32,
        rad2deg=np.float32(180.0 / np.pi),
        bin_step=np.float32(np.float32(n_bins) / np.float32(360.0)),
        wscale=np.float32(-2.0) / np.float32(n_hist * n_hist))



def descriptor_plain(gauss_flat: torch.Tensor, plane, xi, yi, kp_scale, angle,
                     live, h: int, w: int, pad: int, cfg: SiftConfig,
                     chunk: int = 1024) -> torch.Tensor:
    """Plain version of K6. gauss_flat (L, Hp, Wp); plane/xi/yi (M,) int
    ((yi, xi) the rounded unpadded octave position); kp_scale/angle (M,)
    f32; live (M,) bool -> raw hist (M, 128) f32, zero on dead lanes."""
    out = torch.zeros((plane.shape[0], cfg.descriptor_size), dtype=F32,
                      device=gauss_flat.device)
    idx = torch.nonzero(live.bool())[:, 0]      # dead lanes stay zero
    for c0 in range(0, idx.shape[0], chunk):
        sel = idx[c0:c0 + chunk]
        out[sel] = _hist(gauss_flat, plane[sel], xi[sel], yi[sel],
                         kp_scale[sel], angle[sel], live[sel], h, w, pad, cfg)
    return out


def _hist(gauss_flat, plane, xi, yi, kp_scale, angle, live, h, w, pad, cfg):
    n_hist, n_bins = cfg.descriptor_n_histograms, cfg.descriptor_n_bins
    D = n_hist * n_hist * n_bins
    R = R_DESC_MAX
    L, hp, wp = gauss_flat.shape
    prm = _params(cfg)
    dev = plane.device
    K = plane.shape[0]
    plane = torch.clamp(plane.long(), 0, L - 1)
    yi = torch.clamp(yi.long(), 0, h - 1)
    xi = torch.clamp(xi.long(), 0, w - 1)
    live = live.bool()

    orientation = f32(360.0, angle) - angle
    hw = f32(cfg.lambda_descr, kp_scale) * kp_scale
    radius = round_half_away(hw * f32(prm["sqrt2"], hw) * f32(n_hist + 1, hw)
                             * f32(0.5, hw))
    if bool(((radius > R) & live).any()):
        raise ValueError(f"descriptor radius exceeds R_DESC_MAX={R}")
    ori_rad = orientation * f32(prm["deg2rad"], angle)
    sin_s = torch.sin(ori_rad.double()).to(F32) / hw
    cos_s = torch.cos(ori_rad.double()).to(F32) / hw

    lin = window_index(yi, xi, pad, R, wp) + plane[:, None, None] * hp * wp
    win = gauss_flat.reshape(-1)[lin]
    gx = win[:, 1:-1, 2:] - win[:, 1:-1, :-2]
    gy = win[:, :-2, 1:-1] - win[:, 2:, 1:-1]

    offs = torch.arange(-R, R + 1, device=dev)
    dyi = offs[None, :, None]
    dxi = offs[None, None, :]
    dyf, dxf = dyi.to(F32), dxi.to(F32)
    c_ = cos_s[:, None, None]
    s_ = sin_s[:, None, None]
    col_rot = dxf * c_ - dyf * s_
    row_rot = dxf * s_ + dyf * c_
    half = f32(n_hist * 0.5, hw)
    row_bin = row_rot + half
    col_bin = col_rot + half
    y_img = yi[:, None, None] + dyi
    x_img = xi[:, None, None] + dxi
    rad = radius[:, None, None]
    hi = n_hist + 0.5
    ok = ((dyi.abs().to(F32) <= rad) & (dxi.abs().to(F32) <= rad)
          & (row_bin > -0.5) & (row_bin < hi) & (col_bin > -0.5) & (col_bin < hi)
          & (y_img > 0) & (y_img < h - 1) & (x_img > 0) & (x_img < w - 1)
          & live[:, None, None])

    w2 = col_rot * col_rot + row_rot * row_rot
    weights = torch.exp((w2 * f32(prm["wscale"], w2)).double()).to(F32)
    mag = sqrt_f32(gx * gx + gy * gy)
    deg = atan2_f32(gy, gx) * f32(prm["rad2deg"], gx)
    ori_norm = (torch.remainder(deg + f32(360.0, deg), f32(360.0, deg))
                - orientation[:, None, None])
    zero = torch.zeros_like(mag)
    one = f32(1.0, mag)
    rb = torch.where(ok, row_bin - f32(0.5, mag), zero)
    cb = torch.where(ok, col_bin - f32(0.5, mag), zero)
    obin = torch.where(ok, ori_norm * f32(prm["bin_step"], mag), zero)
    m = torch.where(ok, mag * weights, zero)
    rfl, cfl, ofl = torch.floor(rb), torch.floor(cb), torch.floor(obin)
    rfr, cfr, ofr = rb - rfl, cb - cfl, obin - ofl
    r1 = torch.clamp(rfl.long() + 1, 0, n_hist)
    c1 = torch.clamp(cfl.long() + 1, 0, n_hist)
    of = ofl.long()
    of = torch.where(of < 0, of + n_bins, of)
    of = torch.where(of >= n_bins, of - n_bins, of)
    of = torch.clamp(of, 0, n_bins - 1)
    of1 = torch.where(of + 1 >= n_bins, torch.zeros_like(of), of + 1)
    uo = (m * (one - ofr), m * ofr)

    corners = []                   # (bin index, contribution), D = discard
    for dr, ur in ((0, one - rfr), (1, rfr)):
        rr = r1 + dr
        for dc, uc in ((0, one - cfr), (1, cfr)):
            cc = c1 + dc
            inside = ok & (rr >= 1) & (rr <= n_hist) & (cc >= 1) & (cc <= n_hist)
            base = ((rr - 1) * n_hist + (cc - 1)) * n_bins
            wrc = ur * uc
            for ob, u in ((of, uo[0]), (of1, uo[1])):
                idx = torch.where(inside, base + ob, torch.full_like(ob, D))
                corners.append((idx, torch.where(inside, wrc * u, zero)))

    n = 2 * R + 1
    rowhist = torch.zeros((K, n, D + 1), dtype=F32, device=dev)
    for c in range(n):                       # ascending columns per row
        for idx, val in corners:
            rowhist.scatter_add_(2, idx[:, :, c:c + 1], val[:, :, c:c + 1])
    hist = rowhist[:, 0, :D]
    for r in range(1, n):                    # ascending rows per bin
        hist = hist + rowhist[:, r, :D]
    return hist


def descriptor_hist(gauss_flat: torch.Tensor, plane, xi, yi, kp_scale, angle,
                    live, h: int, w: int, pad: int,
                    cfg: SiftConfig) -> torch.Tensor:
    """K6 wrapper -> raw hist (M, 128) f32. The plain version for a CPU
    tensor; the CUDA kernel for a CUDA tensor (or an error)."""
    if gauss_flat.device.type == "cpu":
        return descriptor_plain(gauss_flat, plane, xi, yi, kp_scale, angle,
                                live, h, w, pad, cfg)
    L, hp, wp = gauss_flat.shape
    plane = torch.clamp(plane, 0, L - 1).to(torch.int32).contiguous()
    yi = torch.clamp(yi, 0, h - 1).to(torch.int32).contiguous()
    xi = torch.clamp(xi, 0, w - 1).to(torch.int32).contiguous()
    live = live.to(torch.int32).contiguous()
    kp_scale = kp_scale.to(F32).contiguous()
    angle = angle.to(F32).contiguous()
    build.require_cuda("descriptor_hist", gauss_flat, plane, xi, yi, kp_scale,
                       angle, live)
    M = plane.shape[0]
    hist = torch.empty((M, cfg.descriptor_size), dtype=F32,
                       device=gauss_flat.device)
    prm = _params(cfg)
    fn = build.bind("descriptor", "sift_descriptor",
                    [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                    + [ctypes.c_int] * 7 + [ctypes.c_float] * 6
                    + [ctypes.c_void_p])
    rc = fn(build.ptr(gauss_flat), hp, wp, build.ptr(plane), build.ptr(yi),
            build.ptr(xi), build.ptr(kp_scale), build.ptr(angle),
            build.ptr(live), build.ptr(hist), M, h, w, pad, R_DESC_MAX,
            cfg.descriptor_n_histograms, cfg.descriptor_n_bins,
            float(np.float32(cfg.lambda_descr)), float(prm["sqrt2"]),
            float(prm["deg2rad"]), float(prm["rad2deg"]),
            float(prm["bin_step"]), float(prm["wscale"]),
            build.stream_ptr(gauss_flat))
    build.check(rc, "K6 descriptor")
    build.count_launch("K6")
    return hist
