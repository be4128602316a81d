"""K6, K6′ and K7: 4x4x8 descriptor histograms over a rotated window.

K6 (`descriptor_hist`, a per-lane live flag) replaces
sift_features_tpu/ops/pallas/descriptor_packed.py:descriptor_hist_packed_masked,
dispatched per scale bucket by ops/pallas/descriptor_kernel.py:
descriptor_hist_masked. K6′ (`descriptor_hist_prefix`, lane i live iff
i < count, the count a device tensor so no caller syncs the host) replaces
descriptor_packed.py:descriptor_hist_packed, dispatched per bucket by
descriptor_kernel.py:descriptor_hist_bucketed; `descriptor_hist_bucketed`
here is that dispatcher's counterpart. Both are one `_kernel` on the TPU and
one CUDA kernel here. One launch serves every scale; the window bound
R_DESC_MAX = 39 is asserted in the kernel (the radius is at most 38 on the
main path). The CUDA kernel is
csrc/descriptor.cu; its note gives the bound (the per-sample operations,
~100 f32 instructions per in-radius sample) and the design: all threads of
a lane's block compute the per-sample records of a chunk of window rows,
then one thread per row applies them in the order below.
`finalize_descriptor` (ops/descriptor.py) turns the raw histograms into u8.

K7 (`descriptor_hist_perkey`, count prefix) replaces
ops/pallas/descriptor_kernel.py:descriptor_hist_pallas, which the JAX
dispatcher launches per scale bucket with the bucket's static window bound
when window_kernel="perkey"; `descriptor_hist_bucketed` here does the same
then.

The Gaussian stack may be f32 or bf16 (the storage modes; launches count
as `K6:bf16`, `K6′:bf16`, `K7:bf16`): the kernels widen each sample to f32
at the load, the plain version each gathered window, both exactly.

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
import math

import numpy as np
import torch

from ...config import SiftConfig
from ..descriptor import DEG2RAD_F32, R_DESC_MAX
from ..orientation import window_index
from ..util import atan2_f32, f32, round_half_away, sqrt_f32
from ...utils.compact import compact_indices, per_bucket
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
                     chunk: int = 1024, r_max: int = R_DESC_MAX) -> torch.Tensor:
    """Plain version of K6 (and, with a bucket's r_max, of K7). gauss_flat
    (L, Hp, Wp); plane/xi/yi (M,) int ((yi, xi) the rounded unpadded octave
    position); kp_scale/angle (M,) f32; live (M,) bool -> raw hist (M, 128)
    f32, zero on dead lanes. A live radius above r_max raises."""
    out = torch.zeros((plane.shape[0], cfg.descriptor_size), dtype=F32,
                      device=gauss_flat.device)
    idx = torch.nonzero(live.bool())[:, 0]      # dead lanes stay zero
    for c0 in range(0, idx.shape[0], chunk):
        sel = idx[c0:c0 + chunk]
        out[sel] = _hist(gauss_flat, plane[sel], xi[sel], yi[sel],
                         kp_scale[sel], angle[sel], live[sel], h, w, pad, cfg,
                         r_max)
    return out


def _hist(gauss_flat, plane, xi, yi, kp_scale, angle, live, h, w, pad, cfg, R):
    n_hist, n_bins = cfg.descriptor_n_histograms, cfg.descriptor_n_bins
    D = n_hist * n_hist * n_bins
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
        raise ValueError(f"descriptor radius exceeds the window bound {R}")
    ori_rad = orientation * f32(prm["deg2rad"], angle)
    sin_s = torch.sin(ori_rad.double()).to(F32) / hw
    cos_s = torch.cos(ori_rad.double()).to(F32) / hw

    lin = window_index(yi, xi, pad, R, wp) + plane[:, None, None] * hp * wp
    win = gauss_flat.reshape(-1)[lin].to(F32)
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


def _launch(gauss_flat, plane, xi, yi, kp_scale, angle, live, count, h, w,
            pad, cfg, name):
    """One launch of the CUDA kernel: liveness from `live` (K6) or from
    the device int `count` (K6′)."""
    L, hp, wp = gauss_flat.shape
    plane = torch.clamp(plane, 0, L - 1).to(torch.int32).contiguous()
    yi = torch.clamp(yi, 0, h - 1).to(torch.int32).contiguous()
    xi = torch.clamp(xi, 0, w - 1).to(torch.int32).contiguous()
    flag = (live if count is None else count.reshape(1)).to(torch.int32).contiguous()
    kp_scale = kp_scale.to(F32).contiguous()
    angle = angle.to(F32).contiguous()
    build.require_cuda(name, gauss_flat, plane, xi, yi, kp_scale, angle, flag)
    gauss_t = build.dtype_code(name, gauss_flat)
    M = plane.shape[0]
    hist = torch.empty((M, cfg.descriptor_size), dtype=F32,
                       device=gauss_flat.device)
    prm = _params(cfg)
    entry = "sift_descriptor" if count is None else "sift_descriptor_prefix"
    fn = build.bind("descriptor", entry,
                    [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
                    + [ctypes.c_int] * 7 + [ctypes.c_float] * 6
                    + [ctypes.c_void_p])
    rc = fn(build.ptr(gauss_flat), gauss_t, hp, wp, build.ptr(plane), build.ptr(yi),
            build.ptr(xi), build.ptr(kp_scale), build.ptr(angle),
            build.ptr(flag), build.ptr(hist), M, h, w, pad, R_DESC_MAX,
            cfg.descriptor_n_histograms, cfg.descriptor_n_bins,
            float(np.float32(cfg.lambda_descr)), float(prm["sqrt2"]),
            float(prm["deg2rad"]), float(prm["rad2deg"]),
            float(prm["bin_step"]), float(prm["wscale"]),
            build.stream_ptr(gauss_flat))
    return hist, rc


def descriptor_hist(gauss_flat: torch.Tensor, plane, xi, yi, kp_scale, angle,
                    live, h: int, w: int, pad: int,
                    cfg: SiftConfig) -> torch.Tensor:
    """K6 wrapper -> raw hist (M, 128) f32. The plain version for a CPU
    tensor; the CUDA kernel for a CUDA tensor (or an error)."""
    if gauss_flat.device.type == "cpu":
        return descriptor_plain(gauss_flat, plane, xi, yi, kp_scale, angle,
                                live, h, w, pad, cfg)
    hist, rc = _launch(gauss_flat, plane, xi, yi, kp_scale, angle, live, None,
                       h, w, pad, cfg, "descriptor_hist")
    name = build.form("K6", gauss_flat)
    build.check(rc, f"{name} descriptor")
    build.count_launch(name)
    return hist


def descriptor_hist_prefix(gauss_flat: torch.Tensor, plane, xi, yi, kp_scale,
                           angle, count, h: int, w: int, pad: int,
                           cfg: SiftConfig) -> torch.Tensor:
    """K6′ wrapper: lane i is live iff i < count, a 0-d integer tensor on
    gauss_flat's device (descriptor_packed.py:descriptor_hist_packed). The
    plain version for a CPU tensor; the CUDA kernel, which reads the count
    on the card, for a CUDA tensor (or an error)."""
    if gauss_flat.device.type == "cpu":
        live = torch.arange(plane.shape[0]) < count
        return descriptor_plain(gauss_flat, plane, xi, yi, kp_scale, angle,
                                live, h, w, pad, cfg)
    hist, rc = _launch(gauss_flat, plane, xi, yi, kp_scale, angle, None, count,
                       h, w, pad, cfg, "descriptor_hist_prefix")
    name = build.form("K6′", gauss_flat)
    build.check(rc, f"{name} descriptor_prefix")
    build.count_launch(name)
    return hist


def bucket_radii(cfg: SiftConfig) -> dict[int, int]:
    """Per-scale-level window bound of the descriptor histograms
    (ops/pallas/descriptor_kernel.py:bucket_radii): radius
    round(lambda_descr kp_scale sqrt2 (n_hist + 1) / 2) with kp_scale <
    sigma_min inv_delta_min 2^((s + 0.5) / S)."""
    factor = (cfg.lambda_descr * math.sqrt(2.0)
              * (cfg.descriptor_n_histograms + 1) / 2.0)
    out = {}
    for s in range(1, cfg.scales_per_octave + 1):
        scl_max = (cfg.sigma_min * cfg.inv_delta_min
                   * 2.0 ** ((s + 0.5) / cfg.scales_per_octave))
        out[s] = int(round(factor * scl_max))
    if max(out.values()) > R_DESC_MAX:
        raise ValueError(f"descriptor window radius {max(out.values())} "
                         f"exceeds the kernel bound R_DESC_MAX={R_DESC_MAX}")
    return out


def descriptor_hist_perkey(gauss_flat: torch.Tensor, plane, xi, yi, kp_scale,
                           angle, count, h: int, w: int, pad: int, r_max: int,
                           cfg: SiftConfig) -> torch.Tensor:
    """K7 wrapper -> raw hist (M, 128) f32 over windows of half-width
    r_max; lane i is live iff i < count, a 0-d integer tensor on
    gauss_flat's device. The plain version for a CPU tensor; the CUDA
    kernel, which reads the count on the card, for a CUDA tensor (or an
    error)."""
    if gauss_flat.device.type == "cpu":
        live = torch.arange(plane.shape[0]) < count
        return descriptor_plain(gauss_flat, plane, xi, yi, kp_scale, angle,
                                live, h, w, pad, cfg, r_max=r_max)
    L, hp, wp = gauss_flat.shape
    plane = torch.clamp(plane, 0, L - 1).to(torch.int32).contiguous()
    yi = torch.clamp(yi, 0, h - 1).to(torch.int32).contiguous()
    xi = torch.clamp(xi, 0, w - 1).to(torch.int32).contiguous()
    count = count.reshape(1).to(torch.int32).contiguous()
    kp_scale = kp_scale.to(F32).contiguous()
    angle = angle.to(F32).contiguous()
    build.require_cuda("descriptor_hist_perkey", gauss_flat, plane, xi, yi,
                       kp_scale, angle, count)
    gauss_t = build.dtype_code("descriptor_hist_perkey", gauss_flat)
    M = plane.shape[0]
    hist = torch.empty((M, cfg.descriptor_size), dtype=F32,
                       device=gauss_flat.device)
    prm = _params(cfg)
    fn = build.bind("descriptor", "sift_descriptor_perkey",
                    [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
                    + [ctypes.c_int] * 7 + [ctypes.c_float] * 6
                    + [ctypes.c_void_p])
    rc = fn(build.ptr(gauss_flat), gauss_t, hp, wp, build.ptr(plane), build.ptr(yi),
            build.ptr(xi), build.ptr(kp_scale), build.ptr(angle),
            build.ptr(count), build.ptr(hist), M, h, w, pad, r_max,
            cfg.descriptor_n_histograms, cfg.descriptor_n_bins,
            float(np.float32(cfg.lambda_descr)), float(prm["sqrt2"]),
            float(prm["deg2rad"]), float(prm["rad2deg"]),
            float(prm["bin_step"]), float(prm["wscale"]),
            build.stream_ptr(gauss_flat))
    name = build.form("K7", gauss_flat)
    build.check(rc, f"{name} descriptor_perkey")
    build.count_launch(name)
    return hist


def descriptor_hist_bucketed(gauss_flat: torch.Tensor, s_img, s_level, xi, yi,
                             kp_scale, angle, count, h: int, w: int, pad: int,
                             cfg: SiftConfig, live=None) -> torch.Tensor:
    """Counterpart of ops/pallas/descriptor_kernel.py:descriptor_hist_bucketed
    -> raw hist (M, 128) f32. s_img (M,) is the plane to sample, s_level
    (M,) the scale level in [1, S] (the JAX bucket key: lanes outside it
    stay zero); liveness is lane < count, or `live` (M,) bool when given.

    window_kernel="perkey": the JAX rule, each scale bucket compacted
    (count kept on the device), served by K7 at the bucket's window bound
    and restored by rank. "packed": one K6′ launch serves every radius, so
    with `live` the live lanes are compacted once into a count prefix and
    restored by rank. Per-keypoint output is the same."""
    M = s_img.shape[0]
    in_range = (s_level >= 1) & (s_level <= cfg.scales_per_octave)
    if cfg.window_kernel == "perkey":
        if live is None:
            live = torch.arange(M, device=s_img.device) < count
        return per_bucket(live, s_level, bucket_radii(cfg),
                          lambda idx, n, r_max: descriptor_hist_perkey(
                              gauss_flat, s_img[idx], xi[idx], yi[idx],
                              kp_scale[idx], angle[idx], n, h, w, pad, r_max,
                              cfg),
                          torch.zeros((M, cfg.descriptor_size), dtype=F32,
                                      device=gauss_flat.device))
    if live is None:
        hist = descriptor_hist_prefix(gauss_flat, s_img, xi, yi, kp_scale,
                                      angle, count, h, w, pad, cfg)
        return torch.where(in_range[:, None], hist, torch.zeros_like(hist))
    mask = live.bool() & in_range
    idx, _, n = compact_indices(mask, M)
    hb = descriptor_hist_prefix(gauss_flat, s_img[idx], xi[idx], yi[idx],
                                kp_scale[idx], angle[idx], n, h, w, pad, cfg)
    rank = torch.clamp(torch.cumsum(mask, 0) - 1, min=0)
    return torch.where(mask[:, None], hb[rank], torch.zeros_like(hb))
