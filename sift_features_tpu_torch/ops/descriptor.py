"""128-D SIFT descriptor in plain PyTorch.

Counterpart of sift_features_tpu/ops/descriptor.py (reference
compute_descriptor, lib.rs:759-990): 4x4 spatial x 8 orientation histograms
over a rotated window of radius round(3*scale*sqrt(2)*5/2), trilinear
accumulation with circular orientation wrap, then the chunks-of-4 L2 fold,
the 0.2 cap, renormalisation to 512, half-away rounding and a saturating
u8 cast (`finalize_descriptor`, used by every path).

`descriptor_batch` is the tiny-octave path and keeps the JAX XLA path's
numerics (f64 sin/cos/exp/atan2). The main path's histograms come from the
K6 kernel (ops/kernels/descriptor.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, SiftConfig
from .orientation import window_index
from .util import f32, rust_round, sqrt_f32

F32 = torch.float32

# Max descriptor radius: round(3*scale*sqrt(2)*2.5) with scale < 3.5923.
R_DESC_MAX = 39
# Pad ring of every plane the window kernels read (the JAX layout).
PAD_DESC = R_DESC_MAX + 17
DEG2RAD_F32 = np.float32(np.float32(np.pi) / np.float32(180.0))



def pad_stack_for_kernels(gauss: torch.Tensor) -> torch.Tensor:
    """Zero-pad (S, H, W) by PAD_DESC on all sides, plus right columns up to
    a multiple of 128 (the JAX package's padded-plane layout)."""
    w_pad = gauss.shape[-1] + 2 * PAD_DESC
    extra = (-w_pad) % 128
    return torch.nn.functional.pad(
        gauss, (PAD_DESC, PAD_DESC + extra, PAD_DESC, PAD_DESC))


def descriptor_params(kp_scale, angle, cfg: SiftConfig):
    """Per-keypoint f32 parameters, in the op order of the TPU kernel:
    (orientation, radius, sin/hist_width, cos/hist_width). sin and cos go
    through f64 and round once to f32."""
    n_hist = cfg.descriptor_n_histograms
    orientation = f32(360.0, angle) - angle
    hist_width = f32(cfg.lambda_descr, kp_scale) * kp_scale
    radius = rust_round(hist_width * f32(np.sqrt(np.float32(2.0)), kp_scale)
                        * f32(n_hist + 1, kp_scale) * f32(0.5, kp_scale))
    ori_rad = orientation * f32(DEG2RAD_F32, angle)
    sin_s = torch.sin(ori_rad.double()).to(F32) / hist_width
    cos_s = torch.cos(ori_rad.double()).to(F32) / hist_width
    return orientation, radius, sin_s, cos_s


def descriptor_batch(gauss_padded: torch.Tensor, h: int, w: int,
                     scale_idx, x_oct, y_oct, kp_scale, angle, valid,
                     cfg: SiftConfig = DEFAULT_CONFIG,
                     pad: int = PAD_DESC) -> torch.Tensor:
    """u8 descriptors (M, 128) for keypoints of one octave. gauss_padded
    (L, H_pad, W_pad) with `pad` rows/columns before the image; scale_idx
    is the plane index into it. Invalid lanes give all-zero rows."""
    n_hist = cfg.descriptor_n_histograms
    n_bins = cfg.descriptor_n_bins
    M = scale_idx.shape[0]
    R = R_DESC_MAX
    L, hp, wp = gauss_padded.shape
    orientation, radius, sin_s, cos_s = descriptor_params(kp_scale, angle, cfg)
    xi = torch.clamp(rust_round(x_oct).long(), 0, w - 1)
    yi = torch.clamp(rust_round(y_oct).long(), 0, h - 1)
    scale_idx = torch.clamp(scale_idx.long(), 0, L - 1)

    lin = window_index(yi, xi, pad, R, wp) + scale_idx.long()[:, None, None] * hp * wp
    win = gauss_padded.reshape(-1)[lin]
    dx = win[:, 1:-1, 2:] - win[:, 1:-1, :-2]
    dy = win[:, :-2, 1:-1] - win[:, 2:, 1:-1]

    offs = torch.arange(-R, R + 1, device=win.device)
    dyy = offs[None, :, None].to(F32)
    dxx = offs[None, None, :].to(F32)
    c_ = cos_s[:, None, None]
    s_ = sin_s[:, None, None]
    col_rot = dxx * c_ - dyy * s_
    row_rot = dxx * s_ + dyy * c_
    half = f32(n_hist / 2, win)
    row_bin = row_rot + half
    col_bin = col_rot + half
    y_img = yi[:, None, None] + offs[None, :, None]
    x_img = xi[:, None, None] + offs[None, None, :]
    rad = radius[:, None, None]
    ok = ((offs.abs()[None, :, None] <= rad) & (offs.abs()[None, None, :] <= rad)
          & (row_bin > -0.5) & (row_bin < n_hist + 0.5)
          & (col_bin > -0.5) & (col_bin < n_hist + 0.5)
          & (y_img > 0) & (y_img < h - 1) & (x_img > 0) & (x_img < w - 1)
          & valid.bool()[:, None, None])

    wscale = f32(np.float32(-2.0) / np.float32(n_hist * n_hist), win)
    w2 = col_rot * col_rot + row_rot * row_rot
    weights = torch.exp((w2 * wscale).double()).to(F32)
    mag = sqrt_f32(dx * dx + dy * dy)
    deg = torch.rad2deg(torch.atan2(dy.double(), dx.double()))
    ori_norm = torch.remainder(deg + 360.0, 360.0).to(F32) - orientation[:, None, None]

    bin_step = f32(np.float32(n_bins) / np.float32(360.0), win)
    one = f32(1.0, win)
    zero = torch.zeros_like(mag)
    rb = row_bin - f32(0.5, win)
    cb = col_bin - f32(0.5, win)
    m = torch.where(ok, mag * weights, zero)
    obin = ori_norm * bin_step
    rfl, cfl, ofl = torch.floor(rb), torch.floor(cb), torch.floor(obin)
    rfr = torch.where(ok, rb - rfl, zero)
    cfr = torch.where(ok, cb - cfl, zero)
    ofr = torch.where(ok, obin - ofl, zero)
    side = n_hist + 2
    r1 = torch.clamp(torch.where(ok, rfl, zero).long() + 1, 0, side - 2)
    c1 = torch.clamp(torch.where(ok, cfl, zero).long() + 1, 0, side - 2)
    of = torch.where(ok, ofl, zero).long()
    of = torch.where(of < 0, of + n_bins, of)
    of = torch.where(of >= n_bins, of - n_bins, of)
    of = torch.clamp(of, 0, n_bins - 1)
    of1 = torch.where(of + 1 >= n_bins, torch.zeros_like(of), of + 1)

    acc = torch.zeros((M, side * side * n_bins), dtype=F32, device=win.device)
    for dr, ur in ((0, one - rfr), (1, rfr)):
        for dc, uc in ((0, one - cfr), (1, cfr)):
            wrc = ur * uc
            for ob, po in ((of, m * (one - ofr)), (of1, m * ofr)):
                idx = ((r1 + dr) * side + (c1 + dc)) * n_bins + ob
                acc.scatter_add_(1, idx.reshape(M, -1), (wrc * po).reshape(M, -1))
    hist = acc.reshape(M, side, side, n_bins)[:, 1:-1, 1:-1, :].reshape(M, -1)
    return finalize_descriptor(hist, cfg)


def finalize_descriptor(hist: torch.Tensor,
                        cfg: SiftConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Normalisation and quantisation (lib.rs:950-990) with the chunks-of-4
    sequential accumulation order, bit-equal to the JAX version."""
    M, D = hist.shape

    def chunked_l2(v):
        ch = (v * v).reshape(M, D // 4, 4)
        csum = ((ch[:, :, 0] + ch[:, :, 1]) + ch[:, :, 2]) + ch[:, :, 3]
        acc = csum[:, 0]
        for i in range(1, D // 4):
            acc = acc + csum[:, i]
        return sqrt_f32(acc)

    l2 = chunked_l2(hist)
    cap = l2 * f32(cfg.descriptor_magnitude_cap, hist)
    hist = torch.minimum(hist, cap[:, None])
    l2c = chunked_l2(hist)
    eps = f32(np.finfo(np.float32).eps, hist)
    normalizer = f32(cfg.descriptor_l2_norm, hist) / torch.maximum(l2c, eps)
    q = rust_round(hist * normalizer[:, None])
    return torch.clamp(q, 0, 255).to(torch.uint8)
