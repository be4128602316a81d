"""K1, the fused octave kernel (csrc/pyramid.cu): from the padded base
(B, Hp, Wp) f32, every Gaussian level's separable blur chain and the DoG.
Bytes: the base read once, S levels and S + 2 DoG planes written once, f32.
Operations: per pixel, one f32 multiply and one add per tap in each of the
two passes of every level, and one subtraction per DoG plane."""

from __future__ import annotations

from ..reference.pixel_ops import cv_ksize, gaussian_kernel

SOURCE = "pyramid"


def octave_taps(params):
    return [gaussian_kernel(s, cv_ksize(s)) for s in params.octave_sigmas()[1:]]


def work(batch: int, h_pad: int, w_pad: int, params) -> tuple[float, float]:
    """(bytes, f32 operations) of one launch."""
    taps = octave_taps(params)
    px = batch * h_pad * w_pad
    nbytes = 4 * px * (1 + params.scales_per_octave + len(taps))
    ops = px * (sum(4 * len(t) for t in taps) + len(taps))
    return float(nbytes), float(ops)
