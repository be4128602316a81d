"""K2, the extremum-word kernel (csrc/extrema.cu) on the DoG (B, S + 2, Hp,
Wp) f32 within the bounds [y0, y1) x [x0, x1) of the octave's interior
(image_border inside the PAD_DESC ring). Bytes: each DoG value of rows
y0 - 1 .. y1 and columns x0 - 1 .. x1 read once, one 32-bit word per 32
pixels of each of the S scales written once. Operations: 27 compares for
each pixel inside the bounds of each scale."""

from __future__ import annotations

from .octaves import PAD_DESC

SOURCE = "extrema"


def work(batch: int, h: int, w: int, h_pad: int, w_pad: int,
         params) -> tuple[float, float]:
    """(bytes, operations) of one launch on an (h, w) octave."""
    n_s = params.scales_per_octave
    bd = params.image_border
    y0, y1 = PAD_DESC + bd, PAD_DESC + h - bd
    x0, x1 = PAD_DESC + bd, PAD_DESC + w - bd
    y0, y1, x0, x1 = max(y0, 0), min(y1, h_pad), max(x0, 0), min(x1, w_pad)
    rows = max(min(y1 + 1, h_pad) - max(y0 - 1, 0), 0)
    cols = max(min(x1 + 1, w_pad) - max(x0 - 1, 0), 0)
    nbytes = (batch * (n_s + 2) * rows * cols * 4
              + batch * n_s * h_pad * w_pad // 32 * 4)
    ops = batch * n_s * max(y1 - y0, 0) * max(x1 - x0, 0) * 27
    return float(nbytes), float(ops)
