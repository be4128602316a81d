"""kernels.pyramid_roofline: the pyramid kernels' share of their roofline,
in percent: the summed bounds of K1 (csrc/pyramid.cu) and K2
(csrc/extrema.cu) at each fused octave of each traced step, over the
device time of those sources' kernels in the traced window. Bounds from
rooflines/ (bytes at 3.35 TB/s or f32 instructions at 33.5 T/s)."""

from h100_bench.rooflines import k1_pyramid, k2_extrema
from h100_bench.rooflines.octaves import fused_octaves
from h100_bench.rooflines.peaks import bound_s


def read(trace):
    t = trace.kernel_s({k1_pyramid.SOURCE, k2_extrema.SOURCE})
    c = trace.cell
    if t <= 0 or not trace.n_steps or "frame_h" not in c:
        return None
    b, p = c["batch"], c["params"]
    per_step = 0.0
    for _, h, w, hp, wp in fused_octaves(c["frame_h"], c["frame_w"], p):
        per_step += bound_s(*k1_pyramid.work(b, hp, wp, p))
        per_step += bound_s(*k2_extrema.work(b, h, w, hp, wp, p))
    return 100.0 * per_step * trace.n_steps / t
