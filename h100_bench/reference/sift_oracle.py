"""Plain SIFT reference in NumPy: OpenCV's SIFT as the reference crate
(sift-features, src/lib.rs) computes it, operation for operation in f32.

A frozen copy of the program's NumPy oracle, made to stand alone: it reads
its parameters from `pixel_ops.SiftParams` and its blur and resizes from
`pixel_ops.NumpyProcessing`, and imports nothing of the program.

Semantics, cited into the reference crate's src/lib.rs:
  seed image             lib.rs:196-210
  scale space / DoG      lib.rs:213-279
  discrete extrema       lib.rs:437-506   (threshold floored to 0.0, lib.rs:460)
  Newton refinement      lib.rs:508-603
  contrast / edge tests  lib.rs:605-653
  orientation histogram  lib.rs:655-757, 371-433
  descriptor             lib.rs:759-990
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .pixel_ops import NumpyProcessing, SiftParams

DEFAULT_PARAMS = SiftParams()

F32 = np.float32


def _f32(x) -> np.float32:
    return np.float32(x)


def rust_round_f32(x: np.ndarray) -> np.ndarray:
    """Rust f32::round — half away from zero."""
    x = np.asarray(x, F32)
    t = np.trunc(x)
    frac = x - t
    r = np.round(x)
    return np.where(np.abs(frac) == F32(0.5), t + np.sign(x), r).astype(F32)


# ---------------------------------------------------------------------------
# Pipeline stages
# ---------------------------------------------------------------------------


def create_seed_image(img_u8: np.ndarray, proc=NumpyProcessing, cfg: SiftParams = DEFAULT_PARAMS) -> np.ndarray:
    """u8 -> f32 [0,1], 2x linear upsample, pre-blur (lib.rs:196-210)."""
    img = img_u8.astype(F32) / F32(255.0)
    h, w = img.shape
    img2x = proc.resize_linear(img, w * cfg.inv_delta_min, h * cfg.inv_delta_min)
    return proc.gaussian_blur(img2x, cfg.seed_sigma)


def build_gaussian_scale_space(seed: np.ndarray, n_octaves: int, proc=NumpyProcessing,
                               cfg: SiftParams = DEFAULT_PARAMS) -> list[np.ndarray]:
    """Per-octave stacks (S+3, H_o, W_o) (lib.rs:213-267)."""
    sigmas = cfg.octave_sigmas()
    octaves = []
    initial = seed
    for _ in range(n_octaves):
        imgs = [initial]
        for sigma in sigmas[1:]:
            imgs.append(proc.gaussian_blur(imgs[-1], sigma))
        octaves.append(np.stack(imgs, axis=0))
        nxt = imgs[len(imgs) - 3]
        h, w = nxt.shape
        initial = proc.resize_nearest(nxt, w // 2, h // 2)
    return octaves


def build_dog(scale_space: list[np.ndarray]) -> list[np.ndarray]:
    """Adjacent-slice subtraction (lib.rs:271-279)."""
    return [(o[1:] - o[:-1]).astype(F32) for o in scale_space]


def discrete_extrema_mask(dog: np.ndarray, cfg: SiftParams = DEFAULT_PARAMS) -> np.ndarray:
    """Vectorized 26-neighbor extremum test (lib.rs:437-506).

    Returns bool mask of shape (scales_per_octave, H, W) for s in 1..=3.
    The OpenCV-derived prefilter threshold floors to exactly 0.0 (lib.rs:460),
    so only |v| > 0 survives the prefilter; ties with neighbors are allowed
    (>= / <=).
    """
    S, H, W = dog.shape
    n_s = cfg.scales_per_octave
    border = cfg.image_border
    mask = np.zeros((n_s, H, W), dtype=bool)
    if H < 2 * border or W < 2 * border:
        return mask

    # 3x3 neighborhood max/min per slice, excluding center.
    def ring_max(a: np.ndarray) -> np.ndarray:
        p = np.pad(a, 1, constant_values=-np.inf)
        vs = [p[dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3) if not (dy == 1 and dx == 1)]
        return np.max(np.stack(vs), axis=0)

    def ring_min(a: np.ndarray) -> np.ndarray:
        p = np.pad(a, 1, constant_values=np.inf)
        vs = [p[dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3) if not (dy == 1 and dx == 1)]
        return np.min(np.stack(vs), axis=0)

    rmax = np.stack([ring_max(dog[s]) for s in range(S)])
    rmin = np.stack([ring_min(dog[s]) for s in range(S)])

    for s in range(1, n_s + 1):
        v = dog[s]
        up = np.maximum(np.maximum(rmax[s - 1], rmax[s + 1]), rmax[s])
        up = np.maximum(up, np.maximum(dog[s - 1], dog[s + 1]))
        lo = np.minimum(np.minimum(rmin[s - 1], rmin[s + 1]), rmin[s])
        lo = np.minimum(lo, np.minimum(dog[s - 1], dog[s + 1]))
        is_max = (v > 0.0) & (v >= up)
        is_min = (v < 0.0) & (v <= lo)
        m = is_max | is_min
        m[:border, :] = False
        m[H - border:, :] = False
        m[:, :border] = False
        m[:, W - border:] = False
        mask[s - 1] = m
    return mask


def _grad_hess(dog: np.ndarray, s, y, x):
    """3D gradient and Hessian entries at integer points (lib.rs:540-553).
    s/y/x are int arrays; returns per-candidate f32 arrays."""
    d = dog
    g1 = (d[s + 1, y, x] - d[s - 1, y, x]) / F32(2.0)
    g2 = (d[s, y + 1, x] - d[s, y - 1, x]) / F32(2.0)
    g3 = (d[s, y, x + 1] - d[s, y, x - 1]) / F32(2.0)
    v2 = d[s, y, x] * F32(2.0)
    h11 = d[s + 1, y, x] + d[s - 1, y, x] - v2
    h12 = (d[s + 1, y + 1, x] - d[s + 1, y - 1, x] - d[s - 1, y + 1, x] + d[s - 1, y - 1, x]) / F32(4.0)
    h13 = (d[s + 1, y, x + 1] - d[s + 1, y, x - 1] - d[s - 1, y, x + 1] + d[s - 1, y, x - 1]) / F32(4.0)
    h22 = d[s, y + 1, x] + d[s, y - 1, x] - v2
    h33 = d[s, y, x + 1] + d[s, y, x - 1] - v2
    h23 = (d[s, y + 1, x + 1] - d[s, y + 1, x - 1] - d[s, y - 1, x + 1] + d[s, y - 1, x - 1]) / F32(4.0)
    return g1, g2, g3, h11, h12, h13, h22, h33, h23


def interpolate_extrema(dog: np.ndarray, s0, y0, x0, cfg: SiftParams = DEFAULT_PARAMS):
    """Vectorized Newton refinement over candidates (lib.rs:508-603).

    Returns dict with ok mask, final integer (s,y,x) and offsets (f32).
    """
    S, H, W = dog.shape
    n = len(s0)
    s = s0.astype(np.int64).copy()
    y = y0.astype(np.int64).copy()
    x = x0.astype(np.int64).copy()
    off_s = np.zeros(n, F32)
    off_y = np.zeros(n, F32)
    off_x = np.zeros(n, F32)
    converged = np.zeros(n, bool)
    dead = np.zeros(n, bool)  # went out of bounds -> rejected forever
    border = cfg.image_border

    for _ in range(cfg.max_interpolation_steps):
        active = ~(converged | dead)
        if not active.any():
            break
        sa, ya, xa = s[active], y[active], x[active]
        g1, g2, g3, h11, h12, h13, h22, h33, h23 = _grad_hess(dog, sa, ya, xa)
        det = (h11 * h22 * h33 - h11 * h23 * h23 - h12 * h12 * h33
               + F32(2.0) * h12 * h13 * h23 - h13 * h13 * h22)
        with np.errstate(divide="ignore", invalid="ignore"):
            hinv11 = (h22 * h33 - h23 * h23) / det
            hinv12 = (h13 * h23 - h12 * h33) / det
            hinv13 = (h12 * h23 - h13 * h22) / det
            hinv22 = (h11 * h33 - h13 * h13) / det
            hinv23 = (h12 * h13 - h11 * h23) / det
            hinv33 = (h11 * h22 - h12 * h12) / det
            osc = -(hinv11 * g1 + hinv12 * g2 + hinv13 * g3)
            ox = -(hinv13 * g1 + hinv23 * g2 + hinv33 * g3)
            oy = -(hinv12 * g1 + hinv22 * g2 + hinv23 * g3)
        ok = (np.abs(osc) < 0.5) & (np.abs(ox) < 0.5) & (np.abs(oy) < 0.5)
        # NaN offsets (det==0) compare False in all three -> not ok; the
        # reference would produce inf/nan offsets and also fail the < checks
        # (NaN < 0.5 is false), then round NaN... Rust: NaN.round() is NaN,
        # `as isize` saturates NaN to 0 -> x+0, stays, loops. To match: treat
        # NaN offsets as 0 steps (stay in place, burn iterations).
        osc = np.where(np.isnan(osc), F32(0), osc)
        ox = np.where(np.isnan(ox), F32(0), ox)
        oy = np.where(np.isnan(oy), F32(0), oy)

        idx = np.where(active)[0]
        conv_idx = idx[ok]
        converged[conv_idx] = True
        off_s[conv_idx] = osc[ok]
        off_y[conv_idx] = oy[ok]
        off_x[conv_idx] = ox[ok]

        step_idx = idx[~ok]
        if len(step_idx) == 0:
            continue
        # Rust: x = x + offset.round() (f32 round half-away, cast through isize)
        nx = x[step_idx] + rust_round_f32(ox[~ok]).astype(np.int64)
        ny = y[step_idx] + rust_round_f32(oy[~ok]).astype(np.int64)
        ns = s[step_idx] + rust_round_f32(osc[~ok]).astype(np.int64)
        x[step_idx], y[step_idx], s[step_idx] = nx, ny, ns
        bad = ((ns < 1) | (ns > cfg.scales_per_octave)
               | (nx < border) | (nx >= W - border)
               | (ny < border) | (ny >= H - border))
        dead[step_idx[bad]] = True

    return {
        "ok": converged,
        "s": s, "y": y, "x": x,
        "off_s": off_s, "off_y": off_y, "off_x": off_x,
    }


def extremum_contrast(dog: np.ndarray, s, y, x, off_s, off_y, off_x) -> np.ndarray:
    """Interpolated DoG response (lib.rs:605-626)."""
    g1 = (dog[s + 1, y, x] - dog[s - 1, y, x]) / F32(2.0)
    g2 = (dog[s, y + 1, x] - dog[s, y - 1, x]) / F32(2.0)
    g3 = (dog[s, y, x + 1] - dog[s, y, x - 1]) / F32(2.0)
    interp = off_s * g1 + off_y * g2 + off_x * g3
    return dog[s, y, x] + interp / F32(2.0)


def extremum_on_edge(dog: np.ndarray, s, y, x, cfg: SiftParams = DEFAULT_PARAMS) -> np.ndarray:
    """Edge rejection at the refined integer point (lib.rs:628-653)."""
    d = dog
    v2 = d[s, y, x] * F32(2.0)
    h11 = d[s, y + 1, x] + d[s, y - 1, x] - v2
    d22 = d[s, y, x + 1] + d[s, y, x - 1] - v2
    h12 = (d[s, y + 1, x + 1] - d[s, y + 1, x - 1] - d[s, y - 1, x + 1] + d[s, y - 1, x - 1]) / F32(4.0)
    tr = d22 + h11
    det = d22 * h11 - h12 * h12
    edge_thr = F32(cfg.edge_threshold)
    on_edge = (det <= 0.0) | ((tr * tr * edge_thr) > (edge_thr + F32(1.0)) ** 2 * det)
    return on_edge


def gradient_direction_histogram(img: np.ndarray, x: int, y: int, radius: int,
                                 sigma: float, n_bins: int) -> np.ndarray:
    """36-bin orientation histogram around integer (x, y) (lib.rs:655-757).

    Returns the smoothed histogram (n_bins,) f32. Accumulation happens in
    sample scan order (y then x) to match the reference's float-add order.
    """
    h, w = img.shape
    grad_weight_scale = F32(-1.0) / (F32(2.0) * F32(sigma) * F32(sigma))

    ys = np.arange(-radius, radius + 1)
    ys_img = y + ys
    ys_ok = (ys > -y) & (ys_img > 0) & (ys_img < h - 1)
    xs = np.arange(-radius, radius + 1)
    xs_img = x + xs
    xs_ok = (xs > -x) & (xs_img > 0) & (xs_img < w - 1)

    yy_img, xx_img = np.meshgrid(ys_img[ys_ok], xs_img[xs_ok], indexing="ij")
    yy_p, xx_p = np.meshgrid(ys[ys_ok], xs[xs_ok], indexing="ij")
    dx = img[yy_img, xx_img + 1] - img[yy_img, xx_img - 1]
    dy = img[yy_img - 1, xx_img] - img[yy_img + 1, xx_img]
    wexp = ((yy_p * yy_p + xx_p * xx_p).astype(F32) * grad_weight_scale)
    # Rust f32::exp is glibc expf (correctly rounded); f64 exp + downcast
    # reproduces it except in vanishingly rare double-rounding corners.
    weights = np.exp(wexp.astype(np.float64)).astype(F32)
    mags = np.sqrt(dx * dx + dy * dy).astype(F32)
    oris = np.arctan2(dy.astype(np.float64), dx.astype(np.float64)).astype(F32)

    # lib.rs:718: n_bins as f32 / (PI32 * 2.) — f32 pi times 2, exact
    bin_angle_step = F32(n_bins) / (F32(np.pi) * F32(2.0))
    raw_bin = bin_angle_step * oris
    bins = rust_round_f32(raw_bin).astype(np.int64)
    bins = np.where(bins >= n_bins, bins - n_bins, bins)
    bins = np.where(bins < 0, bins + n_bins, bins)

    raw_hist = np.zeros(n_bins + 4, F32)
    contrib = (weights * mags).astype(F32)
    np.add.at(raw_hist, bins.ravel() + 2, contrib.ravel())
    raw_hist[1] = raw_hist[n_bins + 1]
    raw_hist[0] = raw_hist[n_bins]
    raw_hist[n_bins + 2] = raw_hist[2]
    raw_hist[n_bins + 3] = raw_hist[3]
    i = np.arange(2, n_bins + 2)
    hist = ((raw_hist[i - 2] + raw_hist[i + 2]) * F32(1.0 / 16.0)
            + (raw_hist[i - 1] + raw_hist[i + 1]) * F32(4.0 / 16.0)
            + raw_hist[i] * F32(6.0) / F32(16.0))
    return hist.astype(F32)


@dataclasses.dataclass
class OracleKeyPoint:
    x: float
    y: float
    size: float
    angle: float
    response: float
    octave: int
    scale: int


def find_keypoints(scale_space: list[np.ndarray], dog: list[np.ndarray],
                   cfg: SiftParams = DEFAULT_PARAMS) -> list[OracleKeyPoint]:
    """Detection + orientation over all octaves (lib.rs:281-435)."""
    keypoints: list[OracleKeyPoint] = []
    n_bins = cfg.n_orientation_bins
    for octave, d in enumerate(dog):
        mask = discrete_extrema_mask(d, cfg)
        cand = np.argwhere(mask)  # (N,3) in (s-1, y, x) row-major == scan order
        if len(cand) == 0:
            continue
        s0 = cand[:, 0] + 1
        y0 = cand[:, 1]
        x0 = cand[:, 2]
        res = interpolate_extrema(d, s0, y0, x0, cfg)
        ok = res["ok"]
        if not ok.any():
            continue
        s, y, x = res["s"][ok], res["y"][ok], res["x"][ok]
        off_s, off_y, off_x = res["off_s"][ok], res["off_y"][ok], res["off_x"][ok]
        contrast = extremum_contrast(d, s, y, x, off_s, off_y, off_x)
        keep = np.abs(contrast) * F32(cfg.scales_per_octave) > F32(cfg.contrast_threshold)
        on_edge = extremum_on_edge(d, s, y, x, cfg)
        keep &= ~on_edge

        osf = F32(2.0) ** np.int32(octave)
        # lib.rs:372-374: 0.8f32 * 2f32.powf((scale+off)/3) * 2 — powf via f64
        # exp2 + downcast (glibc powf is correctly rounded)
        pw = np.exp2(((s.astype(F32) + off_s) / F32(cfg.scales_per_octave)).astype(np.float64)).astype(F32)
        kp_scale = F32(cfg.sigma_min) * pw * F32(2.0)
        kp_x = (x.astype(F32) + off_x) * osf
        kp_y = (y.astype(F32) + off_y) * osf
        radius = rust_round_f32(F32(3.0) * F32(cfg.lambda_ori) * kp_scale).astype(np.int64)

        for i in np.where(keep)[0]:
            img = scale_space[octave][s[i]]
            hist = gradient_direction_histogram(
                img, int(x[i]), int(y[i]), int(radius[i]),
                F32(cfg.lambda_ori) * kp_scale[i], n_bins)
            hist_max = hist.max()
            thr = hist_max * F32(cfg.orientation_localmax_ratio)
            for k in range(n_bins):
                km = (k - 1) % n_bins
                kp_ = (k + 1) % n_bins
                if hist[k] > hist[km] and hist[k] > hist[kp_] and hist[k] >= thr:
                    interp = (hist[km] - hist[kp_]) / (hist[km] - F32(2.0) * hist[k] + hist[kp_])
                    b = F32(k) + F32(0.5) * interp
                    if b < 0:
                        b = F32(n_bins) + b
                    elif b >= n_bins:
                        b = b - F32(n_bins)
                    angle = F32(360.0) - (F32(360.0) / F32(n_bins)) * b
                    keypoints.append(OracleKeyPoint(
                        x=kp_x[i], y=kp_y[i],
                        size=kp_scale[i] * osf,
                        angle=angle, response=np.abs(contrast[i]),
                        octave=octave, scale=int(s[i]),
                    ))
    return keypoints


def compute_descriptor(img: np.ndarray, x: float, y: float, scale: float,
                       orientation: float, cfg: SiftParams = DEFAULT_PARAMS) -> np.ndarray:
    """128-D u8 descriptor (lib.rs:785-990)."""
    n_hist = cfg.descriptor_n_histograms
    n_bins = cfg.descriptor_n_bins
    height, width = img.shape
    xi = int(rust_round_f32(F32(x)))
    yi = int(rust_round_f32(F32(y)))
    bin_angle_step = F32(n_bins) / F32(360.0)
    hist_width = F32(cfg.lambda_descr) * F32(scale)
    radius = int(rust_round_f32(
        F32(cfg.lambda_descr) * F32(scale) * F32(np.sqrt(np.float32(2.0)))
        * F32(n_hist + 1) * F32(0.5)))
    # Rust f32::to_radians = self * (f32::consts::PI / 180.0) — an f32 constant
    deg2rad_f32 = F32(np.float32(np.pi) / np.float32(180.0))
    ori_rad = F32(orientation) * deg2rad_f32
    # Rust f32::sin_cos -> libm sinf/cosf (correctly rounded); emulate via f64
    sin_ori = np.float32(np.sin(np.float64(ori_rad)))
    cos_ori = np.float32(np.cos(np.float64(ori_rad)))
    sin_ori_scaled = sin_ori / hist_width
    cos_ori_scaled = cos_ori / hist_width

    rng = np.arange(-radius, radius + 1, dtype=np.int64)
    yy, xx = np.meshgrid(rng, rng, indexing="ij")  # y outer = scan order
    yyf = yy.astype(F32)
    xxf = xx.astype(F32)
    col_rot = xxf * cos_ori_scaled - yyf * sin_ori_scaled
    row_rot = xxf * sin_ori_scaled + yyf * cos_ori_scaled
    row_bin = row_rot + F32(n_hist / 2)
    col_bin = col_rot + F32(n_hist / 2)
    abs_y = yi + yy
    abs_x = xi + xx
    ok = ((row_bin > -0.5) & (row_bin < n_hist + 0.5)
          & (col_bin > -0.5) & (col_bin < n_hist + 0.5)
          & (abs_y > 0) & (abs_y < height - 1)
          & (abs_x > 0) & (abs_x < width - 1))

    ay, ax = abs_y[ok], abs_x[ok]
    dx = img[ay, ax + 1] - img[ay, ax - 1]
    dy = img[ay - 1, ax] - img[ay + 1, ax]
    col_rot, row_rot = col_rot[ok], row_rot[ok]
    row_bin, col_bin = row_bin[ok], col_bin[ok]

    weight_scale = F32(-2.0) / F32(n_hist * n_hist)
    # lib.rs:850: col_rotated.powi(2) + row_rotated.powi(2)
    w2 = col_rot * col_rot + row_rot * row_rot
    weights = np.exp((w2 * weight_scale).astype(np.float64)).astype(F32)
    ori_norm = ((np.degrees(np.arctan2(dy.astype(np.float64), dx.astype(np.float64)))
                 + 360.0) % 360.0).astype(F32) - F32(orientation)
    mag = np.sqrt(dx * dx + dy * dy).astype(F32)

    # trilinear scatter (lib.rs:883-948)
    row_bin = row_bin - F32(0.5)
    col_bin = col_bin - F32(0.5)
    m = mag * weights
    obin = ori_norm * bin_angle_step
    row_floor = np.floor(row_bin)
    col_floor = np.floor(col_bin)
    ori_floor = np.floor(obin)
    row_frac = row_bin - row_floor
    col_frac = col_bin - col_floor
    ori_frac = obin - ori_floor

    c1 = m * row_frac
    c0 = m - c1
    c11 = c1 * col_frac
    c10 = c1 - c11
    c01 = c0 * col_frac
    c00 = c0 - c01
    c111 = c11 * ori_frac
    c110 = c11 - c111
    c101 = c10 * ori_frac
    c100 = c10 - c101
    c011 = c01 * ori_frac
    c010 = c01 - c011
    c001 = c00 * ori_frac
    c000 = c00 - c001

    rf1 = (row_floor + 1).astype(np.int64)
    cf1 = (col_floor + 1).astype(np.int64)
    rf2 = rf1 + 1
    cf2 = cf1 + 1
    of = ori_floor.astype(np.int64)
    of = np.where(of < 0, of + n_bins, of)
    of = np.where(of >= n_bins, of - n_bins, of)
    of1 = np.where(of + 1 >= n_bins, 0, of + 1)

    hist = np.zeros((n_hist + 2) * (n_hist + 2) * n_bins, F32)
    nb = n_bins
    side = n_hist + 2
    # per-sample interleaved adds, in the reference's fixed c000..c111 order
    idx8 = np.stack([
        (rf1 * side + cf1) * nb + of,
        (rf1 * side + cf1) * nb + of1,
        (rf1 * side + cf2) * nb + of,
        (rf1 * side + cf2) * nb + of1,
        (rf2 * side + cf1) * nb + of,
        (rf2 * side + cf1) * nb + of1,
        (rf2 * side + cf2) * nb + of,
        (rf2 * side + cf2) * nb + of1,
    ], axis=1).ravel()
    val8 = np.stack([c000, c001, c010, c011, c100, c101, c110, c111], axis=1).ravel()
    np.add.at(hist, idx8, val8)

    hist = hist.reshape(side, side, nb)[1:-1, 1:-1, :].ravel()

    # finalization (lib.rs:950-990): chunks-of-4 sequential norm accumulation
    def chunked_l2(v: np.ndarray) -> np.float32:
        sq = v * v
        chunk = sq.reshape(-1, 4)
        csum = ((chunk[:, 0] + chunk[:, 1]) + chunk[:, 2]) + chunk[:, 3]
        acc = csum[0]
        for i in range(1, len(csum)):
            acc = acc + csum[i]
        return np.float32(np.sqrt(acc))

    l2_uncapped = chunked_l2(hist)
    cap = l2_uncapped * F32(cfg.descriptor_magnitude_cap)
    hist = np.minimum(hist, cap)
    l2_capped = chunked_l2(hist)
    normalizer = F32(cfg.descriptor_l2_norm) / np.maximum(l2_capped, np.finfo(F32).eps)
    q = rust_round_f32(hist * normalizer).astype(np.int64)
    return np.clip(q, 0, 255).astype(np.uint8)


def compute_descriptors(scale_space: list[np.ndarray], keypoints: list[OracleKeyPoint],
                        cfg: SiftParams = DEFAULT_PARAMS) -> np.ndarray:
    """Batch form (lib.rs:759-782)."""
    out = np.zeros((len(keypoints), cfg.descriptor_size), np.uint8)
    for i, kp in enumerate(keypoints):
        img = scale_space[kp.octave][kp.scale]
        angle = F32(360.0) - F32(kp.angle)
        osf = F32(2.0) ** np.int32(-kp.octave)
        out[i] = compute_descriptor(img, F32(kp.x) * osf, F32(kp.y) * osf,
                                    F32(kp.size) * osf, angle, cfg)
    return out


def sift(img_u8: np.ndarray, features_limit: int | None = None, proc=NumpyProcessing,
         cfg: SiftParams = DEFAULT_PARAMS):
    """Full pipeline (lib.rs:71-177). Returns (keypoints (N,5) f32 in original
    image coords with columns x,y,size,angle,response; descriptors (N,128) u8)."""
    seed = create_seed_image(img_u8, proc, cfg)
    n_octaves = cfg.n_octaves(seed.shape[0], seed.shape[1])
    ss = build_gaussian_scale_space(seed, n_octaves, proc, cfg)
    dog = build_dog(ss)
    kps = find_keypoints(ss, dog, cfg)
    if features_limit is not None and features_limit < len(kps):
        order = np.argsort(-np.asarray([kp.response for kp in kps], F32), kind="stable")
        kps = [kps[i] for i in order[:features_limit]]
    desc = compute_descriptors(ss, kps, cfg)
    arr = np.asarray(
        [[kp.x * F32(cfg.delta_min), kp.y * F32(cfg.delta_min),
          kp.size * F32(cfg.delta_min), kp.angle, kp.response] for kp in kps],
        F32).reshape(-1, 5)
    return arr, desc
