"""End-to-end SIFT extractor of the port.

Counterpart of sift_features_tpu/models/extractor.py. The frame-batched
fused path `_extract_batch_fused`, for every octave whose padded plane is at
least 256 x 256:

    seed -> [K1 blur chain + DoG -> K2 extremum words -> word compaction ->
    K3 Newton walk (or K4 steps) -> survivor compaction -> K5 orientation
    histograms + peaks -> emission compaction -> K6 descriptor histograms ->
    finalize_descriptor]

With a features_limit the descriptors wait: `_assemble_budget` takes each
frame's response top-K over all octaves first and describes only the chosen
keypoints (K6′ through `descriptor_hist_bucketed`).

The other modes of SiftConfig give the same output through other kernels:
refine_mode="region" runs K10 for the first region_steps Newton steps and
K4 after them, refine_mode="tile" the K11 tile walk (escapes re-refined by
K4), refine_mode="step" K4 only; window_kernel="perkey" replaces K5 / K5′
by K8 and K6 / K6′ by K7, launched per scale bucket, with the peaks taken
from the smoothed histograms.

The storage modes of SiftConfig act on this path alone, as in the JAX
package: storage_dtype="bfloat16" rounds the seed to bf16 and K1 stores
bf16 levels and DoG (the refinement then takes the K4 step loop, whatever
refine_mode says, and the window kernels read bf16); "split" stores the
Gaussian levels bf16 and the DoG f32, bit-equal to the f32 run's, and
chains the octaves through K1's f32 level S; gather_dtype="bfloat16" adds
K1's bf16 copy of the Gaussian levels for the window kernels. The tiny
octaves compute in f32 and round their next base back to the storage type.

The per-frame path `_extract_single` builds each octave level by level (K9)
and runs the single-frame `_detect_octave`: K2′ words (or the plain extremum
scan), K3 or K4, K5′ histograms, K6′ descriptors. `extract_with_precomputed`
runs the same `_detect_octave` on `precompute`'s plain pyramid, and the
spatial path (parallel/extract.py) runs it on each member's row band
(the plain extremum scan there, never K2′), describing a budget's chosen
rows through `_describe_octave_subset`. Which branch
of `_detect_octave` runs depends on shapes only, as on the TPU, so the CPU
runs the same branches with the kernels' plain versions inside.

The tiny top octaves take `_detect_octave_plain` (pure torch ops, batched
over frames). Per-frame compaction keeps the reference's scan order;
per-octave counters n_candidates / n_survivors / n_emitted expose any
capacity overflow. Kernels launch once per stage per octave for the whole
batch. With tensors on the CPU every kernel wrapper runs its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, SiftConfig, check_supported
from ..ops import descriptor as desc_ops
from ..ops import extrema as ext_ops
from ..ops import orientation as ori_ops
from ..ops.kernels.descriptor import descriptor_hist, descriptor_hist_bucketed
from ..ops.kernels.extrema import extrema_words, extrema_words_single
from ..ops.kernels.orientation import (orientation_hist_peaks,
                                       orientation_histograms_bucketed)
from ..ops.kernels.pyramid import (build_octave_padded, octave_fused,
                                   reflect_pad_image)
from ..ops.kernels.refine import (refine_region, refine_stepwise,
                                  refine_tile, refine_walk)
from ..ops.pyramid import (build_dog, build_scale_space, create_seed_image,
                           octave_levels)
from ..ops.resize import resize_nearest_half
from ..ops.util import f32, rust_round
from ..utils.compact import compact_indices
from ..utils.device import resolve_device

F32 = torch.float32


def octave_capacities(h: int, w: int, cfg: SiftConfig):
    """Static per-octave buffer sizes (raw candidates K, survivors K2,
    emitted keypoints M), the sizing rule of the JAX package
    (models/extractor.py:_octave_capacities)."""
    k = min(cfg.max_candidates_per_octave, max(512, (3 * h * w) // 512))
    k = -(-k // 128) * 128
    k2 = max(256, k // 2)
    m = min(cfg.max_keypoints_per_octave, max(256, (3 * k2) // 2))
    return k, k2, -(-m // 128) * 128


def padded_dims(h: int, w: int) -> tuple[int, int]:
    """Padded plane of an (h, w) octave: the PAD_DESC ring, rows and columns
    rounded up to 128, columns above 1536 up to 1024 (the JAX layout)."""
    p = desc_ops.PAD_DESC
    h_pad = -(-(h + 2 * p) // 128) * 128
    w_pad = -(-(w + 2 * p) // 128) * 128
    if w_pad > 1536:
        w_pad = -(-w_pad // 1024) * 1024
    return h_pad, w_pad


def stable_top_k(values: torch.Tensor, k: int):
    """Top k along the last axis, largest first, with jax.lax.top_k's tie
    rule: among equal values the lower index comes first (torch.topk leaves
    the order of ties unspecified). -> (values, int64 indices)."""
    val, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def _frame_offsets(b: int, per_frame: int, n: int, dev) -> torch.Tensor:
    """(b * n,) int32: frame * per_frame for each of the n lanes of a frame."""
    return (torch.arange(b, dtype=torch.int32, device=dev)
            * per_frame).repeat_interleave(n)


def _emit(angles, emit, svalid, m: int):
    """Compact (B, K2, n) emission flags into M keypoint slots: (survivor
    index ci, angle, valid, count) per frame, scan order."""
    b, k2, n = emit.shape
    e = (emit & svalid[:, :, None]).reshape(b, k2 * n)
    eidx, evalid, n_emit = compact_indices(e, m)
    kp_angle = torch.where(evalid, torch.gather(angles.reshape(b, k2 * n), 1, eidx),
                           torch.zeros((), dtype=F32, device=e.device))
    return eidx // n, kp_angle, evalid, n_emit


def _survivors(rows, valid, b: int, k: int, k2: int, coord_off: int):
    """Per-frame survivor compaction of (b * k, 16) refine rows."""
    ref = ext_ops.rows_to_fields(rows)
    keep = (ref["keep"] & valid.reshape(-1)).reshape(b, k)
    sidx, svalid, n_surv = compact_indices(keep, k2)

    def g2(a):
        return torch.gather(a.reshape(b, k), 1, sidx)

    surv = {name: g2(ref[name]) for name in
            ("s", "y", "x", "off_s", "off_y", "off_x", "response")}
    surv["y"] = surv["y"] - coord_off
    surv["x"] = surv["x"] - coord_off
    return surv, svalid, n_surv


def _keypoints(surv, ci, kp_angle, evalid, octave: int, cfg: SiftConfig):
    """Keypoint rows [x, y, size, angle, response] in image coordinates plus
    the descriptor inputs, gathered at the emitted survivors."""
    def gc(a):
        return torch.gather(a, 1, ci)

    x_oct = gc(surv["x"].to(F32)) + gc(surv["off_x"])
    y_oct = gc(surv["y"].to(F32)) + gc(surv["off_y"])
    kp_sc = gc(surv["kp_scale"])
    osf = f32(2.0 ** octave, x_oct)
    dm = f32(cfg.delta_min, x_oct)
    kps = torch.stack([(x_oct * osf) * dm, (y_oct * osf) * dm,
                       (kp_sc * osf) * dm, kp_angle, gc(surv["response"])], -1)
    kps = torch.where(evalid[..., None], kps, torch.zeros_like(kps))
    return kps, {"kp_s": gc(surv["s"]), "x_oct": x_oct, "y_oct": y_oct,
                 "kp_sc": kp_sc}


def _refine_auto(dog_flat, s0, y0, x0, valid, pad: int, h: int, w: int,
                 cfg: SiftConfig, plane_off=None):
    """The refinement dispatch of ops/extrema.py:refine_tpu_auto: when the
    stack is f32 with rows % 8 == 0 and columns % 128 == 0, refine_mode
    picks the K11 tile walk, the K3 walk, the K10-then-K4 region loop or
    the K4 step loop; otherwise the K4 step loop. All give the same rows."""
    hp, wp = dog_flat.shape[-2], dog_flat.shape[-1]
    tile_ok = dog_flat.dtype == F32 and hp % 8 == 0 and wp % 128 == 0
    fn = {"tile": refine_tile, "walk": refine_walk, "region": refine_region,
          "step": refine_stepwise}[cfg.refine_mode if tile_ok else "step"]
    return fn(dog_flat, s0, y0, x0, valid, pad, h, w, cfg, plane_off=plane_off)


def _detect_octave_batched(gauss_p, dog_p, octave: int, cfg: SiftConfig, hw,
                           describe: bool = True, gauss_win=None):
    """Frame-batched detection on the padded stacks of K1: gauss_p (B, S,
    Hp, Wp) = levels 1..S, dog_p (B, S+2, Hp, Wp); hw the unpadded octave
    size (models/extractor.py:_detect_octave_batched, stages="full").
    gauss_win: K1's bf16 copy of gauss_p (gather16), which the window
    kernels then sample instead. describe=False (the budget path) skips the
    descriptors and returns their inputs `desc_in` and the window stack
    `win_ctx` instead."""
    b, n_dog, hp, wp = dog_p.shape
    h, w = hw
    dev = dog_p.device
    k, k2, m = octave_capacities(h, w, cfg)
    p = desc_ops.PAD_DESC
    bd = cfg.image_border
    n_bins = cfg.n_orientation_bins

    words = extrema_words(dog_p, (p + bd, p + h - bd, p + bd, p + w - bd), cfg)
    s0, y0, x0, valid, n_cand = ext_ops.find_candidates_words(words, k)

    rows = _refine_auto(dog_p.reshape(b * n_dog, hp, wp), s0.reshape(-1),
                        y0.reshape(-1), x0.reshape(-1), valid.reshape(-1), p, h,
                        w, cfg, plane_off=_frame_offsets(b, n_dog, k, dev))
    surv, svalid, n_surv = _survivors(rows, valid, b, k, k2, p)
    surv["kp_scale"] = ori_ops.kp_scale_of(surv["s"], surv["off_s"], cfg)

    win_src = gauss_p if gauss_win is None else gauss_win
    n_win = win_src.shape[1]
    gauss_flat = win_src.reshape(b * n_win, hp, wp)
    live2 = svalid.reshape(-1)
    ori_args = (gauss_flat, (surv["s"] - 1).reshape(-1)
                + _frame_offsets(b, n_win, k2, dev))
    if cfg.window_kernel == "perkey":
        # K8 per scale bucket, no peaks in the kernel
        hist = orientation_histograms_bucketed(
            *ori_args, surv["s"].reshape(-1), surv["y"].reshape(-1),
            surv["x"].reshape(-1), surv["kp_scale"].reshape(-1), None, h, w,
            p, cfg, live=live2)
    else:
        raw, angles_p, n_pk = orientation_hist_peaks(
            *ori_args, surv["y"].reshape(-1), surv["x"].reshape(-1),
            surv["kp_scale"].reshape(-1), live2, h, w, p, cfg)
        n_pk_cap = angles_p.shape[1]
        # a survivor with more peaks than the kernel's slots takes the
        # full peaks too
        hist = (ori_ops.smooth(raw)
                if bool(((n_pk > n_pk_cap) & live2).any()) else None)
    if hist is not None:
        # the full peaks over the smoothed histograms (extractor.py:342-354)
        angles, emit = ori_ops.orientation_peaks(hist, cfg)
        ci, kp_angle, evalid, n_emit = _emit(
            angles.reshape(b, k2, n_bins), emit.reshape(b, k2, n_bins), svalid, m)
    else:
        slots = torch.arange(n_pk_cap, device=dev)
        emit = slots < torch.clamp(n_pk, max=n_pk_cap).reshape(b, k2)[:, :, None]
        ci, kp_angle, evalid, n_emit = _emit(
            angles_p.reshape(b, k2, n_pk_cap), emit, svalid, m)

    kps, d_in = _keypoints(surv, ci, kp_angle, evalid, octave, cfg)
    xi = rust_round(d_in["x_oct"]).to(torch.int32)
    yi = rust_round(d_in["y_oct"]).to(torch.int32)
    res = {"kps": kps, "valid": evalid, "n_candidates": n_cand,
           "n_survivors": n_surv, "n_emitted": n_emit}
    if not describe:
        # the budget path describes only the chosen keypoints later, which
        # keeps every octave's window stack alive until then
        # (models/extractor.py:414-428)
        res["desc_in"] = {"kp_s": d_in["kp_s"], "xi": xi, "yi": yi,
                          "kp_sc": d_in["kp_sc"], "kp_angle": kp_angle}
        res["win_ctx"] = (gauss_flat, n_win)
        return res
    desc_args = (gauss_flat, (d_in["kp_s"] - 1).reshape(-1)
                 + _frame_offsets(b, n_win, m, dev))
    desc_lanes = (xi.reshape(-1), yi.reshape(-1), d_in["kp_sc"].reshape(-1),
                  kp_angle.reshape(-1))
    if cfg.window_kernel == "perkey":
        hist = descriptor_hist_bucketed(
            *desc_args, d_in["kp_s"].reshape(-1), *desc_lanes, None, h, w, p,
            cfg, live=evalid.reshape(-1))
    else:
        hist = descriptor_hist(*desc_args, *desc_lanes, evalid.reshape(-1), h,
                               w, p, cfg)
    res["desc"] = desc_ops.finalize_descriptor(hist, cfg).reshape(b, m, -1)
    return res


def _describe_subset(gauss_flat, win_planes: int, fields, live,
                     cfg: SiftConfig, h: int, w: int, slot_off: int = 1):
    """Descriptors (B, C, 128) u8 of a compacted keypoint subset: fields are
    (B, C) tensors of `desc_in` gathered at the chosen rows, live the (B, C)
    mask (models/extractor.py:_describe_subset); K6′ serves it, or K7 with
    window_kernel="perkey". Plane f * win_planes + k of gauss_flat holds
    frame f's level k + slot_off."""
    b, c = fields["kp_s"].shape
    kp_s = fields["kp_s"].reshape(-1)
    hist = descriptor_hist_bucketed(
        gauss_flat,
        kp_s - slot_off + _frame_offsets(b, win_planes, c, gauss_flat.device),
        kp_s, fields["xi"].reshape(-1), fields["yi"].reshape(-1),
        fields["kp_sc"].reshape(-1), fields["kp_angle"].reshape(-1), None,
        h, w, desc_ops.PAD_DESC, cfg, live=live.reshape(-1))
    return desc_ops.finalize_descriptor(hist, cfg).reshape(b, c, -1)


def _detect_octave_plain(gauss: torch.Tensor, octave: int, cfg: SiftConfig,
                         dog: torch.Tensor | None = None, bounds=None,
                         describe: bool = True):
    """The plain branch of models/extractor.py:_detect_octave (pure torch
    ops, no kernel), batched over frames: the tiny top octaves. gauss (B,
    S+3, h, w) holds every level of the octave; dog (B, S+2, h, w) defaults
    to the differences of adjacent levels. bounds = (y0, y1, x0, x1) limits
    the candidates (default: the image_border interior). describe=False
    returns the descriptor inputs `desc_in` and the window stack `win_ctx`
    in place of `desc` (see _describe_octave_subset)."""
    b, n_lv, h, w = gauss.shape
    dev = gauss.device
    k, k2, m = octave_capacities(h, w, cfg)
    p = desc_ops.PAD_DESC
    n_bins = cfg.n_orientation_bins

    gp = desc_ops.pad_stack_for_kernels(gauss)
    hp, wp = gp.shape[-2], gp.shape[-1]
    gflat = gp.reshape(b * n_lv, hp, wp)
    if dog is None:
        dog = gauss[:, 1:] - gauss[:, :-1]
    mask = ext_ops.extrema_mask(dog, cfg, bounds=bounds)
    s0, y0, x0, valid, n_cand = ext_ops.find_candidates(mask, k)
    n_dog = n_lv - 1
    rows = ext_ops.refine(dog.reshape(b * n_dog, h, w), s0.reshape(-1),
                          y0.reshape(-1), x0.reshape(-1), valid.reshape(-1),
                          0, h, w, cfg, plane_off=_frame_offsets(b, n_dog, k, dev))
    surv, svalid, n_surv = _survivors(rows, valid, b, k, k2, 0)
    surv["kp_scale"] = ori_ops.kp_scale_of(surv["s"], surv["off_s"], cfg)

    hist = ori_ops.orientation_histograms(
        gflat, h, w, surv["s"].reshape(-1) + _frame_offsets(b, n_lv, k2, dev),
        surv["y"].reshape(-1), surv["x"].reshape(-1),
        surv["kp_scale"].reshape(-1), svalid.reshape(-1), cfg, pad=p)
    angles, emit = ori_ops.orientation_peaks(hist, cfg)
    ci, kp_angle, evalid, n_emit = _emit(
        angles.reshape(b, k2, n_bins), emit.reshape(b, k2, n_bins), svalid, m)

    kps, d_in = _keypoints(surv, ci, kp_angle, evalid, octave, cfg)
    res = {"kps": kps, "valid": evalid, "n_candidates": n_cand,
           "n_survivors": n_surv, "n_emitted": n_emit}
    if not describe:
        res["desc_in"] = {**d_in, "kp_angle": kp_angle}
        res["win_ctx"] = (gflat, 0, False)
        return res
    res["desc"] = desc_ops.descriptor_batch(
        gflat, h, w, d_in["kp_s"].reshape(-1) + _frame_offsets(b, n_lv, m, dev),
        d_in["x_oct"].reshape(-1), d_in["y_oct"].reshape(-1),
        d_in["kp_sc"].reshape(-1), kp_angle.reshape(-1), evalid.reshape(-1),
        cfg, pad=p).reshape(b, m, -1)
    return res


def _detect_octave(gauss, dog, octave: int, cfg: SiftConfig, padded=None,
                   hw=None, row_range=None, describe: bool = True):
    """Single-frame single-octave detection (models/extractor.py:
    _detect_octave). gauss (S+3, h, w) and dog (S+2, h, w) or None, or
    padded = (gauss_slots, dog_p, slot_off) from the per-level pyramid
    kernel K9 with hw = (h, w): gauss_slots[k] holds level k + slot_off.
    The kernel branch runs when the padded plane is at least 256 wide,
    whatever the device; else the plain branch.

    row_range = (y0, y1) limits the candidates to rows [y0, y1) of the
    octave (the spatial path's row band, clipped to the image_border
    interior); the extremum scan then takes the plain mask with those
    bounds, never K2′, as the JAX package's traced band does.
    describe=False returns the descriptor inputs `desc_in` (kp_s, x_oct,
    y_oct, kp_sc, kp_angle) and the window context `win_ctx` in place of
    `desc`, for _describe_octave_subset."""
    if padded is not None:
        gauss_padded, dog_p, slot_off = padded
        h, w = hw
    else:
        h, w = gauss.shape[-2], gauss.shape[-1]
        slot_off = 0
        gauss_padded = desc_ops.pad_stack_for_kernels(gauss)
    bd = cfg.image_border
    y_lo, y_hi = (bd, h - bd) if row_range is None else (
        max(bd, row_range[0]), min(h - bd, row_range[1]))
    if gauss_padded.shape[-1] < 256:
        r = _detect_octave_plain(gauss[None], octave, cfg,
                                 None if dog is None else dog[None],
                                 bounds=(y_lo, y_hi, bd, w - bd),
                                 describe=describe)
        one = {key: v[0] for key, v in r.items()
               if key not in ("desc_in", "win_ctx")}
        if not describe:
            one["desc_in"] = {key: v[0] for key, v in r["desc_in"].items()}
            one["win_ctx"] = r["win_ctx"]
        return one
    k, k2, m = octave_capacities(h, w, cfg)
    p = desc_ops.PAD_DESC
    n_bins = cfg.n_orientation_bins
    if padded is None:
        # the precomputed layout: the DoG of the zero-padded stack
        dog_p = gauss_padded[1:] - gauss_padded[:-1]
    hp, wp = dog_p.shape[-2], dog_p.shape[-1]
    if row_range is None and hp % 128 == 0 and (wp <= 1536 or wp % 1024 == 0):
        words = extrema_words_single(
            dog_p, (p + bd, p + h - bd, p + bd, p + w - bd), cfg)
        s0, y0, x0, valid, n_cand = ext_ops.find_candidates_words(words, k)
    else:
        mask = ext_ops.extrema_mask(dog_p, cfg,
                                    bounds=(p + y_lo, p + y_hi, p + bd, p + w - bd))
        s0, y0, x0, valid, n_cand = ext_ops.find_candidates(mask, k)
    rows = _refine_auto(dog_p, s0, y0, x0, valid, p, h, w, cfg)
    surv, svalid, n_surv = _survivors(rows, valid[None], 1, k, k2, p)
    surv["kp_scale"] = ori_ops.kp_scale_of(surv["s"], surv["off_s"], cfg)

    s = surv["s"][0]
    hist = orientation_histograms_bucketed(
        gauss_padded, s - slot_off, s, surv["y"][0], surv["x"][0],
        surv["kp_scale"][0], n_surv[0], h, w, p, cfg)
    angles, emit = ori_ops.orientation_peaks(hist, cfg)
    ci, kp_angle, evalid, n_emit = _emit(
        angles.reshape(1, k2, n_bins), emit.reshape(1, k2, n_bins), svalid, m)
    kps, d_in = _keypoints(surv, ci, kp_angle, evalid, octave, cfg)
    res = {"kps": kps[0], "valid": evalid[0], "n_candidates": n_cand,
           "n_survivors": n_surv[0], "n_emitted": n_emit[0]}
    if not describe:
        res["desc_in"] = {**{key: v[0] for key, v in d_in.items()},
                          "kp_angle": kp_angle[0]}
        res["win_ctx"] = (gauss_padded, slot_off, True)
        return res
    kp_s = d_in["kp_s"][0]
    hist128 = descriptor_hist_bucketed(
        gauss_padded, kp_s - slot_off, kp_s,
        rust_round(d_in["x_oct"][0]).to(torch.int32),
        rust_round(d_in["y_oct"][0]).to(torch.int32), d_in["kp_sc"][0],
        kp_angle[0], n_emit[0], h, w, p, cfg)
    res["desc"] = desc_ops.finalize_descriptor(hist128, cfg)
    return res


def _describe_octave_subset(win_ctx, fields, live, cfg: SiftConfig, h: int,
                            w: int) -> torch.Tensor:
    """Descriptors (C, 128) u8 of a compacted subset of one frame's octave,
    from _detect_octave(describe=False): fields are (C,) tensors of its
    `desc_in` at the chosen rows, live the (C,) mask
    (models/extractor.py:_describe_octave_subset). The kernel branch's
    subset goes through _describe_subset (K6′, or K7 with
    window_kernel="perkey"); the plain branch's through the plain
    descriptor."""
    gauss_padded, slot_off, kernels = win_ctx
    if kernels:
        one = {"kp_s": fields["kp_s"][None], "kp_sc": fields["kp_sc"][None],
               "kp_angle": fields["kp_angle"][None],
               "xi": rust_round(fields["x_oct"]).to(torch.int32)[None],
               "yi": rust_round(fields["y_oct"]).to(torch.int32)[None]}
        return _describe_subset(gauss_padded, gauss_padded.shape[0], one,
                                live[None], cfg, h, w, slot_off)[0]
    return desc_ops.descriptor_batch(
        gauss_padded, h, w, fields["kp_s"] - slot_off, fields["x_oct"],
        fields["y_oct"], fields["kp_sc"], fields["kp_angle"], live, cfg,
        pad=desc_ops.PAD_DESC)


COUNTERS = ("n_candidates", "n_survivors", "n_emitted")


def _concat(out: list[dict], dim: int, keys=("kps", "desc", "valid")) -> dict:
    """Per-octave results -> rows concatenated along `dim` (0 for one
    frame, 1 for a batch) and the counters stacked there (n_octaves)."""
    res = {key: torch.cat([r[key] for r in out], dim) for key in keys}
    res.update({key: torch.stack([r[key] for r in out], dim) for key in COUNTERS})
    return res


def _extract_single(img_u8: torch.Tensor, n_octaves: int, cfg: SiftConfig):
    """The per-frame pipeline (models/extractor.py:_extract_single): (H, W)
    u8 -> one frame's result dict. Octaves whose padded plane is at least
    256 x 256 are built level by level in K9 and detected on its slots;
    the others blur in plain torch ops."""
    p = desc_ops.PAD_DESC
    initial = create_seed_image(img_u8[None], cfg)[0]
    out = []
    for o in range(n_octaves):
        h, w = initial.shape
        h_pad, w_pad = padded_dims(h, w)
        if h_pad >= 256 and w_pad >= 256:
            base = reflect_pad_image(initial, p, w_pad - w - 2 * p,
                                     h_pad - h - 2 * p).contiguous()
            g_slots, dog_p = build_octave_padded(base, cfg)
            out.append(_detect_octave(None, None, o, cfg,
                                      padded=(g_slots, dog_p, 1), hw=(h, w)))
            nxt = g_slots[cfg.scales_per_octave - 1]
            initial = nxt[p:p + (h // 2) * 2:2, p:p + (w // 2) * 2:2]
        else:
            levels = octave_levels(initial, cfg)
            out.append(_detect_octave(torch.stack(levels), None, o, cfg))
            initial = resize_nearest_half(levels[cfg.scales_per_octave])
    return _concat(out, 0)


def _tiny_octave(initial: torch.Tensor, octave: int, cfg: SiftConfig):
    """A tiny top octave of the batched path (padded side < 256, the JAX
    extractor.py:513-531): the levels of the (B, h, w) base in f32 whatever
    its storage type, `_detect_octave_plain`, and the next octave's base
    rounded back to the base's type. -> (result, next base)."""
    levels = octave_levels(initial.float(), cfg)
    res = _detect_octave_plain(torch.stack(levels, 1), octave, cfg)
    nxt = resize_nearest_half(levels[cfg.scales_per_octave])
    return res, nxt.to(initial.dtype)


def _extract_batch_fused(imgs_u8: torch.Tensor, n_octaves: int,
                         cfg: SiftConfig, budget: int | None = None) -> dict:
    """(B, H, W) u8 on the target device -> padded result dict
    (models/extractor.py:_extract_batch_fused)."""
    p = desc_ops.PAD_DESC
    initial = create_seed_image(imgs_u8, cfg)                # (B, h, w)
    if cfg.storage_dtype == "bfloat16":
        initial = initial.to(torch.bfloat16)
    out, hw_list = [], []
    for o in range(n_octaves):
        h, w = initial.shape[-2], initial.shape[-1]
        h_pad, w_pad = padded_dims(h, w)
        if h_pad >= 256 and w_pad >= 256:
            base = reflect_pad_image(initial, p, w_pad - w - 2 * p,
                                     h_pad - h - 2 * p).contiguous()
            g, d, g16, l3 = octave_fused(base, cfg, gather16=cfg.gather16,
                                         split=cfg.split)
            out.append(_detect_octave_batched(g, d, o, cfg, (h, w),
                                              describe=budget is None,
                                              gauss_win=g16))
            nxt = l3 if l3 is not None else g[:, cfg.scales_per_octave - 1]
            initial = nxt[:, p:p + (h // 2) * 2:2, p:p + (w // 2) * 2:2]
        else:
            r, initial = _tiny_octave(initial, o, cfg)
            out.append(r)
        hw_list.append((h, w))
    if budget is not None:
        return _assemble_budget(out, hw_list, budget, cfg)
    return _concat(out, 1)


def _gather_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (B, N, ...) at idx (B, C) -> (B, C, ...)."""
    return torch.gather(a, 1, idx.reshape(*idx.shape, *[1] * (a.dim() - 2))
                        .expand(*idx.shape, *a.shape[2:]))


def _top_rows(kps, valid, budget: int):
    """Each frame's response top-`budget` over (B, N) rows: (kps of the
    chosen rows, zero where empty; their indices; their validity)."""
    neg_inf = f32(float("-inf"), kps)
    resp = torch.where(valid, kps[..., 4], neg_inf)
    top_val, top_idx = stable_top_k(resp, min(budget, resp.shape[1]))
    tvalid = top_val > neg_inf
    out_kps = torch.where(tvalid[..., None], _gather_rows(kps, top_idx),
                          torch.zeros((), dtype=F32, device=kps.device))
    return out_kps, top_idx, tvalid


def _budget_result(kps, desc, top_idx, tvalid, full: dict) -> dict:
    """The budgeted result: the chosen rows, src_idx, and the counters of
    the full result."""
    src = torch.where(tvalid, top_idx, torch.full_like(top_idx, -1))
    return {"kps": kps, "desc": desc, "valid": tvalid,
            "src_idx": src.to(torch.int32), **{k: full[k] for k in COUNTERS}}


def _assemble_budget(out, hw_list, budget: int, cfg: SiftConfig) -> dict:
    """Each frame's response top-K across octaves, then descriptors of only
    the chosen keypoints (the reference truncates before describing,
    lib.rs:156-161; models/extractor.py:_assemble_budget). Octaves that
    already carry descriptors (the tiny ones) are gathered; the fused ones
    describe their chosen subset in one K6′ launch each. Rows come
    response-sorted, ties by emission index; src_idx maps each row back to
    the emission order. Nothing here waits for the host."""
    full = _concat(out, 1, keys=("kps", "valid"))
    kps_all = full["kps"]
    out_kps, top_idx, tvalid = _top_rows(kps_all, full["valid"], budget)
    b, n_top = top_idx.shape
    out_desc = torch.zeros((b, n_top, cfg.descriptor_size), dtype=torch.uint8,
                           device=kps_all.device)
    off = 0
    for r, (h, w) in zip(out, hw_list):
        m_o = r["valid"].shape[1]
        member = tvalid & (top_idx >= off) & (top_idx < off + m_o)
        local = torch.clamp(top_idx - off, 0, m_o - 1)
        if "desc" in r:
            d_rows = _gather_rows(r["desc"], local)
        else:
            c = min(n_top, m_o)
            midx, mvalid, _ = compact_indices(member, c)
            sel = torch.gather(local, 1, midx)
            fields = {k: torch.gather(v, 1, sel) for k, v in r["desc_in"].items()}
            desc_c = _describe_subset(*r["win_ctx"], fields, mvalid, cfg, h, w)
            rank = torch.clamp(torch.cumsum(member, 1) - 1, 0, c - 1)
            d_rows = _gather_rows(desc_c, rank)
        out_desc = torch.where(member[..., None], d_rows, out_desc)
        off += m_o
    return _budget_result(out_kps, out_desc, top_idx, tvalid, full)


def _truncate_result(res: dict, budget: int) -> dict:
    """Top-K truncation of a full (described) batched result, with the
    output of _assemble_budget (models/extractor.py:_truncate_result)."""
    kps, top_idx, tvalid = _top_rows(res["kps"], res["valid"], budget)
    desc = torch.where(tvalid[..., None], _gather_rows(res["desc"], top_idx),
                       torch.zeros((), dtype=torch.uint8, device=kps.device))
    return _budget_result(kps, desc, top_idx, tvalid, res)


def _images(imgs_u8, dev) -> torch.Tensor:
    if isinstance(imgs_u8, torch.Tensor):
        return imgs_u8.to(device=dev, dtype=torch.uint8)
    return torch.as_tensor(np.asarray(imgs_u8, dtype=np.uint8), device=dev)


def _n_octaves(h: int, w: int, cfg: SiftConfig) -> int:
    return cfg.n_octaves(h * cfg.inv_delta_min, w * cfg.inv_delta_min)


def extract_batch(imgs_u8, config: SiftConfig = DEFAULT_CONFIG,
                  features_limit: int | None = None, device="cuda") -> dict:
    """Batched extraction: (B, H, W) u8 -> padded result dict on `device`:
    kps (B, N, 5) f32 [x, y, size, angle, response], desc (B, N, 128) u8,
    valid (B, N) bool, and the per-octave counters n_candidates /
    n_survivors / n_emitted (B, n_octaves).

    features_limit: each frame's response top-K, taken before the
    descriptors as the reference does (lib.rs:156-161). Budgeted rows are
    response-sorted (N = the limit, or fewer rows if the frame has fewer)
    and carry src_idx (B, N) int32, the emission-order index or -1."""
    check_supported(config)
    dev = resolve_device(device)
    imgs = _images(imgs_u8, dev)
    n_oct = _n_octaves(imgs.shape[-2], imgs.shape[-1], config)
    return _extract_batch_fused(imgs, n_oct, config, features_limit)


def extract(img_u8, features_limit: int | None = None,
            config: SiftConfig = DEFAULT_CONFIG, device="cuda"):
    """Single-image extraction (the reference's sift(), lib.rs:71-81):
    (keypoints (N, 5) f32 in image coordinates, descriptors (N, 128) u8) as
    numpy arrays, octave-major scan order; response-sorted when the limit
    truncates."""
    res = extract_batch(np.asarray(img_u8)[None], config, features_limit,
                        device)
    valid = res["valid"][0].cpu().numpy()
    kps = res["kps"][0].cpu().numpy()[valid]
    desc = res["desc"][0].cpu().numpy()[valid]
    if (features_limit is not None
            and int(res["n_emitted"][0].sum()) <= features_limit):
        # the reference sorts by response only when the limit truncates
        # (lib.rs:156-161): restore the emission order through src_idx
        order = np.argsort(res["src_idx"][0].cpu().numpy()[valid], kind="stable")
        kps, desc = kps[order], desc[order]
    return kps, desc


def precompute(imgs_u8, config: SiftConfig = DEFAULT_CONFIG, device="cuda"):
    """The pyramid stage alone (the reference's precompute_images,
    lib.rs:131-146): (B, H, W) u8 -> (Gaussian octaves, DoG octaves), lists
    of (B, S+3, H_o, W_o) and (B, S+2, H_o, W_o) f32 tensors on `device`.
    Plain torch ops, as the JAX package's precompute is plain XLA."""
    check_supported(config)
    imgs = _images(imgs_u8, resolve_device(device))
    seed = create_seed_image(imgs, config)
    octaves = build_scale_space(
        seed, _n_octaves(imgs.shape[-2], imgs.shape[-1], config), config)
    return octaves, build_dog(octaves)


def extract_with_precomputed(octaves, dogs, config: SiftConfig = DEFAULT_CONFIG,
                             device="cuda") -> dict:
    """Detection and description on a precomputed pyramid (the reference's
    sift_with_precomputed, lib.rs:147-177): the padded result dict of
    extract_batch, frame by frame through the single-frame _detect_octave."""
    check_supported(config)
    dev = resolve_device(device)
    octaves = [torch.as_tensor(o).to(dev) for o in octaves]
    dogs = [torch.as_tensor(d).to(dev) for d in dogs]
    frames = [_concat([_detect_octave(g[i], d[i], o, config)
                       for o, (g, d) in enumerate(zip(octaves, dogs))], 0)
              for i in range(octaves[0].shape[0])]
    return {k: torch.stack([f[k] for f in frames]) for k in frames[0]}
