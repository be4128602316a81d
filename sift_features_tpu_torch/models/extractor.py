"""End-to-end SIFT extractor of the port.

Counterpart of sift_features_tpu/models/extractor.py: the frame-batched
fused path `_extract_batch_fused`, for every octave whose padded plane is at
least 256 x 256,

    seed -> [K1 blur chain + DoG -> K2 extremum words -> word compaction ->
    K3 Newton walk (or K4 steps) -> survivor compaction -> K5 orientation
    histograms + peaks -> emission compaction -> K6 descriptor histograms ->
    finalize_descriptor]

and the plain path of `_detect_octave` (pure torch ops, batched over frames)
for the tiny top octaves. Per-frame compaction keeps the reference's scan
order; per-octave counters n_candidates / n_survivors / n_emitted expose any
capacity overflow. Kernels launch once per stage per octave for the whole
batch. With tensors on the CPU every kernel wrapper runs its plain version.

Not ported yet (ROADMAP.md): features_limit (`_assemble_budget`,
`_truncate_result`), precompute / extract_with_precomputed and the per-frame
path `_extract_single`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, SiftConfig, check_supported
from ..ops import descriptor as desc_ops
from ..ops import extrema as ext_ops
from ..ops import orientation as ori_ops
from ..ops.gaussian import gaussian_blur
from ..ops.kernels.descriptor import descriptor_hist
from ..ops.kernels.extrema import extrema_words
from ..ops.kernels.orientation import orientation_hist_peaks
from ..ops.kernels.pyramid import octave_fused, reflect_pad_image
from ..ops.kernels.refine import refine_stepwise, refine_walk
from ..ops.pyramid import create_seed_image
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


def _detect_octave_batched(gauss_p, dog_p, octave: int, cfg: SiftConfig, hw):
    """Frame-batched detection on the padded stacks of K1: gauss_p (B, S,
    Hp, Wp) = levels 1..S, dog_p (B, S+2, Hp, Wp); hw the unpadded octave
    size (models/extractor.py:_detect_octave_batched, describe=True,
    stages="full")."""
    b, n_dog, hp, wp = dog_p.shape
    h, w = hw
    dev = dog_p.device
    k, k2, m = octave_capacities(h, w, cfg)
    p = desc_ops.PAD_DESC
    bd = cfg.image_border
    n_bins = cfg.n_orientation_bins

    words = extrema_words(dog_p, (p + bd, p + h - bd, p + bd, p + w - bd), cfg)
    s0, y0, x0, valid, n_cand = ext_ops.find_candidates_words(words, k)

    refine_fn = refine_walk if cfg.refine_mode == "walk" else refine_stepwise
    rows = refine_fn(dog_p.reshape(b * n_dog, hp, wp), s0.reshape(-1),
                     y0.reshape(-1), x0.reshape(-1), valid.reshape(-1), p, h, w,
                     cfg, plane_off=_frame_offsets(b, n_dog, k, dev))
    surv, svalid, n_surv = _survivors(rows, valid, b, k, k2, p)
    surv["kp_scale"] = ori_ops.kp_scale_of(surv["s"], surv["off_s"], cfg)

    n_win = gauss_p.shape[1]
    gauss_flat = gauss_p.reshape(b * n_win, hp, wp)
    live2 = svalid.reshape(-1)
    raw, angles_p, n_pk = orientation_hist_peaks(
        gauss_flat, (surv["s"] - 1).reshape(-1) + _frame_offsets(b, n_win, k2, dev),
        surv["y"].reshape(-1), surv["x"].reshape(-1),
        surv["kp_scale"].reshape(-1), live2, h, w, p, cfg)
    n_pk_cap = angles_p.shape[1]
    if bool(((n_pk > n_pk_cap) & live2).any()):
        # a survivor has more peaks than the kernel's slots: the full
        # peaks over the smoothed histograms (extractor.py:342-354)
        angles, emit = ori_ops.orientation_peaks(ori_ops.smooth(raw), cfg)
        ci, kp_angle, evalid, n_emit = _emit(
            angles.reshape(b, k2, n_bins), emit.reshape(b, k2, n_bins), svalid, m)
    else:
        slots = torch.arange(n_pk_cap, device=dev)
        emit = slots < torch.clamp(n_pk, max=n_pk_cap).reshape(b, k2)[:, :, None]
        ci, kp_angle, evalid, n_emit = _emit(
            angles_p.reshape(b, k2, n_pk_cap), emit, svalid, m)

    kps, d_in = _keypoints(surv, ci, kp_angle, evalid, octave, cfg)
    hist = descriptor_hist(
        gauss_flat, (d_in["kp_s"] - 1).reshape(-1) + _frame_offsets(b, n_win, m, dev),
        rust_round(d_in["x_oct"]).to(torch.int32).reshape(-1),
        rust_round(d_in["y_oct"]).to(torch.int32).reshape(-1),
        d_in["kp_sc"].reshape(-1), kp_angle.reshape(-1), evalid.reshape(-1),
        h, w, p, cfg)
    desc = desc_ops.finalize_descriptor(hist, cfg).reshape(b, m, -1)
    return {"kps": kps, "desc": desc, "valid": evalid, "n_candidates": n_cand,
            "n_survivors": n_surv, "n_emitted": n_emit}


def _detect_octave(gauss: torch.Tensor, octave: int, cfg: SiftConfig):
    """Tiny top octaves: the plain branch of models/extractor.py:
    _detect_octave (pure torch ops, no kernel), batched over frames.
    gauss (B, S+3, h, w) holds every level of the octave."""
    b, n_lv, h, w = gauss.shape
    dev = gauss.device
    k, k2, m = octave_capacities(h, w, cfg)
    p = desc_ops.PAD_DESC
    n_bins = cfg.n_orientation_bins

    gp = desc_ops.pad_stack_for_kernels(gauss)
    hp, wp = gp.shape[-2], gp.shape[-1]
    gflat = gp.reshape(b * n_lv, hp, wp)
    dog = gauss[:, 1:] - gauss[:, :-1]
    mask = ext_ops.extrema_mask(dog, cfg)
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
    desc = desc_ops.descriptor_batch(
        gflat, h, w, d_in["kp_s"].reshape(-1) + _frame_offsets(b, n_lv, m, dev),
        d_in["x_oct"].reshape(-1), d_in["y_oct"].reshape(-1),
        d_in["kp_sc"].reshape(-1), kp_angle.reshape(-1), evalid.reshape(-1),
        cfg, pad=p).reshape(b, m, -1)
    return {"kps": kps, "desc": desc, "valid": evalid, "n_candidates": n_cand,
            "n_survivors": n_surv, "n_emitted": n_emit}


def _extract_batch_fused(imgs_u8: torch.Tensor, n_octaves: int,
                         cfg: SiftConfig) -> dict:
    """(B, H, W) u8 on the target device -> padded result dict
    (models/extractor.py:_extract_batch_fused, budget=None)."""
    p = desc_ops.PAD_DESC
    sigmas = cfg.octave_sigmas()
    initial = create_seed_image(imgs_u8, cfg)                # (B, h, w)
    out = []
    for o in range(n_octaves):
        h, w = initial.shape[-2], initial.shape[-1]
        h_pad, w_pad = padded_dims(h, w)
        if h_pad >= 256 and w_pad >= 256:
            base = reflect_pad_image(initial, p, w_pad - w - 2 * p,
                                     h_pad - h - 2 * p).contiguous()
            g, d = octave_fused(base, cfg)
            out.append(_detect_octave_batched(g, d, o, cfg, (h, w)))
            nxt = g[:, cfg.scales_per_octave - 1]
            initial = nxt[:, p:p + (h // 2) * 2:2, p:p + (w // 2) * 2:2]
        else:
            levels = [initial]
            for sig in sigmas[1:]:
                levels.append(gaussian_blur(levels[-1], sig))
            out.append(_detect_octave(torch.stack(levels, 1), o, cfg))
            initial = resize_nearest_half(levels[len(levels) - 3])
    res = {key: torch.cat([r[key] for r in out], 1)
           for key in ("kps", "desc", "valid")}
    for key in ("n_candidates", "n_survivors", "n_emitted"):
        res[key] = torch.stack([r[key] for r in out], 1)
    return res


def extract_batch(imgs_u8, config: SiftConfig = DEFAULT_CONFIG,
                  features_limit: int | None = None, device="cuda") -> dict:
    """Batched extraction: (B, H, W) u8 -> padded result dict on `device`:
    kps (B, N, 5) f32 [x, y, size, angle, response], desc (B, N, 128) u8,
    valid (B, N) bool, and the per-octave counters n_candidates /
    n_survivors / n_emitted (B, n_octaves)."""
    if features_limit is not None:
        raise NotImplementedError(
            "features_limit is not ported yet (ROADMAP.md Queue A)")
    check_supported(config)
    dev = resolve_device(device)
    if isinstance(imgs_u8, torch.Tensor):
        imgs = imgs_u8.to(device=dev, dtype=torch.uint8)
    else:
        imgs = torch.as_tensor(np.asarray(imgs_u8, dtype=np.uint8), device=dev)
    h, w = imgs.shape[-2], imgs.shape[-1]
    n_oct = config.n_octaves(h * config.inv_delta_min, w * config.inv_delta_min)
    return _extract_batch_fused(imgs, n_oct, config)


def extract(img_u8, features_limit: int | None = None,
            config: SiftConfig = DEFAULT_CONFIG, device="cuda"):
    """Single-image extraction (the reference's sift(), lib.rs:71-81):
    (keypoints (N, 5) f32 in image coordinates, descriptors (N, 128) u8) as
    numpy arrays, octave-major scan order."""
    res = extract_batch(np.asarray(img_u8)[None], config, features_limit,
                        device)
    valid = res["valid"][0].cpu().numpy()
    return (res["kps"][0].cpu().numpy()[valid],
            res["desc"][0].cpu().numpy()[valid])


def precompute(imgs_u8, config: SiftConfig = DEFAULT_CONFIG):
    raise NotImplementedError(
        "precompute is not ported yet (ROADMAP.md Queue A)")


def extract_with_precomputed(octaves, dogs, config: SiftConfig = DEFAULT_CONFIG):
    raise NotImplementedError(
        "extract_with_precomputed is not ported yet (ROADMAP.md Queue A)")
