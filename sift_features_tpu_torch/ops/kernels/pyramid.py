"""K1: whole-octave Gaussian blur chain + DoG over the padded plane; K9: one
level of that chain per launch.

K1 (`octave_fused`, a frame batch) replaces
sift_features_tpu/ops/pallas/pyramid_kernel.py:build_octave_fused
(`_octave_kernel`), in every storage mode: an f32 or bf16 base; Gaussian
levels stored f32 or bf16 ("split"), a bf16 gather copy (gather16), an f32
level-S plane `l3` (split). K9 (`octave_level`) replaces
pyramid_kernel.py:_call_level, driven level by level by
`build_octave_padded` (the per-frame path, f32) and by
`build_octave_padded_batched` (its bf16, split and gather16 forms, which no
entry point reaches, as in the JAX package). Both launch one fused level
kernel per level (csrc/pyramid.cu): a block stages its tile of the level
before with the halo in shared memory, runs the H pass and then the V pass
there, and stores the level and its DoG; `level_plan` sizes its tiles. The
note in the source gives the bound on the H100 (at octave 0 of a 1080p B=4
batch in f32, 1.36 GB to move and 13.4 G unfused f32 operations, 0.41 ms
each) and what the design moves.

Storage rule of both: the blur arithmetic is f32. K1 chains its levels in
f32 and rounds only what it stores; K9 reads each level back from its
stored slot, so a bf16 chain of K9 calls rounds between levels, as the TPU
kernel does. Launches count per form: `K1` / `K9` for f32 planes, else
`K1:bf16` (bf16 base), `K1:split`, `K1:g16` and the same for K9.

The chain runs over the padded plane of the octave base, as the TPU kernel
does: level k+1 blurs all of level k, pad ring included, and
DoG_k = L_{k+1} - L_k. Edge rule of the port: a tap that falls outside the
padded plane reads 0. The TPU kernel's strip-roll wrap poisons the outer
ring instead; both agree everywhere within PAD_DESC - (sum of tap radii)
of the image, which covers every pixel a consumer reads (the image
interior), so comparisons with the JAX kernel run on [P:P+h, P:P+w].
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ...config import SiftConfig
from ..gaussian import cv_ksize, gaussian_kernel, reflect101_pad, tap_sum
from . import build

MAX_TAPS = 63            # csrc/pyramid.cu: radius at most 31
TILE_W = 128             # output columns of a level block
ROWS_PER_THREAD = 8      # V-pass outputs of a thread (the tile height's unit)
SMEM_LIMIT = 232448      # shared memory a block may use on the H100


def level_plan(ksize: int) -> tuple[int, int]:
    """(tile height, shared-memory bytes) of one level launch of K1 / K9
    for `ksize` taps: the tallest tile of 64, 32, 16 or 8 rows whose staged
    level (tile + 2r halo rows, TILE_W + 2 align4(r) columns) and H pass
    (tile + 2r rows, TILE_W columns), f32, fit in half an SM's shared
    memory, so that two blocks share an SM (csrc/pyramid.cu:level_smem).
    Raises for a tap count the kernel does not take (even, or above
    MAX_TAPS)."""
    if ksize < 1 or ksize % 2 == 0 or ksize > MAX_TAPS:
        raise ValueError(f"{ksize} taps: the level kernel takes an odd count "
                         f"of 1 to {MAX_TAPS} taps")
    r = ksize // 2
    ra = -(-r // 4) * 4
    for tile_h in (64, 32, 16, ROWS_PER_THREAD):
        smem = (tile_h + 2 * r) * (2 * TILE_W + 2 * ra) * 4
        if smem <= SMEM_LIMIT // 2:
            return tile_h, smem
    raise AssertionError("unreachable: 8 rows fit at the largest radius")


def reflect_pad_image(img: torch.Tensor, pad: int, extra_right: int,
                      extra_bottom: int = 0) -> torch.Tensor:
    """Reflect-101-extend (..., H, W) by `pad` on every side, then zero-fill
    `extra_bottom` rows and `extra_right` columns (pyramid_kernel.py:443)."""
    out = reflect101_pad(img, pad, img.dim() - 2)
    out = reflect101_pad(out, pad, img.dim() - 1)
    if extra_right or extra_bottom:
        out = F.pad(out, (0, extra_right, 0, extra_bottom))
    return out


def octave_taps(cfg: SiftConfig) -> list[np.ndarray]:
    """f32 Gaussian taps of levels 1..S+2 of an octave."""
    return [gaussian_kernel(s, cv_ksize(s)) for s in cfg.octave_sigmas()[1:]]


def level_plain(prev: torch.Tensor, taps: np.ndarray):
    """One level of the chain over (..., Hp, Wp): (next level, its DoG
    next - prev). Ascending tap sums, a tap outside the plane reads 0."""
    hp, wp = prev.shape[-2], prev.shape[-1]
    r = len(taps) // 2
    hsum = tap_sum(F.pad(prev, (r, r)), taps, wp, prev.dim() - 1)
    nxt = tap_sum(F.pad(hsum, (0, 0, r, r)), taps, hp, prev.dim() - 2)
    return nxt, nxt - prev


BF16 = torch.bfloat16


def storage_dtypes(base_dtype: torch.dtype, split: bool):
    """(Gaussian, DoG) store types for a base of base_dtype, the rule of
    pyramid_kernel.py:build_octave_fused: a bf16 base stores both bf16,
    split stores the Gaussian levels bf16 and the DoG f32."""
    if base_dtype == BF16:
        return BF16, BF16
    return (BF16 if split else torch.float32), torch.float32


def storage_form(kernel: str, g_dtype, d_dtype, g16: bool) -> str:
    """Launch-count name of a K1 / K9 launch by what it stores."""
    if d_dtype == BF16:
        return f"{kernel}:bf16"
    if g_dtype == BF16:
        return f"{kernel}:split"
    return f"{kernel}:g16" if g16 else kernel


def octave_fused_plain(base: torch.Tensor, cfg: SiftConfig,
                       gather16: bool = False, split: bool = False):
    """Plain version of K1: base (B, Hp, Wp) f32 or bf16 -> (gauss (B, S,
    Hp, Wp) = levels 1..S, dog (B, S+2, Hp, Wp), g16 (bf16 copy of gauss)
    or None, l3 (f32 level S) or None), types by `storage_dtypes`. Same
    ascending tap sums and zero-outside-the-plane edge rule as the kernel,
    the chain in f32 and rounded only at the stores, so the two are
    bit-equal."""
    g_dtype, d_dtype = storage_dtypes(base.dtype, split)
    gauss, dog = [], []
    cur = base.float()
    for lv, taps in enumerate(octave_taps(cfg)):
        cur, d = level_plain(cur, taps)
        dog.append(d.to(d_dtype))
        if lv < cfg.scales_per_octave:
            gauss.append(cur)
    g = torch.stack(gauss, 1)
    return (g.to(g_dtype), torch.stack(dog, 1),
            g.to(BF16) if gather16 else None, gauss[-1] if split else None)


def build_octave_padded_plain(base: torch.Tensor, cfg: SiftConfig):
    """Plain version of a K9 chain: base (Hp, Wp) -> (gauss slots (S+2, Hp,
    Wp) = levels 1..S+2, dog (S+2, Hp, Wp))."""
    g, d, _ = build_octave_padded_batched_plain(base[None], cfg)
    return g[0], d[0]


def octave_fused(base: torch.Tensor, cfg: SiftConfig, gather16: bool = False,
                 split: bool = False):
    """K1 wrapper -> (gauss, dog, g16, l3) as `octave_fused_plain`. The plain
    version for a CPU tensor; the CUDA kernel for a CUDA tensor (or an
    error)."""
    if gather16 and split:
        raise ValueError("octave_fused: gather16 and split are exclusive")
    if base.device.type == "cpu":
        return octave_fused_plain(base, cfg, gather16, split)
    build.require_cuda("octave_fused", base)
    if base.dim() != 3:
        raise ValueError("octave_fused: base must be (B, Hp, Wp)")
    base_t = build.dtype_code("octave_fused", base)
    b, hp, wp = base.shape
    taps = octave_taps(cfg)
    n_levels, n_keep = len(taps), cfg.scales_per_octave
    taps_arr = (ctypes.c_float * (n_levels * MAX_TAPS))()
    ksizes = (ctypes.c_int * n_levels)()
    tile_hs = (ctypes.c_int * n_levels)()
    for lv, t in enumerate(taps):
        ksizes[lv] = len(t)
        tile_hs[lv] = level_plan(len(t))[0]
        for j, v in enumerate(t):
            taps_arr[lv * MAX_TAPS + j] = float(v)
    g_dtype, d_dtype = storage_dtypes(base.dtype, split)
    dev = base.device
    f32 = dict(dtype=torch.float32, device=dev)
    gauss = torch.empty((b, n_keep, hp, wp), dtype=g_dtype, device=dev)
    dog = torch.empty((b, n_levels, hp, wp), dtype=d_dtype, device=dev)
    g16 = (torch.empty((b, n_keep, hp, wp), dtype=BF16, device=dev)
           if gather16 else None)
    l3 = torch.empty((b, hp, wp), **f32) if split else None
    # f32 chain planes: level S+1 alone when the stored levels are f32,
    # else two used in turn (csrc/pyramid.cu)
    n_scratch = 2 if g_dtype == BF16 else 1
    scratch = torch.empty((n_scratch, b, hp, wp), **f32)
    fn = build.bind("pyramid", "sift_octave_fused",
                    [ctypes.c_void_p, ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                    + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4)
    none = ctypes.c_void_p(None)
    rc = fn(build.ptr(base), base_t, build.ptr(gauss), build.DTYPE_CODE[g_dtype],
            build.ptr(dog), build.DTYPE_CODE[d_dtype],
            none if g16 is None else build.ptr(g16),
            none if l3 is None else build.ptr(l3), build.ptr(scratch),
            n_scratch, b, hp, wp, n_keep, n_levels,
            ctypes.cast(taps_arr, ctypes.c_void_p),
            ctypes.cast(ksizes, ctypes.c_void_p),
            ctypes.cast(tile_hs, ctypes.c_void_p), build.stream_ptr(base))
    name = storage_form("K1", g_dtype, d_dtype, gather16)
    build.check(rc, f"{name} octave_fused")
    build.count_launch(name)
    return gauss, dog, g16, l3


def octave_level(gauss: torch.Tensor, dog: torch.Tensor, k: int,
                 taps: np.ndarray, base: torch.Tensor | None = None,
                 g16: torch.Tensor | None = None) -> None:
    """K9 wrapper: one blur level for a batch of frames. gauss and dog are
    (B, n_slots, Hp, Wp) slot stacks, or (n_slots, Hp, Wp) for one frame;
    level k+1 is blurred from `base` ((B,) Hp, Wp) when k == 0, else from
    the stored gauss slot k-1, and written in place into gauss slot k, dog
    slot k (level k+1 minus its source) and, when given, g16 slot k (a bf16
    copy). The source is widened to f32, the results rounded to the slot
    types. The plain version for a CPU tensor; the CUDA kernel for a CUDA
    tensor (or an error)."""
    if gauss.dim() == 3:
        gauss, dog = gauss[None], dog[None]
        base = None if base is None else base[None]
        g16 = None if g16 is None else g16[None]
    src = base if k == 0 else gauss[:, k - 1]
    if src.device.type == "cpu":
        nxt, d = level_plain(src.float(), taps)
        gauss[:, k], dog[:, k] = nxt, d
        if g16 is not None:
            g16[:, k] = nxt
        return
    whole = [t for t in (gauss, dog, g16, base) if t is not None]
    build.require_cuda("octave_level", *whole)
    tile_h = level_plan(len(taps))[0]
    if g16 is not None and g16.dtype != BF16:
        raise ValueError("octave_level: g16 must be bfloat16")
    b, _, hp, wp = gauss.shape
    plane = hp * wp
    src_fs = plane if k == 0 else gauss.stride(0)
    taps_arr = (ctypes.c_float * len(taps))(*(float(v) for v in taps))
    fn = build.bind("pyramid", "sift_octave_level",
                    [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong] * 2
                    + [ctypes.c_void_p, ctypes.c_longlong]
                    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
                    + [ctypes.c_int] * 3
                    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    rc = fn(build.ptr(src), build.dtype_code("octave_level", src), src_fs,
            build.ptr(gauss[:, k]), build.dtype_code("octave_level", gauss),
            gauss.stride(0),
            ctypes.c_void_p(None) if g16 is None else build.ptr(g16[:, k]),
            0 if g16 is None else g16.stride(0),
            build.ptr(dog[:, k]), build.dtype_code("octave_level", dog),
            dog.stride(0), b, hp, wp,
            ctypes.cast(taps_arr, ctypes.c_void_p), len(taps), tile_h,
            build.stream_ptr(gauss))
    name = storage_form("K9", gauss.dtype, dog.dtype, g16 is not None)
    build.check(rc, f"{name} octave_level")
    build.count_launch(name)


def build_octave_padded(base: torch.Tensor, cfg: SiftConfig):
    """The per-frame octave (pyramid_kernel.py:build_octave_padded): base
    (Hp, Wp) f32, reflect-padded -> (gauss slots (S+2, Hp, Wp) = levels
    1..S+2, dog (S+2, Hp, Wp), dog[k] = level k+1 - level k), one K9 launch
    per level."""
    taps = octave_taps(cfg)
    gauss = torch.empty((len(taps), *base.shape), dtype=torch.float32,
                        device=base.device)
    dog = torch.empty_like(gauss)
    for k, t in enumerate(taps):
        octave_level(gauss, dog, k, t, base=base)
    return gauss, dog


def build_octave_padded_batched(base: torch.Tensor, cfg: SiftConfig,
                                gather16: bool = False, split: bool = False):
    """pyramid_kernel.py:build_octave_padded_batched: base (B, Hp, Wp) f32
    or bf16 -> (gauss (B, S+2, Hp, Wp) = levels 1..S+2, dog (B, S+2, Hp,
    Wp), g16 (B, S, Hp, Wp) bf16 copy of levels 1..S or None), one K9 launch
    per level for the whole batch. The slot types follow the base (a bf16
    base stores everything bf16); split stores the Gaussian slots bf16 and
    the DoG f32. Each level reads the stored slot before it, so in bf16 and
    split the chain rounds between levels, unlike K1."""
    if gather16 and split:
        raise ValueError("build_octave_padded_batched: gather16 and split "
                         "are exclusive")
    taps = octave_taps(cfg)
    b, hp, wp = base.shape
    g_dtype, d_dtype = storage_dtypes(base.dtype, split)
    dev = base.device
    gauss = torch.empty((b, len(taps), hp, wp), dtype=g_dtype, device=dev)
    dog = torch.empty((b, len(taps), hp, wp), dtype=d_dtype, device=dev)
    n16 = cfg.scales_per_octave
    g16 = (torch.empty((b, n16, hp, wp), dtype=BF16, device=dev)
           if gather16 else None)
    for k, t in enumerate(taps):
        octave_level(gauss, dog, k, t, base=base,
                     g16=g16 if k < n16 else None)
    return gauss, dog, g16


def build_octave_padded_batched_plain(base: torch.Tensor, cfg: SiftConfig,
                                      gather16: bool = False,
                                      split: bool = False):
    """Plain version of `build_octave_padded_batched`: the same chain with
    its per-level rounding, in plain torch ops."""
    g_dtype, d_dtype = storage_dtypes(base.dtype, split)
    gauss, dog = [], []
    src = base
    for t in octave_taps(cfg):
        nxt, d = level_plain(src.float(), t)
        src = nxt.to(g_dtype)
        gauss.append(src)
        dog.append(d.to(d_dtype))
    g = torch.stack(gauss, 1)
    n16 = cfg.scales_per_octave
    return (g, torch.stack(dog, 1),
            torch.stack(gauss[:n16], 1).to(BF16) if gather16 else None)
