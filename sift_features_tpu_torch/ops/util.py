"""Numeric primitives shared by the port's plain versions.

Counterparts of the JAX package's ops/pallas/util.py (round_half_away,
Cephes atan_f32/atan2_f32) and ops/extrema.py (rust_round). All f32, with
the same operation order, so results are bit-equal where the arithmetic is
IEEE (add, mul, div, floor, sqrt). The CUDA kernels carry the same formulas
in csrc/common.cuh.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

F32 = torch.float32

_TAN_PI_8 = float(np.float32(0.4142135623730950))
_TAN_3PI_8 = float(np.float32(2.414213562373095))
_PI = float(np.float32(np.pi))
_PI_2 = float(np.float32(np.pi / 2))
_PI_4 = float(np.float32(np.pi / 4))


@functools.lru_cache(maxsize=None)
def _const_on(v: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(v, dtype=F32, device=device)


def f32(v, like: torch.Tensor) -> torch.Tensor:
    """An f32 scalar tensor holding np.float32(v) on `like`'s device. Each
    (value, device) is copied to the device once and kept: a fresh host
    copy per call would synchronise the stream at every constant. Constants
    stay tensors rather than Python scalars because PyTorch divides by a
    host scalar through its reciprocal, which is not an IEEE division."""
    return _const_on(float(np.float32(v)), like.device)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root. The sqrt of PyTorch's vectorised
    CPU kernels may be one ulp off; the f64 root rounded to f32 is exact
    (53 >= 2 * 24 + 2 bits make the double rounding innocuous), as CUDA's
    and XLA's f32 sqrt are."""
    return torch.sqrt(x.double()).to(F32)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Rust f32::round without trunc: floor(x+0.5), fixed where x+0.5 is
    integral and x < 0 (negative exact halves round away)."""
    xp = x + f32(0.5, x)
    r = torch.floor(xp)
    return torch.where((xp == r) & (x < 0), r - f32(1.0, x), r)


def rust_round(x: torch.Tensor) -> torch.Tensor:
    """Rust f32::round: half away from zero."""
    t = torch.trunc(x)
    frac = x - t
    r = torch.round(x)          # half to even, fixed at exact halves below
    return torch.where(torch.abs(frac) == 0.5, t + torch.sign(x), r)


def atan_f32(x: torch.Tensor) -> torch.Tensor:
    """Cephes atanf: reduce |x| to [0, tan(pi/8)], degree-7 odd polynomial."""
    ax = torch.abs(x)
    big = ax > _TAN_3PI_8
    mid = (ax > _TAN_PI_8) & ~big
    one = f32(1.0, x)
    x1 = torch.where(big, f32(-1.0, x) / torch.clamp_min(ax, f32(1e-30, x)),
                     torch.where(mid, (ax - one) / (ax + one), ax))
    z = x1 * x1
    p = (((f32(8.05374449538e-2, x) * z - f32(1.38776856032e-1, x)) * z
          + f32(1.99777106478e-1, x)) * z - f32(3.33329491539e-1, x)) * z * x1 + x1
    r = torch.where(big, f32(_PI_2, x) + p, torch.where(mid, f32(_PI_4, x) + p, p))
    return torch.where(x < 0, -r, r)


def atan2_f32(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f32 atan2 with the standard quadrant rules (atan2(0, -a) = +pi)."""
    safe_x = torch.where(x == 0, f32(1.0, x), x)
    a = atan_f32(y / safe_x)
    pi = f32(_PI, x)
    r = torch.where(x > 0, a, torch.where(y >= 0, a + pi, a - pi))
    zero_x = torch.where(y > 0, f32(_PI_2, x),
                         torch.where(y < 0, f32(-_PI_2, x), f32(0.0, x)))
    return torch.where(x == 0, zero_x, r)
