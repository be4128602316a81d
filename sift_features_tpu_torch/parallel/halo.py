"""Halo-exchange blurs of a frame whose rows are sharded over the mesh.

Counterpart of sift_features_tpu/parallel/halo.py. When one frame's pyramid
is split by rows over the mesh's `space` axis, the vertical pass of each
separable blur needs r rows from each neighbour: the top halo is the
previous member's last r rows, the bottom halo the next member's first r
rows, each one `mesh.shift` (two separate hops, so that with two members,
where next and previous are the same peer, each hop is its own exchange).
The first and last members rebuild the global reflect-101 border from
their own rows instead. The horizontal pass is row-local.

Same ops in the same order as ops/gaussian.gaussian_blur (one f32 multiply
and one f32 add per tap, taps ascending), so the row-gathered output is
bit-equal to gaussian_blur of the whole array. Plain torch ops, as the JAX
module is plain XLA: no kernel of the port runs here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gaussian import blur_1d, gaussian_kernel, tap_sum
from .mesh import Mesh, shift


def blur_rows_halo(x: torch.Tensor, kernel: np.ndarray, mesh: Mesh,
                   axis_name: str = "space") -> torch.Tensor:
    """Vertical (rows) blur pass of x (..., h_local, W), this member's
    contiguous rows of an array split evenly over `axis_name`; every member
    calls it. Returns the same shape.

    Raises ValueError when h_local < r, where JAX asserts. With more than
    one member it also raises at h_local == r: the first and last members
    rebuild the reflect-101 border from rows 1..r of their own, which row
    r must hold (JAX's arrays mismatch there and its trace fails)."""
    r = len(kernel) // 2
    h_loc = x.shape[-2]
    n = mesh.shape[axis_name]
    if h_loc < r or (n > 1 and h_loc == r):
        raise ValueError(f"shard height {h_loc} too small for a blur of "
                         f"radius {r} over {n} members")
    dim = x.dim() - 2
    if n == 1:
        return blur_1d(x, kernel, dim)
    i = mesh.coords[axis_name]
    top = shift(mesh, axis_name, x[..., h_loc - r:, :], 1)     # from i - 1
    bot = shift(mesh, axis_name, x[..., :r, :], -1)            # from i + 1
    if i == 0:
        top = x[..., 1:r + 1, :].flip(dim)
    if i == n - 1:
        bot = x[..., h_loc - r - 1:h_loc - 1, :].flip(dim)
    return tap_sum(torch.cat([top, x, bot], dim), kernel, h_loc, dim)


def gaussian_blur_sharded(x: torch.Tensor, sigma: float, mesh: Mesh,
                          axis_name: str = "space") -> torch.Tensor:
    """OpenCV-semantics Gaussian blur of a row-sharded (..., h_local, W) f32
    array: the horizontal pass local, then the vertical pass through the
    halo exchange (the order of ops/gaussian.gaussian_blur)."""
    kern = gaussian_kernel(sigma)
    out = blur_1d(x, kern, x.dim() - 1)
    return blur_rows_halo(out, kern, mesh, axis_name)
