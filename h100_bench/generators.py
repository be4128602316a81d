"""Inputs of every cell, made from the run's seed.

- `canvas`: a non-periodic multi-scale noise texture, a weighted sum of
  Gaussian-blurred white-noise octaves, shaped in one FFT on the device and
  quantised to u8.
- `CameraPath`: crops of the canvas along a straight camera path of a few
  pixels a frame, reflecting at the canvas edges, as consecutive frames of
  a panning video.
- `sift_rows`: rows shaped as SIFT finalises a descriptor: non-negative
  draws, L2-normalised, clipped at the magnitude cap, renormalised, scaled,
  rounded and saturated to u8.

Everything is drawn from `torch.Generator`s or NumPy generators seeded from
the run's seed, so one seed gives the same inputs on one device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def seed_of(*parts: int) -> int:
    """A 63-bit generator seed from the run's seed and stream numbers (any
    whole numbers, negative and above 2**32 included)."""
    ss = np.random.SeedSequence([int(p) % (1 << 63) for p in parts])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def device_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def canvas(seed: int, height: int, width: int, sigmas, mean: float,
           std: float, device) -> np.ndarray:
    """(height, width) u8 texture on the host: white noise filtered by
    sum_k sigma_k exp(-2 pi^2 sigma_k^2 |f|^2), each octave sigma_k blurred
    and weighted by sigma_k (so each carries the same variance), scaled to
    `mean` and `std` grey levels, rounded and clipped."""
    g = device_generator(seed_of(seed, 1), device)
    noise = torch.randn((height, width), generator=g, device=device)
    fy = torch.fft.fftfreq(height, device=device)[:, None]
    fx = torch.fft.rfftfreq(width, device=device)[None, :]
    f2 = fy * fy + fx * fx
    filt = sum(s * torch.exp(-2.0 * math.pi ** 2 * s * s * f2) for s in sigmas)
    field = torch.fft.irfft2(torch.fft.rfft2(noise) * filt, s=(height, width))
    field = (field - field.mean()) / field.std()
    img = torch.clamp(torch.round(mean + std * field), 0, 255).to(torch.uint8)
    return img.cpu().numpy()


class CameraPath:
    """Frames (h, w) cropped from a canvas along a straight path of `speed`
    pixels a frame in a seeded direction, from a seeded start, reflecting
    at the canvas edges. `take(n)` returns the next n frames as one
    contiguous (n, h, w) u8 array."""

    def __init__(self, canvas_u8: np.ndarray, h: int, w: int, speed: float,
                 seed: int):
        self.canvas = canvas_u8
        self.h, self.w = h, w
        self.span = (canvas_u8.shape[0] - h, canvas_u8.shape[1] - w)
        if min(self.span) < 1:
            raise ValueError("the canvas must be larger than a frame")
        rng = np.random.default_rng(seed_of(seed, 2))
        self.pos = rng.uniform(0, 1, 2) * np.asarray(self.span, np.float64)
        angle = rng.uniform(0, 2 * math.pi)
        self.vel = speed * np.asarray([math.sin(angle), math.cos(angle)])
        self.frames_taken = 0

    def _advance(self) -> tuple[int, int]:
        y, x = (int(round(v)) for v in self.pos)
        p = self.pos + self.vel
        for a in range(2):
            if p[a] < 0:
                p[a], self.vel[a] = -p[a], -self.vel[a]
            elif p[a] > self.span[a]:
                p[a], self.vel[a] = 2 * self.span[a] - p[a], -self.vel[a]
        self.pos = p
        return y, x

    def take(self, n: int) -> np.ndarray:
        out = np.empty((n, self.h, self.w), np.uint8)
        for i in range(n):
            y, x = self._advance()
            out[i] = self.canvas[y:y + self.h, x:x + self.w]
        self.frames_taken += n
        return out


def sift_rows(g: torch.Generator, n: int, dim: int, cap: float,
              l2_norm: float, device) -> torch.Tensor:
    """(n, dim) u8 rows made as SIFT finalises a descriptor (squared
    normal draws, so most bins are small and a few large)."""
    v = torch.randn((n, dim), generator=g, device=device) ** 2
    v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True).clamp_min(1e-12)
    v = torch.minimum(v, torch.full((), cap, device=device))
    v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True).clamp_min(1e-12)
    return torch.clamp(torch.round(v * l2_norm), 0, 255).to(torch.uint8)
