"""Seed image, Gaussian scale space and DoG in plain PyTorch (counterpart of
sift_features_tpu/ops/pyramid.py: create_seed_image, build_scale_space and
build_dog, lib.rs:196-279). The scale space is the precompute stage of the
split API; the main path builds its octaves in the K1 / K9 kernels."""

from __future__ import annotations

import torch

from ..config import DEFAULT_CONFIG, SiftConfig
from .gaussian import gaussian_blur
from .resize import resize_linear, resize_nearest_half
from .util import f32


def create_seed_image(img_u8: torch.Tensor,
                      cfg: SiftConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """(B, H, W) u8 -> (B, 2H, 2W) f32: /255, 2x linear upsample, pre-blur
    with sigma = sqrt(sigma_min^2 - sigma_in^2) * 2."""
    img = img_u8.to(torch.float32)
    img = img / f32(255.0, img)
    h, w = img.shape[-2], img.shape[-1]
    up = resize_linear(img, h * cfg.inv_delta_min, w * cfg.inv_delta_min)
    return gaussian_blur(up, cfg.seed_sigma)


def octave_levels(initial: torch.Tensor,
                  cfg: SiftConfig = DEFAULT_CONFIG) -> list[torch.Tensor]:
    """The S+3 Gaussian levels of one octave from its base (..., H, W):
    each level blurs the one before (lib.rs:231-240)."""
    levels = [initial]
    for sigma in cfg.octave_sigmas()[1:]:
        levels.append(gaussian_blur(levels[-1], sigma))
    return levels


def build_scale_space(seed: torch.Tensor, n_octaves: int,
                      cfg: SiftConfig = DEFAULT_CONFIG) -> list[torch.Tensor]:
    """Seed (B, H, W) -> n_octaves tensors (B, S+3, H_o, W_o); octave o+1
    starts from the nearest-neighbour half of octave o's level S."""
    octaves = []
    initial = seed
    for _ in range(n_octaves):
        levels = octave_levels(initial, cfg)
        octaves.append(torch.stack(levels, dim=-3))
        initial = resize_nearest_half(levels[cfg.scales_per_octave])
    return octaves


def build_dog(scale_space: list[torch.Tensor]) -> list[torch.Tensor]:
    """Adjacent-level differences per octave (lib.rs:271-279)."""
    return [o[..., 1:, :, :] - o[..., :-1, :, :] for o in scale_space]
