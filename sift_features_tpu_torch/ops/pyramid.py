"""Seed image of the scale space (counterpart of
sift_features_tpu/ops/pyramid.py:create_seed_image, lib.rs:196-210)."""

from __future__ import annotations

import torch

from ..config import DEFAULT_CONFIG, SiftConfig
from .gaussian import gaussian_blur
from .resize import resize_linear
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
