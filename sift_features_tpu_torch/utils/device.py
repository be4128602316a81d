"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device the caller asked for; a CUDA device must exist (the port
    never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' to "
            "run the plain versions of its kernels on the CPU")
    return dev
