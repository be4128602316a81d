"""Algorithm configuration of the PyTorch port.

A copy of the JAX package's `SiftConfig` (sift_features_tpu/config.py): the
port keeps its own so that it imports nothing of the JAX package. The
constants are the OpenCV-compatibility spec of the reference crate
(lib.rs:92-113,179-193,297,516,798,954,978); changing a default breaks
parity. SIFT learns nothing, so this frozen config (and the Gaussian taps
derived from it, ops/gaussian.py) is all the "weights" the port carries
across: `config_from_reference` builds it from the JAX config's fields.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    # --- scale space (lib.rs:92, 179-193) ---
    scales_per_octave: int = 3
    sigma_in: float = 0.5          # assumed blur of the input image
    sigma_min: float = 0.8         # blur level of the seed image
    inv_delta_min: int = 2         # seed image is a 2x upsample
    delta_min: float = 0.5

    # --- detection (lib.rs:93-100, 516) ---
    contrast_threshold: float = 0.04
    edge_threshold: float = 10.0
    image_border: int = 5
    max_interpolation_steps: int = 5

    # --- orientation assignment (lib.rs:96-104, 297) ---
    n_orientation_bins: int = 36
    lambda_ori: float = 1.5
    orientation_localmax_ratio: float = 0.8

    # --- descriptor (lib.rs:105-112, 798, 954, 978) ---
    lambda_descr: float = 3.0
    descriptor_n_histograms: int = 4
    descriptor_n_bins: int = 8
    descriptor_magnitude_cap: float = 0.2
    descriptor_l2_norm: float = 512.0

    # --- fixed-shape capacities (same sizing rule as the JAX package,
    # models/extractor.py:_octave_capacities) ---
    max_candidates_per_octave: int = 32768
    max_keypoints_per_octave: int = 16384
    max_keypoints: int = 32768
    # Kept for field parity with the JAX config; the port dispatches by the
    # tensors' device, not by this flag.
    use_pallas: bool = True
    # Pyramid storage of the frame-batched path (extract_batch, extract,
    # sift): storage_dtype "float32", "bfloat16" (bf16 seed, Gaussian
    # levels and DoG; K4 refines) or "split" (bf16 Gaussian levels, f32
    # DoG bit-equal to the f32 run's); gather_dtype "bfloat16" adds a bf16
    # copy of the Gaussian levels for the window kernels when storage is
    # f32. Blur arithmetic is f32 in every mode. The per-frame path and
    # precompute / extract_with_precomputed ignore both, as the JAX
    # package's do.
    gather_dtype: str = "float32"
    storage_dtype: str = "float32"
    # "walk" (whole <=5-step loop in one kernel launch, K3), "step" (one
    # masked step per launch, K4), "region" (the first region_steps steps
    # region-grouped, K10, then K4) or "tile" (tile-grouped whole walk,
    # K11, escapes re-refined by K4); identical outputs.
    refine_mode: str = "walk"
    region_steps: int = 5
    # "packed" (K5 / K6 and their count-prefix forms) or "perkey" (K8 / K7,
    # launched per scale bucket); identical outputs.
    window_kernel: str = "packed"

    @property
    def descriptor_size(self) -> int:
        return self.descriptor_n_histograms ** 2 * self.descriptor_n_bins

    @property
    def gather16(self) -> bool:
        """K1 writes a bf16 window copy of the Gaussian levels
        (models/extractor.py:498-499 of the JAX package)."""
        return self.gather_dtype == "bfloat16" and self.storage_dtype == "float32"

    @property
    def split(self) -> bool:
        """bf16 Gaussian levels, f32 DoG and an f32 next-octave base."""
        return self.storage_dtype == "split"

    @property
    def n_scale_images(self) -> int:
        return self.scales_per_octave + 3

    @property
    def n_dog_images(self) -> int:
        return self.scales_per_octave + 2

    @property
    def seed_sigma(self) -> float:
        """Pre-blur applied to the 2x-upsampled seed image (lib.rs:207)."""
        return math.sqrt(self.sigma_min ** 2 - self.sigma_in ** 2) * self.inv_delta_min

    def octave_sigmas(self) -> list[float]:
        """Incremental blur sigmas within an octave (lib.rs:220-229), with
        LLVM-powi (square-and-multiply) semantics for m.powi(s-1) so the f64
        values are bit-identical to the reference's. Index 0 is unused."""

        def powi(x: float, n: int) -> float:
            if n < 0:
                return 1.0 / powi(x, -n)
            r, b = 1.0, x
            while n:
                if n & 1:
                    r = r * b
                b = b * b
                n >>= 1
            return r

        m = 2.0 ** (2.0 / self.scales_per_octave)
        out = []
        for s in range(self.scales_per_octave + 3):
            a = powi(m, s - 1)
            b = a * m
            out.append(math.sqrt(b - a) * self.sigma_min * self.inv_delta_min)
        return out

    def n_octaves(self, height: int, width: int) -> int:
        """Number of octaves for a seed image of (height, width)
        (lib.rs:133-134): f32 log2 + round-half-away like the reference."""
        min_axis = np.float32(min(width, height))
        v = np.float32(np.log2(min_axis)) - np.float32(2.0)
        return int(np.floor(v + np.float32(0.5))) + 1


DEFAULT_CONFIG = SiftConfig()


def config_from_reference(d: dict) -> SiftConfig:
    """Port config from the JAX config's fields
    (`dataclasses.asdict(jax_cfg)`). Unknown fields raise, so a field added
    on one side only is caught."""
    names = {f.name for f in dataclasses.fields(SiftConfig)}
    extra = set(d) - names
    if extra:
        raise ValueError(f"fields unknown to the port's SiftConfig: {sorted(extra)}")
    return SiftConfig(**d)


def check_supported(cfg: SiftConfig) -> None:
    """Raise ValueError for an unknown mode name."""
    if cfg.storage_dtype not in ("float32", "bfloat16", "split"):
        raise ValueError(f"unknown storage_dtype {cfg.storage_dtype!r}")
    if cfg.gather_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown gather_dtype {cfg.gather_dtype!r}")
    if cfg.refine_mode not in ("walk", "step", "region", "tile"):
        raise ValueError(f"unknown refine_mode {cfg.refine_mode!r}")
    if cfg.window_kernel not in ("packed", "perkey"):
        raise ValueError(f"unknown window_kernel {cfg.window_kernel!r}")
