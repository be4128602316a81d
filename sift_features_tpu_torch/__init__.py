"""sift_features_tpu_torch — the PyTorch / CUDA port of sift_features_tpu.

A second package beside the JAX one: the same SIFT pipeline (seed ->
Gaussian/DoG pyramid -> 3x3x3 extrema -> Newton refinement -> 36-bin
orientation -> 128-D u8 descriptors) and the same cross-check matcher, in
PyTorch, with every kernel of the main path written by hand in CUDA for an
NVIDIA H100 (`csrc/`, built with nvcc at first use). It imports nothing of
the JAX package; the JAX package is the reference it is tested against.

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"` runs the kernels' plain PyTorch versions):

    sift(img, device="cuda")                  -> (kps (N, 5) f32, desc (N, 128) u8)
    match_descriptors(d1, d2, cross_check=True, device="cuda")
    descriptor_index(db=None, mesh=None, device=None)
                                              -> service.DescriptorIndex
    stream(paths, batch, hw, device="cuda")   JPEG files -> per-batch
                                              [(kps, desc), ...] per frame
    SiftConfig                                the frozen parameter spec
    oracle.sift(img, proc=NumpyProcessing)    the exact-semantics NumPy
                                              oracle (oracle/processing.py;
                                              no device, no cv2 with it)
"""

from .config import DEFAULT_CONFIG, SiftConfig  # noqa: F401

__version__ = "0.1.0"


def sift(img, features_limit=None, config=DEFAULT_CONFIG, device="cuda"):
    """Extract SIFT keypoints [x, y, size, angle, response] in image
    coordinates and u8 descriptors from an (H, W) uint8 image."""
    from .models.extractor import extract

    return extract(img, features_limit=features_limit, config=config,
                   device=device)


def match_descriptors(d1, d2, cross_check=True, device="cuda"):
    """Brute-force L2 matching (BFMatcher NORM_L2 crossCheck analog)."""
    from .ops.matcher import match_brute_force

    return match_brute_force(d1, d2, cross_check=cross_check, device=device)


def descriptor_index(db=None, mesh=None, axis_name="data", *, device=None):
    """Queryable descriptor-database service (extract -> index -> query),
    ring-matched over `mesh` when one is given; see
    sift_features_tpu_torch.service.DescriptorIndex."""
    from .service import DescriptorIndex

    return DescriptorIndex(db, mesh, axis_name, device=device)


def stream(paths, batch, hw, features_limit=None, config=DEFAULT_CONFIG,
           device="cuda", **kw):
    """Streaming serving loop: JPEG files -> per-frame (kps, desc), with
    decode / H2D / extraction / readback overlapped; see
    sift_features_tpu_torch.parallel.stream. Raises at the call when the
    device is missing."""
    from .parallel.stream import stream_extract_paths

    return stream_extract_paths(paths, batch, hw, config,
                                features_limit=features_limit, device=device,
                                **kw)
