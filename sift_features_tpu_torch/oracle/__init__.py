"""The exact-semantics NumPy oracle (the port's copy of
sift_features_tpu/oracle/): `sift(img, proc=NumpyProcessing)` runs on any
machine; the default CvProcessing needs cv2, imported at its first call."""

from .oracle import (  # noqa: F401
    CvProcessing,
    OracleKeyPoint,
    build_dog,
    build_gaussian_scale_space,
    compute_descriptor,
    compute_descriptors,
    create_seed_image,
    discrete_extrema_mask,
    extremum_contrast,
    extremum_on_edge,
    find_keypoints,
    gradient_direction_histogram,
    interpolate_extrema,
    rust_round_f32,
    sift,
)
