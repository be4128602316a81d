"""The plain reference the benchmark judges the program by: SIFT in NumPy
(`sift_oracle`, with its own parameters and pixel ops in `pixel_ops`), the
NumPy brute-force cross-check matcher (`matcher`) and the comparisons
(`compare`). It imports nothing of the program."""


def frame_rows(frame, sift: dict, features_limit=None):
    """(keypoints (N, 5) f32, descriptors (N, 128) u8) of one (H, W) u8
    frame, with the parameters of a configuration's `sift` object; a
    top-level function, so that a process pool can run it."""
    from .pixel_ops import SiftParams
    from .sift_oracle import sift as sift_frame

    return sift_frame(frame, features_limit, cfg=SiftParams.from_dict(sift))
