"""Minimal extraction CLI (the reference's examples/run-sift.rs; the port's
counterpart of the JAX package's examples/run_sift.py).

Usage: python -m sift_features_tpu_torch.examples.run_sift <image>
       [features_limit] [--device cuda|cpu]

Prints the number of keypoints found. Reads the image with cv2.
"""

import argparse
import sys

from sift_features_tpu_torch.io.image import load_gray


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("image")
    ap.add_argument("features_limit", nargs="?", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import sift_features_tpu_torch as port

    img = load_gray(args.image, "cv2")
    kps, desc = port.sift(img, features_limit=args.features_limit,
                          device=args.device)
    print(f"found {len(kps)} keypoints")
    return 0


if __name__ == "__main__":
    sys.exit(main())
