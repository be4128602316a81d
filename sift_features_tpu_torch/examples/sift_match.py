"""Two-image matching demo (the reference's examples/sift-match.rs; the
port's counterpart of the JAX package's examples/sift_match.py).

Extracts with the port and with OpenCV's SIFT, matches each pair with the
port's brute-force cross-check matcher, and renders matches.jpg /
cv_matches.jpg into out_dir with cv2.drawMatches. Needs cv2 (and its SIFT).

Usage: python -m sift_features_tpu_torch.examples.sift_match img1 img2
       [out_dir] [--device cuda|cpu]
"""

import argparse
import os
import sys

import numpy as np

from sift_features_tpu_torch.io.image import load_gray


def to_cv_kps(kps: np.ndarray):
    import cv2

    return [cv2.KeyPoint(float(k[0]), float(k[1]), float(k[2]) * 2,
                         float(k[3]), float(k[4])) for k in kps]


def draw(img1, kps1, img2, kps2, matches, path):
    """Render the matches of img1's keypoints (queries) to img2's."""
    import cv2

    dmatches = [cv2.DMatch(int(q), int(t), float(d))
                for q, t, d in zip(matches.query_idx, matches.train_idx,
                                   matches.distance)]
    out = cv2.drawMatches(img1, to_cv_kps(kps1), img2, to_cv_kps(kps2),
                          dmatches, None,
                          flags=cv2.DrawMatchesFlags_NOT_DRAW_SINGLE_POINTS)
    cv2.imwrite(path, out)
    print(f"wrote {path} ({len(matches.query_idx)} matches)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("img1")
    ap.add_argument("img2")
    ap.add_argument("out_dir", nargs="?", default=".")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import sift_features_tpu_torch as port

    img1 = load_gray(args.img1, "cv2")
    img2 = load_gray(args.img2, "cv2")

    # the port's pipeline and matcher (query = img2's rows, train = img1's)
    k1, d1 = port.sift(img1, device=args.device)
    k2, d2 = port.sift(img2, device=args.device)
    print(f"ours: {len(k1)} / {len(k2)} keypoints")
    m = port.match_descriptors(d1, d2, cross_check=True, device=args.device)
    draw(img2, k2, img1, k1, m, os.path.join(args.out_dir, "matches.jpg"))

    # OpenCV's pair, matched with the port's matcher
    import cv2

    s = cv2.SIFT_create()
    ck1, cd1 = s.detectAndCompute(img1, None)
    ck2, cd2 = s.detectAndCompute(img2, None)
    print(f"cv2 : {len(ck1)} / {len(ck2)} keypoints")
    cm = port.match_descriptors(cd1, cd2, cross_check=True, device=args.device)
    dmatches = [cv2.DMatch(int(q), int(t), float(d))
                for q, t, d in zip(cm.query_idx, cm.train_idx, cm.distance)]
    out = cv2.drawMatches(img2, ck2, img1, ck1, dmatches, None,
                          flags=cv2.DrawMatchesFlags_NOT_DRAW_SINGLE_POINTS)
    path = os.path.join(args.out_dir, "cv_matches.jpg")
    cv2.imwrite(path, out)
    print(f"wrote {path} ({len(dmatches)} matches)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
