"""Cross-implementation compatibility check (the reference's
examples/opencv-cross-match.rs; the port's counterpart of the JAX
package's examples/opencv_cross_match.py): OpenCV descriptors of image 1
matched against the port's descriptors of image 2 with cross-check L2
matching. Were the two not descriptor-compatible, mutual matches would be
near zero. Needs cv2 (and its SIFT).

Usage: python -m sift_features_tpu_torch.examples.opencv_cross_match
       img1 img2 [out.jpg] [--device cuda|cpu]
"""

import argparse
import sys

import numpy as np

from sift_features_tpu_torch.io.image import load_gray


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("img1")
    ap.add_argument("img2")
    ap.add_argument("out_path", nargs="?", default="matches-port-opencv.jpg")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import cv2

    import sift_features_tpu_torch as port

    img1 = load_gray(args.img1, "cv2")
    img2 = load_gray(args.img2, "cv2")

    s = cv2.SIFT_create()
    cv_kps, cv_desc = s.detectAndCompute(img1, None)       # f32 descriptors
    k2, d2 = port.sift(img2, device=args.device)           # the port's u8 rows
    print(f"cv2: {len(cv_kps)} keypoints, ours: {len(k2)}")

    # u8 -> f32 for NORM_L2 (opencv-cross-match.rs:75)
    m = port.match_descriptors(cv_desc, d2.astype(np.float32),
                               cross_check=True, device=args.device)
    print(f"mutual cross-implementation matches: {len(m.query_idx)}")

    our_kps = [cv2.KeyPoint(float(k[0]), float(k[1]), float(k[2]) * 2,
                            float(k[3]), float(k[4])) for k in k2]
    dmatches = [cv2.DMatch(int(q), int(t), float(d))
                for q, t, d in zip(m.query_idx, m.train_idx, m.distance)]
    out = cv2.drawMatches(img2, our_kps, img1, cv_kps, dmatches, None,
                          flags=cv2.DrawMatchesFlags_NOT_DRAW_SINGLE_POINTS)
    cv2.imwrite(args.out_path, out)
    print(f"wrote {args.out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
