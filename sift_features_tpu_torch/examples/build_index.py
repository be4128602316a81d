"""Descriptor-database service demo (the port's counterpart of the JAX
package's examples/build_index.py): index images, then query a shifted
crop of the first one and report where its keypoints matched.

Usage: python -m sift_features_tpu_torch.examples.build_index images...
       [--budget N] [--save DIR] [--device cuda|cpu]

The serving loop this shows: frames come in, budgeted extraction fills a
persistent descriptor database, and new frames are matched against the
whole database (loop closure / retrieval). With a mesh
(DescriptorIndex(mesh=...)) the same query runs the ring matcher.
"""

import argparse
import os
import sys
import time

import numpy as np

from sift_features_tpu_torch.io.image import load_gray


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("images", nargs="+", help="image files to index")
    ap.add_argument("--budget", type=int, default=512,
                    help="features_limit per frame (0 = unlimited)")
    ap.add_argument("--save", default="",
                    help="directory to persist the index shards")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from sift_features_tpu_torch.service import DescriptorIndex

    idx = DescriptorIndex(device=args.device)
    budget = args.budget or None
    for i, path in enumerate(args.images):
        img = load_gray(path, "cv2")
        t0 = time.time()
        idx.add_frames(img[None], frame_ids=np.array([i]),
                       features_limit=budget)
        n = int(idx.db.offsets[-1])
        print(f"indexed {os.path.basename(path)}: {n} rows total "
              f"({time.time() - t0:.1f}s)")

    # query a shifted crop of image 0: matches should land in frame 0
    name0 = os.path.basename(args.images[0])
    crop = load_gray(args.images[0], "cv2")[10:, 10:]
    kps, desc, r = idx.query_image(crop, features_limit=budget)
    per_frame = {int(f): int((r.frame_id == f).sum())
                 for f in np.unique(r.frame_id)}
    print(f"query crop of {name0}: {len(kps)} kps, "
          f"{len(r.query_idx)} cross-checked matches, per-frame {per_frame}")
    if len(r.query_idx):
        own = (r.frame_id == 0).mean()
        print(f"fraction matched into its own frame: {own:.3f}")

    if args.save:
        idx.save(args.save)
        print(f"saved shards to {args.save}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
