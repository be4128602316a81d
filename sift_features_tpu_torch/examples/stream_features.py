"""Streaming serving-loop demo: JPEG files -> features, pipelined on the card.

The native C++ decode pool, the host-to-card copy, the extraction and the
readback overlap across batches (sift_features_tpu_torch/parallel/stream.py).
The port's counterpart of the JAX package's examples/stream_features.py and
the continuous-feed counterpart of the reference's one-shot
examples/run-sift.rs. Frames are decoded by the port's native loader.

Usage: python -m sift_features_tpu_torch.examples.stream_features
       jpegs... [--batch B] [--budget N] [--hw H,W] [--index]
       [--device cuda|cpu]

With --index the streamed features are appended to a DescriptorIndex
(loop-closure database) as they arrive.
"""

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("paths", nargs="+", help="JPEG files")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--budget", type=int, default=512,
                    help="features_limit per frame (0 = unlimited)")
    ap.add_argument("--hw", default="608,800",
                    help="fixed H,W frames are cropped/padded to")
    ap.add_argument("--index", action="store_true",
                    help="append streamed features to a DescriptorIndex")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from sift_features_tpu_torch.parallel.stream import stream_extract_paths

    h, w = (int(v) for v in args.hw.split(","))
    budget = args.budget or None
    index = None
    if args.index:
        from sift_features_tpu_torch.service import DescriptorIndex

        index = DescriptorIndex(device=args.device)

    t0 = time.perf_counter()
    n_frames = n_kps = 0
    for batch in stream_extract_paths(args.paths, args.batch, (h, w),
                                      features_limit=budget,
                                      device=args.device):
        for kps, desc in batch:
            path = args.paths[n_frames]
            print(f"{os.path.basename(path):24s} {len(kps):6d} keypoints")
            if index is not None:
                index.add_batch_result(
                    {"kps": kps[None], "desc": desc[None],
                     "valid": np.ones((1, len(kps)), bool)},
                    frame_ids=np.array([n_frames]))
            n_frames += 1
            n_kps += len(kps)
    dt = time.perf_counter() - t0
    print(f"\n{n_frames} frames, {n_kps} keypoints in {dt:.1f}s "
          f"({n_frames / dt:.2f} frames/s end to end)")
    if index is not None:
        print(f"index: {int(index.db.offsets[-1])} descriptor rows from "
              f"{len(index.db.frame_ids)} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
