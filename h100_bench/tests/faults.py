"""Faults planted in the program under a run of the harness, for the tests
that show `correct` comes out false: each wraps one entry point of
sift_features_tpu_torch so that its answer is wrong in one way."""

from __future__ import annotations


def _video(name: str) -> None:
    import sift_features_tpu_torch as port
    from sift_features_tpu_torch.models import extractor

    orig = extractor.extract_batch
    if name == "video_match_altered":
        orig_m = port.match_descriptors

        def match(*a, **k):
            m = orig_m(*a, **k)
            if len(m.train_idx):
                m.train_idx = m.train_idx.copy()
                m.train_idx[0] += 1
            return m

        port.match_descriptors = match
        return
    first = {}

    def extract_batch(imgs, *a, **k):
        if name == "video_stale":
            # a step that hands back its first state, unchanged
            if "r" not in first:
                first["r"] = orig(imgs, *a, **k)
            return first["r"]
        if name == "video_half_batch":
            # half of the batch left out, its results filled from the rest
            import torch

            half = orig(imgs[: (len(imgs) + 1) // 2], *a, **k)
            return {key: torch.cat([v, v])[: len(imgs)] for key, v in half.items()}
        r = dict(orig(imgs, *a, **k))
        if name == "video_kps_moved":
            # one frame's keypoints altered where they are produced
            kps = r["kps"].clone()
            kps[0, :, 0] += 1.0
            r["kps"] = kps
        return r

    extractor.extract_batch = extract_batch


def _index(name: str) -> None:
    from sift_features_tpu_torch.service import DescriptorIndex

    orig = DescriptorIndex.query
    first = {}

    def query(self, desc_q, cross_check=True):
        if name == "index_stale":
            if "r" not in first:
                first["r"] = orig(self, desc_q, cross_check)
            return first["r"]
        if name == "index_half_rows":
            return orig(self, desc_q[: len(desc_q) // 2], cross_check)
        r = orig(self, desc_q, cross_check)
        if name == "index_frame_altered" and len(r.frame_id):
            r.frame_id = r.frame_id.copy()
            r.frame_id[0] += 1
        return r

    DescriptorIndex.query = query


VIDEO = ("video_stale", "video_half_batch", "video_kps_moved",
         "video_match_altered")
INDEX = ("index_stale", "index_half_rows", "index_frame_altered")


def apply(name: str | None) -> None:
    if name is None:
        return
    if name in VIDEO:
        _video(name)
    elif name in INDEX:
        _index(name)
    else:
        raise ValueError(f"unknown fault {name!r}")
