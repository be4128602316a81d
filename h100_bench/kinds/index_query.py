"""Traffic kind `index_query`: one caller in a closed loop asking a map of
keyframes for loop closure, one request at a time.

Set-up builds the map from the seed on the device: `map.keyframes`
keyframes of `map.rows_per_keyframe` rows each, shaped as SIFT finalises
a descriptor (generators.sift_rows), with seeded keypoint fields. It goes in
through the service's public API (`DescriptorIndex.add_batch_result`), and
the warm-up queries move it to the device as the service's train cache.
The benchmark keeps its own copy of the map on the host.

A request is `DescriptorIndex.query` with `query_rows` rows made on the
host from the seed: a `revisit_share` of them copies of rows of one seeded
keyframe with every byte moved by up to `revisit_noise` (a revisit), the
rest fresh rows (generators.sift_rows), in a seeded order. The brute-force
match computes every distance whatever the rows hold, so the share sets
which answers the check sees, not the work. A request's time runs from
the call to the `QueryResult` on the host.

Judged once the window has closed: `judged_queries` requests of the
window drawn from the seed, each whole, against the reference matcher
(reference.matcher.match, exact float32 on the device) over the
benchmark's own copy of the map and its own row maps.

Control (`control`): "bf16_product" answers the requests with that
reference matcher computed in bfloat16, in place of the configuration's
exact distances. (float32, the step below the stated float64, is exact on
u8 rows and cannot break the guarantee.)
"""

from __future__ import annotations

import time
import types

import numpy as np

from .. import generators as gen
from ..reference import compare
from ..reference import matcher
from ..tracing import span

CONTROLS = {"bf16_product": "bfloat16"}


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.traffic = ctx.config, ctx.traffic
        self.latencies = []
        self.in_window = False
        self.results = []
        self.n_queries = 0

    # --- set-up ----------------------------------------------------------

    def setup(self) -> None:
        import torch

        from sift_features_tpu_torch.service import DescriptorIndex

        self.train = None
        dev = self.device = self.ctx.device
        m = self.config["map"]
        self.dim, self.cap, self.l2 = int(m["dim"]), float(m["magnitude_cap"]), float(m["l2_norm"])
        n_f, per = int(m["keyframes"]), int(m["rows_per_keyframe"])
        total = n_f * per
        self.n_f, self.per = n_f, per
        g = gen.device_generator(gen.seed_of(self.ctx.seed, 21), dev)
        rows = torch.cat([gen.sift_rows(g, min(1 << 18, total - r0), self.dim,
                                        self.cap, self.l2, dev)
                          for r0 in range(0, total, 1 << 18)])
        fr = self.config["frame"]
        u = torch.rand((total, 5), generator=g, device=dev)
        scale = torch.tensor([fr["width"], fr["height"], 30.0, 360.0, 0.1],
                             device=dev)
        desc, kps = rows.view(n_f, per, self.dim), (u * scale).view(n_f, per, 5)
        valid = torch.ones((n_f, per), dtype=torch.bool, device=dev)
        self.index = DescriptorIndex(device=dev)
        self.index.add_batch_result({"kps": kps, "desc": desc, "valid": valid},
                                    np.arange(n_f, dtype=np.int64))
        self.map_desc = rows.cpu().numpy()
        self.row_frame = np.repeat(np.arange(n_f, dtype=np.int64), per)
        self.row_kp = np.tile(np.arange(per, dtype=np.int64), n_f)
        del desc, kps, valid, u, rows
        self.query = self.index.query
        if self.ctx.control:
            self.train = torch.as_tensor(self.map_desc, device=dev)
            dtype = getattr(torch, CONTROLS[self.ctx.control])
            self.query = lambda q, cc=True: self._plain_query(q, cc, dtype)
        if str(dev).startswith("cuda"):
            torch.cuda.empty_cache()
        for _ in range(int(self.traffic.get("warmup_queries", 2))):
            self.step()
        self.latencies = []

    def query_rows(self, k: int) -> np.ndarray:
        """The rows of request k (module note)."""
        t = self.traffic
        rng = np.random.default_rng(gen.seed_of(self.ctx.seed, 30, k))
        n = int(t["query_rows"])
        n_rev = int(round(float(t["revisit_share"]) * n))
        f = int(rng.integers(self.n_f))
        src = rng.choice(self.per, n_rev, replace=False) + f * self.per
        noise = int(t["revisit_noise"])
        rev = np.clip(self.map_desc[src].astype(np.int16)
                      + rng.integers(-noise, noise + 1, (n_rev, self.dim)),
                      0, 255).astype(np.uint8)
        g = gen.device_generator(gen.seed_of(self.ctx.seed, 32, k), "cpu")
        fresh = gen.sift_rows(g, n - n_rev, self.dim, self.cap, self.l2,
                              "cpu").numpy()
        return np.concatenate([rev, fresh])[rng.permutation(n)]

    # --- one request -----------------------------------------------------

    def step(self, traced: bool = False) -> None:
        k = self.n_queries
        self.n_queries += 1
        q = self.query_rows(k)
        cc = bool(self.traffic.get("cross_check", True))
        t0 = time.perf_counter()
        with span("bench.step", traced), span("bench.query", traced):
            r = self.query(q, cc)
        t1 = time.perf_counter()
        self.latencies.append(t1 - t0)
        if self.in_window:
            self.results.append((k, r))

    def _plain_query(self, q, cross_check: bool, dtype):
        """The control: the reference matcher in place of the program, in
        dtype."""
        qi, ti, dist = matcher.match(self.train, q, cross_check,
                                           self.device, dtype)
        return types.SimpleNamespace(query_idx=qi, frame_id=self.row_frame[ti],
                                     keypoint_idx=self.row_kp[ti], distance=dist)

    # --- results ---------------------------------------------------------

    def end_to_end(self, window_s: float) -> dict:
        lat = np.asarray(self.latencies, np.float64)
        return {"query_ms": 1e3 * float(lat.mean())}

    def trace_cell(self) -> dict:
        return {}

    def audit(self) -> list[str]:
        return [f"map keyframes {self.n_f} rows {self.n_f * self.per} "
                f"rows_per_keyframe {self.per}"]

    def free(self) -> None:
        self.index = self.query = None
        self.train = None

    def judge(self, workers: int) -> dict:
        rng = np.random.default_rng(gen.seed_of(self.ctx.seed, 31))
        n = min(int(self.traffic.get("judged_queries", 1)), len(self.results))
        picks = rng.choice(len(self.results), n, replace=False)
        cc = bool(self.traffic.get("cross_check", True))
        differ = 0
        for p in sorted(picks):
            k, r = self.results[int(p)]
            differ += compare.query_readings(r, self.map_desc, self.row_frame,
                                             self.row_kp, self.query_rows(k), cc,
                                             self.device)
        return {"answer_rows_differ": differ}
