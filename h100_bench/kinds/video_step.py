"""Traffic kind `video_step`: one caller in a closed loop feeding batches of
consecutive video frames.

A step hands `batch` new frames of the camera path (host memory, u8) to
`extract_batch` (with the mix's `features_limit`), takes each frame's valid
rows, matches them with `match_descriptors` (cross-check per the mix)
against the previous frame's rows (frame 0 against the previous step's
last frame), and brings keypoints and descriptors to the host; the matches
come back on the host. The step's time runs from the frames in host memory
to all of that on the host.

Judged once the window has closed: one step of the window drawn from the
seed. Every frame of it against the plain reference from the frame itself
(`reference.frame_rows`), and every frame's matches against the reference
matcher on the same two descriptor sets the program matched.

Controls (`control`): "bf16_storage" runs the program's own bfloat16
pyramid storage (SiftConfig.storage_dtype) in place of the configuration's
float32.
"""

from __future__ import annotations

import time

import numpy as np

from .. import generators as gen
from ..reference import compare
from ..tracing import span

CONTROLS = {"bf16_storage": {"storage_dtype": "bfloat16"}}


def _pct(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.traffic = ctx.config, ctx.traffic
        self.batch = int(self.traffic["batch"])
        self.limit = self.traffic.get("features_limit")
        self.cross_check = bool(self.traffic.get("cross_check", True))
        self.latencies, self.items = [], 0
        self.in_window = False
        self.sample = None
        self.window_steps = 0
        self.counters, self.counts = [], []

    # --- set-up ----------------------------------------------------------

    def setup(self) -> None:
        import torch

        import sift_features_tpu_torch as port
        from sift_features_tpu_torch.models.extractor import extract_batch

        self.torch = torch
        self.extract_batch, self.match = extract_batch, port.match_descriptors
        sift = dict(self.config["sift"])
        if self.ctx.control:
            sift.update(CONTROLS[self.ctx.control])
        self.cfg = port.SiftConfig(**sift)
        self.device = self.ctx.device
        self.is_cuda = str(self.device).startswith("cuda")
        fr, cv = self.config["frame"], self.config["canvas"]
        self.frame_h, self.frame_w = int(fr["height"]), int(fr["width"])
        canvas = gen.canvas(self.ctx.seed, int(cv["height"]), int(cv["width"]),
                            cv["sigmas"], cv["mean"], cv["std"], self.device)
        self.path = gen.CameraPath(canvas, self.frame_h, self.frame_w,
                                   float(self.config["path"]["speed_px_per_frame"]),
                                   self.ctx.seed)
        self.rng = np.random.default_rng(gen.seed_of(self.ctx.seed, 3))
        self.prev = self.prev_host = None
        for _ in range(int(self.traffic.get("warmup_steps", 3))):
            self.step()
        self.latencies, self.items = [], 0

    # --- one step --------------------------------------------------------

    def step(self, traced: bool = False) -> None:
        frames = self.path.take(self.batch)
        prev_host = self.prev_host
        t0 = time.perf_counter()
        with span("bench.step", traced):
            with span("bench.extract", traced):
                res = self.extract_batch(frames, self.cfg, self.limit,
                                         device=self.device)
                if traced and self.is_cuda:
                    self.torch.cuda.synchronize()
            outs = []
            for i in range(self.batch):
                v = res["valid"][i]
                kps, desc = res["kps"][i][v], res["desc"][i][v]
                m = None
                if self.prev is not None:
                    with span("bench.match", traced):
                        m = self.match(self.prev, desc, self.cross_check,
                                       device=self.device)
                outs.append((kps.cpu().numpy(), desc.cpu().numpy(), m))
                self.prev = desc
        t1 = time.perf_counter()
        self.prev_host = outs[-1][1]
        self.latencies.append(t1 - t0)
        self.items += self.batch
        if self.in_window:
            self.counters.append(tuple(res[k] for k in ("n_candidates",
                                                        "n_survivors",
                                                        "n_emitted")))
            self.counts.extend(len(o[0]) for o in outs)
            # one step of the window, uniformly, drawn from the seed
            self.window_steps += 1
            if self.rng.random() * self.window_steps < 1.0:
                self.sample = (frames, outs, prev_host)

    # --- results ---------------------------------------------------------

    def end_to_end(self, window_s: float) -> dict:
        return {"frames_per_s": self.items / window_s,
                "step_p95_ms": 1e3 * _pct(self.latencies, 95)}

    def trace_cell(self) -> dict:
        from ..reference.pixel_ops import SiftParams

        return {"batch": self.batch, "frame_h": self.frame_h,
                "frame_w": self.frame_w,
                "params": SiftParams.from_dict(self.cfg.__dict__)}

    def audit(self) -> list[str]:
        """The program's capacity-overflow audit over every frame of the
        window (utils/profiling.extraction_metrics)."""
        from sift_features_tpu_torch.utils.profiling import extraction_metrics

        if not self.counters:
            return []
        cat = {k: np.concatenate([c[i].cpu().numpy() for c in self.counters])
               for i, k in enumerate(("n_candidates", "n_survivors", "n_emitted"))}
        counts = np.asarray(self.counts)
        cat["valid"] = np.arange(counts.max(initial=0))[None, :] < counts[:, None]
        m = extraction_metrics(cat, (self.frame_h, self.frame_w), self.cfg)
        over = m["capacity_overflow_per_octave"]
        return [f"audit frames {m['frames']} keypoints_per_frame min "
                f"{counts.min()} median {int(np.median(counts))} max "
                f"{counts.max()} capacity_overflow_per_octave {over} "
                f"max_candidates_per_octave {cat['n_candidates'].max(0).tolist()} "
                f"max_survivors_per_octave {cat['n_survivors'].max(0).tolist()} "
                f"max_emitted_per_octave {cat['n_emitted'].max(0).tolist()}"]

    def free(self) -> None:
        self.prev = None
        self.counters = []

    def judge(self, workers: int) -> dict:
        """The readings of the sampled step (module note)."""
        from ..reference import frame_rows

        frames, outs, prev_host = self.sample
        sift = self.config["sift"]
        args = [(f, sift, self.limit) for f in frames]
        if workers > 1:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            with ProcessPoolExecutor(min(workers, len(args)),
                                     mp_context=mp.get_context("spawn")) as ex:
                refs = list(ex.map(frame_rows, *zip(*args)))
        else:
            refs = [frame_rows(*a) for a in args]
        readings = dict.fromkeys(compare.ROW_READINGS, 0.0)
        differ = 0
        for i, ((kps, desc, m), (kr, dr)) in enumerate(zip(outs, refs)):
            for k, v in compare.rows_readings(kps, desc, kr, dr).items():
                readings[k] = max(readings[k], v)
            train = prev_host if i == 0 else outs[i - 1][1]
            differ += compare.matches_readings(m, train, desc, self.cross_check)
        readings["match_rows_differ"] = differ
        return readings
