"""Analytic multi-rank scaling model for the extract + match step.

Counterpart of sift_features_tpu/utils/scaling.py. Per-step collective
bytes come from the array shapes the step moves (ring blocks, halo rows,
gathers), overlapped against a per-frame compute time and an interconnect
rate. The rate is the caller's: no link figure is built in, since none has
been measured for this port (one card, no interconnect to time).
"""

from __future__ import annotations

import dataclasses

DESC_BYTES = 128          # u8 descriptor


@dataclasses.dataclass
class StepTraffic:
    """Per-device, per-step collective byte counts for extract_match_step."""

    ring_bytes: int        # train blocks + column state, all hops
    gather_bytes: int      # final cross-check all_gather
    halo_bytes: int        # spatial-axis halo rows (0 when space=1)

    @property
    def total(self) -> int:
        return self.ring_bytes + self.gather_bytes + self.halo_bytes


def step_traffic(batch: int, n_kps: int, queries_per_frame: int,
                 n_data: int, n_space: int = 1, height: int = 1080,
                 width: int = 1920, halo_rows: int = 16,
                 n_levels: int = 5) -> StepTraffic:
    """Collective bytes per device for one extract_match_step.

    batch: frames per step (global); n_kps: database descriptors per frame
    (the padded capacity); queries_per_frame: ring query rows. Shapes
    mirror parallel.pipeline.extract_match_step."""
    T = batch * n_kps                       # database rows, frame-major
    t_blk = T // n_data
    # each hop moves: u8 block (t_blk, 128), f32 col_d, i32 col_q, i32 tag
    per_hop = t_blk * (DESC_BYTES + 4 + 4 + 4)
    ring = n_data * per_hop
    # final all_gather of per-train best-query indices: T i32 per device
    gather = T * 4
    halo = 0
    if n_space > 1:
        # 2 * halo_rows boundary rows per blur level per octave (f32),
        # geometric sum over octaves ~ 4/3 of octave 0
        halo = int(2 * halo_rows * width * 4 * n_levels * 4 / 3)
    return StepTraffic(ring_bytes=ring, gather_bytes=gather, halo_bytes=halo)


def projected_efficiency(fps_per_chip: float, batch: int, n_kps: int,
                         queries_per_frame: int, n_chips: int,
                         link_bps: float, n_space: int = 1,
                         overlap: float = 0.0) -> dict:
    """Scaling efficiency projection at n_chips data-parallel ranks.

    fps_per_chip: measured one-device throughput (compute time per frame =
    1/fps); link_bps: the interconnect's bytes/s per device, the caller's
    figure. Communication time = per-device collective bytes / link rate;
    `overlap` in [0, 1] is the share of it hidden under compute (0 = fully
    exposed, the worst case). Efficiency = t_compute / (t_compute +
    t_comm)."""
    tr = step_traffic(batch * n_chips, n_kps, queries_per_frame,
                      n_data=n_chips, n_space=n_space)
    t_compute = batch / fps_per_chip               # seconds per local batch
    t_comm = tr.total / link_bps * (1.0 - overlap)
    eff = t_compute / (t_compute + t_comm)
    return {
        "n_chips": n_chips,
        "collective_mb_per_device": round(tr.total / 1e6, 3),
        "t_compute_ms": round(t_compute * 1e3, 2),
        "t_comm_exposed_ms": round(t_comm * 1e3, 3),
        "efficiency": round(eff, 4),
        "aggregate_fps": round(eff * fps_per_chip * n_chips, 1),
    }
