"""Candidate -> region grouping of the tile refinement (K11).

The port's copy of sift_features_tpu/ops/pallas/region_group.py:
group_by_region and merge_escaped. Candidates are grouped by an image
region of their frame; each region's candidate list is padded to a multiple
of the block size `bk`, so every kernel block belongs to one region, and
`slot_k` maps each candidate back to its slot. Empty regions take no slot,
and a block with no real candidate (`active_b == 0`) has nothing to do.
The geometry (region, window and margin sizes) is the caller's: K11 passes
its own (ops/kernels/refine.py), the tests also the TPU's.

Nothing here synchronises with the host: every size is a static bound.
"""

from __future__ import annotations

import dataclasses

import torch

I32 = torch.int32


@dataclasses.dataclass
class RegionLayout:
    """Slot-level layout of one grouped launch (all tensors)."""

    s_slot: torch.Tensor    # (T_cap,) frame-local scale per slot
    y_slot: torch.Tensor    # (T_cap,) padded row per slot
    x_slot: torch.Tensor    # (T_cap,) padded column per slot
    a_slot: torch.Tensor    # (T_cap,) 1 = real candidate
    seg_b: torch.Tensor     # (nb,) segment id per block
    r0_b: torch.Tensor      # (nb,) window row origin per block
    c0_b: torch.Tensor      # (nb,) window column origin per block
    pb_b: torch.Tensor      # (nb,) plane base (frame * n_dog) per block
    active_b: torch.Tensor  # (nb,) real-candidate count per block
    slot_k: torch.Tensor    # (K,) slot of each original candidate
    src: torch.Tensor       # (T_cap,) candidate index per slot (garbage on
    #                         inactive slots: mask with a_slot)
    T_cap: int
    nb: int


def _scatter_add_ones(n: int, index: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(n, dtype=torch.int64, device=index.device)
    return out.index_add_(0, index, torch.ones_like(index))


def group_by_region(s0, y0, x0, valid, pad: int, Hp: int, Wp: int,
                    n_dog: int, n_frames: int, plane_off,
                    reg_r: int, reg_c: int, win_r: int, win_c: int,
                    margin_r: int, margin_c: int, bk: int) -> RegionLayout:
    """Group candidates by (frame, reg_r-row, reg_c-column) region.

    Regions partition the padded image; each block's window origin is the
    region origin minus (margin_r, margin_c), clamped into the stack. Every
    region's candidate list is padded to a multiple of bk so blocks never
    straddle regions; invalid candidates sort into a per-frame virtual
    segment that takes no slot."""
    dev = s0.device
    K = s0.shape[0]
    LR = min(win_r, Hp)
    LW = min(win_c, Wp)
    NRY = -(-Hp // reg_r) if LR < Hp else 1
    NRX = -(-Wp // reg_c) if LW < Wp else 1
    NR = NRY * NRX
    s0, y0, x0 = s0.long(), y0.long(), x0.long()
    valid = valid.bool()

    frame = (plane_off.long() // n_dog if plane_off is not None
             else torch.zeros(K, dtype=torch.int64, device=dev))
    ry = torch.clamp(y0 // reg_r, 0, NRY - 1)
    rx = torch.clamp(x0 // reg_c, 0, NRX - 1)
    reg = ry * NRX + rx
    gkey = frame * (NR + 1) + torch.where(valid, reg, torch.full_like(reg, NR))
    NSEG = n_frames * (NR + 1)
    seg_ids = torch.arange(NSEG, device=dev)

    perm = torch.sort(gkey, stable=True)[1]
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = torch.arange(K, device=dev)
    counts = _scatter_add_ones(NSEG, gkey)
    starts = torch.cumsum(counts, 0) - counts
    is_virtual = (seg_ids % (NR + 1)) == NR
    padded = torch.where(is_virtual, torch.zeros_like(counts),
                         -(-counts // bk) * bk)
    cum = torch.cumsum(padded, 0)
    offsets = cum - padded

    T_cap = K + n_frames * NR * bk
    T_cap = -(-T_cap // bk) * bk
    nb = T_cap // bk

    # per-block segment id: seg of block b = #{i: cum[i] <= b*bk}; cum values
    # are bk-multiples, so mark each boundary's block and cumsum
    markb = _scatter_add_ones(nb + 1, torch.clamp(cum // bk, 0, nb))
    seg_raw = torch.cumsum(markb, 0)[:nb]           # may reach NSEG (tail)
    seg_b = torch.clamp(seg_raw, max=NSEG - 1)

    lanes = torch.arange(bk, device=dev)
    rank = ((torch.arange(nb, device=dev) * bk - offsets[seg_b])[:, None]
            + lanes[None, :])                        # (nb, bk)
    active2 = (seg_raw < NSEG)[:, None] & (rank < counts[seg_b][:, None])
    src = perm[torch.clamp(starts[seg_b][:, None] + rank, 0, K - 1)].reshape(-1)
    active = active2.reshape(-1)

    # one packed gather for (s, y, x); dead slots decode to (1, pad, pad)
    pk = (s0 * Hp + y0) * Wp + x0
    pv = torch.where(active, pk[src], torch.full_like(src, (Hp + pad) * Wp + pad))
    x_sl = pv % Wp
    yy = pv // Wp
    y_sl = yy % Hp
    s_sl = yy // Hp

    reg_b = seg_b % (NR + 1)
    frame_b = seg_b // (NR + 1)
    ry_b = torch.clamp(reg_b, 0, NR - 1) // NRX
    rx_b = torch.clamp(reg_b, 0, NR - 1) % NRX
    a_slot = active.to(I32)

    gclip = torch.clamp(gkey, 0, NSEG - 1)
    return RegionLayout(
        s_slot=s_sl.to(I32), y_slot=y_sl.to(I32), x_slot=x_sl.to(I32),
        a_slot=a_slot, seg_b=seg_b.to(I32),
        r0_b=torch.clamp(ry_b * reg_r - margin_r, 0, Hp - LR).to(I32),
        c0_b=torch.clamp(rx_b * reg_c - margin_c, 0, Wp - LW).to(I32),
        pb_b=(frame_b * n_dog).to(I32),
        active_b=a_slot.reshape(nb, bk).sum(1, dtype=I32),
        slot_k=(offsets[gclip] + (inv_perm - starts[gclip])).to(I32),
        src=src.to(I32), T_cap=T_cap, nb=nb)


def merge_escaped(rows, valid, fallback):
    """Tile rows (K, 16), gathered back to the candidates, merged with a
    full re-refinement `fallback(escaped)` of the escaped candidates (column
    9) from their original positions. The fallback's rows also stand for
    the invalid candidates (they never move), so the result equals the
    plain refinement row for row."""
    escaped = (rows[:, 9] > 0) & valid.bool()
    fb = fallback(escaped)
    keep = valid.bool() & ~escaped
    return torch.where(keep[:, None], rows, fb)
