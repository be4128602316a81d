"""Fixed-capacity, order-preserving compaction of masked lanes.

The contract of sift_features_tpu/utils/compact.py: idx[..., i] is the
position of the i-th True element (row-major scan order, which is the
reference's emission order), 0-filled past the true count; count is the
true count, so an overflow (count > capacity) keeps the scan-order prefix
and stays visible. The TPU version avoids scatters; on the GPU a cumsum
plus one scatter is cheap, and nothing here synchronises with the host.
All functions take a leading batch of rows: mask (..., N).
"""

from __future__ import annotations

import torch


def compact_indices(mask: torch.Tensor, capacity: int):
    """mask (..., N) bool -> (idx (..., capacity) int64, valid (...,
    capacity) bool, count (...) int64)."""
    n = mask.shape[-1]
    pos = torch.cumsum(mask, dim=-1)                       # inclusive, int64
    count = pos[..., -1] if n else torch.zeros(mask.shape[:-1], dtype=torch.int64,
                                               device=mask.device)
    keep = mask & (pos <= capacity)
    # every lane that is not kept lands in the dump slot `capacity`, which
    # is cut off; kept lanes have distinct targets
    tgt = torch.where(keep, pos - 1, torch.full_like(pos, capacity))
    out = torch.zeros((*mask.shape[:-1], capacity + 1), dtype=torch.int64,
                      device=mask.device)
    src = torch.arange(n, device=mask.device).expand(mask.shape)
    out.scatter_(-1, tgt, src)
    slots = torch.arange(capacity, device=mask.device)
    valid = slots < torch.clamp(count, max=capacity).unsqueeze(-1)
    idx = torch.where(valid, out[..., :capacity], torch.zeros_like(slots))
    return idx, valid, count


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (as int64)."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., nw) int32 -> (..., nw * 32) bool, bit j of word w = element
    32w + j."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1).to(torch.bool)


def compact_words(words: torch.Tensor, capacity: int):
    """compact_indices over a bit-packed mask: words (..., nw) int32, bit j
    of word w = mask element 32w + j. Same contract and outputs.

    Only the first `capacity` non-zero words are unpacked: each holds at
    least one set bit, so they cover every kept element."""
    nz = words != 0
    widx, wvalid, _ = compact_indices(nz, capacity)
    sel = torch.where(wvalid, torch.gather(words, -1, widx),
                      torch.zeros_like(widx, dtype=words.dtype))
    bits = unpack_bits(sel)                                # (..., cap*32)
    bidx, valid, _ = compact_indices(bits, capacity)
    idx = torch.gather(widx, -1, bidx // 32) * 32 + bidx % 32
    count = popcount32(words).sum(dim=-1)
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    return idx, valid, count


def per_bucket(live: torch.Tensor, s_level: torch.Tensor, radii: dict, launch,
               out: torch.Tensor) -> torch.Tensor:
    """The per-scale-bucket dispatch of the JAX window kernels
    (orientation_kernel.py / descriptor_kernel.py *_bucketed): for each
    bucket si with window bound radii[si], the lanes live & (s_level == si)
    are compacted into a count prefix (count kept on the device),
    launch(idx, count, r_max) -> (N, ...) rows serves them, and each row
    goes back to its lane by rank. out (N, ...) holds the other lanes'
    rows."""
    n = live.shape[0]
    for si, r_max in radii.items():
        maskb = live.bool() & (s_level == si)
        idx, _, count = compact_indices(maskb, n)
        rows = launch(idx, count, r_max)
        rank = torch.clamp(torch.cumsum(maskb, 0) - 1, min=0)
        out = torch.where(maskb[:, None], rows[rank], out)
    return out
