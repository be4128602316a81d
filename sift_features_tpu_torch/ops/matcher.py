"""Brute-force L2 descriptor matching with cross-check.

Counterpart of sift_features_tpu/ops/matcher.py (`_match_jit`, f32 path, and
`match_brute_force`): BFMatcher(NORM_L2, crossCheck=True) semantics, with
||a - b||^2 = ||a||^2 + ||b||^2 - 2 a.b (the JAX package leaves it to
XLA, not to a kernel of its own). Ties resolve to the lowest index, as
`torch.argmin` does.

The distances run in float64 and are rounded once to f32. No TF32
setting touches a float64 product, so the result is the same whatever the
caller has set (the legacy `torch.backends.cuda.matmul.allow_tf32` or the
current `fp32_precision`, globally or for `cuda.matmul`), and the matcher
reads and writes none of those process-wide switches: it is safe to call
from several threads. On u8 descriptors (what the extractor emits) every
product and partial sum is an integer below 2^24 (128 x 255^2 =
8,323,200), exact in float64 as in f32; on f32 input each product of two
values is exact in float64 and only the sums round.

Routes, chosen from the input itself (its device, dtypes and width):
- u8 x u8 rows of at most 128 bytes on a CUDA device, the int8 opt-in
  unset: the hand-written kernel
  M1 (ops/kernels/matcher.py, csrc/matcher.cu), one launch for the whole
  train set. It computes every distance in float64 on the tensor cores and
  keeps, per query and per train row, the packed key (f32 bits of d^2) << 32
  | index of its minimum. The (Q, T) distances never reach device memory.
  A u64 min over the keys gives the same tie rule, so the result equals
  the chunk loop's bit for bit. Anything that goes wrong there raises.
- Everything else takes the chunk loop: CPU tensors (M1's plain version),
  f32 input (no caller on the main path holds f32 rows, and M1's
  order of summation would move their last bits), u8 rows wider than 128
  bytes (M1's keys hold d^2 in 23 bits; no SIFT row is wider), and the
  int8 opt-in. The
  ring matcher (`parallel/ring.py`) calls the loop's `_chunk_d2` itself.

The chunk loop computes the product with `torch.matmul`, one per chunk of
train rows (`TEMP_BYTES`), so that a query against a database of millions
of rows holds a few (Q, chunk) temporaries, never the whole (Q, T) matrix:
a one-frame 1080p query
(~8.7k rows) against 256 frames (~2.2M rows) would need ~155 GB for the
f64 distances alone. Each chunk's per-train argmin over all queries is
exact on its own. The per-query best runs across the chunks in ascending
order and moves only on a strictly smaller f32 distance, so ties still go
to the lowest global index (jnp.argmin's rule), and the result equals the
one-chunk form's bit for bit wherever a chunk's distances are those of the
whole matrix: always on u8 descriptors, whose sums are exact in any order.
The ring matcher streams database shards with running minima by the same
rule.

SIFT_INT8_MATCH=1 (read at each call, as the JAX package reads it outside
`jit`) takes JAX's opt-in int8 path for u8 x u8 input (JAX
ops/matcher.py:_dot_qt_int8): the descriptors shifted by -128 into int8,
their products by `torch._int_mm` (int8 x int8 -> int32), the distances
exact integers in int32. They equal the f64 path's bit for bit (an integer
below 2^24 is exact in f32), in half the bytes a chunk; each chunk takes
TEMP_BYTES // (4 Q) train rows. Any other dtype ignores the variable, as
in JAX.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.profiling import span, stage_clock
from .kernels import matcher as kmatcher
from .util import sqrt_f32

# Bytes of one (Q, chunk) float64 temporary of the distance matrix: the
# train rows go in chunks of max(1, TEMP_BYTES // (8 Q)) rows, with two such
# temporaries and their f32 rounding alive at a time (~1.25 GiB). A
# 1024-row query (the main step's) takes up to 65,536 train rows at once.
TEMP_BYTES = 1 << 29

# the stages that a profiled query times on the card's stream (launch gaps
# included): the distances (M1's launch, or each chunk's `_chunk_d2`), then
# the selection (M1's keys unpacked and cross-checked, or each chunk's
# argmins, running best and per-train argmin)
STAGES = ("matcher.distance", "matcher.select")


@dataclasses.dataclass
class Matches:
    """query index / train index / L2 distance for each retained match."""

    query_idx: np.ndarray
    train_idx: np.ndarray
    distance: np.ndarray


def _chunk_d2(a_rows: torch.Tensor, b: torch.Tensor,
              bb: torch.Tensor) -> torch.Tensor:
    """(Q, n) f32 squared distances of the queries b (Q, D) f64, with
    ||b||^2 = bb, to the train rows a_rows (n, D): bb + aa - 2 a.b in f64,
    rounded once to f32, clamped at 0. The product is doubled and
    subtracted in place (the same roundings as the expression), so two f64
    temporaries are alive, not four."""
    a = a_rows.to(torch.float64)
    aa = torch.sum(a * a, dim=1)
    d2 = bb[:, None] + aa[None, :]
    ab = b @ a.T
    d2.sub_(ab.mul_(2.0))
    del ab
    return torch.clamp_min(d2.to(torch.float32), 0.0)


def _int8(x: torch.Tensor) -> torch.Tensor:
    """u8 descriptors shifted by -128 into int8 (x - 128 is x ^ 0x80)."""
    return x.view(torch.int8) ^ -128


def _chunk_d2_int8(a_rows: torch.Tensor, b8: torch.Tensor,
                   bb8: torch.Tensor, n_q: int) -> torch.Tensor:
    """(Q, n) int32 squared distances of the queries b8 (Q', D) int8 (the
    shifted u8 rows, padded with zero rows to Q' >= 17), with
    ||b8||^2 = bb8, to the u8 train rows a_rows (n, D). JAX's identity
    a.b = a8.b8 + 128 (sum a + sum b) - 128^2 D, its terms collected per
    query and per train row: ||a - b||^2 = ||a8||^2 + ||b8||^2 - 2 a8.b8,
    every term an exact int32. torch._int_mm takes more than 16 rows and
    inner and column sizes that are multiples of 8: the train rows are
    padded to a multiple of 8 and the padding cut off."""
    n = a_rows.shape[0]
    a8 = _int8(a_rows)
    if n % 8:
        a8 = torch.cat([a8, a8.new_zeros((8 - n % 8, a8.shape[1]))])
    aa8 = torch.sum(a8.to(torch.int32) ** 2, dim=1)
    d2 = torch._int_mm(b8, a8.T)
    d2.mul_(-2).add_(bb8[:, None]).add_(aa8[None, :])
    return d2[:n_q, :n]


def int8_match_enabled() -> bool:
    """SIFT_INT8_MATCH, read at each call (JAX ops/matcher.py:51-55)."""
    return bool(int(os.environ.get("SIFT_INT8_MATCH", "0")))


def kernel_route(device: torch.device, train_dtype: torch.dtype,
                 query_dtype: torch.dtype, width: int, int8: bool) -> bool:
    """Whether match_dense takes M1 (module note): u8 x u8 rows of at most
    `kmatcher.MAX_DIM` bytes on a CUDA device, without the int8 opt-in."""
    return (device.type == "cuda" and not int8 and width <= kmatcher.MAX_DIM
            and train_dtype == query_dtype == torch.uint8)


def match_dense(d_train: torch.Tensor, d_query: torch.Tensor,
                cross_check: bool = True, int8: bool = False):
    """(T, D), (Q, D) -> (best_train (Q,) int64, distance (Q,) f32, keep (Q,)
    bool); keep marks mutual nearest neighbours when cross_check. The query
    rows move to the train rows' device. u8 x u8 rows of at most 128 bytes
    on a CUDA device take M1, anything else the chunk loop (module note);
    int8=True on u8 x u8 input takes the loop's int8 path, with the same
    result. With no row on either
    side no query row is kept.

    Spans `matcher.prepare` (the query to the device, its norms) and
    `matcher.chunks` (the distances, the selection and the cross-check;
    attributes `chunks`, `pairs` (the Q x T distances) and `route`,
    "kernel" for M1 or "plain" for the loop). Under a profiler session on
    the card, the stream time of `matcher.distance` and `matcher.select`
    goes in child spans of `matcher.chunks` (utils/profiling.py)."""
    n_q, n_t = d_query.shape[0], d_train.shape[0]
    dev = d_train.device
    if n_q == 0 or n_t == 0:
        return (torch.zeros(n_q, dtype=torch.int64, device=dev),
                torch.full((n_q,), float("inf"), dtype=torch.float32, device=dev),
                torch.zeros(n_q, dtype=torch.bool, device=dev))
    int8 = int8 and d_train.dtype == d_query.dtype == torch.uint8
    if kernel_route(dev, d_train.dtype, d_query.dtype, d_train.shape[1], int8):
        with span("matcher.prepare", rows=n_q):
            d_query = d_query.to(dev).contiguous()
        with span("matcher.chunks", chunks=1, pairs=n_q * n_t, route="kernel"):
            clock = stage_clock(dev, STAGES, "chunks")
            if clock is not None:
                clock.mark()
            keys = kmatcher.match_keys(d_train.contiguous(), d_query)
            if clock is not None:
                clock.mark()
            out = kmatcher.keys_to_matches(*keys, cross_check)
            if clock is not None:
                clock.mark()
            return out
    with span("matcher.prepare", rows=n_q):
        d_query = d_query.to(dev)
        if int8:
            rows = max(8, TEMP_BYTES // (4 * n_q) // 8 * 8)
            b = _int8(d_query)
            b = torch.cat([b, b.new_zeros((max(0, 17 - n_q), b.shape[1]))])
            bb = torch.sum(b.to(torch.int32) ** 2, dim=1)
        else:
            rows = max(1, TEMP_BYTES // (8 * n_q))
            b = d_query.to(torch.float64)
            bb = torch.sum(b * b, dim=1)
    n_chunks = -(-n_t // rows)
    with span("matcher.chunks", chunks=n_chunks, pairs=n_q * n_t,
              route="plain"):
        clock = stage_clock(dev, STAGES, "chunks")
        best_query = []
        for t0 in range(0, n_t, rows):
            if clock is not None:
                clock.mark()
            a = d_train if rows >= n_t else d_train[t0:t0 + rows]
            d2 = (_chunk_d2_int8(a, b, bb, n_q) if int8
                  else _chunk_d2(a, b, bb))
            if clock is not None:
                clock.mark()
            arg = torch.argmin(d2, dim=1)
            low = torch.gather(d2, 1, arg[:, None])[:, 0]
            if t0 == 0:
                best_train, best_d2 = arg, low
            else:
                better = low < best_d2
                best_train = torch.where(better, arg + t0, best_train)
                best_d2 = torch.where(better, low, best_d2)
            if cross_check:
                best_query.append(torch.argmin(d2, dim=0))
            del d2
        if clock is not None:
            clock.mark()
        if cross_check:
            best_query = (best_query[0] if len(best_query) == 1
                          else torch.cat(best_query))
            keep = best_query[best_train] == torch.arange(n_q, device=dev)
        else:
            keep = torch.ones(n_q, dtype=torch.bool, device=dev)
        return best_train, sqrt_f32(best_d2.to(torch.float32)), keep


def _on(x, dev: torch.device) -> torch.Tensor:
    """x (a tensor on any device, or an array) as a tensor on dev."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.asarray(x), device=dev)


def match_brute_force(d_train, d_query, cross_check: bool = True,
                      device: str | torch.device = "cuda") -> Matches:
    """BFMatcher.match(query) analog: d_train was 'add'ed, d_query matched.
    Arrays or tensors (on any device) of (N, 128) u8 or f32; the match runs
    on `device`, where a tensor that is already there is not copied."""
    dev = resolve_device(device)
    if not isinstance(d_query, torch.Tensor):
        d_query = torch.as_tensor(np.asarray(d_query))
    bt, dist, keep = match_dense(_on(d_train, dev), d_query, cross_check,
                                 int8_match_enabled())
    with span("matcher.readback"):
        bt, dist, keep = bt.cpu().numpy(), dist.cpu().numpy(), keep.cpu().numpy()
        qi = np.nonzero(keep)[0]
    return Matches(query_idx=qi, train_idx=bt[qi], distance=dist[qi])
