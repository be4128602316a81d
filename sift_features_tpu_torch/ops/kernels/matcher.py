"""M1: the matcher's fused float64 distances and cross-check minima.

M1 replaces no TPU kernel: the JAX package leaves the matcher to XLA (a dot
and two argmins, sift_features_tpu/ops/matcher.py:_match_jit). Its plain
version is the chunk loop of ops/matcher.py:match_dense, which the CPU
takes. The CUDA kernel is csrc/matcher.cu. Its note gives the bound and
the design: float64 on the tensor cores, with one block per SM over a range
of train rows. Every distance is exact: each of a pair's 128 products is a
float64 multiply-add on the tensor cores. Two query rows share each f64
operand, B = b1 + 2^24 b2, against the train operand -2 a; the accumulator
starts at 2^52 + G (1 + 2^24), G = ||a||^2 + 2^23, and ends holding two
24-bit fields F = d^2 - ||b||^2 + 2^23, one a query row, which the kernel
reads from the double's words. Padding train rows start at G = 2^24 - 1,
above every real field; padding query rows are zero rows of norm 2^23,
above every real d^2. The bound is float64 operations: the pairs' work is
1,166 ms for 8,192 query rows against 37.2M train rows, and the packed
products M1 runs half of that, 583 ms. The (Q, T) distances never reach
device memory.

The kernel returns packed keys, (f32 bits of d^2) << 32 | index, as int64
(never negative: a distance's f32 bits are below 2^31). A plain min over
them picks the smallest distance and, among equal ones, the lowest index.
`row_key[q]` is query q's minimum over the train rows and `col_key[t]` is
train row t's minimum over the queries. `keys_to_matches` unpacks them
into match_dense's result, so the key format stays inside this module and
the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..util import sqrt_f32
from . import build

# bytes a descriptor row may have: the keys hold d^2 in 23 bits and the
# packed operand's fields in 24, and 128 x 255^2 < 2^23
MAX_DIM = 128


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x as the kernel's (n, 128) u8 rows: narrower rows padded with zero
    bytes (no distance changes), a base off 16 bytes copied."""
    if x.shape[1] < MAX_DIM:
        x = torch.nn.functional.pad(x, (0, MAX_DIM - x.shape[1]))
    if x.data_ptr() % 16:
        x = x.clone()
    return x


def match_keys(d_train: torch.Tensor, d_query: torch.Tensor):
    """M1 wrapper: (T, D) train and (Q, D) query rows, u8, contiguous, on
    one CUDA device, D <= 128, T and Q >= 1 -> (row_key (Q,) int64,
    col_key (T,) int64), the packed keys of the module note. Raises for
    anything else, before any build. One launch."""
    name = "match_keys"
    for t in (d_train, d_query):
        if t.dtype != torch.uint8:
            raise ValueError(f"{name}: rows must be uint8, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: rows must be contiguous")
        if t.dim() != 2 or t.shape[0] == 0 or t.shape[0] >= 2 ** 31:
            raise ValueError(f"{name}: rows must be (N, D) with 1 <= N < 2^31")
    if d_train.shape[1] != d_query.shape[1] or d_train.shape[1] > MAX_DIM:
        raise ValueError(f"{name}: train and query rows must have the same "
                         f"width, at most {MAX_DIM} bytes")
    build.require_cuda(name, d_train, d_query)
    n_t, n_q = d_train.shape[0], d_query.shape[0]
    train, query = _rows(d_train), _rows(d_query)
    dev = train.device
    row_key = torch.full((n_q,), -1, dtype=torch.int64, device=dev)
    col_key = torch.empty((n_t,), dtype=torch.int64, device=dev)
    fn = build.bind("matcher", "sift_match_keys",
                    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_void_p])
    rc = fn(build.ptr(train), n_t, build.ptr(query), n_q, build.ptr(row_key),
            build.ptr(col_key), _sm_count(dev.index if dev.index is not None
                                          else torch.cuda.current_device()),
            build.stream_ptr(train))
    build.check(rc, "M1 match_keys")
    build.count_launch("M1")
    return row_key, col_key


def keys_to_matches(row_key: torch.Tensor, col_key: torch.Tensor,
                    cross_check: bool):
    """match_keys' packed keys -> match_dense's (best_train (Q,) int64,
    distance (Q,) f32, keep (Q,) bool): keep marks the queries that are
    their best train row's best query when cross_check, every query
    otherwise."""
    low = (1 << 32) - 1
    best_train = row_key & low
    d2 = (row_key >> 32).to(torch.int32).view(torch.float32)
    if cross_check:
        arange = torch.arange(row_key.shape[0], device=row_key.device)
        keep = (col_key[best_train] & low) == arange
    else:
        keep = torch.ones(row_key.shape[0], dtype=torch.bool,
                          device=row_key.device)
    return best_train, sqrt_f32(d2), keep
