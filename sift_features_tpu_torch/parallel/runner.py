"""Multi-process serving runner: the process group, a health barrier and an
at-least-once batch executor.

Counterpart of sift_features_tpu/parallel/runner.py. The pipeline is
stateless per frame batch, so a lost or failed batch is simply run again:
work is split into frame batches, a failed one is re-enqueued, and a
collective barrier with a timeout checks the ranks' health at batch
boundaries. Without a coordinator everything runs in this one process, so
the same serving script runs on one card and on many ranks.
"""

from __future__ import annotations

import datetime
import logging
import time

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

log = logging.getLogger("sift_features_tpu_torch.runner")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device="cuda",
                     timeout_s: float = 600.0) -> int:
    """Join the process group at `coordinator` ("host:port", TCP) as rank
    process_id of num_processes, with every rank computing on `device`.
    Returns this process's rank; without a coordinator it joins nothing and
    returns 0.

    The backend follows the device: NCCL for a CUDA device, gloo for the
    CPU, except where there are more ranks than cards (several ranks on
    one card: NCCL refuses two ranks on one GPU): those take gloo, whose
    collectives the mesh stages through pinned host memory
    (parallel/mesh.py)."""
    dev = resolve_device(device)
    if coordinator is None:
        return 0
    shared = dev.type == "cuda" and num_processes > torch.cuda.device_count()
    backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count()
                              if dev.index is None else dev.index)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank()


def barrier(tag: str = "health", timeout_s: float = 60.0) -> float:
    """Cross-rank health check: a tiny all_reduce over the world, on the
    device its backend moves (the current card for NCCL, the CPU for
    gloo), waited for. A dead or wedged rank makes it raise or time out
    instead of corrupting results. Returns its latency in seconds; in a
    one-process world it only times an empty step."""
    t0 = time.perf_counter()
    if dist.is_initialized():
        nccl = dist.get_backend() == "nccl"
        x = torch.ones(1, device="cuda" if nccl else "cpu")
        dist.all_reduce(x)
        if nccl:
            torch.cuda.synchronize()
        if int(x.item()) != dist.get_world_size():
            raise RuntimeError(f"barrier '{tag}': all_reduce gave {x.item()}")
    dt = time.perf_counter() - t0
    if dt > timeout_s:
        raise TimeoutError(f"barrier '{tag}' took {dt:.1f}s > {timeout_s}s")
    return dt


class BatchRunner:
    """At-least-once frame-batch executor with re-enqueue on failure.

    `step_fn(batch) -> result` is the pipeline step; `batches` is any
    iterator of (batch_id, frames). Failed batches (device errors,
    timeouts) are retried up to `max_retries` times, the 'restartable per
    frame-batch' recovery model; a batch counts as done once the card has
    finished its work (torch.cuda.synchronize on a CUDA device)."""

    def __init__(self, step_fn, max_retries: int = 2,
                 health_check_every: int = 0, device="cuda"):
        self.step_fn = step_fn
        self.max_retries = max_retries
        self.health_check_every = health_check_every
        self.device = resolve_device(device)
        self.completed = 0
        self.retried = 0

    def run(self, batches):
        pending = list(batches)
        attempts: dict = {}
        while pending:
            batch_id, frames = pending.pop(0)
            try:
                out = self.step_fn(frames)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            except Exception as e:  # noqa: BLE001 — device loss is generic
                n = attempts.get(batch_id, 0) + 1
                attempts[batch_id] = n
                if n > self.max_retries:
                    raise RuntimeError(
                        f"batch {batch_id} failed {n} times") from e
                log.warning("batch %s failed (%s); re-enqueueing (%d/%d)",
                            batch_id, e, n, self.max_retries)
                self.retried += 1
                pending.append((batch_id, frames))
                continue
            self.completed += 1
            if (self.health_check_every
                    and self.completed % self.health_check_every == 0):
                barrier()
            yield batch_id, out
