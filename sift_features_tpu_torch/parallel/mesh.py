"""The (data, space) mesh of the port: a torch.distributed process group.

Counterpart of sift_features_tpu/parallel/mesh.py. The JAX package is
single-controller: one process drives a device array. PyTorch's idiom is
SPMD, one process per device, so here the mesh is the world's ranks, laid
out row-major as JAX lays out its device array:

    rank = data * n_space + space

  data  — frames (the throughput axis: a batch of frames per step)
  space — rows of one frame's pyramid (the spatial path: halo-exchange
          blurs, parallel/halo.py; row-band detection, parallel/extract.py)

Every rank builds the same mesh (the subgroups are created by every rank in
the same order, as `dist.new_group` requires) and calls the distributed
entry points with the same whole arrays; each takes its own shard and
returns the whole result. Without an initialised process group the world is
this one rank and every collective is the identity, as on JAX's one-device
mesh.

Collectives go through the group's backend: NCCL on CUDA tensors; gloo
moves CPU tensors only, so a rank on a card whose group is gloo (several
ranks sharing one card, `runner.init_distributed`) stages each collective
through pinned host memory while its compute stays on the card. The
backend decides that, nothing else.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

# what this process's collectives have moved: hops (shift: the ring's and
# the halo's), tiled all_gathers and psums, each counted with the bytes
# this rank sent, in all ("gather_bytes") and per axis ("gather_bytes_space")
TRAFFIC = {f"{kind}{what}{axis}": 0 for kind in ("hop", "gather", "reduce")
           for what in ("s", "_bytes") for axis in ("", "_data", "_space")}


def _count(kind: str, axis_name: str, t: torch.Tensor) -> None:
    """Count one collective of `kind` over `axis_name` that sent t."""
    nbytes = t.numel() * t.element_size()
    for suffix in ("", "_" + axis_name):
        TRAFFIC[f"{kind}s{suffix}"] += 1
        TRAFFIC[f"{kind}_bytes{suffix}"] += nbytes


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a (data, space) mesh of ranks.

    shape: {"data": n_data, "space": n_space}; coords: this rank's
    {"data": d, "space": s}; group: the mesh's process group; groups: the
    subgroup of this rank along each axis (the ranks that differ from it in
    that coordinate only); all None without an initialised process group;
    ranks: the global ranks of those subgroups, in axis order;
    device: where this rank computes."""

    shape: dict
    coords: dict
    rank: int
    group: object
    groups: dict
    ranks: dict
    device: torch.device


def rank_device(device) -> torch.device:
    """The rank's device: a CUDA device without an index becomes
    cuda:{LOCAL_RANK}, or cuda:0 where the ranks share one card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK",
                                   dist.get_rank() if dist.is_initialized() else 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def make_mesh(n_data: int | None = None, n_space: int = 1, group=None,
              device="cuda") -> Mesh:
    """Build a (data, space) mesh over the ranks of `group` (the world's by
    default). Defaults to every rank on the data axis. Collective: every
    rank of the group calls it with the same arguments."""
    dev = rank_device(device)
    if not dist.is_initialized():
        world, rank = 1, 0
    else:
        group = group if group is not None else dist.group.WORLD
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_data is None:
        n_data = world // n_space
    n = n_data * n_space
    if n > world:
        raise ValueError(f"mesh {n_data}x{n_space} needs {n} devices, "
                         f"have {world}")
    shape = {"data": n_data, "space": n_space}
    coords = {"data": rank // n_space, "space": rank % n_space}
    if not dist.is_initialized():
        return Mesh(shape, coords, rank, None, {"data": None, "space": None},
                    {"data": [rank], "space": [rank]}, dev)

    def glob(local):
        return [dist.get_global_rank(group, r) for r in local]

    # an axis that spans the whole mesh uses the mesh's group; in an
    # initialised world even a one-rank axis has its group, so that its
    # all_gathers go through the backend (its hops are skipped)
    mesh_group = group if n == world else dist.new_group(glob(range(n)))
    groups, ranks = {}, {}
    for axis, other, lines in (
            ("data", "space", [range(s, n, n_space) for s in range(n_space)]),
            ("space", "data", [range(d * n_space, (d + 1) * n_space)
                               for d in range(n_data)])):
        for i, line in enumerate(lines):
            members = glob(line)
            g = mesh_group if len(lines) == 1 else dist.new_group(members)
            if coords[other] == i:
                groups[axis], ranks[axis] = g, members
    if rank >= n:    # after the group calls, which every rank must make
        raise ValueError(f"rank {rank} lies outside the {n_data}x{n_space} "
                         f"mesh of the first {n} ranks")
    return Mesh(shape, coords, rank, mesh_group, groups, ranks, dev)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a whole array splits over the mesh: spec names, per leading
    dimension, the axis it is split over (None: not split). The
    counterpart of a NamedSharding with a PartitionSpec."""

    mesh: Mesh
    spec: tuple

    def shard(self, x):
        """This rank's block of the whole array x (a view)."""
        index = []
        for dim, axis in enumerate(self.spec):
            if axis is None:
                index.append(slice(None))
                continue
            n = self.mesh.shape[axis]
            if x.shape[dim] % n:
                raise ValueError(f"dimension {dim} of size {x.shape[dim]} does "
                                 f"not split over {axis}={n}")
            size = x.shape[dim] // n
            lo = self.mesh.coords[axis] * size
            index.append(slice(lo, lo + size))
        return x[tuple(index)]


def frames_sharding(mesh: Mesh) -> Sharding:
    """Sharding of a (B, H, W) frame batch: frames over data, rows over
    space."""
    return Sharding(mesh, ("data", "space", None))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def _staged(group, dev: torch.device) -> bool:
    """Whether a collective of `group` on `dev` goes through host memory:
    gloo moves CPU tensors only."""
    return dev.type == "cuda" and dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor, staged: bool) -> torch.Tensor:
    """t as the collective sends it: bool as u8 (one byte, as gloo and
    NCCL both take), contiguous, in pinned host memory when staged."""
    if t.dtype == torch.bool:
        t = t.view(torch.uint8)
    t = t.contiguous()
    if staged:
        t = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
    return t


def all_gather(mesh: Mesh, axis_name: str, t: torch.Tensor,
               dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's t along `dim` in `axis_name` order (a tiled
    all_gather); every rank's t has the same shape. Identity on a one-rank
    axis."""
    group = mesh.groups[axis_name]
    if group is None:
        return t
    staged = _staged(group, t.device)
    src = _wire(t, staged)
    parts = [torch.empty_like(src) for _ in range(mesh.shape[axis_name])]
    dist.all_gather(parts, src, group=group)
    _count("gather", axis_name, src)
    out = torch.cat(parts, dim).to(t.device, non_blocking=False)
    return out.view(torch.bool) if t.dtype == torch.bool else out


def psum(mesh: Mesh, axis_name: str, t: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of every rank's t over `axis_name` (an
    all_reduce into a new tensor; t is left as it was). Identity on a
    one-rank axis."""
    group = mesh.groups[axis_name]
    if group is None:
        return t
    staged = _staged(group, t.device)
    buf = _wire(t, staged)
    if buf.data_ptr() == t.data_ptr():
        buf = buf.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    _count("reduce", axis_name, buf)
    return buf.to(t.device)


def shift(mesh: Mesh, axis_name: str, buf: torch.Tensor,
          offset: int = 1) -> torch.Tensor:
    """One hop along `axis_name`: send buf to the rank `offset` places on,
    (i + offset) % n, and return the one received from (i - offset) % n,
    of buf's shape and type. offset=1 is the ring's hop; offset=-1 the
    reverse one, which the halo exchange takes for its bottom rows.
    Identity on a one-rank axis."""
    group, ranks = mesh.groups[axis_name], mesh.ranks[axis_name]
    n, i = len(ranks), mesh.coords[axis_name]
    if n == 1:
        return buf
    staged = _staged(group, buf.device)
    send = _wire(buf, staged)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, ranks[(i + offset) % n], group),
           dist.P2POp(dist.irecv, recv, ranks[(i - offset) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    _count("hop", axis_name, send)
    out = recv.to(buf.device) if staged else recv
    return out.view(torch.bool) if buf.dtype == torch.bool else out
