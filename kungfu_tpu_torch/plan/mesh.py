"""The rank mesh: named parallelism axes over the process group
(counterpart of kungfu_tpu/plan/mesh.py).

The JAX package arranges devices into a `jax.sharding.Mesh` and lets XLA
insert the collectives of each axis.  Here every rank is one process, so
the mesh says where this rank sits and which ranks it talks to on each
axis:

  shape   the axis sizes, in AXIS_ORDER (dp outer, then fsdp, pp, sp, ep,
          tp inner: a tp group is consecutive ranks)
  coords  this rank's index on each axis
  groups  one torch.distributed group per axis, holding the ranks that
          differ from this one only on that axis (`distributed.sub_group`);
          `group(("dp", "sp"))` is the group of the ranks that differ only
          on those axes, made on first use (collective)

Every axis of the JAX package is accepted: the data axes (dp, and fsdp:
`fsdp.FSDPTrainer` shards the model over it), the sequence axis (sp), and
the model axes tensor (tp), expert (ep) and pipeline (pp) parallelism,
which `trainer.MeshTrainer` and the models split by the rules table of
`parallel/sharding.py`.  `make_hierarchical_mesh`
makes the ("dcn", "ici") mesh of the Session's hierarchical strategies.
The JAX module's `data_sharding` and `replicated` name jax shardings and
have no counterpart: a rank holds its own rows.
Without a process group the world is this process, and every group is
None (a world of one).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch.distributed as dist

# Canonical axis order, outermost first, as in the JAX package.
AXIS_ORDER = ("dp", "fsdp", "pp", "sp", "ep", "tp")
DATA_AXES = ("dp", "fsdp")  # gradient reduction axes


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named axis sizes; -1 for one auto axis (filled from the world size)."""

    axes: Tuple[Tuple[str, int], ...]

    @classmethod
    def make(cls, **sizes: int) -> "MeshSpec":
        unknown = [k for k in sizes if k not in AXIS_ORDER]
        if unknown:
            raise ValueError(f"unknown axes {unknown}; valid: {AXIS_ORDER}")
        ordered = tuple((a, sizes[a]) for a in AXIS_ORDER if a in sizes)
        if sum(1 for _, v in ordered if v == -1) > 1:
            raise ValueError("at most one -1 axis")
        return cls(axes=ordered)

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = dict(self.axes)
        known = math.prod(v for v in sizes.values() if v != -1)
        for a, v in sizes.items():
            if v == -1:
                if n_devices % known:
                    raise ValueError(f"{n_devices} devices not divisible by {known}")
                sizes[a] = n_devices // known
        total = math.prod(sizes.values())
        if total != n_devices:
            raise ValueError(f"mesh {sizes} != {n_devices} devices")
        return sizes


class Mesh:
    """This rank's place in a layout of the world's ranks over named axes."""

    def __init__(self, shape: Dict[str, int], rank: int, groups: Dict[str, Any]):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.rank = rank
        self.coords = coords(rank, self.shape)
        self.groups = groups
        self._multi: Dict[Tuple[str, ...], Any] = {}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coord(self, axis: str) -> int:
        """This rank's index on `axis` (0 on an axis the mesh lacks)."""
        return self.coords.get(axis, 0)

    def group(self, axis):
        """The process group of `axis` that holds this rank; for a tuple of
        axes, the group of the ranks whose coordinates differ from this
        rank's only on those axes (a group of this rank alone for none of
        them).  None only without a process group (a world of one).  A
        tuple's group is made on its first call, which every rank makes at
        the same point (collective)."""
        if isinstance(axis, str):
            return self.groups[axis]
        axes = tuple(a for a in self.axis_names if a in axis)
        if len(axes) == 1:
            return self.groups[axes[0]]
        if axes not in self._multi:
            if self.size == 1 or not dist.is_initialized():
                self._multi[axes] = None
            else:
                from ..distributed import sub_group

                self._multi[axes] = sub_group(axis_partition(self.shape, axes))
        return self._multi[axes]

    def index(self, axes) -> int:
        """This rank's row-major index within its group over `axes`."""
        i = 0
        for a in self.axis_names:
            if a in axes:
                i = i * self.shape[a] + self.coords[a]
        return i


def coords(rank: int, shape: Dict[str, int]) -> Dict[str, int]:
    """Row-major coordinates of `rank` over the axes of `shape`, in order."""
    out = {}
    for axis in reversed(tuple(shape)):
        rank, out[axis] = divmod(rank, shape[axis])
    return {a: out[a] for a in shape}


def axis_partition(shape: Dict[str, int], axis):
    """The ranks of every group of `axis` (a name, or a tuple of names):
    lists of the ranks whose coordinates differ only on those axes, in
    rank order."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    groups: Dict[Tuple[int, ...], list] = {}
    for r in range(math.prod(shape.values())):
        c = coords(r, shape)
        groups.setdefault(tuple(v for a, v in c.items() if a not in axes), []).append(r)
    return list(groups.values())


def make_mesh(spec: Optional[MeshSpec] = None, **sizes: int) -> Mesh:
    """The mesh over every rank of the process group (this process alone
    without one).  `make_mesh(dp=-1)` is pure data parallelism;
    `make_mesh(fsdp=4)` one model sharded over four ranks;
    `make_mesh(dp=1, sp=4)` one sequence over four ranks;
    `make_mesh(dp=2, tp=2)` each data shard on a pair of tensor-parallel
    ranks.  Collective: every rank makes the same mesh, in the same
    order."""
    if spec is None:
        spec = MeshSpec.make(**(sizes or {"dp": -1}))
    world = dist.get_world_size() if dist.is_initialized() else 1
    return _mesh(spec.resolve(world))


def make_hierarchical_mesh(n_hosts: int) -> Mesh:
    """The ("dcn", "ici") mesh: the outer axis across hosts, the inner one
    within a host, rank r at (r // per_host, r % per_host), so the ranks of
    each host must be consecutive, as the launcher numbers them.  The
    analog of the reference's hierarchical all-reduce split (local reduce,
    cross-host all-reduce, local broadcast; srcs/cpp/src/nccl/controller.cpp:
    8-40): collectives over "ici" stay on a host, those over "dcn" cross
    hosts.  Collective, as `make_mesh`."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_hosts < 1 or world % n_hosts:
        raise ValueError(f"{world} ranks not divisible by {n_hosts} hosts")
    return _mesh({"dcn": n_hosts, "ici": world // n_hosts})


def _mesh(shape: Dict[str, int]) -> Mesh:
    """This rank's Mesh of `shape` (covering every rank), with a group an axis."""
    from ..distributed import sub_group

    if math.prod(shape.values()) == 1:
        return Mesh(shape, 0, dict.fromkeys(shape))
    return Mesh(shape, dist.get_rank(),
                {axis: sub_group(axis_partition(shape, axis)) for axis in shape})


def mesh_digest(mesh: Mesh) -> str:
    """Stable digest of the mesh's shape and ranks, for membership consensus
    (the JAX package digests its shape and device ids)."""
    import hashlib

    desc = f"{dict(mesh.shape)}|{','.join(map(str, range(mesh.size)))}"
    return hashlib.sha256(desc.encode()).hexdigest()[:16]
