"""Meshes of ranks on ``torch.distributed``.

Port of ``repro.launch.mesh``.  Where the reference lays a JAX device
mesh over the chips of a pod, the port lays a :class:`Mesh` over the
ranks of the process group, one rank per device: the world's ranks map
x-major onto the mesh shape (rank = the row-major flat index of the
rank's coordinates), and the mesh keeps one process group per team of
every non-empty tuple of its axes (``("data",)``, ``("model",)``, the
batch's ``("pod", "data")``, ...), in mesh-axis order.  Its collectives
are ``comm.group.Teams``'s, announced to the collective watcher.

The process group comes from ``comm.group.init_process_group``: NCCL on
a CUDA device, gloo when the caller asks for it (``device="cpu"``, or
several ranks on one card).  A one-process world is the (1, 1) mesh,
with every team of one member and every collective the identity, as in
``comm.group``'s one-process grid.

A mesh also places tensors: :meth:`Mesh.shard` keeps this rank's block
of a whole tensor under a spec (``models.config``: one entry per
dimension, None, an axis name or a tuple of names), and
:meth:`Mesh.gather` assembles the whole tensor from every rank's block.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.distributed as dist

from ..comm import group as comm_group
from ..comm.group import Teams
from ..device import resolve_device
from ..models.config import spec_axes

#: the reference's production meshes: one pod of 16 x 16 chips, and two
POD_SHAPE, POD_AXES = (16, 16), ("data", "model")
MULTIPOD_SHAPE, MULTIPOD_AXES = (2, 16, 16), ("pod", "data", "model")


class Mesh(Teams):
    """This rank's place on a mesh of ranks: ``axis_names``, ``shape``
    (axis name to size, in axis order, as the reference's
    ``mesh.shape``), ``coords`` (axis name to this rank's coordinate)
    and a process team per tuple of axes."""

    def __init__(self, shape, axes, device):
        shape, axes = tuple(int(n) for n in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} do not "
                             f"pair up")
        size = math.prod(shape)
        if dist.is_initialized():
            world, rank = dist.get_world_size(), dist.get_rank()
            backend = dist.get_backend()
        else:
            world, rank, backend = 1, 0, None
        if size != world:
            raise ValueError(
                f"a mesh of shape {dict(zip(axes, shape))} needs {size} "
                f"ranks; the world has {world}"
                + ("" if dist.is_initialized() else
                   " (no process group: start under torchrun or call "
                   "comm.group.init_process_group first)"))
        super().__init__(device, rank, backend)
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.coords = dict(zip(axes, self._coords_of(rank)))
        for k in range(1, len(axes) + 1):
            for team_axes in itertools.combinations(axes, k):
                self._teams[team_axes] = self._team(team_axes)
        if self.backend is not None and world > 1:
            # every rank has joined every team before any traffic
            self.psum(torch.zeros(1, device=self.device), self.axis_names)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def _coords_of(self, rank: int) -> tuple[int, ...]:
        """The coordinates of global rank ``rank`` (x-major)."""
        out = []
        for n in reversed(tuple(self.shape.values())):
            out.append(rank % n)
            rank //= n
        return tuple(reversed(out))

    def _team(self, axes):
        """(group, member ranks in team order): the ranks that share this
        rank's coordinates off ``axes``, ordered x-major over ``axes``;
        creates the group of every team over ``axes`` (``new_group`` is
        collective).  A one-member team has no group."""
        teams: dict = {}
        for r in range(self.size):
            c = dict(zip(self.axis_names, self._coords_of(r)))
            key = tuple(c[a] for a in self.axis_names if a not in axes)
            teams.setdefault(key, []).append(r)
        mine, group = None, None
        for members in teams.values():
            if self.backend is None or len(members) == 1:
                pg = None
            elif len(members) == self.size:
                pg = dist.group.WORLD
            else:
                pg = comm_group.new_group(members)
            if self.rank in members:
                mine, group = members, pg
        return group, mine

    def key(self, axes) -> tuple[str, ...]:
        """``axes`` as a team key: the mesh's own order."""
        axes = set(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def axes_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def axes_index(self, axes) -> int:
        """This rank's x-major index over ``axes`` (its team position)."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    # -- placing tensors -----------------------------------------------

    def shard(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of the whole tensor ``t`` under ``spec``, as
        a copy (the whole tensor can be freed)."""
        out = t
        for dim, entry in enumerate(spec):
            axes = spec_axes(entry)
            if not axes:
                continue
            n = self.axes_size(axes)
            if out.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                                 f"split under {spec} on {self.shape}")
            out = out.chunk(n, dim=dim)[self.axes_index(axes)]
        return out.clone(memory_format=torch.contiguous_format)

    def gather(self, t: torch.Tensor, spec) -> torch.Tensor:
        """The whole tensor from every rank's block ``t`` under
        ``spec``: an all-gather over each sharded dimension's axes."""
        out = t
        for dim, entry in enumerate(spec):
            axes = spec_axes(entry)
            if not axes or self.axes_size(axes) == 1:
                continue
            if axes != self.key(axes):
                raise ValueError(f"spec entry {entry} lists axes out of the "
                                 f"mesh's order {self.axis_names}")
            out = torch.cat(list(self.all_gather(out, axes).unbind(0)),
                            dim=dim)
        return out

    def owns(self, spec) -> bool:
        """Whether this rank holds the copy of its block that counts: a
        block replicated along an axis the spec does not use is counted
        at that axis's coordinate 0 only."""
        used = {a for entry in spec for a in spec_axes(entry)}
        return all(self.coords[a] == 0 for a in self.axis_names
                   if a not in used)

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (one all-reduce)."""
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        return bool(self.psum(t, self.axis_names).item() > 0)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.backend or 'one process'})")


def make_mesh(shape, axes, *, device=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` on this process group's ranks
    (tests / examples); the world must have ``prod(shape)`` ranks."""
    return Mesh(shape, axes, resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production meshes: one pod (16, 16) over ("data",
    "model"), or two (2, 16, 16) over ("pod", "data", "model").  Raises
    unless the world has 256 (512) ranks."""
    shape, axes = ((MULTIPOD_SHAPE, MULTIPOD_AXES) if multi_pod
                   else (POD_SHAPE, POD_AXES))
    return make_mesh(shape, axes, device=device)


def make_host_mesh(*, max_devices: int | None = None, device=None) -> Mesh:
    """A (data, model) mesh over the world's ranks, factored as the
    reference factors its devices: ``model`` the largest of 8, 4, 2, 1
    dividing the rank count.  ``max_devices`` caps the count, as the
    reference's does; the port's mesh spans the whole world, so a cap
    below the world size raises."""
    n = comm_group.world_size()
    if max_devices and max_devices < n:
        raise ValueError(f"max_devices={max_devices} would leave ranks of "
                         f"a world of {n} off the mesh")
    model = next(m for m in (8, 4, 2, 1) if n % m == 0)
    return make_mesh((n // model, model), ("data", "model"), device=device)
