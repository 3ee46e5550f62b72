"""Process groups and collectives of the 1.5D grid on ``torch.distributed``.

The counterpart of the reference's ``comm/compat.py`` collective wrappers
and ``launch/mesh.py``.  Where the reference runs one ``shard_map``
program over a device mesh and names collectives by mesh axis, the port
runs one process per grid position (rank = the x-major flat index of
``comm.grid``) and keeps, per grid, one ``torch.distributed`` group per
axis team:

  ("k",)            the X-team of a block: the x ring's gather layer
  ("j",)            the Omega-team of a block: the omega ring's gather
                    layer and the reduce flavor's finishing psum
  ("i", "j")        one replica layer of the X-like blocks: the Cov
                    driver's psum / pmin and ``transpose_xlike``
  ("i", "k")        one replica layer of the Omega-like blocks: the Obs
                    driver's psum / pmin and ``transpose_omegalike``
  ("i", "j", "k")   every process: the ring permutations

``Comm`` wraps them with the reference's semantics: ``ppermute`` over a
table of (source, destination) ranks, ``all_gather`` stacking the team's
shards in team order, ``psum`` / ``pmin``, and the tiled ``all_to_all``.

Set-up (:func:`init_process_group`): a CUDA device means NCCL and
``device="cpu"`` means gloo, chosen by the caller, never as a fallback;
``backend="gloo"`` with a CUDA device puts several ranks on one card
(NCCL refuses two ranks of one communicator on one device).  Gloo
takes CUDA tensors only for ``all_reduce`` (PyTorch's backend table:
gloo's GPU column has ``broadcast`` and ``all_reduce``); every other
gloo collective on a CUDA tensor copies the payload to the host and
back, and ``Comm.host_copies`` counts each copy.  NCCL never does.

Without a process group, a grid of one process runs with every team of
size one and every collective the identity: the reference's one-device
mesh.

Every wrapper announces ``(prim, axes, wire bytes)`` to the watcher set
with :func:`set_collective_watcher` (the reference's
``set_collective_watcher`` hook), counted by
``core.costmodel.collective_wire_bytes``'s conventions, so a caller can
hold the bytes of a product equal to ``core.costmodel.comm_volume``.
"""
from __future__ import annotations

import datetime
import math
import os
from collections import Counter
from typing import Callable

import torch
import torch.distributed as dist

from ..core.costmodel import collective_wire_bytes
from ..device import resolve_device
from .grid import AXES, Grid1p5D

#: the axis teams a grid builds, in the order every rank creates them
TEAM_AXES = (("k",), ("j",), ("i", "j"), ("i", "k"), AXES)

#: gloo collectives that take CUDA tensors; the others stage on the host
GLOO_CUDA_NATIVE = frozenset({"all_reduce"})

_WATCHER: Callable | None = None

#: one Comm per (grid, device) of the current process group
_COMMS: dict = {}


def set_collective_watcher(watcher: Callable | None) -> Callable | None:
    """Install ``watcher(prim, axes, nbytes)`` (or None) on every wrapper
    of :class:`Comm`; returns the previous watcher so callers can restore
    it.  ``nbytes`` is the exact per-process wire count (a Fraction)."""
    global _WATCHER
    prev = _WATCHER
    _WATCHER = watcher
    return prev


def init_process_group(device=None, *, backend: str | None = None,
                       world_size: int | None = None,
                       rank: int | None = None,
                       init_method: str | None = None,
                       timeout: datetime.timedelta | None = None
                       ) -> torch.device:
    """Join the process group and return this rank's device.

    ``device=None`` is the CUDA card (raising without one, as every entry
    point of the port does); a bare ``"cuda"`` becomes ``cuda:LOCAL_RANK``.
    The backend is NCCL on a CUDA device and gloo on the CPU unless
    ``backend`` names one.  World size, rank and the rendezvous come from
    the arguments, else from torchrun's environment (``WORLD_SIZE``,
    ``RANK``, ``env://``).  ``timeout`` bounds each collective's wait
    (PyTorch's default when None)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kw)
    return dev


def destroy_process_group() -> None:
    """Leave the process group and forget its teams."""
    _COMMS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """Processes in the current group; 1 outside one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def comm_for(grid: Grid1p5D, device) -> "Comm":
    """The :class:`Comm` of ``grid`` on this rank, built once per process
    group (building one is collective: every rank asks for the same grids
    in the same order)."""
    device = torch.device(device)
    key = (grid, str(device), dist.is_initialized())
    comm = _COMMS.get(key)
    if comm is None:
        comm = _COMMS[key] = Comm(grid, device)
    return comm


class _Pending:
    """An issued ``ppermute``: ``wait()`` returns the received tensor
    (copied to ``device`` first when it was received on the host)."""

    def __init__(self, out, works=(), comm=None, device=None):
        self._out, self._works = out, works
        self._comm, self._device = comm, device

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        if self._device is not None:
            return self._comm._to_device(self._out)
        return self._out


class Comm:
    """This rank's position in a :class:`Grid1p5D` and the process teams
    of its axes, with the collectives the 1.5D products post."""

    def __init__(self, grid: Grid1p5D, device):
        self.grid = grid
        self.device = torch.device(device)
        if dist.is_initialized():
            if dist.get_world_size() != grid.n_devices:
                raise ValueError(
                    f"grid of {grid.n_devices} processes in a process "
                    f"group of {dist.get_world_size()}")
            self.rank = dist.get_rank()
            self.backend = dist.get_backend()
        else:
            if grid.n_devices != 1:
                raise ValueError(
                    f"a grid of {grid.n_devices} processes needs a process "
                    f"group: start under torchrun or call "
                    f"comm.group.init_process_group first")
            self.rank, self.backend = 0, None
        self.i, self.j, self.k = grid.flat_to_coords(self.rank)
        #: X-like block of this rank (t = i*c_omega + j)
        self.block_x = self.i * grid.c_omega + self.j
        #: Omega-like block of this rank (u = i*c_x + k)
        self.block_om = self.i * grid.c_x + self.k
        #: position on the omega-major ring
        self.ring_pos_om = self.block_om * grid.c_omega + self.j
        #: host copies made by gloo collectives on CUDA tensors
        self.host_copies = 0
        #: collectives issued on the backend, by primitive
        self.calls: Counter = Counter()
        self._teams = {axes: self._team(axes) for axes in TEAM_AXES}
        if self.backend is not None:
            # every rank has joined every team; a first collective on
            # the whole group before any point-to-point traffic
            self.psum(torch.zeros(1, device=self.device), AXES)

    def _team(self, axes):
        """(group, member ranks in team order) of this rank's team over
        ``axes``; creates every team of ``axes`` (``new_group`` is
        collective)."""
        g = self.grid
        sizes = dict(zip(AXES, g.mesh_shape()))
        mine, group = None, None
        teams: dict = {}
        for f in range(g.n_devices):
            coords = dict(zip(AXES, g.flat_to_coords(f)))
            key = tuple(coords[a] for a in AXES if a not in axes)
            teams.setdefault(key, []).append(f)
        for members in teams.values():
            if len(members) != math.prod(sizes[a] for a in axes):
                raise AssertionError("team sizes do not tile the grid")
            if self.backend is None:
                pg = None
            elif len(members) == g.n_devices:
                pg = dist.group.WORLD
            else:
                pg = dist.new_group(members)
            if self.rank in members:
                mine, group = members, pg
        if group is not None and \
                dist.get_group_rank(group, self.rank) != mine.index(self.rank):
            raise AssertionError("group ranks are not in team order")
        return group, mine

    # -- bookkeeping ---------------------------------------------------

    def _announce(self, prim, axes, x, extent, moves=True):
        if _WATCHER is not None:
            nbytes = x.numel() * x.element_size()
            _WATCHER(prim, tuple(axes), collective_wire_bytes(
                prim, nbytes, extent, moves=moves))

    def _stage(self, op: str) -> bool:
        """True when ``op`` must go through a host copy (gloo + CUDA)."""
        return (self.backend == "gloo" and self.device.type == "cuda"
                and op not in GLOO_CUDA_NATIVE)

    def _to_host(self, x):
        self.host_copies += 1
        return x.cpu()

    def _to_device(self, x):
        self.host_copies += 1
        return x.to(self.device)

    # -- collectives ---------------------------------------------------

    def ppermute_start(self, x: torch.Tensor, perm) -> _Pending:
        """Issue ``lax.ppermute(x, AXES, perm)``: rank ``src`` sends to
        ``dst`` for every (src, dst) pair, all in one batch.  A rank whose
        pair is (r, r) gets its own tensor back: no bytes move, and the
        ring never writes into its operands."""
        moves = any(s != d for s, d in perm)
        self._announce("ppermute", AXES, x, self.grid.n_devices, moves)
        dst = dict(perm)[self.rank]
        src = {d: s for s, d in perm}[self.rank]
        if dst == self.rank:
            return _Pending(x)
        stage = self._stage("p2p")
        x = x.contiguous()
        if stage:
            x = self._to_host(x)
        out = torch.empty_like(x)
        self.calls["ppermute"] += 1
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst),
                                        dist.P2POp(dist.irecv, out, src)])
        return _Pending(out, works, self, self.device if stage else None)

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        return self.ppermute_start(x, perm).wait()

    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """(E, *x.shape): the team's shards stacked in team order."""
        group, members = self._teams[tuple(axes)]
        self._announce("all_gather", axes, x, len(members))
        if self.backend is None:
            return x.unsqueeze(0)
        self.calls["all_gather"] += 1
        x = x.contiguous()
        if self.backend == "nccl":
            out = torch.empty((len(members),) + tuple(x.shape),
                              dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x, group=group)
            return out
        stage = self._stage("all_gather")
        if stage:
            x = self._to_host(x)
        parts = [torch.empty_like(x) for _ in members]
        dist.all_gather(parts, x, group=group)
        out = torch.stack(parts)
        return self._to_device(out) if stage else out

    def _all_reduce(self, x, axes, prim, op):
        group, members = self._teams[tuple(axes)]
        self._announce(prim, axes, x, len(members))
        if self.backend is None:
            return x
        self.calls[prim] += 1
        out = x.clone(memory_format=torch.contiguous_format)
        stage = self._stage("all_reduce")
        if stage:
            out = self._to_host(out)
        dist.all_reduce(out, op=op, group=group)
        return self._to_device(out) if stage else out

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self._all_reduce(x, axes, "psum", dist.ReduceOp.SUM)

    def pmin(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self._all_reduce(x, axes, "pmin", dist.ReduceOp.MIN)

    def all_to_all(self, x: torch.Tensor, axes, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """``lax.all_to_all(..., tiled=True)``: ``x`` split into E chunks
        along ``split_axis``, chunk e sent to team member e, the chunks
        received concatenated along ``concat_axis`` in team order."""
        group, members = self._teams[tuple(axes)]
        e = len(members)
        self._announce("all_to_all", axes, x, e)
        if self.backend is None:
            return x
        self.calls["all_to_all"] += 1
        xs = x.movedim(split_axis, 0)
        xs = xs.reshape((e, xs.shape[0] // e) + tuple(xs.shape[1:]))
        xs = xs.contiguous()
        stage = self._stage("all_to_all")
        if stage:
            xs = self._to_host(xs)
        out = torch.empty_like(xs)
        dist.all_to_all_single(out, xs, group=group)
        if stage:
            out = self._to_device(out)
        return torch.cat([out[m].movedim(0, split_axis) for m in range(e)],
                         dim=concat_axis)
