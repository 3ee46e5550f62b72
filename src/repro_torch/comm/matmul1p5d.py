"""1.5D communication-avoiding matmuls + transposes (paper Algorithm 4, S.2).

Port of ``repro.comm.matmul1p5d``, schedule for schedule: the same
collectives in the same order, the last shift of each ring included, so
the bytes each product moves equal ``core.costmodel.comm_volume``.

Two flavors of the rotation:

  * gather-flavor — the rotating operand R contributes different OUTPUT
    blocks each round (the contraction is fully local).  Used for
    S = X^T X (Cov), W = Omega S (Cov), Z = Y X (Obs).  After
    n_R/c_F rounds each team allgathers its panel (Alg. 4 line 8).

  * reduce-flavor — the rotating operand R contributes different slices of
    the CONTRACTION dim; partial products accumulate into a stationary
    output, finished with a psum over the team layer (Alg. 4 line 8).
    Used for Y = Omega X^T (Obs).

The reference's ``lax.scan`` over rounds is a Python loop here, and its
``lax.dynamic_slice`` a slice at a host index (the ring position is known
on the host).  Each round issues the shift first and multiplies while it
is in flight (the paper's overlap of MPI_Isend with dgemm).

Functions with the ``_local`` suffix take this rank's shards and its
:class:`~repro_torch.comm.group.Comm`, and return shards.  The
module-level functions take full matrices on every rank, shard them,
run the local product and gather the result to every rank
(:func:`shard` / :func:`unshard`).

Replication-aware transposes implement Lemma 3.2: with replication c, the
all-to-all neighborhood shrinks from P to P/c^2 (each replica layer
exchanges only a 1/c slice, finished by an allgather over the layer).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import matops
from .contract import CommContract
from .grid import AXES
from .group import Comm

# Layouts (see grid.py), as (dim, partitioning axes):
#   X-like     : global (r, p) col-blocked  -> SPEC_XCOL
#                global (p, r) row-blocked  -> SPEC_XROW
#   Omega-like : global (p, r) row-blocked  -> SPEC_OM
SPEC_XCOL = (1, ("i", "j"))
SPEC_XROW = (0, ("i", "j"))
SPEC_OM = (0, ("i", "k"))


def shard(a: torch.Tensor, comm: Comm, spec) -> torch.Tensor:
    """This rank's block of the full ``a`` under ``spec`` (contiguous)."""
    dim, axes = spec
    xlike = tuple(axes) == ("i", "j")
    blk = a.shape[dim] // (comm.grid.n_x if xlike else comm.grid.n_om)
    lo = (comm.block_x if xlike else comm.block_om) * blk
    return a.narrow(dim, lo, blk).contiguous()


def unshard(loc: torch.Tensor, comm: Comm, spec) -> torch.Tensor:
    """The full matrix on every rank, from each rank's block under
    ``spec`` (an all-gather over the partitioning team)."""
    dim, axes = spec
    parts = comm.all_gather(loc, axes)
    return torch.cat(list(parts), dim=dim)


# ---------------------------------------------------------------------------
# gather-flavor rotation
# ---------------------------------------------------------------------------

def rot_gather_local(r_blk, f_loc, comm: Comm, *, n_r: int,
                     canonical: str, ring: str, r_mask=None,
                     policy: matops.MatmulPolicy | None = None):
    """Rotate R around `ring`, multiplying with the fixed local block.

    ring="x":      tile = r_visit @ f_loc   (R row-block x fixed col-block)
                   team layer = "k", c_F = c_x
    ring="omega":  tile = f_loc @ r_visit   (fixed row-block x R col-block)
                   team layer = "j", c_F = c_omega

    With ``r_mask`` (the rotating operand's block-occupancy mask, ring="x"
    only — i.e. R is the Omega iterate), the mask travels around the ring
    with R and every local tile product routes through the block-sparse
    dispatch of ``core.matops``: kernel 2 on the card, on each rank's
    tiles.  The dispatch decides per tile on the host and posts no
    collective, so ranks whose tiles differ in density still issue the
    same collectives.

    Returns the stacked tile sequence (n_r, *tile.shape) reordered so index
    b holds the tile of R block b (the caller reshapes into a panel).
    """
    grid = comm.grid
    c_f = grid.c_x if ring == "x" else grid.c_omega
    layer_axis = ("k",) if ring == "x" else ("j",)
    if c_f < n_r and n_r % c_f:
        raise ValueError(f"need c_F | n_R (or c_F >= n_R): c_F={c_f}, n_R={n_r}")
    if r_mask is not None and ring != "x":
        raise ValueError("masked rotation is defined for ring='x' (the "
                         "rotating operand is the Omega iterate)")
    rounds = max(1, n_r // c_f)
    stagger = grid.stagger_perm(canonical, ring, n_r)
    shift = grid.shift_perm(ring, c_f)

    cur = comm.ppermute(r_blk.contiguous(), stagger)
    msk = None if r_mask is None else comm.ppermute(r_mask.contiguous(),
                                                    stagger)
    tiles = []
    for _ in range(rounds):
        nxt = comm.ppermute_start(cur, shift)
        nmsk = None if msk is None else comm.ppermute_start(msk, shift)
        if ring == "x":
            tiles.append(matops.matmul(cur, f_loc, mask=msk, policy=policy))
        else:
            tiles.append(f_loc @ cur)
        cur = nxt.wait()
        msk = None if nmsk is None else nmsk.wait()
    tiles = tiles[0].unsqueeze(0) if rounds == 1 else torch.stack(tiles)
    g = comm.all_gather(tiles, layer_axis)              # (c_f, rounds, ...)
    seq = g.transpose(0, 1).reshape((rounds * c_f,) + tuple(tiles.shape[1:]))
    team = comm.block_x if ring == "x" else comm.block_om
    # sequence position m holds the tile of block (team*c_f + m) mod n_r;
    # when c_f > n_r team members hold duplicates — the mod-take dedupes.
    idx = np.mod(np.arange(n_r) - team * c_f, n_r)
    if seq.shape[0] == n_r and np.array_equal(idx, np.arange(n_r)):
        return seq
    return seq[torch.as_tensor(idx, device=seq.device)]


def xtx_local(x_loc, comm: Comm, *, scale=1.0):
    """S = scale * X^T X from the local X col-block (n, blk_x).  Cov line 2."""
    xt_loc = x_loc.T  # canonical X-like row-block of X^T
    seq = rot_gather_local(xt_loc, x_loc, comm, n_r=comm.grid.n_x,
                           canonical="xlike", ring="x")
    blk = x_loc.shape[1]
    return seq.reshape(comm.grid.n_x * blk, blk) * scale  # S col-panel


def omega_s_local(omega_rows, s_panel, comm: Comm, *, canonical="omegalike"):
    """W = Omega @ S.  omega_rows: R row-block; s_panel: fixed (p, blk_x).

    canonical="omegalike" for the standalone op (Omega in its canonical
    layout, n_om blocks); the Cov driver stores Omega X-like-transposed
    (c_omega == c_x) and passes canonical="xlike"."""
    grid = comm.grid
    n_r = grid.n_om if canonical == "omegalike" else grid.n_x
    seq = rot_gather_local(omega_rows, s_panel, comm, n_r=n_r,
                           canonical=canonical, ring="x")
    blk_r, blk_c = omega_rows.shape[0], s_panel.shape[1]
    return seq.reshape(n_r * blk_r, blk_c)              # W col-panel (p, blk_x)


def y_x_local(y_rows, x_loc, comm: Comm, *, scale=1.0):
    """Z = scale * Y @ X.  y_rows: fixed Omega-like (blk_om, n);
    x_loc: rotating X col-block (n, blk_x).  Obs line 4."""
    seq = rot_gather_local(x_loc, y_rows, comm, n_r=comm.grid.n_x,
                           canonical="xlike", ring="omega")
    # seq: (n_x, blk_om, blk_x) with block v at index v -> concat on cols
    blk_om = y_rows.shape[0]
    z = seq.permute(1, 0, 2).reshape(blk_om, -1)
    return z * scale                                    # Z row-block (blk_om, p)


# ---------------------------------------------------------------------------
# reduce-flavor rotation
# ---------------------------------------------------------------------------

def omega_xt_local(omega_rows, xt_loc, comm: Comm, *, scale=1.0,
                   omega_mask=None,
                   policy: matops.MatmulPolicy | None = None):
    """Y = scale * Omega @ X^T.  omega_rows: fixed Omega-like (blk_om, p);
    xt_loc: rotating X^T row-block (blk_x, n).  Obs lines 2/10.

    With ``omega_mask`` (the fixed operand's (blk_om/bs, p/bs) occupancy),
    each round gates the contracted Omega column-slice with the matching
    mask column-slice through the ``core.matops`` dispatch (requires the
    policy block size to divide blk_x)."""
    if omega_mask is not None and policy is None:
        raise ValueError("omega_mask requires a matops policy (they are "
                         "only meaningful together)")
    grid = comm.grid
    n_x, c_om = grid.n_x, grid.c_omega
    blk_om, p = omega_rows.shape
    blk_x, n = xt_loc.shape
    mcols_blk = None if omega_mask is None else blk_x // policy.block_size
    rounds = n_x // c_om
    stagger = grid.stagger_perm("xlike", "omega", n_x)
    shift = grid.shift_perm("omega", c_om)

    cur = comm.ppermute(xt_loc.contiguous(), stagger)
    v = comm.ring_pos_om % n_x
    acc = torch.zeros((blk_om, n), dtype=torch.result_type(omega_rows, xt_loc),
                      device=omega_rows.device)
    for _ in range(rounds):
        nxt = comm.ppermute_start(cur, shift)
        cols = omega_rows[:, v * blk_x:(v + 1) * blk_x]
        if omega_mask is None:
            acc = acc + cols @ cur
        else:
            mcols = omega_mask[:, v * mcols_blk:(v + 1) * mcols_blk]
            acc = acc + matops.matmul(cols, cur, mask=mcols, policy=policy)
        v = (v + c_om) % n_x
        cur = nxt.wait()
    y = comm.psum(acc, ("j",))                          # finish team reduce
    return y * scale                                    # Y row-block (blk_om, n)


# ---------------------------------------------------------------------------
# replication-aware distributed transposes (Lemma 3.2)
# ---------------------------------------------------------------------------

def transpose_xlike_local(w_panel, comm: Comm):
    """(p, blk_x) col-panel of W  ->  (p, blk_x) col-panel of W^T.

    Each replica layer k exchanges only its 1/c_x row-slice (Lemma 3.2),
    finished by an allgather over "k"."""
    n_x, c_x = comm.grid.n_x, comm.grid.c_x
    p, blk = w_panel.shape
    sub = blk // c_x
    w3 = w_panel.reshape(n_x, blk, blk)
    mine = w3[:, comm.k * sub:(comm.k + 1) * sub]               # (n_x, sub, blk)
    rcv = comm.all_to_all(mine, ("i", "j"), 0, 0)               # (n_x, sub, blk)
    rows = rcv.permute(1, 0, 2).reshape(sub, p)                 # W[t-rows k-slice, :]
    g = comm.all_gather(rows.T, ("k",))                         # (c_x, p, sub)
    return g.permute(1, 0, 2).reshape(p, blk)


def transpose_omegalike_local(z_rows, comm: Comm):
    """(blk_om, p) row-block of Z  ->  (blk_om, p) row-block of Z^T."""
    n_om, c_om = comm.grid.n_om, comm.grid.c_omega
    blk, p = z_rows.shape
    sub = blk // c_om
    z3 = z_rows.reshape(blk, n_om, blk)
    mine = z3[comm.j * sub:(comm.j + 1) * sub]                  # (sub, n_om, blk)
    rcv = comm.all_to_all(mine, ("i", "k"), 1, 1)               # (sub, n_om, blk)
    part = rcv.permute(2, 1, 0)                                 # (blk, n_om, sub)
    g = comm.all_gather(part, ("j",))                           # (c_om, blk, n_om, sub)
    return g.permute(1, 2, 0, 3).reshape(blk, p)


# ---------------------------------------------------------------------------
# standalone wrappers: full matrices in and out on every rank
# ---------------------------------------------------------------------------

def xtx(x, comm: Comm, *, scale=1.0):
    """S = scale * X^T X.  x: (n, p) -> S: (p, p)."""
    s = xtx_local(shard(x, comm, SPEC_XCOL), comm, scale=scale)
    return unshard(s, comm, SPEC_XCOL)


def omega_s(omega, s, comm: Comm):
    """W = Omega @ S.  omega: (p, p) Omega-like; s: (p, p) X-like col."""
    w = omega_s_local(shard(omega, comm, SPEC_OM),
                      shard(s, comm, SPEC_XCOL), comm, canonical="omegalike")
    return unshard(w, comm, SPEC_XCOL)


def omega_xt(omega, x, comm: Comm, *, scale=1.0):
    """Y = scale * Omega @ X^T.  omega: (p, p) Omega-like; x: (n, p)."""
    y = omega_xt_local(shard(omega, comm, SPEC_OM),
                       shard(x, comm, SPEC_XCOL).T, comm, scale=scale)
    return unshard(y, comm, SPEC_OM)


def y_x(y, x, comm: Comm, *, scale=1.0):
    """Z = scale * Y @ X.  y: (p, n) Omega-like rows; x: (n, p)."""
    z = y_x_local(shard(y, comm, SPEC_OM), shard(x, comm, SPEC_XCOL), comm,
                  scale=scale)
    return unshard(z, comm, SPEC_OM)


def transpose_xlike(w, comm: Comm):
    wt = transpose_xlike_local(shard(w, comm, SPEC_XCOL), comm)
    return unshard(wt, comm, SPEC_XCOL)


def transpose_omegalike(z, comm: Comm):
    zt = transpose_omegalike_local(shard(z, comm, SPEC_OM), comm)
    return unshard(zt, comm, SPEC_OM)


# ---------------------------------------------------------------------------
# declared collective schedules
# ---------------------------------------------------------------------------
# Every ring product above DECLARES its schedule: which axes it may bind,
# which collective kinds it may post, how many rotation rounds its ring
# runs, what may travel the wire, and — exactly — how many bytes one
# invocation moves (core.costmodel.comm_volume, the analytic side of the
# paper's W term).  The tests hold the bytes the wrappers announce while a
# product runs equal to ``volume``.

def _contract(entry, flavor, *, kinds, masked=False, block_size=None,
              canonical=None):
    from ..core.costmodel import comm_volume

    def vol(**kw):
        return comm_volume(flavor=flavor, masked=masked,
                           block_size=block_size, canonical=canonical, **kw)

    return CommContract(
        entry=entry, axes=AXES, kinds=kinds,
        rounds=lambda **kw: vol(**kw).rounds,
        wire=("operand", "mask") if masked else ("operand",),
        volume=lambda **kw: vol(**kw).total,
        volume_class=("ring+allgather" if flavor != "omega_xt"
                      else "ring+psum") + (" masked" if masked else ""))


COMM_CONTRACT = {
    "xtx_local": _contract(
        "comm.matmul1p5d.xtx_local", "xtx",
        kinds=("ppermute", "all_gather")),
    "omega_s_local": _contract(
        "comm.matmul1p5d.omega_s_local", "omega_s",
        kinds=("ppermute", "all_gather")),
    "y_x_local": _contract(
        "comm.matmul1p5d.y_x_local", "y_x",
        kinds=("ppermute", "all_gather")),
    "omega_xt_local": _contract(
        "comm.matmul1p5d.omega_xt_local", "omega_xt",
        kinds=("ppermute", "psum")),
}


# ---------------------------------------------------------------------------
# analysis manifest (repro_torch.analysis.dispatchpass)
# ---------------------------------------------------------------------------
# The ring products on a one-process (1, 1, 1) grid: one round, the
# team collectives the identity; the local products and the schedule's
# bookkeeping run as they do on every rank.

_TRACE_P, _TRACE_N = 8, 6


def _one_process(device):
    from .grid import Grid1p5D
    from .group import comm_for
    return comm_for(Grid1p5D(1, 1, 1), torch.device(device))


def _f64(device, *shape, lo=0.0, hi=1.0):
    n = int(np.prod(shape))
    return torch.linspace(lo, hi, n, dtype=torch.float64,
                          device=device).reshape(shape)


def _entry_xtx(device):
    return {"fn": xtx_local, "args": (_f64(device, _TRACE_N, _TRACE_P, lo=-1),
                                      _one_process(device))}


def _entry_omega_s(device):
    return {"fn": omega_s_local,
            "args": (_f64(device, _TRACE_P, _TRACE_P),
                     _f64(device, _TRACE_P, _TRACE_P),
                     _one_process(device)),
            "kwargs": {"canonical": "omegalike"}}


def _entry_y_x(device):
    return {"fn": y_x_local,
            "args": (_f64(device, _TRACE_P, _TRACE_N),
                     _f64(device, _TRACE_N, _TRACE_P),
                     _one_process(device))}


def _entry_omega_xt(device):
    return {"fn": omega_xt_local,
            "args": (_f64(device, _TRACE_P, _TRACE_P),
                     _f64(device, _TRACE_P, _TRACE_N),
                     _one_process(device))}


_PATH = "src/repro_torch/comm/matmul1p5d.py"
ANALYSIS_ENTRIES = [
    {"name": "comm.matmul1p5d.xtx_ring", "path": _PATH,
     "build": _entry_xtx},
    {"name": "comm.matmul1p5d.omega_s_ring", "path": _PATH,
     "build": _entry_omega_s},
    {"name": "comm.matmul1p5d.y_x_ring", "path": _PATH,
     "build": _entry_y_x},
    {"name": "comm.matmul1p5d.omega_xt_ring", "path": _PATH,
     "build": _entry_omega_xt},
]
