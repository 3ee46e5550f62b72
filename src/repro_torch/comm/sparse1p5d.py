"""Sparsity-aware 1.5D Omega-side products (the distributed half of the
matops layer).

Port of ``repro.comm.sparse1p5d``: the masked entry points for the two
Omega-side products of ``comm.matmul1p5d`` — W = Omega S (Cov, gather
flavor) and Y = Omega X^T (Obs, reduce flavor).  The ring schedules live
in ``matmul1p5d`` itself (one implementation, optionally masked); this
module only packages the Omega-iterate + occupancy-mask calling
convention the solver drivers use:

  * gather flavor (Cov): the Omega row-block ROTATES around the x-ring, so
    its mask rotates with it (the same stagger/shift permutations applied
    to both).  Each round's local product routes through
    :func:`repro_torch.core.matops.matmul` with the visiting block's mask:
    kernel 2 on the card, on every rank's tiles.
  * reduce flavor (Obs): Omega is the FIXED operand; each round contracts
    a column-slice of it, gated by the matching block-column slice of the
    fixed mask, which never leaves the rank.

The mask is tiny — (rows/bs, cols/bs) entries of ``core.matops.MASK_DTYPE``
(int8, one byte per block whatever the operand dtype) — so rotating it
adds a negligible fraction of the Omega traffic.  Both paths are exact:
the dispatch takes the block-sparse branch only where the mask covers
every nonzero tile, so results match the dense rotation up to float
summation order.
"""
from __future__ import annotations

from ..core import matops
from . import matmul1p5d as mm
from .contract import CommContract
from .group import Comm


def omega_s_local_sparse(omega_rows, omega_mask, s_panel, comm: Comm, *,
                         policy: matops.MatmulPolicy,
                         canonical: str = "omegalike"):
    """W = Omega @ S with block-sparse local products.

    ``omega_rows``: the rotating Omega row-block; ``omega_mask``: its
    (rows/bs, cols/bs) occupancy; ``s_panel``: the fixed (p, blk_x) column
    panel.  Same layouts/canonical conventions as
    ``matmul1p5d.omega_s_local``.
    """
    grid = comm.grid
    n_r = grid.n_om if canonical == "omegalike" else grid.n_x
    seq = mm.rot_gather_local(omega_rows, s_panel, comm, n_r=n_r,
                              canonical=canonical, ring="x",
                              r_mask=omega_mask, policy=policy)
    blk_r, blk_c = omega_rows.shape[0], s_panel.shape[1]
    return seq.reshape(n_r * blk_r, blk_c)              # W col-panel (p, blk_x)


def omega_xt_local_sparse(omega_rows, omega_mask, xt_loc, comm: Comm, *,
                          policy: matops.MatmulPolicy, scale=1.0):
    """Y = scale * Omega @ X^T with block-sparse local products.

    ``omega_rows``: fixed Omega-like (blk_om, p); ``omega_mask``: its
    (blk_om/bs, p/bs) occupancy; ``xt_loc``: rotating X^T row-block.
    Same schedule as ``matmul1p5d.omega_xt_local``.
    """
    return mm.omega_xt_local(omega_rows, xt_loc, comm, scale=scale,
                             omega_mask=omega_mask, policy=policy)


# ---------------------------------------------------------------------------
# declared collective schedules
# ---------------------------------------------------------------------------
# The masked gather flavor ships the int8 occupancy mask around the ring
# with Omega (wire = operand + mask); the masked reduce flavor ships
# NOTHING extra — the mask is fixed and sliced locally.  Both facts are
# part of the declared volume (core.costmodel.comm_volume masked=...).

def _sparse_contract(entry, flavor):
    from ..core.costmodel import comm_volume

    def vol(**kw):
        # block_size rides in via the params (kw)
        return comm_volume(flavor=flavor, masked=(flavor == "omega_s"), **kw)

    return CommContract(
        entry=entry, axes=mm.AXES,
        kinds=(("ppermute", "all_gather") if flavor == "omega_s"
               else ("ppermute", "psum")),
        rounds=lambda **kw: vol(**kw).rounds,
        wire=("operand", "mask"),
        volume=lambda **kw: vol(**kw).total,
        volume_class=("ring+allgather masked" if flavor == "omega_s"
                      else "ring+psum masked-local"))


COMM_CONTRACT = {
    "omega_s_local_sparse": _sparse_contract(
        "comm.sparse1p5d.omega_s_local_sparse", "omega_s"),
    "omega_xt_local_sparse": _sparse_contract(
        "comm.sparse1p5d.omega_xt_local_sparse", "omega_xt"),
}
