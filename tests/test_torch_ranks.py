"""Multi-process harness of the port's distributed tests (no JAX here),
and the harness's own check.

:class:`RankPool` spawns P processes once, joins them into one gloo
process group through a ``file://`` rendezvous in a temporary directory
(never a fixed TCP port: the suite runs under pytest-xdist), and then
runs tasks on every rank: ``pool.run(fn, *args)`` returns each rank's
result, rank 0 first.  ``fn`` is a module-level function taking
``(rank, *args)``, pickled by import path, so the rank processes import
the test module that defines it; keep JAX out of such modules.

A task that raises on one rank leaves the others waiting in a
collective until the group's timeout, then fails them too; the pool
reports the first traceback and is closed.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

#: seconds a rank waits in a collective before giving up
GROUP_TIMEOUT = 60
#: seconds the parent waits for one task on every rank
TASK_TIMEOUT = 240


def _rank_main(rank, world, init_file, tasks, results):
    from repro_torch.comm import group
    torch.set_num_threads(1)
    group.init_process_group(
        "cpu", world_size=world, rank=rank,
        init_method=f"file://{init_file}",
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                results.put((rank, True, fn(rank, *args)))
            except BaseException:   # reported to the parent, then exit
                results.put((rank, False, traceback.format_exc()))
                break
    finally:
        group.destroy_process_group()


class RankPool:
    """P gloo ranks on the CPU that run tasks in lock step."""

    def __init__(self, world: int):
        self.world = world
        self._dir = tempfile.TemporaryDirectory(prefix="torch_dist_")
        ctx = mp.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        init_file = os.path.join(self._dir.name, "pg")
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, world, init_file, self._tasks[r],
                                         self._results))
                       for r in range(world)]
        for p in self._procs:
            p.start()
        self.alive = True

    def run(self, fn, *args):
        """``fn(rank, *args)`` on every rank; the results in rank order."""
        if not self.alive:
            raise RuntimeError("the rank pool was closed by a failed task")
        for q in self._tasks:
            q.put((fn, args))
        out, errors = {}, []
        for _ in range(self.world):
            try:
                rank, ok, val = self._results.get(timeout=TASK_TIMEOUT)
            except queue.Empty:
                errors.append(f"no result within {TASK_TIMEOUT} s")
                break
            if ok:
                out[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
                break
        if errors:
            self.close()
            raise AssertionError("distributed task failed: " + errors[0])
        return [out[r] for r in range(self.world)]

    def close(self):
        if self.alive:
            for q in self._tasks:
                q.put(None)
        self.alive = False
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self._dir.cleanup()


def _fail_on_rank_1(rank):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return rank


def test_a_failing_rank_fails_the_task():
    """A task that raises on one rank fails ``run`` with that rank's
    traceback and closes the pool, so no later task waits on it."""
    import pytest
    pool = RankPool(2)
    try:
        assert pool.run(_comm_rank) == [0, 1]
        with pytest.raises(AssertionError, match="rank 1 fails on purpose"):
            pool.run(_fail_on_rank_1)
        assert not pool.alive
        with pytest.raises(RuntimeError, match="closed"):
            pool.run(_comm_rank)
    finally:
        pool.close()


def _comm_rank(rank):
    return _comm(2, 1, 1).rank


# ---------------------------------------------------------------------------
# rank-side tasks (run inside the pool; torch and repro_torch only)
# ---------------------------------------------------------------------------

def _comm(P, cx, co):
    from repro_torch.comm import Grid1p5D, comm_for
    return comm_for(Grid1p5D(P, cx, co), "cpu")


def _watched(fn):
    """(fn(), [(prim, axes, bytes as str)]) with the collective watcher
    recording every wrapper call made by fn."""
    from repro_torch.comm import set_collective_watcher
    events = []
    prev = set_collective_watcher(
        lambda prim, axes, nb: events.append((prim, axes, str(nb))))
    try:
        out = fn()
    finally:
        set_collective_watcher(prev)
    return out, events


def products(rank, P, cx, co, p, n, seed):
    """The six standalone products and the two masked ones on full
    matrices drawn from ``seed`` (the same on every rank); returns the
    full results as numpy."""
    import numpy as np
    from repro_torch.comm import matmul1p5d as mm
    from repro_torch.comm import sparse1p5d as sp
    from repro_torch.core import matops
    comm = _comm(P, cx, co)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((n, p)))
    om = torch.as_tensor(rng.standard_normal((p, p)))
    out = {}
    s = mm.xtx(x, comm, scale=1.0 / n)
    out["xtx"] = s
    out["omega_s"] = mm.omega_s(om, s, comm)
    out["omega_xt"] = y = mm.omega_xt(om, x, comm)
    out["y_x"] = z = mm.y_x(y, x, comm, scale=1.0 / n)
    out["transpose_xlike"] = mm.transpose_xlike(out["omega_s"], comm)
    out["transpose_omegalike"] = mm.transpose_omegalike(z, comm)
    # the masked flavors, Omega zeroed outside a random block pattern
    bs = 4
    keep = torch.as_tensor(rng.random((p // bs, p // bs)) < 0.3)
    oms = om * keep.repeat_interleave(bs, 0).repeat_interleave(bs, 1)
    pol = matops.MatmulPolicy("on", bs, 0.5)
    rows = mm.shard(oms, comm, mm.SPEC_OM)
    mask = matops.block_mask(rows, bs)
    w = sp.omega_s_local_sparse(rows, mask, mm.shard(s, comm, mm.SPEC_XCOL),
                                comm, policy=pol)
    out["omega_s_masked"] = mm.unshard(w, comm, mm.SPEC_XCOL)
    out["omega_s_dense"] = mm.omega_s(oms, s, comm)
    y = sp.omega_xt_local_sparse(rows, mask,
                                 mm.shard(x, comm, mm.SPEC_XCOL).T, comm,
                                 policy=pol)
    out["omega_xt_masked"] = mm.unshard(y, comm, mm.SPEC_OM)
    out["omega_xt_dense"] = mm.omega_xt(oms, x, comm)
    out["oms"] = oms
    # the third layout: X^T row-blocked, through shard and unshard
    out["xt_rows"] = mm.unshard(mm.shard(x.T, comm, mm.SPEC_XROW), comm,
                                mm.SPEC_XROW)
    return {k: v.numpy() for k, v in out.items()}


def product_bytes(rank, P, cx, co, p, n, dtype, bs):
    """The wire bytes each local product announces, per flavor (one
    invocation each, on this rank's shards), and the events' primitives."""
    from repro_torch.comm import matmul1p5d as mm
    from repro_torch.comm import sparse1p5d as sp
    from repro_torch.core import matops
    comm = _comm(P, cx, co)
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(rank)
    x_loc = torch.randn((n, p // comm.grid.n_x), generator=gen, dtype=dt)
    om_rows = torch.randn((p // comm.grid.n_om, p), generator=gen, dtype=dt)
    s_panel = torch.randn((p, p // comm.grid.n_x), generator=gen, dtype=dt)
    y_rows = torch.randn((p // comm.grid.n_om, n), generator=gen, dtype=dt)
    pol = matops.MatmulPolicy("on", bs, 0.5)
    mask = matops.block_mask(om_rows, bs)
    calls = {
        "xtx": lambda: mm.xtx_local(x_loc, comm),
        "omega_s": lambda: mm.omega_s_local(om_rows, s_panel, comm),
        "y_x": lambda: mm.y_x_local(y_rows, x_loc, comm),
        "omega_xt": lambda: mm.omega_xt_local(om_rows, x_loc.T, comm),
        "omega_s_masked": lambda: sp.omega_s_local_sparse(
            om_rows, mask, s_panel, comm, policy=pol),
        "omega_xt_masked": lambda: sp.omega_xt_local_sparse(
            om_rows, mask, x_loc.T, comm, policy=pol),
    }
    if cx == co:   # the Cov driver's form: Omega stored X-like
        x_rows = torch.randn((p // comm.grid.n_x, p), generator=gen,
                             dtype=dt)
        calls["omega_s_xlike"] = lambda: mm.omega_s_local(
            x_rows, s_panel, comm, canonical="xlike")
    out = {}
    for name, fn in calls.items():
        _, events = _watched(fn)
        out[name] = events
    return out


def unequal_density(rank, P, cx, co, p, bs):
    """W = Omega S with Omega dense on rank 0's rows and nearly empty on
    the others, so the per-tile dispatch takes different branches on
    different ranks; returns the masked and dense products, the events
    each rank posted and the branches its tiles took."""
    import numpy as np
    from repro_torch.comm import matmul1p5d as mm
    from repro_torch.comm import sparse1p5d as sp
    from repro_torch.core import matops
    comm = _comm(P, cx, co)
    rng = np.random.default_rng(7)
    om = torch.as_tensor(rng.standard_normal((p, p)))
    blk = p // comm.grid.n_om
    om[blk:] *= torch.as_tensor(rng.random((p - blk, p)) < 0.002)
    s = torch.as_tensor(rng.standard_normal((p, p)))
    pol = matops.MatmulPolicy("on", bs, 0.25)
    rows = mm.shard(om, comm, mm.SPEC_OM)
    mask = matops.block_mask(rows, bs)
    branches = []
    real = matops.masked_matmul

    def spy(*a, **kw):
        branches.append("sparse")
        return real(*a, **kw)
    matops.masked_matmul = spy
    try:
        w, events = _watched(lambda: sp.omega_s_local_sparse(
            rows, mask, mm.shard(s, comm, mm.SPEC_XCOL), comm, policy=pol))
    finally:
        matops.masked_matmul = real
    dense = mm.omega_s_local(rows, mm.shard(s, comm, mm.SPEC_XCOL), comm)
    return {"masked": mm.unshard(w, comm, mm.SPEC_XCOL).numpy(),
            "dense": mm.unshard(dense, comm, mm.SPEC_XCOL).numpy(),
            "want": (om @ s).numpy(), "events": events,
            "sparse_tiles": len(branches),
            "density": float(matops.block_density(mask))}


def solve(rank, P, cx, co, variant, data, lam1, lam2, sparse_block,
          weights, kw):
    """One distributed fit (``core.distributed``) on every rank; returns
    its record, the estimate as numpy."""
    from repro_torch.comm import Grid1p5D
    from repro_torch.core import distributed as dist
    from repro_torch.core import matops
    from repro_torch.core.penalty import PenaltySpec
    pol = None if sparse_block is None else matops.MatmulPolicy(
        "on", sparse_block, 0.25)
    pen = None if weights is None else PenaltySpec.weighted_l1(
        lam1, weights, lam2)
    fit = dist.fit_cov if variant == "cov" else dist.fit_obs
    args = dict(grid=Grid1p5D(P, cx, co), sparse_matmul=pol, **kw)
    if pen is None:
        args.update(lam1=lam1, lam2=lam2)
    r = fit(torch.as_tensor(data), penalty=pen, **args)
    return dict(omega=r.omega.numpy(), iters=r.iters, ls_total=r.ls_total,
                converged=r.converged, stalled=r.stalled,
                g_final=r.g_final, block_density=r.block_density)


def facade(rank, x, lam1, backend, config_kw):
    """``ConcordEstimator.fit`` through a backend on every rank."""
    from repro_torch import estimator as est
    cfg = est.SolverConfig(backend=backend, device="cpu", **config_kw)
    rep = est.ConcordEstimator(lam1=lam1, lam2=0.05, config=cfg).fit(
        x).report_
    return dict(omega=rep.omega.numpy(), iters=rep.iters,
                ls_total=rep.ls_total, backend=rep.backend,
                variant=rep.variant, c_x=rep.c_x, c_omega=rep.c_omega,
                n_devices=rep.n_devices)


def gram(rank, x, transform):
    """``distributed_gram`` of this rank's quarter of the rows."""
    from repro_torch.data import distributed_gram
    rows = np.array_split(x, torch.distributed.get_world_size())[rank]
    g = distributed_gram(rows, transform=transform, chunk_rows=25,
                         device="cpu")
    return dict(s=g.s.numpy(), n=g.n, p=g.p, n_chunks=g.n_chunks,
                mean=g.mean.numpy())


def cli(rank, argv):
    """``launch.solve.main`` inside the rank group."""
    from repro_torch.launch import solve
    rep = solve.main(list(argv), device="cpu")
    return dict(omega=rep.omega.numpy(), iters=rep.iters,
                ls_total=rep.ls_total, backend=rep.backend,
                c_x=rep.c_x, c_omega=rep.c_omega, n_devices=rep.n_devices)
