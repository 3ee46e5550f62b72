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
from fractions import Fraction

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
                n_devices=rep.n_devices, telemetry=rep.telemetry)


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


def reconcile(rank, P, cx, co, variant, x, max_iters):
    """A dense distributed fit under ``obs.commwatch.CommWatch``; returns
    this rank's reconciliation reports as JSON."""
    from repro_torch.comm import Grid1p5D
    from repro_torch.core import distributed as dist
    from repro_torch.obs.commwatch import CommWatch
    x = torch.as_tensor(x)
    data = x if variant == "obs" else (x.T @ x) / x.shape[0]
    fit = dist.fit_cov if variant == "cov" else dist.fit_obs
    with CommWatch() as watch:
        fit(data, 0.3, grid=Grid1p5D(P, cx, co), max_iters=max_iters)
    return [r.to_json() for r in watch.reconcile()]


def obs_cli(rank, argv):
    """``obs.cli.main`` inside the rank group; returns its exit code."""
    from repro_torch.obs import cli
    return cli.main(list(argv), device="cpu")


def replication_sweep(rank):
    """``examples/torch_replication_study.py``'s ``main`` inside the rank
    group; its rows with the estimates as numpy."""
    import importlib.util
    from pathlib import Path
    path = (Path(__file__).resolve().parents[1] / "examples"
            / "torch_replication_study.py")
    spec = importlib.util.spec_from_file_location("torch_replication_study",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rows = mod.main([], device="cpu")
    return [dict(r, omega=r["omega"].numpy()) for r in rows]


# ---------------------------------------------------------------------------
# multi-rank LM training (repro_torch.launch.mesh, lm.make_train_step(mesh=))
# ---------------------------------------------------------------------------

def _lm_mesh(name, shape, axes=("data", "model")):
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    cfg = configs.get_smoke(name).with_(dtype="float32")
    return cfg, make_mesh(shape, axes, device="cpu")


def _full_state(state, cfg, mesh, seq_len):
    """The rank's train state gathered whole, as the reference's numpy
    tree (``convert.train_state_to_numpy``'s layout)."""
    from repro_torch import convert
    from repro_torch.models import lm
    from repro_torch.train import optim
    from repro_torch.train.loop import _state_shardings
    specs = _state_shardings(cfg, optim.AdamW(), mesh,
                             type("tc", (), {"seq_len": seq_len}))
    return convert.train_state_to_numpy(lm.gather_tree(state, specs, mesh))


def train_mesh(rank, name, shape, params, kw, ckpt_dir=""):
    """``train(mesh=)`` of the smoke config ``name`` (float32) from the
    reference's weights ``params`` on a (data, model) mesh of ``shape``:
    the losses, each rank's block shapes and state bytes, and (rank 0)
    the final state gathered whole."""
    from repro_torch import convert
    from repro_torch.models import lm
    from repro_torch.train import loop, optim
    cfg, mesh = _lm_mesh(name, shape)
    model = convert.lm_params_from_numpy(cfg, params, device="cpu")
    specs = lm.param_shardings(cfg, mesh, max_len=kw["seq_len"])
    lm.shard_params_(model, specs, mesh)
    state = lm.init_train_state(model, optim.AdamW(weight_decay=0.1,
                                                   clip_norm=1.0))
    res = loop.train(cfg, loop.TrainerConfig(ckpt_dir=ckpt_dir, **kw),
                     mesh=mesh, state=state, log=lambda *a: None,
                     device="cpu")
    leaves = optim.tree_leaves(res.state.params.tree())
    out = {"losses": res.losses, "final_step": res.final_step,
           "coords": mesh.coords,
           "shapes": [tuple(t.shape) for t in leaves],
           "grad_norm": [float(m["grad_norm"]) for m in res.metrics]}
    whole = _full_state(res.state, cfg, mesh, kw["seq_len"])
    out["state"] = whole if rank == 0 else None
    return out


def restore_mesh(rank, name, shape, ckpt_dir, seq_len):
    """A sharded template on a (data, model) mesh of ``shape`` filled by
    ``checkpoint.restore(shardings=)`` from ``ckpt_dir``: the state
    gathered whole (rank 0) and each rank's step."""
    import torch
    from repro_torch.models import lm, transformer
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optim
    from repro_torch.train.loop import _state_shardings
    cfg, mesh = _lm_mesh(name, shape)
    opt = optim.AdamW(weight_decay=0.1, clip_norm=1.0)
    specs = _state_shardings(cfg, opt, mesh,
                             type("tc", (), {"seq_len": seq_len}))
    model = transformer.init_params(cfg, seed=9, max_len=seq_len,
                                    device="cpu")
    lm.shard_params_(model, specs.params, mesh)
    template = lm.init_train_state(model, opt)
    state, manifest = ckpt.restore(ckpt_dir, template, shardings=specs,
                                   mesh=mesh)
    whole = _full_state(state, cfg, mesh, seq_len)
    return {"state": whole if rank == 0 else None,
            "step": int(state.step), "mesh_shape": manifest["mesh_shape"],
            "local": [tuple(t.shape) for t in optim.tree_leaves(
                state.params.tree())],
            "equal_blocks": all(torch.equal(a, b) for a, b in zip(
                optim.tree_leaves(state.params.tree()),
                optim.tree_leaves(lm.shard_tree(
                    lm.gather_tree(state.params, specs.params, mesh),
                    specs.params, mesh))))}


def train_cli(rank, argv):
    """``launch.train.main(argv, device="cpu")`` inside the group: the
    mesh it trained on (via its result) and the losses."""
    from repro_torch.launch import train as cli
    res = cli.main(argv, device="cpu")
    return {"losses": res.losses, "final_step": res.final_step}


def train_cli_error(rank, argv):
    """The message of the error ``launch.train.main(argv)`` raises."""
    from repro_torch.launch import train as cli
    try:
        cli.main(argv, device="cpu")
    except ValueError as e:
        return str(e)
    return ""


# ---------------------------------------------------------------------------
# the compressed collectives and the MoE's per-shard dispatch
# ---------------------------------------------------------------------------

def collectives(rank, kind, inputs):
    """``compressed_psum`` (bf16) and ``ring_allreduce_int8`` of row
    ``rank`` of each input over a team of every rank: a 1-axis mesh
    (``kind="mesh"``) or a 1.5D grid's all-rank team (``"grid"``); the
    results and each call's watched wire bytes (as str)."""
    import torch
    from repro_torch.comm import collectives as cc
    world = len(inputs["psum"])
    if kind == "mesh":
        from repro_torch.launch.mesh import make_mesh
        team, axes = make_mesh((world,), ("d",), device="cpu"), ("d",)
    else:
        from repro_torch.comm.grid import AXES
        team, axes = _comm(world, 1, 1), AXES
    out = {}
    for name, fn in (
            ("psum", lambda x: cc.compressed_psum(
                {"g": x}, team, axes, method="bf16")[0]["g"]),
            ("ring", lambda x: cc.ring_allreduce_int8(x, team, axes)),
            ("ring_pad", lambda x: cc.ring_allreduce_int8(x, team, axes))):
        x = torch.as_tensor(inputs[name][rank])
        got, events = _watched(lambda: fn(x))
        out[name] = got.numpy()
        out[name + "_bytes"] = str(sum(Fraction(e[2]) for e in events))
        out[name + "_prims"] = sorted({e[0] for e in events})
    return out


def moe_mesh(rank, shape, p, x, w):
    """``layers.apply_moe`` of the OLMoE smoke config (float32) inside
    ``batch_shards`` on a (data, model) mesh of ``shape``: each rank its
    rows of ``x`` when they divide the data team, else all of them.  The
    output, aux, drops and the gradients of sum(out * w) + 10 aux: the
    weights' summed over the team (each rank's share of the aux taken
    once), the input's for the rank's rows."""
    import torch
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers
    cfg = configs.get_smoke("olmoe_1b_7b").with_(dtype="float32")
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    team = layers.batch_axes(cfg, mesh)
    n = mesh.axes_size(team)
    b = x.shape[0]
    rows = b % n == 0
    lo, hi = ((b // n) * mesh.axes_index(team),
              (b // n) * (mesh.axes_index(team) + 1)) if rows else (0, b)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    xt = torch.tensor(x[lo:hi], requires_grad=True)
    with layers.batch_shards(mesh, rows), layers.count_moe_drops() as tally:
        out, aux = layers.apply_moe(cfg, pt, xt)
    share = n if rows else 1
    ((out * torch.as_tensor(w[lo:hi])).sum() + 10.0 * aux / share).backward()
    grads = {k: (mesh.psum(t.grad, team) if rows else t.grad).numpy()
             for k, t in pt.items()}
    return {"rows": rows, "lo": lo, "hi": hi, "out": out.detach().numpy(),
            "aux": float(aux), "grads": grads, "dx": xt.grad.numpy(),
            "dropped": tally.dropped, "assigned": tally.assigned}


# ---------------------------------------------------------------------------
# tensor and expert parallelism over "model" (repro_torch.models.parallel)
# ---------------------------------------------------------------------------

#: the leaves whose gradient is held equal on every model rank: the norm
#: scales (and biases), chameleon's qk-norm scales and the SSM's gated-
#: norm scale
def _norm_leaf(name: str) -> bool:
    return name.endswith(("_scale", "_bias")) or name in (
        "attn_qnorm", "attn_knorm", "ssm_gnorm")


def tp_run(rank, name, over, shape, params, kw, ckpt_dir=""):
    """The sharded train step of the smoke config ``name`` (float32,
    ``over`` its overrides) from the reference's weights ``params`` on a
    (data, model) mesh of ``shape``: one gradient step (``lm.sharded_grads`` on the
    first batch) under the collective watcher and ``FlopCounterMode``,
    its blocks' shapes, the norm leaves' gradients and (rank 0) every
    gradient gathered whole; then ``train`` for ``kw["steps"]`` steps: the
    losses, the parameters' block shapes and (rank 0) the final state
    gathered whole."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import convert
    from repro_torch.models import lm
    from repro_torch.train import loop, optim
    from repro_torch.train.data import make_source
    cfg, mesh = _lm_mesh(name, shape)
    cfg = cfg.with_(**over)
    specs = lm.param_shardings(cfg, mesh, max_len=kw["seq_len"])
    opt = optim.AdamW(weight_decay=0.1, clip_norm=1.0)

    def state():
        model = convert.lm_params_from_numpy(cfg, params, device="cpu")
        lm.shard_params_(model, specs, mesh)
        return lm.init_train_state(model, opt)

    probe = state()
    batch = make_source(cfg, kw["seq_len"], kw["global_batch"], 0,
                        "cpu")(0)
    with FlopCounterMode(display=False) as fc:
        (loss, _, grads), events = _watched(lambda: lm.sharded_grads(
            cfg, mesh, specs, probe.params, batch, cfg.n_micro))
    flat = {}
    for group, leaves in grads.items():
        for i, layer in enumerate(leaves if isinstance(leaves, list)
                                  else [leaves]):
            for k, g in layer.items():
                flat[f"{group}/{i}/{k}"] = g
    whole = {}
    for group, leaves in lm.gather_tree(grads, specs, mesh).items():
        for k in (leaves[0] if isinstance(leaves, list) else leaves):
            whole[f"{group}/{k}"] = (
                np.stack([layer[k].numpy() for layer in leaves])
                if isinstance(leaves, list) else leaves[k].numpy())
    res = loop.train(cfg, loop.TrainerConfig(ckpt_dir=ckpt_dir, **kw),
                     mesh=mesh, state=state(), log=lambda *a: None,
                     device="cpu")
    leaves = optim.tree_leaves(res.state.params.tree())
    state_whole = _full_state(res.state, cfg, mesh, kw["seq_len"])
    return {"coords": mesh.coords, "losses": res.losses,
            "probe_loss": float(loss), "flops": fc.get_total_flops(),
            "events": events,
            "shapes": [tuple(t.shape) for t in leaves],
            "grad_shapes": {k: tuple(g.shape) for k, g in flat.items()},
            "norm_grads": {k: g.numpy() for k, g in flat.items()
                           if _norm_leaf(k.rsplit("/", 1)[1])},
            "grads": whole if rank == 0 else None,
            "state": state_whole if rank == 0 else None}


def tp_collective(rank, shape, op, axes, dim, x, dy):
    """``parallel.<op>`` over the team ``axes`` of a (data, model) mesh of
    ``shape``, rank r's input ``x[r]`` and output gradient ``dy[r]``: the
    output, the input's gradient, the team's members and the primitives
    watched forward and backward."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import parallel
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    team = mesh.key(axes)
    xin = torch.as_tensor(x[rank]).requires_grad_(True)
    extra = () if dim is None else (dim,)
    out, fwd = _watched(lambda: getattr(parallel, op)(xin, mesh, team,
                                                      *extra))
    _, bwd = _watched(lambda: out.backward(torch.as_tensor(dy[rank])))
    return {"members": mesh.team(team), "out": out.detach().numpy(),
            "grad": xin.grad.numpy(), "fwd": [e[0] for e in fwd],
            "bwd": [e[0] for e in bwd]}


def tp_grads(rank, name, over, shape, seq, batch):
    """One ``lm.sharded_grads`` of the smoke config ``name`` (float32,
    ``over`` its overrides, weights from ``init_params`` at seed 0) on a
    (data, model) mesh of ``shape``: the loss and (rank 0) the gradients
    gathered whole, as numpy trees."""
    from repro_torch.models import lm, transformer
    from repro_torch.train.data import make_source
    cfg, mesh = _lm_mesh(name, shape)
    cfg = cfg.with_(**over)
    specs = lm.param_shardings(cfg, mesh, max_len=seq)
    model = transformer.init_params(cfg, seed=0, max_len=seq, device="cpu")
    lm.shard_params_(model, specs, mesh)
    model.requires_grad_(True)
    data = make_source(cfg, seq, batch, 0, "cpu")(0)
    loss, _, grads = lm.sharded_grads(cfg, mesh, specs, model, data,
                                      cfg.n_micro)
    whole = lm.gather_tree(grads, specs, mesh)
    return {"loss": float(loss),
            "grads": (lm.map_with_specs(lambda t, s: t.numpy(), whole,
                                        specs) if rank == 0 else None)}


# ---------------------------------------------------------------------------
# prefill and decode on a mesh (lm.make_prefill / make_decode_step(mesh=))
# ---------------------------------------------------------------------------

def _leaf_paths(tree, prefix=""):
    """(path, leaf) of a nest of dicts, sorted: ``layers/self/k``."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaf_paths(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k]


def tp_serve(rank, name, over, shape, params, seq, max_len, tokens, frames,
             forced, events=False):
    """Prefill and decode of the smoke config ``name`` (float32, ``over``
    its overrides) from the reference's weights ``params`` (built at
    ``seq``) on a (data, model) mesh of ``shape``, at the global batch of
    ``tokens``: this rank's rows of ``tokens`` (and its block of
    ``frames``), then one decode step per token of ``forced[i]`` (the
    global tokens fed at step i, teacher forcing) at positions L, L + 1,
    ....  Returns the rank's coordinates, the logits gathered whole, each
    step's next tokens gathered over the batch team, (rank 0) the cache
    gathered whole after prefill and after each step, the shapes of the
    rank's blocks (``logits``, ``tokN``, ``cacheN/leaf``) and, with
    ``events``, the collectives watched in the first decode step."""
    from repro_torch import convert
    from repro_torch.models import lm
    cfg, mesh = _lm_mesh(name, shape)
    cfg = cfg.with_(**over)
    b, length = tokens.shape
    specs = lm.param_shardings(cfg, mesh, max_len=seq)
    model = convert.lm_params_from_numpy(cfg, params, device="cpu")
    lm.shard_params_(model, specs, mesh)
    lay = lm.serve_shardings(cfg, mesh, b, max_len)
    cache = lm.init_cache_blocks(cfg, mesh, b, max_len, device="cpu")
    prefill = lm.make_prefill(cfg, max_len, mesh=mesh, specs=specs, batch=b)
    decode = lm.make_decode_step(cfg, mesh=mesh, specs=specs, batch=b)
    rows = mesh.shard(torch.as_tensor(tokens), lay["tokens"])
    args = [model, cache, rows]
    if frames is not None:
        args.append(mesh.shard(torch.as_tensor(frames), lay["frames"]))
    blocks, caches, toks, watched = {}, [], [], None

    def keep(i, cache):
        for path, t in _leaf_paths(cache):
            blocks[f"cache{i}/{path}"] = tuple(t.shape)
        whole = lm.gather_tree(cache, lay["cache"], mesh)
        # a copy: a leaf no spec splits is the cache's own storage
        caches.append({k: np.array(v) for k, v in _leaf_paths(
            convert.cache_to_numpy(whole))} if rank == 0 else None)

    cache, logits = prefill(*args)
    blocks["logits"] = tuple(logits.shape)
    keep(0, cache)
    for i, tok in enumerate(forced):
        fed = mesh.shard(torch.as_tensor(tok), lay["token"])
        step = torch.tensor([length + i])
        if events and i == 0:
            (cache, nxt), watched = _watched(
                lambda: decode(model, cache, fed, step))
        else:
            cache, nxt = decode(model, cache, fed, step)
        blocks[f"tok{i + 1}"] = tuple(nxt.shape)
        toks.append(mesh.gather(nxt, lay["token"]).numpy())
        keep(i + 1, cache)
    caches = [c for c in caches if c is not None]
    return {"rank": rank, "coords": mesh.coords,
            "logits": mesh.gather(logits, lay["logits"]).numpy(),
            "tokens": toks, "caches": caches, "blocks": blocks,
            "events": watched}


def tp_serve_refusals(rank):
    """Which misuses of prefill on a (2, 2) mesh raise ``ValueError`` on
    this rank (danube smoke, a global batch of 4): no global batch, all
    4 rows where the rank holds 2, the whole cache where it holds
    blocks."""
    from repro_torch.models import lm, transformer
    cfg, mesh = _lm_mesh("h2o_danube_1p8b", (2, 2))
    specs = lm.param_shardings(cfg, mesh, max_len=32)
    model = transformer.init_params(cfg, seed=0, device="cpu")
    lm.shard_params_(model, specs, mesh)
    toks = torch.zeros((4, 8), dtype=torch.int32)
    out = []
    try:
        lm.make_prefill(cfg, 32, mesh=mesh, specs=specs)
    except ValueError as e:
        out.append("batch" if "global batch" in str(e) else str(e))
    prefill = lm.make_prefill(cfg, 32, mesh=mesh, specs=specs, batch=4)
    blocks = lm.init_cache_blocks(cfg, mesh, 4, 32, device="cpu")
    try:
        prefill(model, blocks, toks)
    except ValueError as e:
        out.append("rows" if "rows" in str(e) else str(e))
    try:
        prefill(model, transformer.init_cache(cfg, 4, 32, device="cpu"),
                toks[:2])
    except ValueError as e:
        out.append("cache" if "blocks" in str(e) else str(e))
    return out


def serve_flops(rank, name, kind, shape, batch, length):
    """``FlopCounterMode``'s count of one sharded prefill (of ``length``
    tokens) or decode step (position ``length // 2``) of the smoke config
    ``name`` (its own dtype, weights from ``init_params``) on a (data,
    model) mesh of ``shape`` at a global batch of ``batch``, the cache
    ``length`` positions wide: the dry run's ``trace_step`` inputs."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm, transformer
    cfg = configs.get_smoke(name)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    specs = lm.param_shardings(cfg, mesh, length)
    model = transformer.init_params(cfg, seed=0, max_len=length,
                                    device="cpu")
    lm.shard_params_(model, specs, mesh)
    lay = lm.serve_shardings(cfg, mesh, batch, length)
    cache = lm.init_cache_blocks(cfg, mesh, batch, length, device="cpu")
    gen = torch.Generator().manual_seed(0)
    kw = dict(mesh=mesh, specs=specs, batch=batch)
    if kind == "prefill":
        toks = mesh.shard(torch.randint(0, cfg.vocab, (batch, length),
                                        generator=gen), lay["tokens"])
        args = [model, cache, toks]
        if cfg.enc_dec:
            args.append(mesh.shard(torch.randn(
                (batch, cfg.enc_len, cfg.d_model), generator=gen).to(
                    getattr(torch, cfg.dtype)), lay["frames"]))
        fn = lm.make_prefill(cfg, length, **kw)
    else:
        tok = mesh.shard(torch.randint(0, cfg.vocab, (batch,),
                                       generator=gen), lay["token"])
        args = [model, cache, tok, torch.tensor(length // 2)]
        fn = lm.make_decode_step(cfg, **kw)
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()
