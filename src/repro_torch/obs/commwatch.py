"""Measured-vs-predicted communication reconciliation (the CA303 closure).

Port of ``repro.obs.commwatch``.  What a distributed solve moves is
checked at run time against the paper's analytic volumes.

**Measured side.**  A :class:`CommWatch` installed on
``comm.group.set_collective_watcher`` sees every collective a rank
posts, with its exact wire bytes (``core.costmodel.
collective_wire_bytes``' conventions), and on ``core.distributed``'s
dispatch hook sees each ``fit_cov``/``fit_obs`` loop start and end.
Between the two, it counts the collectives per (prim, axes).  The
reference re-traces the dispatched program, walks its jaxpr and expands
each collective by the loop's trip counts (``walk_collectives``,
``expand_counts``); the port runs no traced program, so it counts the
collectives actually posted, which is the stronger measurement.

**Predicted side.**  An independent analytic table built from
``core.costmodel.comm_volume`` (paper Algorithm 4 ring/finish volumes)
plus the closed-form per-phase collective census of the port's
``core.prox.prox_gradient`` control flow (:func:`predict_schedule`).

:meth:`CommWatch.reconcile` demands EXACT equality (integer counts,
``Fraction`` bytes) per (prim, axes): a single extra collective or one
widened payload anywhere in the stack is a reportable finding.

Scope: the dense product path.  The block-sparse policy adds mask ring
traffic and density reductions whose analytic volume lives in
``comm.sparse1p5d``'s contracts; reconciling those is out of scope and
:meth:`CommWatch.reconcile` refuses rather than guessing.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction

from ..core.costmodel import DTYPE_BYTES, collective_wire_bytes, comm_volume


class ReconcileError(RuntimeError):
    """A schedule this reconciler cannot measure or predict exactly."""


# ---------------------------------------------------------------------------
# analytic prediction (costmodel volumes x prox_gradient phase counts)
# ---------------------------------------------------------------------------

def predict_schedule(variant: str, *, p_pad: int, n: int | None, grid,
                     iters: int, ls_total: int,
                     dtype: str = "float64") -> dict:
    """Per-(prim, axes) execution counts and exact ``Fraction``
    bytes-on-wire of one dense ``fit_cov``/``fit_obs`` solve of the port,
    built from ``comm_volume`` (ring products) and the closed-form
    collective census of the ``prox_gradient`` phases: aux+objective
    runs ``1 + ls_total`` times (cold start + every line-search trial),
    the gradient runs ``iters`` times.

    Every ring product, transpose and gather row is the reference's
    (``repro.obs.commwatch.predict_schedule``), count and bytes.  The
    scalar ``psum`` row differs in two places, both deliberate:

      * the objective posts ONE psum of a stacked 3-element payload
        (log-det, quadratic, ridge sums) where the reference posts three
        scalar psums — the same bytes (wire bytes are linear in the
        payload), ``2 * (1 + ls_total)`` fewer collectives;
      * each outer iteration posts one psum (``<Omega, Omega>``) where
        the reference posts two: the port's loop reuses the accepted
        trial's ``<D, D>`` for the step's relative change instead of
        recomputing it — ``iters`` fewer collectives, and ``iters``
        scalar psums' bytes fewer.

    The ``pmin`` guard (one per objective) and the two dot psums per
    trial are the reference's."""
    w = DTYPE_BYTES[dtype]
    P, cx, co = grid.n_devices, grid.c_x, grid.c_omega
    n_x, n_om, n_i = grid.n_x, grid.n_om, grid.n_i
    blk_x, blk_om = p_pad // n_x, p_pad // n_om
    aux_calls = 1 + ls_total
    table: dict = {}

    def add(prim, axes, count, nbytes):
        row = table.setdefault((prim, tuple(axes)),
                               {"count": 0, "bytes": Fraction(0)})
        row["count"] += count
        row["bytes"] += Fraction(nbytes)

    def wire(prim, payload_elems, extent):
        return collective_wire_bytes(prim, payload_elems * w, extent)

    ring_axes = ("i", "j", "k")
    if variant == "cov":
        # aux_of: W = Omega S, gather ring (Omega stored X-like)
        vol = comm_volume(p_pad, p_pad, P, cx, co, flavor="omega_s",
                          dtype=dtype, canonical="xlike")
        add("ppermute", ring_axes, aux_calls * (1 + vol.rounds),
            aux_calls * vol.ring_bytes)
        add("all_gather", ("k",), aux_calls, aux_calls * vol.finish_bytes)
        # grad_of: replication-aware transpose of W (Lemma 3.2)
        sub = blk_x // cx
        add("all_to_all", ("i", "j"), iters,
            iters * wire("all_to_all", n_x * sub * blk_x, n_x))
        add("all_gather", ("k",), iters,
            iters * wire("all_gather", p_pad * sub, cx))
        scalar_axes, scalar_extent = ("i", "j"), n_i * co
    elif variant == "obs":
        if n is None:
            raise ReconcileError("obs prediction needs the sample count n")
        # aux_of: Y = Omega X^T, reduce ring
        vol = comm_volume(p_pad, n, P, cx, co, flavor="omega_xt",
                          dtype=dtype)
        add("ppermute", ring_axes, aux_calls * (1 + vol.rounds),
            aux_calls * vol.ring_bytes)
        add("psum", ("j",), aux_calls, aux_calls * vol.finish_bytes)
        # grad_of: Z = Y X gather ring + transpose of Z
        voly = comm_volume(p_pad, n, P, cx, co, flavor="y_x", dtype=dtype)
        add("ppermute", ring_axes, iters * (1 + voly.rounds),
            iters * voly.ring_bytes)
        add("all_gather", ("j",), iters, iters * voly.finish_bytes)
        sub = blk_om // co
        add("all_to_all", ("i", "k"), iters,
            iters * wire("all_to_all", sub * n_om * blk_om, n_om))
        add("all_gather", ("j",), iters,
            iters * wire("all_gather", blk_om * n_om * sub, co))
        scalar_axes, scalar_extent = ("i", "k"), n_i * cx
    else:
        raise ReconcileError(f"unknown variant {variant!r}")

    # scalar collectives of the objective/line-search phases: 1 stacked
    # psum (3 elements) + 1 pmin guard per objective, 2 dot psums per
    # trial, 1 norm psum per iteration
    add("psum", scalar_axes, aux_calls,
        aux_calls * wire("psum", 3, scalar_extent))
    n_dots = 2 * ls_total + iters
    add("psum", scalar_axes, n_dots, n_dots * wire("psum", 1, scalar_extent))
    add("pmin", scalar_axes, aux_calls,
        aux_calls * wire("pmin", 1, scalar_extent))
    return table


# ---------------------------------------------------------------------------
# reconciliation report
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ReconcileRow:
    prim: str
    axes: tuple
    measured_count: int
    predicted_count: int
    measured_bytes: Fraction
    predicted_bytes: Fraction

    @property
    def match(self) -> bool:
        return (self.measured_count == self.predicted_count
                and self.measured_bytes == self.predicted_bytes)

    def to_json(self) -> dict:
        return {"prim": self.prim, "axes": list(self.axes),
                "measured_count": self.measured_count,
                "predicted_count": self.predicted_count,
                "measured_bytes": str(self.measured_bytes),
                "predicted_bytes": str(self.predicted_bytes),
                "match": self.match}


@dataclass(frozen=True)
class ReconcileReport:
    variant: str
    p: int
    p_pad: int
    n: int | None
    n_devices: int
    c_x: int
    c_omega: int
    iters: int
    ls_total: int
    rows: tuple

    @property
    def ok(self) -> bool:
        return all(r.match for r in self.rows)

    @property
    def measured_total(self) -> Fraction:
        return sum((r.measured_bytes for r in self.rows), Fraction(0))

    @property
    def predicted_total(self) -> Fraction:
        return sum((r.predicted_bytes for r in self.rows), Fraction(0))

    def to_json(self) -> dict:
        return {"variant": self.variant, "p": self.p, "p_pad": self.p_pad,
                "n": self.n, "n_devices": self.n_devices, "c_x": self.c_x,
                "c_omega": self.c_omega, "iters": self.iters,
                "ls_total": self.ls_total, "ok": self.ok,
                "measured_bytes_total": str(self.measured_total),
                "predicted_bytes_total": str(self.predicted_total),
                "rows": [r.to_json() for r in self.rows]}

    def render(self) -> str:
        hdr = (f"{self.variant}: p={self.p} (pad {self.p_pad}) "
               f"P={self.n_devices} c_x={self.c_x} c_omega={self.c_omega} "
               f"iters={self.iters} ls_total={self.ls_total}")
        lines = [hdr, f"{'prim':<12} {'axes':<12} {'measured':>22} "
                      f"{'predicted':>22}  match"]
        for r in self.rows:
            m = f"{r.measured_count}x / {_fmt_bytes(r.measured_bytes)}"
            p_ = f"{r.predicted_count}x / {_fmt_bytes(r.predicted_bytes)}"
            lines.append(f"{r.prim:<12} {','.join(r.axes):<12} {m:>22} "
                         f"{p_:>22}  {'OK' if r.match else 'MISMATCH'}")
        lines.append(f"total measured {_fmt_bytes(self.measured_total)} vs "
                     f"predicted {_fmt_bytes(self.predicted_total)} -> "
                     f"{'EXACT MATCH' if self.ok else 'DIVERGENCE'}")
        return "\n".join(lines)


def _fmt_bytes(b: Fraction) -> str:
    f = float(b)
    return f"{f:.0f}B" if f == int(f) else f"{f:.1f}B"


def _table_to_rows(measured: dict, predicted: dict) -> tuple:
    rows = []
    for key in sorted(set(measured) | set(predicted)):
        m = measured.get(key, {"count": 0, "bytes": Fraction(0)})
        p = predicted.get(key, {"count": 0, "bytes": Fraction(0)})
        rows.append(ReconcileRow(
            prim=key[0], axes=key[1],
            measured_count=m["count"], predicted_count=p["count"],
            measured_bytes=m["bytes"], predicted_bytes=p["bytes"]))
    return tuple(rows)


# ---------------------------------------------------------------------------
# the observer
# ---------------------------------------------------------------------------

@dataclass
class DispatchRecord:
    """One observed solve: what the driver announced, the collectives
    posted while its loop ran, and the loop's result."""
    variant: str
    grid: object
    meta: dict
    #: {(prim, axes): {"count": int, "bytes": Fraction}}
    measured: dict = field(default_factory=dict)
    result: object = None


class CommWatch:
    """Observer over the distributed drivers and the comm wrappers.

    Usage (on every rank)::

        with CommWatch() as watch:
            res = dist.fit_cov(s, lam1, grid=grid)
        report = watch.reconcile()[0]
        assert report.ok

    ``install``/``uninstall`` (or the context manager) register this
    object on ``core.distributed.set_dispatch_observer`` and
    ``comm.group.set_collective_watcher``, restoring the previous ones.
    Only collectives posted between a solve's announcement and its
    result count: the communicators' set-up and the closing gather of
    the estimate are not part of the solve's schedule."""

    def __init__(self):
        self.records: list = []
        self._open: DispatchRecord | None = None
        self._prev_dispatch = None
        self._prev_watcher = None
        self._installed = False

    # -- lifecycle -------------------------------------------------------
    def install(self) -> "CommWatch":
        from ..comm import group
        from ..core import distributed
        if self._installed:
            return self
        self._prev_dispatch = distributed.set_dispatch_observer(self)
        self._prev_watcher = group.set_collective_watcher(self.on_collective)
        self._installed = True
        return self

    def uninstall(self) -> None:
        from ..comm import group
        from ..core import distributed
        if not self._installed:
            return
        distributed.set_dispatch_observer(self._prev_dispatch)
        group.set_collective_watcher(self._prev_watcher)
        self._installed = False

    def __enter__(self) -> "CommWatch":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # -- core.distributed dispatch-observer protocol ---------------------
    def on_dispatch(self, variant: str, grid, meta: dict) -> DispatchRecord:
        if self._open is not None:
            raise ReconcileError("a solve started inside another solve's "
                                 "watch window")
        rec = DispatchRecord(variant=variant, grid=grid, meta=dict(meta))
        self.records.append(rec)
        self._open = rec
        return rec

    def on_result(self, token: DispatchRecord, result) -> None:
        token.result = result
        self._open = None

    # -- comm.group collective-watcher protocol --------------------------
    def on_collective(self, prim: str, axes, nbytes) -> None:
        """Count one posted collective and its wire bytes against the
        open solve (collectives outside a solve are not counted)."""
        if self._open is None:
            return
        row = self._open.measured.setdefault(
            (prim, tuple(axes)), {"count": 0, "bytes": Fraction(0)})
        row["count"] += 1
        row["bytes"] += Fraction(nbytes)

    # -- reconciliation --------------------------------------------------
    def reconcile(self) -> list:
        """One :class:`ReconcileReport` per observed solve, from its own
        ``iters``/``ls_total`` (host scalars of the finished loop)."""
        reports = []
        for rec in self.records:
            if rec.result is None:
                raise ReconcileError(
                    f"{rec.variant} solve was observed but its result "
                    f"never arrived (solve still running or crashed)")
            if rec.meta.get("sparse"):
                raise ReconcileError(
                    "block-sparse solves add mask ring traffic the dense "
                    "predictor does not model; reconcile dense solves")
            iters = int(rec.result.iters)
            ls_total = int(rec.result.ls_total)
            predicted = predict_schedule(
                rec.variant, p_pad=rec.meta["p_pad"], n=rec.meta.get("n"),
                grid=rec.grid, iters=iters, ls_total=ls_total,
                dtype=rec.meta.get("dtype", "float64"))
            reports.append(ReconcileReport(
                variant=rec.variant, p=rec.meta.get("p", rec.meta["p_pad"]),
                p_pad=rec.meta["p_pad"], n=rec.meta.get("n"),
                n_devices=rec.grid.n_devices, c_x=rec.grid.c_x,
                c_omega=rec.grid.c_omega, iters=iters, ls_total=ls_total,
                rows=_table_to_rows(rec.measured, predicted)))
        return reports

    def clear(self) -> None:
        self.records.clear()
        self._open = None


# ---------------------------------------------------------------------------
# analysis manifest (repro_torch.analysis.dispatchpass — the CA202 recipe)
# ---------------------------------------------------------------------------

def _analysis_fit(level: str, device):
    """A thunk: one reference-backend Cov fit at obs ``level``."""
    import numpy as np

    from ..estimator import ConcordEstimator, SolverConfig

    x = np.random.default_rng(0).standard_normal((20, 8))
    config = SolverConfig(backend="reference", variant="cov", tol=1e-3,
                          max_iters=5, max_ls=5, obs=level,
                          device=str(device))
    return lambda: ConcordEstimator(lam1=0.2, config=config).fit(x)


def _analysis_obs_build(device):
    """The fit with the span tracer armed at ``trace``: its f64 contract
    is the untraced solve's."""
    return {"fn": _analysis_fit("trace", device)}


def _analysis_obs_same_ops(device):
    """CA202: the same fit at ``obs="off"`` and ``obs="trace"`` dispatches
    the same aten ops, op for op — the tracer and the metrics stay on the
    host and change no device work."""
    return {"off": _analysis_fit("off", device),
            "trace": _analysis_fit("trace", device)}


#: the obs layer's contract: instrumentation changes no device work
ANALYSIS_ENTRIES = [
    {"name": "obs.commwatch.traced_solve_reuse",
     "path": "src/repro_torch/obs/commwatch.py",
     "build": _analysis_obs_build,
     "same_ops": _analysis_obs_same_ops},
]
