"""Batched multi-problem solve engine: many CONCORD solves in lock step.

Port of ``repro.core.batch``.  Two entry points:

  * ``solve_path_batched`` — a lam1 VECTOR against shared data (the
    regularization path / model-selection sweep); the data is one copy,
    only the penalty and the iterates carry a lane axis.
  * ``solve_batch`` — stacked ``(B, ...)`` datasets, each with its own
    penalty if desired.

Both run the reference's flat-step executor.  A FLAT STEP is one
line-search trial of every live lane: per-lane step sizes, per-lane
backtracking, per-lane convergence, exactly the trial sequence of the
sequential solve.  The trial is :func:`repro_torch.core.prox.ls_trial`,
the sequential loop's own, run on lane-stacked (C, p, p) iterates with
(C,) step sizes through lane-aware ops: elementwise work is batched, and
each lane's product and reductions run as the sequential solve runs them
(one GEMM and one dot per lane), so every lane of the compact schedule is
BIT-EXACTLY its sequential solve in float64.

``schedule="compact"`` (default): lanes in difficulty order
(``costmodel.predict_path_iters``), in waves of at most ``max_lanes``,
padded to a capacity tier ({1, 2, 3} x powers of two); steps run in
segments of at most ``chunk`` flat steps, and at each segment boundary
finished lanes are harvested and the live ones repacked to the front.
``schedule="monolithic"``: one wave of all lanes in input order, one
segment with no repacking; finished lanes freeze.  Its per-lane results
equal the compact schedule's.

What differs from the reference, which compiles each segment as one XLA
``while_loop``: a segment is a Python loop, and each flat step makes ONE
host sync (the accepted and finished flags of every lane, one
``tolist()``).  The host therefore knows the live lanes at every step,
so a frozen or padding lane pays no product and no reduction (the
reference computes every lane of the capacity and selects).  Accepted
lanes take their candidate IN PLACE, and repacking moves lanes in place,
so the lane buffers are allocated once per wave: the reference's
``jnp.where`` selects and gathers would allocate new (C, p, p) buffers
each step.

``use_pallas`` routes each flat step's gradient, prox and acceptance sums
through the fused path-step kernel (``kernels.pathstep``; Cov variant,
soft-threshold family, shared data): one launch for all C lanes.  Its
stats are summed in another order than the per-lane dots, so this route
is held to the plain one at a tolerance, not to the bit.

``gemm`` keeps the reference's names: ``"xla"`` is the product on the
solve's device (``torch.matmul``), ``"host"`` runs it through
``np.matmul`` on a host copy (Cov only, plain trial only).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..census import event, host_sync, span
from ..kernels import ops as kops
from . import costmodel
from .matops import DENSITY_DTYPE
from .objective import gradient_from_w
from .penalty import PenaltySpec, _as_numpy, lane_view, normalize_penalty
from .prox import (
    ProxResult,
    VariantOps,
    _analysis_cov,
    cov_ops,
    ls_trial,
    obs_ops,
    resolve_tau_schedule,
    tau_first,
    tau_start_lanes,
)

#: execution schedules of the batched engine
BATCH_SCHEDULES = ("compact", "monolithic")

#: flat steps per segment: boundaries are where the host repacks live
#: lanes, so smaller segments compact sooner
DEFAULT_CHUNK = 32

#: product routes of the flat step: "xla" on the solve's device, "host"
#: through np.matmul on a host copy (bit-stable across waves and lanes)
BATCH_GEMMS = ("xla", "host")


class _Lanes(NamedTuple):
    """Per-lane flat-step state (leading axis = padded capacity C).
    ``omega`` and ``aux`` are updated in place."""
    omega: torch.Tensor      # (C, p, p) current iterate
    aux: torch.Tensor        # (C, p, p) W = Omega S / (C, p, n) Y = Omega X^T
    g_val: torch.Tensor      # (C,) smooth objective at omega
    tau_try: torch.Tensor    # (C,) step size of the NEXT trial
    delta: torch.Tensor      # (C,) last relative change (inf before 1st)
    step: torch.Tensor       # (C,) int32 outer iterations completed
    trials: torch.Tensor     # (C,) int32 trials in the CURRENT iteration
    ls_total: torch.Tensor   # (C,) int32 cumulative trials
    stalled: torch.Tensor    # (C,) bool line search exhausted
    done: torch.Tensor       # (C,) bool frozen (converged/stalled/capped/pad)


class BatchRunStats(NamedTuple):
    """Compaction telemetry of one batched solve (host-side ints)."""
    schedule: str          # "compact" or "monolithic"
    n_lanes: int           # B, the number of real problems
    chunk: int             # flat steps per segment
    segments: int          # segments run
    waves: int             # max_lanes waves the grid was split into
    occupancy: tuple       # live real lanes at each executed flat step
    capacities: tuple      # padded capacity at each executed flat step
    order: tuple           # lane processing order (difficulty sort)
    gemm: str = "xla"      # flat-step product route (BATCH_GEMMS)
    pilot_lane: int = -1   # warm-start pilot lane index (-1 = none)

    @property
    def lane_steps(self) -> int:
        """Useful per-lane trials executed (sum of the occupancy line)."""
        return int(sum(self.occupancy))

    @property
    def padded_lane_steps(self) -> int:
        """Lane-trials of the padded schedule: what the reference's
        engine pays for (the port's products run on live lanes only)."""
        return int(sum(self.capacities))

    @property
    def mean_occupancy(self) -> float:
        """Fraction of the padded lane-steps doing useful work."""
        paid = self.padded_lane_steps
        return self.lane_steps / paid if paid else 1.0

    def summary(self) -> str:
        pilot = (f", pilot lane {self.pilot_lane}"
                 if self.pilot_lane >= 0 else "")
        return (f"[{self.schedule}/{self.gemm}] {self.n_lanes} lanes, "
                f"{self.segments} segments x {self.chunk} steps "
                f"({self.waves} wave{'s' if self.waves != 1 else ''}{pilot}), "
                f"occupancy {self.mean_occupancy:.0%} "
                f"({self.lane_steps}/{self.padded_lane_steps} lane-steps)")


def capacity_ladder(n_max: int) -> list:
    """Padded-capacity tiers {1, 2, 3} x powers of two up to ``n_max``."""
    tiers = set()
    k = 1
    while k <= n_max:
        tiers.add(k)
        if 3 * k // 2 <= n_max and (3 * k) % 2 == 0:
            tiers.add(3 * k // 2)
        k *= 2
    tiers.update({1, 2, 3} & set(range(1, n_max + 1)))
    return sorted(tiers)


def _capacity(n_live: int, b: int) -> int:
    """Smallest ladder tier >= n_live, never exceeding the grid size."""
    cap = 1
    while cap < n_live:
        cap = 3 * cap // 2 if cap % 2 == 0 and 3 * cap // 2 >= n_live \
            else cap * 2
    return min(cap, b) if cap >= n_live else b


# ---------------------------------------------------------------------------
# lane-aware variant ops
# ---------------------------------------------------------------------------

def _lane_data(data: dict, i: int) -> dict:
    """The sequential solve's data dict of lane ``i``."""
    out = {"lam2": data["lam2"][i]}
    for key in ("s", "x", "xt"):
        if key in data:
            out[key] = data[key][i] if data["stacked"] else data[key]
    return out


def _lane_ops(variant: str, live: list[int]) -> VariantOps:
    """``VariantOps`` on lane-stacked iterates.  Elementwise ops run on
    all C lanes at once; the product, the objective and the dots run per
    lane through the sequential ops (the same calls, so the same bits),
    for the ``live`` lanes only.  Other lanes get an inf objective, zero
    dots and an unwritten product: the trial is discarded for them."""
    seq = cov_ops() if variant == "cov" else obs_ops()
    key = "s" if variant == "cov" else "xt"

    def per_lane(fn, like: torch.Tensor, fill: float) -> torch.Tensor:
        out = torch.full((like.shape[0],), fill, dtype=like.dtype,
                         device=like.device)
        for i in live:
            out[i] = fn(i)
        return out

    def aux_of(omega, data):
        b = data[key]
        out = omega.new_empty(omega.shape[:-1] + (b.shape[-1],))
        host = data.get("host")
        for i in live:
            if host is not None:
                h = host[i] if data["stacked"] else host
                # gemm="host": the product runs on the host by design
                prod = np.matmul(omega[i].cpu().numpy(), h)  # ca: allow=CA106
                out[i].copy_(torch.from_numpy(prod))
            else:
                torch.matmul(omega[i], b[i] if data["stacked"] else b,
                             out=out[i])
        return out

    def g_of(omega, aux, data):
        return per_lane(lambda i: seq.g_of(omega[i], aux[i],
                                           _lane_data(data, i)),
                        omega, math.inf)

    def grad_of(omega, aux, data):
        if variant == "cov":
            return gradient_from_w(omega, aux,
                                   lane_view(data["lam2"], omega))
        grad = torch.empty_like(omega)
        for i in live:
            grad[i] = seq.grad_of(omega[i], aux[i], _lane_data(data, i))
        return grad

    def dot(a, b):
        return per_lane(lambda i: seq.dot(a[i], b[i]), a, 0.0)

    return VariantOps(aux_of, g_of, grad_of, dot, seq.prox)


def _trial_plain(lanes: _Lanes, data, spec, ops):
    grad = ops.grad_of(lanes.omega, lanes.aux, data)
    cand, aux_c, g_c, dot_dd, ok = ls_trial(
        ops, data, spec, lanes.omega, grad, lanes.g_val, lanes.tau_try)
    return cand, aux_c, g_c, dot_dd, ok, ops.dot(lanes.omega, lanes.omega)


def _trial_kernel(lanes: _Lanes, data, spec, ops):
    """The flat step through the fused path-step kernel: gradient, prox
    and the acceptance sums in one launch for all C lanes; the
    candidate's product and objective stay per lane."""
    tau = lanes.tau_try
    cand, stats = kops.fused_path_step(lanes.omega, lanes.aux, tau,
                                       spec.lam1, data["lam2"],
                                       weights=spec.weights)
    dot_dg, dot_dd = stats[:, 0], stats[:, 1]
    aux_c = ops.aux_of(cand, data)
    g_c = ops.g_of(cand, aux_c, data)
    ok = g_c <= lanes.g_val + dot_dg + dot_dd / (2.0 * tau)
    return cand, aux_c, g_c, dot_dd, ok, ops.dot(lanes.omega, lanes.omega)


def _apply_trial(lanes: _Lanes, trial, *, tol: float, max_iters: int,
                 max_ls: int, tau_schedule: str, tau_init: float):
    """Advance every live lane by ONE line-search trial: accept takes the
    candidate and starts the next outer iteration at the schedule's tau,
    reject halves tau, exhausting ``max_ls`` stalls the lane — the
    sequential backtracking semantics.  Returns the new state and the
    lanes' done flags on the host (the flat step's one sync)."""
    cand, aux_c, g_c, dot_dd, ok, nrm2 = trial
    live = ~lanes.done
    trials_new = lanes.trials + 1
    accept = live & ok
    exhaust = live & ~ok & (trials_new >= max_ls)
    reject = live & ~ok & (trials_new < max_ls)
    fin = accept | exhaust
    delta_acc = torch.sqrt(dot_dd) / torch.clamp_min(torch.sqrt(nrm2), 1.0)
    step_new = lanes.step + 1
    done_acc = (step_new >= max_iters) | (delta_acc < tol)
    tau_next = tau_start_lanes(tau_schedule, step_new, lanes.tau_try,
                               tau_init)
    new = lanes._replace(
        g_val=torch.where(accept, g_c, lanes.g_val),
        tau_try=torch.where(
            accept, tau_next,
            torch.where(reject, lanes.tau_try * 0.5, lanes.tau_try)),
        delta=torch.where(accept, delta_acc,
                          torch.where(exhaust, torch.zeros_like(delta_acc),
                                      lanes.delta)),
        step=torch.where(fin, step_new, lanes.step),
        trials=torch.where(fin, torch.zeros_like(trials_new),
                           torch.where(reject, trials_new, lanes.trials)),
        ls_total=torch.where(fin, lanes.ls_total + trials_new,
                             lanes.ls_total),
        stalled=lanes.stalled | exhaust,
        done=lanes.done | (accept & done_acc) | exhaust,
    )
    # the flat step's one host sync: which lanes took their candidate
    with host_sync("core/batch.py:_apply_trial"):
        accepted, done = torch.stack(  # ca: allow=CA106 (the step's sync)
            [accept, new.done]).tolist()
    with span("batch.accept", cat="engine"):
        for i, acc in enumerate(accepted):
            if acc:
                lanes.omega[i].copy_(cand[i])
                lanes.aux[i].copy_(aux_c[i])
    return new, done


def _init_lanes(omega0: torch.Tensor, data, n_real: int, done: list, *,
                variant: str, tau_schedule: str, tau_init: float) -> _Lanes:
    """Flat-step state at the warm starts: the product and objective of
    the real lanes (padding lanes copy the last real lane's product),
    first-trial tau from the schedule, counters zeroed, ``done`` the
    lanes' initial done flags."""
    c = omega0.shape[0]
    ops = _lane_ops(variant, list(range(n_real)))
    aux0 = ops.aux_of(omega0, data)
    for k in range(n_real, c):
        aux0[k].copy_(aux0[n_real - 1])
    g0 = ops.g_of(omega0, aux0, data)
    opts = dict(device=omega0.device)
    zeros = torch.zeros((c,), dtype=torch.int32, **opts)
    return _Lanes(
        omega=omega0, aux=aux0, g_val=g0,
        tau_try=torch.full((c,), tau_first(tau_schedule, tau_init),
                           dtype=omega0.dtype, **opts),
        delta=torch.full((c,), math.inf, dtype=omega0.dtype, **opts),
        step=zeros, trials=zeros.clone(), ls_total=zeros.clone(),
        stalled=torch.zeros((c,), dtype=torch.bool, **opts),
        done=torch.as_tensor(done, **opts),
    )


def _run_segment(lanes: _Lanes, done: list, data, spec, *, trial, variant,
                 steps: int, statics: dict):
    """Up to ``steps`` flat steps, ending early once every lane is done.
    Returns the state, the host done flags and the live-lane count of
    each executed step."""
    occ = []
    for _ in range(steps):
        live = [i for i, d in enumerate(done) if not d]
        if not live:
            break
        occ.append(len(live))
        with span("batch.flat_step", cat="engine"):
            ops = _lane_ops(variant, live)
            lanes, done = _apply_trial(lanes, trial(lanes, data, spec, ops),
                                       **statics)
    return lanes, done, occ


# ---------------------------------------------------------------------------
# lane bookkeeping
# ---------------------------------------------------------------------------

def _compact_(t: torch.Tensor, live, cap: int) -> torch.Tensor:
    """Move lanes ``live`` (ascending) of ``t`` to its front IN PLACE,
    pad to ``cap`` lanes with copies of the last, and return the
    (cap, ...) front view (no new buffer)."""
    m = len(live)
    for k, src in enumerate(live):
        if k != src:
            t[k].copy_(t[src])
    for k in range(m, cap):
        t[k].copy_(t[m - 1])
    return t[:cap]


def _broadcast_spec(spec: PenaltySpec, b: int,
                    like: torch.Tensor) -> PenaltySpec:
    """Every leaf as a tensor in ``like``'s dtype and device: scalar
    leaves broadcast to (B,) lanes; a shared (p, p) weight matrix stays
    one operand (no B copies); lane leaves must lead with B."""
    p = like.shape[-1]
    out = []
    for leaf, nd in zip(spec.leaves(), spec._expected_ndims()):
        t = torch.as_tensor(leaf, dtype=like.dtype, device=like.device)
        if t.ndim == nd and nd == 0:
            t = t.expand(b)
        elif t.ndim != nd and (t.ndim != nd + 1 or t.shape[0] != b):
            raise ValueError(
                f"penalty leaf of base ndim {nd} has shape "
                f"{tuple(t.shape)}; expected that or a (B={b},)-leading "
                f"batch of it")
        if nd == 2 and tuple(t.shape[-2:]) != (p, p):
            raise ValueError(f"penalty weights shape {tuple(t.shape)} must "
                             f"end in the problem dimension ({p}, {p})")
        out.append(t)
    return spec.replace_leaves(out)


def _take_spec(spec: PenaltySpec, idx: torch.Tensor) -> PenaltySpec:
    """Lanes ``idx`` of every lane leaf (a new buffer per leaf)."""
    return spec.replace_leaves([
        leaf.index_select(0, idx) if leaf.ndim == nd + 1 else leaf
        for leaf, nd in zip(spec.leaves(), spec._expected_ndims())])


def _compact_spec(spec: PenaltySpec, live, cap: int) -> PenaltySpec:
    return spec.replace_leaves([
        _compact_(leaf, live, cap) if leaf.ndim == nd + 1 else leaf
        for leaf, nd in zip(spec.leaves(), spec._expected_ndims())])


def _difficulty_order(spec: PenaltySpec, b: int, max_iters: int,
                      sort_lanes: bool) -> np.ndarray:
    """Processing order: hardest (most predicted iterations) first, so the
    easy tail of a wave drains together and compaction shrinks capacity
    early.  Without per-lane lam1 (or with sorting off): input order."""
    if sort_lanes:
        lam1 = np.asarray(_as_numpy(spec.lam1), np.float64)
        if lam1.shape == (b,) and np.all(np.isfinite(lam1)) \
                and np.all(lam1 > 0):
            pred = costmodel.predict_path_iters(lam1, max_iters=max_iters)
            return np.argsort(-pred, kind="stable").astype(np.int64)
    return np.arange(b, dtype=np.int64)


def _wave_data(arr_w, ridge_w, variant: str, stacked: bool,
               host: bool) -> dict:
    data = {"lam2": ridge_w, "stacked": stacked}
    if variant == "cov":
        data["s"] = arr_w
        if host:
            data["host"] = arr_w.cpu().numpy()
    else:
        data["x"] = arr_w
        data["xt"] = arr_w.mT.contiguous()
    return data


def _solve_lanes(arr, spec, ridge, omega0, *, variant, tol, max_iters,
                 max_ls, tau_schedule, chunk, max_lanes, sort_lanes,
                 stacked, use_pallas, gemm="xla", warm_start=None,
                 schedule="compact"):
    """Host driver of both schedules: waves, segments of flat steps,
    harvest of finished lanes at segment boundaries, in-place repacking
    of the live ones, and the results in input order."""
    if variant not in ("cov", "obs"):
        raise ValueError(f"unknown variant {variant!r}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if gemm not in BATCH_GEMMS:
        raise ValueError(f"gemm must be one of {BATCH_GEMMS}, got {gemm!r}")
    if gemm == "host" and variant != "cov":
        raise ValueError("gemm='host' supports variant='cov' only")
    if gemm == "host" and use_pallas:
        raise ValueError("gemm='host' and use_pallas are mutually "
                         "exclusive (the path-step kernel feeds the "
                         "device product)")
    if warm_start not in (None, "pilot"):
        raise ValueError(f"warm_start must be None or 'pilot', "
                         f"got {warm_start!r}")
    if warm_start == "pilot" and omega0 is not None:
        raise ValueError("warm_start='pilot' picks its own warm starts; "
                         "pass either it or omega0, not both")
    dtype, dev = arr.dtype, arr.device
    p = arr.shape[-1]
    b = np.shape(spec.lam1)[0]        # the lane count, with no host copy
    spec_b = _broadcast_spec(spec, b, arr)
    ridge_b = torch.as_tensor(ridge, dtype=dtype, device=dev).expand(b)
    if omega0 is None:
        om_b = torch.eye(p, dtype=dtype, device=dev).expand(b, p, p)
    else:
        omega0 = torch.as_tensor(omega0, dtype=dtype, device=dev)
        om_b = omega0.expand(b, p, p)

    monolithic = schedule == "monolithic"
    order = (np.arange(b, dtype=np.int64) if monolithic
             else _difficulty_order(spec, b, max_iters, sort_lanes))
    wave_size = b if (max_lanes is None or monolithic) \
        else max(1, int(max_lanes))
    pilot_lane = -1
    if warm_start == "pilot" and b > 1:
        pilot_lane = int(order[len(order) // 2])
        rest = order[order != pilot_lane]
        waves = [np.asarray([pilot_lane], np.int64)]
        waves += [rest[i:i + wave_size] for i in range(0, b - 1, wave_size)]
    else:
        waves = [order[i:i + wave_size] for i in range(0, b, wave_size)]
    kernel = (use_pallas and variant == "cov" and spec.kernel_ok
              and not stacked)
    trial = _trial_kernel if kernel else _trial_plain
    statics = dict(tol=tol, max_iters=max_iters, max_ls=max_ls,
                   tau_schedule=tau_schedule, tau_init=1.0)
    steps = max_iters * max_ls if monolithic else chunk

    omega_out = torch.empty((b, p, p), dtype=dtype, device=dev)
    scal_out = np.zeros((b, 6))      # iters, ls_total, g, delta, stalled, conv
    occupancy: list = []
    capacities: list = []
    segments = 0

    def harvest(state: _Lanes, done: list, cur_ids: np.ndarray) -> None:
        slots = [k for k, d in enumerate(done) if d and cur_ids[k] >= 0]
        if not slots:
            return
        # one host sync per segment that finished a lane: its counters
        with host_sync("core/batch.py:harvest"):
            rows = torch.stack([  # ca: allow=CA106 (the segment's sync)
                state.step.to(torch.float64),
                state.ls_total.to(torch.float64),
                state.g_val.to(torch.float64),
                state.delta.to(torch.float64),
                state.stalled.to(torch.float64)]).tolist()
        for k in slots:
            lane = int(cur_ids[k])
            omega_out[lane].copy_(state.omega[k])
            it, ls, g, delta, stall = (r[k] for r in rows)
            scal_out[lane] = (it, ls, g, delta, stall,
                              float(delta < tol and not stall))

    for wave_idx, wave in enumerate(waves):
        ids = np.asarray(wave, np.int64)
        cap = b if monolithic else _capacity(len(ids), b)
        event("batch.wave", cat="batch", wave=wave_idx, lanes=len(ids))
        pad_idx = np.concatenate(
            [ids, np.full(cap - len(ids), ids[-1], np.int64)])
        idx = torch.as_tensor(pad_idx, device=dev)
        arr_w = arr.index_select(0, idx) if stacked else arr
        ridge_w = ridge_b.index_select(0, idx)
        spec_w = _take_spec(spec_b, idx)
        data = _wave_data(arr_w, ridge_w, variant, stacked, gemm == "host")
        done = [k >= len(ids) or max_iters <= 0 for k in range(cap)]
        state = _init_lanes(om_b.index_select(0, idx), data, len(ids), done,
                            variant=variant, tau_schedule=tau_schedule,
                            tau_init=1.0)
        cur_ids = pad_idx.copy()
        cur_ids[len(ids):] = -1

        while True:
            # a host numpy array: no device sync
            n_real = int(np.count_nonzero(cur_ids >= 0))  # ca: allow=CA106
            with span("batch.segment", cat="batch", segment=segments,
                      wave=wave_idx, lanes=n_real, cap=cap):
                state, done, occ = _run_segment(
                    state, done, data, spec_w, trial=trial, variant=variant,
                    steps=steps, statics=statics)
            segments += 1
            occupancy.extend(min(v, n_real) for v in occ)
            capacities.extend([cap] * len(occ))
            with span("batch.harvest", cat="engine"):
                harvest(state, done, cur_ids)
            live = [k for k, d in enumerate(done) if not d]
            if not live:
                break
            with span("batch.repack", cat="engine"):
                new_cap = _capacity(len(live), b)
                slot_list = live + [live[-1]] * (new_cap - len(live))
                slots = torch.as_tensor(slot_list, device=dev)
                state = _Lanes(
                    _compact_(state.omega, live, new_cap),
                    _compact_(state.aux, live, new_cap),
                    *(t.index_select(0, slots) for t in state[2:]))
                done = [k >= len(live) for k in range(new_cap)]
                state = state._replace(
                    done=torch.as_tensor(done, device=dev))
                if stacked:
                    arr_w = _compact_(arr_w, live, new_cap)
                ridge_w = ridge_w.index_select(0, slots)
                spec_w = _compact_spec(spec_w, live, new_cap)
                data = _wave_data(arr_w, ridge_w, variant, stacked,
                                  gemm == "host")
                cur_ids = cur_ids[slot_list]
                cur_ids[len(live):] = -1
                cap = new_cap
        del state, data

        if pilot_lane >= 0 and wave_idx == 0:
            om_b = omega_out[pilot_lane].expand(b, p, p)

    def col(j: int, dt: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(scal_out[:, j], device=dev).to(dt)

    res = ProxResult(
        omega=omega_out,
        iters=col(0, torch.int32), ls_total=col(1, torch.int32),
        converged=col(5, torch.bool), g_final=col(2, dtype),
        delta_final=col(3, dtype), stalled=col(4, torch.bool),
        block_density=torch.ones((b,), dtype=DENSITY_DTYPE, device=dev))
    if monolithic:
        stats = BatchRunStats(schedule="monolithic", n_lanes=b, chunk=0,
                              segments=1, waves=1, occupancy=(),
                              capacities=(), order=tuple(range(b)))
    else:
        stats = BatchRunStats(
            schedule="compact", n_lanes=b, chunk=chunk, segments=segments,
            waves=len(waves), occupancy=tuple(occupancy),
            capacities=tuple(capacities), order=tuple(int(i) for i in order),
            gemm=gemm, pilot_lane=pilot_lane)
    return res, stats


def _check_schedule(schedule: str) -> None:
    if schedule not in BATCH_SCHEDULES:
        raise ValueError(f"schedule must be one of {BATCH_SCHEDULES}, "
                         f"got {schedule!r}")


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def solve_path_batched(
    s_or_x: torch.Tensor,
    lam1_grid,
    lam2: float = 0.0,
    *,
    penalty: PenaltySpec | str | None = None,
    omega0: torch.Tensor | None = None,
    variant: str = "cov",
    tol: float = 1e-5,
    max_iters: int = 500,
    max_ls: int = 30,
    warm_start_tau: bool = False,
    tau_schedule: str | None = None,
    schedule: str = "compact",
    chunk: int = DEFAULT_CHUNK,
    max_lanes: int | None = None,
    sort_lanes: bool = True,
    use_pallas: bool = False,
    gemm: str = "xla",
    warm_start: str | None = None,
    return_stats: bool = False,
):
    """Solve a whole lam1 grid against SHARED data, on ``s_or_x``'s device.

    ``s_or_x`` is the (p, p) sample covariance (variant="cov") or the
    (n, p) observations (variant="obs"); ``lam1_grid`` is the (B,)
    penalty vector.  ``penalty`` swaps the penalty family for the whole
    grid (its lam1 is replaced by the grid; other parameters — a SCAD
    shape, a (p, p) or per-lane (B, p, p) weight matrix — are shared or
    per lane).  ``omega0`` is None (identity), one (p, p) warm start, or
    stacked (B, p, p).  Returns a :class:`ProxResult` whose every field
    carries a leading (B,) axis — per-lane values bit-exactly those of B
    sequential solves — or ``(result, BatchRunStats)`` with
    ``return_stats``.

    ``schedule``/``chunk``/``max_lanes``/``sort_lanes`` pick and tune the
    schedule; ``tau_schedule`` the per-lane step-size schedule;
    ``use_pallas`` the fused path-step kernel (Cov, soft-threshold
    family; held to the plain route at a tolerance); ``gemm="host"`` the
    host product; ``warm_start="pilot"`` solves the median-difficulty
    lane first and warm-starts the rest from it.
    """
    arr = torch.as_tensor(s_or_x)
    grid = np.asarray(_as_numpy(lam1_grid), np.float64)
    if grid.ndim != 1:
        raise ValueError(f"lam1_grid must be 1-D, got shape {grid.shape}")
    grid_t = torch.as_tensor(grid, dtype=arr.dtype, device=arr.device)
    if penalty is None:
        spec, ridge = PenaltySpec("l1", grid_t), lam2
    else:
        # the grid IS the strength here, so a string form needs only its
        # kind/shape — a placeholder lam1 that the grid replaces
        base = normalize_penalty(
            penalty, 0.0 if isinstance(penalty, str) else None, lam2)
        spec, ridge = base.with_lam1(grid_t), base.lam2
    _check_schedule(schedule)
    if schedule == "monolithic":
        if gemm != "xla" or warm_start is not None:
            raise ValueError("gemm/warm_start are compact-schedule knobs; "
                             "schedule='monolithic' supports neither")
        use_pallas = False      # the reference's monolithic engine is jnp
    res, stats = _solve_lanes(
        arr, spec, ridge, omega0, variant=variant, tol=tol,
        max_iters=max_iters, max_ls=max_ls,
        tau_schedule=resolve_tau_schedule(tau_schedule, warm_start_tau),
        chunk=chunk, max_lanes=max_lanes, sort_lanes=sort_lanes,
        stacked=False, use_pallas=use_pallas, gemm=gemm,
        warm_start=warm_start, schedule=schedule)
    return (res, stats) if return_stats else res


def solve_batch(
    s_or_x: torch.Tensor,
    lam1=None,
    lam2=0.0,
    *,
    penalty: PenaltySpec | str | None = None,
    omega0: torch.Tensor | None = None,
    variant: str = "cov",
    tol: float = 1e-5,
    max_iters: int = 500,
    max_ls: int = 30,
    warm_start_tau: bool = False,
    tau_schedule: str | None = None,
    schedule: str = "compact",
    chunk: int = DEFAULT_CHUNK,
    max_lanes: int | None = None,
    sort_lanes: bool = True,
    gemm: str = "xla",
    return_stats: bool = False,
):
    """Solve B stacked independent problems, on ``s_or_x``'s device.

    ``s_or_x`` is (B, p, p) stacked covariances (variant="cov") or
    (B, n, p) stacked observations (variant="obs").  ``lam1``/``lam2``
    are scalars (shared) or (B,) vectors; ``penalty`` instead carries the
    whole spec, any of whose numeric leaves may be (B,)-batched.
    ``omega0`` is None, one (p, p) start, or stacked (B, p, p).  Returns
    a :class:`ProxResult` with a leading (B,) axis on every field (or
    ``(result, BatchRunStats)`` with ``return_stats``); the other knobs
    are as in :func:`solve_path_batched`.
    """
    arr = torch.as_tensor(s_or_x)
    if arr.ndim != 3:
        raise ValueError(
            f"solve_batch expects stacked (B, n|p, p) data, got shape "
            f"{tuple(arr.shape)}")
    b = arr.shape[0]
    spec = normalize_penalty(penalty, lam1, lam2)
    opts = dict(dtype=arr.dtype, device=arr.device)
    spec = spec.with_lam1(torch.as_tensor(spec.lam1, **opts).expand(b))
    ridge = torch.as_tensor(spec.lam2, **opts).expand(b)
    _check_schedule(schedule)
    if schedule == "monolithic" and gemm != "xla":
        raise ValueError("gemm is a compact-schedule knob; "
                         "schedule='monolithic' always runs on the device")
    res, stats = _solve_lanes(
        arr, spec, ridge, omega0, variant=variant, tol=tol,
        max_iters=max_iters, max_ls=max_ls,
        tau_schedule=resolve_tau_schedule(tau_schedule, warm_start_tau),
        chunk=chunk, max_lanes=max_lanes, sort_lanes=sort_lanes,
        stacked=True, use_pallas=False, gemm=gemm, schedule=schedule)
    return (res, stats) if return_stats else res


# ---------------------------------------------------------------------------
# analysis manifest (repro_torch.analysis.dispatchpass)
# ---------------------------------------------------------------------------

def _analysis_path(device):
    return {"fn": solve_path_batched,
            "args": (_analysis_cov(6, device), [0.1, 0.2, 0.3]),
            "kwargs": dict(tol=1e-3, max_iters=5, max_ls=5,
                           schedule="monolithic")}


def _analysis_batch(device):
    s = torch.stack([_analysis_cov(6, device)] * 2)
    return {"fn": solve_batch, "args": (s, [0.1, 0.2]),
            "kwargs": dict(tol=1e-3, max_iters=5, max_ls=5)}


def _analysis_chunk(device):
    """The compact engine's segments of 3 flat steps through the fused
    path-step trial (the kernel on the card)."""
    return {"fn": solve_path_batched,
            "args": (_analysis_cov(6, device), [0.1, 0.2, 0.3]),
            "kwargs": dict(tol=1e-3, max_iters=4, max_ls=4,
                           schedule="compact", chunk=3, use_pallas=True)}


#: the batched lambda-path and multi-problem engines: the reference's
#: monolithic path, stacked problems, and the compact engine's chunks
ANALYSIS_ENTRIES = [
    {"name": "core.batch.solve_path_batched",
     "path": "src/repro_torch/core/batch.py", "build": _analysis_path},
    {"name": "core.batch.solve_batch",
     "path": "src/repro_torch/core/batch.py", "build": _analysis_batch},
    {"name": "core.batch.path_chunk",
     "path": "src/repro_torch/core/batch.py", "build": _analysis_chunk},
]
