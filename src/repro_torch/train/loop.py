"""The training loop: data -> step -> metrics, with checkpoint and
resume, preemption handling, heartbeats and straggler monitoring.

Port of ``repro.train.loop``; used by ``launch/train.py`` and
``examples/torch_lm_train.py``.  It runs on one device, or with
``mesh=`` (a ``launch.mesh.Mesh`` of ranks) on every rank of the mesh:
the parameters and the AdamW moments sharded by the config's logical
rules (``_state_shardings``), the batch split over the batch rule's
axes, checkpoints gathered to one writer and restored onto any mesh.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..device import resolve_device
from ..models import lm, transformer as T
from ..models.config import ModelConfig
from . import checkpoint as ckpt
from .data import make_source
from .fault import Heartbeat, PreemptionGuard, StragglerMonitor
from .optim import AdamW, cosine_schedule


@dataclass
class TrainerConfig:
    seq_len: int = 512
    global_batch: int = 8
    n_micro: int = 1
    steps: int = 100
    peak_lr: float = 3e-4
    warmup: int = 10
    ckpt_dir: str = ""
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    heartbeat_path: str = ""


@dataclass
class TrainerResult:
    losses: list = field(default_factory=list)
    final_step: int = 0
    preempted: bool = False
    straggler_flags: int = 0
    # the port's own: the final lm.TrainState, each step's host wall
    # (seconds, the loss read included) and its metrics as device scalars
    # (read once the run is over, so a step still syncs once)
    state: object = None
    step_s: list = field(default_factory=list)
    metrics: list = field(default_factory=list)


def train(cfg: ModelConfig, tc: TrainerConfig, *, mesh=None, state=None,
          log=print, device=None) -> TrainerResult:
    """Run (or resume) a training job on ``device`` (default: the CUDA
    card; ``device="cpu"`` runs it on the host).

    AdamW (weight decay 0.1, clip 1.0) on the cosine schedule, the batch
    of each step from ``make_source``.  Without ``state`` it resumes from
    the latest checkpoint under ``tc.ckpt_dir`` if there is one, else
    starts from ``T.init_params(cfg, seed=tc.seed)``; a given ``state``
    (an ``lm.TrainState``) is trained in place, its loop counted from 0
    as the reference counts it.  One host sync per step (the loss, read
    as a float).  The result carries the final state.

    With ``mesh`` every rank of the mesh calls ``train``: the state holds
    the rank's blocks under ``_state_shardings`` (a given ``state`` must
    already; ``lm.shard_params_`` cuts a whole model), every rank draws
    the whole batch of a step and keeps its rows, and only rank 0 logs
    and beats the heartbeat.  At world size 1 the (1, 1) mesh computes
    exactly what ``mesh=None`` does."""
    dev = resolve_device(device)
    opt = AdamW(weight_decay=0.1, clip_norm=1.0)
    sched = cosine_schedule(tc.peak_lr, tc.warmup, tc.steps)
    specs = (_state_shardings(cfg, opt, mesh, tc) if mesh is not None
             else None)
    step_fn = lm.make_train_step(
        cfg, opt, sched, n_micro=tc.n_micro, mesh=mesh,
        specs=None if specs is None else specs.params)
    source = make_source(cfg, tc.seq_len, tc.global_batch, tc.seed, dev)
    if mesh is not None and mesh.rank != 0:
        log = _silent

    start_step = 0
    if state is None:
        params = T.init_params(cfg, seed=tc.seed, max_len=tc.seq_len,
                               device=dev)
        if mesh is not None:
            lm.shard_params_(params, specs.params, mesh)
        state = lm.init_train_state(params, opt)
        if tc.ckpt_dir and ckpt.latest_step(tc.ckpt_dir) is not None:
            state, manifest = ckpt.restore(tc.ckpt_dir, state,
                                           shardings=specs, mesh=mesh)
            start_step = manifest["step"]
            log(f"[train] resumed from step {start_step}")
    return _run(tc, step_fn, source, state, start_step, log, mesh, specs)


def _silent(*_args, **_kw) -> None:
    return None


def _run(tc, step_fn, source, state, start_step, log, mesh=None,
         specs=None):
    guard = PreemptionGuard().install()
    lead = mesh is None or mesh.rank == 0
    hb = (Heartbeat(tc.heartbeat_path) if tc.heartbeat_path and lead
          else None)
    mon = StragglerMonitor()
    res = TrainerResult()

    step = start_step
    try:
        while step < tc.steps:
            t0 = time.time()
            batch = source(step)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            res.losses.append(loss)
            dt = time.time() - t0
            res.step_s.append(dt)
            res.metrics.append(metrics)
            if mon.record(dt):
                res.straggler_flags += 1
                log(f"[straggler] step {step} took {dt:.2f}s "
                    f"(ewma {mon.ewma:.2f}s)")
            if hb:
                hb.beat(step, {"loss": loss})
            step += 1
            if tc.log_every and step % tc.log_every == 0:
                log(f"[train] step {step} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} {dt:.2f}s")
            stop_now = guard.should_stop
            if mesh is not None and mesh.size > 1:
                # every rank stops (and checkpoints) at the same step
                stop_now = mesh.any(stop_now)
            if tc.ckpt_dir and (step % tc.ckpt_every == 0 or
                                step == tc.steps or stop_now):
                ckpt.save(tc.ckpt_dir, step, state, data_cursor=step,
                          mesh=mesh, shardings=specs)
            if stop_now:
                log(f"[train] preempted at step {step}; checkpointed")
                res.preempted = True
                break
    finally:
        guard.uninstall()
    res.final_step = step
    res.state = state
    return res


def _state_shardings(cfg, opt, mesh, tc) -> lm.TrainState:
    """The train state's spec tree on ``mesh``: the parameters' and the
    moments' from the config's rules, the step counters replicated."""
    return lm.TrainState(lm.param_shardings(cfg, mesh, max_len=tc.seq_len),
                         lm.opt_shardings(cfg, mesh, opt,
                                          max_len=tc.seq_len), ())
