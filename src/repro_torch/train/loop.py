"""The training loop: data -> step -> metrics, with checkpoint and
resume, preemption handling, heartbeats and straggler monitoring.

Port of ``repro.train.loop``; used by ``launch/train.py`` and
``examples/torch_lm_train.py``.  It runs on one device.  The
reference's ``mesh=`` (parameters, optimizer state and batch sharded by
the config's logical rules) waits for the multi-rank training slice.
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


def train(cfg: ModelConfig, tc: TrainerConfig, *, state=None, log=print,
          device=None) -> TrainerResult:
    """Run (or resume) a training job on ``device`` (default: the CUDA
    card; ``device="cpu"`` runs it on the host).

    AdamW (weight decay 0.1, clip 1.0) on the cosine schedule, the batch
    of each step from ``make_source``.  Without ``state`` it resumes from
    the latest checkpoint under ``tc.ckpt_dir`` if there is one, else
    starts from ``T.init_params(cfg, seed=tc.seed)``; a given ``state``
    (an ``lm.TrainState``) is trained in place, its loop counted from 0
    as the reference counts it.  One host sync per step (the loss, read
    as a float).  The result carries the final state."""
    dev = resolve_device(device)
    opt = AdamW(weight_decay=0.1, clip_norm=1.0)
    sched = cosine_schedule(tc.peak_lr, tc.warmup, tc.steps)
    step_fn = lm.make_train_step(cfg, opt, sched, n_micro=tc.n_micro)
    source = make_source(cfg, tc.seq_len, tc.global_batch, tc.seed, dev)

    start_step = 0
    if state is None:
        params = T.init_params(cfg, seed=tc.seed, max_len=tc.seq_len,
                               device=dev)
        state = lm.init_train_state(params, opt)
        if tc.ckpt_dir and ckpt.latest_step(tc.ckpt_dir) is not None:
            state, manifest = ckpt.restore(tc.ckpt_dir, state)
            start_step = manifest["step"]
            log(f"[train] resumed from step {start_step}")
    return _run(tc, step_fn, source, state, start_step, log)


def _run(tc, step_fn, source, state, start_step, log):
    guard = PreemptionGuard().install()
    hb = Heartbeat(tc.heartbeat_path) if tc.heartbeat_path else None
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
            if tc.ckpt_dir and (step % tc.ckpt_every == 0 or
                                step == tc.steps or stop_now):
                ckpt.save(tc.ckpt_dir, step, state, data_cursor=step)
            if stop_now:
                log(f"[train] preempted at step {step}; checkpointed")
                res.preempted = True
                break
    finally:
        guard.uninstall()
    res.final_step = step
    res.state = state
    return res
