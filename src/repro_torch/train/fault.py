"""Fault-tolerance machinery: preemption handling, heartbeats, straggler
detection and bounded retry.

Port of ``repro.train.fault``; host-side, carried over as it is.

 * ``PreemptionGuard``: a SIGTERM/SIGINT handler that flips a flag; the
   training loop polls it, checkpoints and exits cleanly.
 * ``Heartbeat``: writes ``{step, time}`` to a file every step; an
   external watchdog restarts a worker whose heartbeat goes stale, and
   the deterministic data pipeline (``train/data.py``) makes the restart
   exact from the last checkpoint.
 * ``StragglerMonitor``: an EWMA of the step time; flags steps slower
   than ``threshold`` times it.
 * ``retry``: bounded retry with exponential backoff for transient
   failures.
"""
from __future__ import annotations

import json
import os
import signal
import time
from dataclasses import dataclass, field


class PreemptionGuard:
    """Installs signal handlers; ``should_stop`` polled by the loop."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._flag = False
        self._prev = {}
        self._signals = signals

    def install(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def _handler(self, signum, frame):
        self._flag = True

    @property
    def should_stop(self) -> bool:
        return self._flag

    def uninstall(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


@dataclass
class Heartbeat:
    path: str
    host_id: int = 0

    def beat(self, step: int, extra: dict | None = None):
        rec = {"host": self.host_id, "step": step, "time": time.time()}
        if extra:
            rec.update(extra)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.path)

    def read(self) -> dict | None:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def is_stale(self, timeout_s: float) -> bool:
        rec = self.read()
        return rec is None or (time.time() - rec["time"]) > timeout_s


@dataclass
class StragglerMonitor:
    """EWMA step-time tracker with a relative slowness threshold."""
    alpha: float = 0.1
    threshold: float = 2.0
    ewma: float | None = None
    history: list = field(default_factory=list)

    def record(self, step_time: float) -> bool:
        """Returns True when this step looks straggler-slow."""
        self.history.append(step_time)
        if self.ewma is None:
            self.ewma = step_time
            return False
        slow = step_time > self.threshold * self.ewma
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time
        return slow

    @property
    def median(self) -> float:
        h = sorted(self.history)
        return h[len(h) // 2] if h else 0.0


def retry(fn, *args, attempts: int = 3, backoff_s: float = 0.5,
          exceptions=(OSError, IOError), **kw):
    """Bounded retry with exponential backoff for transient failures."""
    for i in range(attempts):
        try:
            return fn(*args, **kw)
        except exceptions:
            if i == attempts - 1:
                raise
            time.sleep(backoff_s * (2 ** i))
