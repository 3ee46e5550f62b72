"""Host-side span/event tracer with ring buffer and trace exporters.

Port of ``repro.obs.trace``, with the same span names, attribute keys
and file formats, so a trace written by either package loads in the
other.  Spans mark host-boundary work (a solve dispatch, a path, a
Gram chunk update, a serve group); instant events mark
points in time.  Everything is recorded on the host: a span starts at
``time.time_ns()``, the Unix-epoch clock ``torch.profiler`` (kineto)
stamps its events with, so an export lays over a profiler trace of the
same run, and lasts what ``time.perf_counter`` measures.  The tracer
launches nothing on the device and reads no device value, so turning it
on cannot change a solve's arithmetic.  A span around device work
measures the host's view of it; the callers close such spans after a
device sync where the time of the work itself is meant.

The solve path opens its spans through ``repro_torch.census.span``,
which opens this tracer's span and a profiler range of the same name.

Two verbosity levels nest the taxonomy:

  * ``"summary"`` — one span per coarse unit of work (solve, path
    point, request).  Cheap enough to leave on in production.
  * ``"trace"``  — adds fine-grained spans (the dispatch vs execute
    split of a solve, per-chunk Gram updates).

``mode="off"`` short-circuits every call through a shared no-op span —
no allocation, no clock read.

Exporters: :meth:`Tracer.export_jsonl` (one JSON object per line) and
:meth:`Tracer.export_chrome` (Perfetto / ``chrome://tracing``
``trace_event`` JSON); :func:`load_chrome` and :func:`load_jsonl` read
both back for round-trip tests and ``python -m repro_torch.obs.cli``.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field

from ..census import NULL_SPAN as _NULL_SPAN

MODES = ("off", "summary", "trace")
_LEVEL_RANK = {"off": 0, "summary": 1, "trace": 2}

#: ring-buffer capacity: old spans fall off rather than growing without
#: bound in an always-on service
RING_CAPACITY = 4096


@dataclass
class Span:
    """One recorded span (``phase="span"``) or instant event
    (``phase="instant"``).  ``t_start`` is Unix-epoch seconds
    (:func:`now`), ``duration`` seconds of ``time.perf_counter``."""
    name: str
    cat: str = "solver"
    t_start: float = 0.0
    duration: float = 0.0
    level: str = "summary"
    phase: str = "span"
    args: dict = field(default_factory=dict)

    def note(self, **attrs) -> "Span":
        """Attach attributes discovered while the span is open (iteration
        counts, convergence flags, ...)."""
        self.args.update(attrs)
        return self

    def to_json(self) -> dict:
        return {
            "name": self.name, "cat": self.cat, "ph": self.phase,
            "t_start": self.t_start, "duration": self.duration,
            "level": self.level, "args": dict(self.args),
        }

    def to_chrome(self, pid: int = 0, tid: int = 0) -> dict:
        """Perfetto ``trace_event``: complete event ("X") for spans,
        instant event ("i") for point events; timestamps in us."""
        ev = {
            "name": self.name, "cat": self.cat,
            "ts": self.t_start * 1e6, "pid": pid, "tid": tid,
            "args": {**self.args, "level": self.level},
        }
        if self.phase == "span":
            ev["ph"] = "X"
            ev["dur"] = self.duration * 1e6
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        return ev


def now() -> float:
    """Unix-epoch seconds: the clock of kineto's event timestamps."""
    return time.time_ns() * 1e-9


class _LiveSpan:
    """Context manager recording one span into the tracer's ring on
    exit (completion order; Chrome sorts by ``ts`` on import)."""
    __slots__ = ("_tracer", "_span", "_t0")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span
        self._t0 = 0.0

    def __enter__(self) -> Span:
        self._span.t_start = now()
        self._t0 = time.perf_counter()
        return self._span

    def __exit__(self, *exc):
        self._span.duration = time.perf_counter() - self._t0
        self._tracer._record(self._span)
        return False

    def note(self, **attrs):
        self._span.note(**attrs)
        return self


class Tracer:
    """Mode-gated span recorder over a bounded ring buffer."""

    def __init__(self, mode: str = "off", capacity: int = RING_CAPACITY):
        self._mode = "off"
        self.set_mode(mode)
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    # -- mode ------------------------------------------------------------
    @property
    def mode(self) -> str:
        return self._mode

    def set_mode(self, mode: str) -> None:
        if mode not in MODES:
            raise ValueError(f"obs mode must be one of {MODES}, got {mode!r}")
        self._mode = mode

    def enabled(self, level: str = "summary") -> bool:
        return _LEVEL_RANK[self._mode] >= _LEVEL_RANK.get(level, 99)

    @contextmanager
    def scoped(self, mode: str):
        """Temporarily run the tracer at ``mode`` (how a backend applies
        ``SolverConfig.obs`` for the duration of one solve)."""
        prev = self._mode
        self.set_mode(mode)
        try:
            yield self
        finally:
            self._mode = prev

    # -- recording -------------------------------------------------------
    def span(self, name: str, *, cat: str = "solver",
             level: str = "summary", **attrs):
        """``with tracer.span("fit", p=64) as s: ... s.note(iters=12)``"""
        if not self.enabled(level):
            return _NULL_SPAN
        return _LiveSpan(self, Span(name=name, cat=cat, level=level,
                                    args=dict(attrs)))

    def event(self, name: str, *, cat: str = "solver",
              level: str = "summary", **attrs) -> None:
        if not self.enabled(level):
            return
        self._record(Span(name=name, cat=cat, t_start=now(),
                          duration=0.0, level=level, phase="instant",
                          args=dict(attrs)))

    def _record(self, span: Span) -> None:
        with self._lock:
            self._events.append(span)

    # -- inspection ------------------------------------------------------
    def snapshot(self) -> tuple:
        """Point-in-time copy of the ring (oldest first)."""
        with self._lock:
            return tuple(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        return len(self._events)

    # -- export ----------------------------------------------------------
    def export_jsonl(self, path) -> int:
        spans = self.snapshot()
        with open(path, "w", encoding="utf-8") as f:
            for s in spans:
                f.write(json.dumps(s.to_json()) + "\n")
        return len(spans)

    def export_chrome(self, path, *, pid: int = 0) -> int:
        spans = self.snapshot()
        doc = {
            "displayTimeUnit": "ms",
            "traceEvents": [s.to_chrome(pid=pid) for s in spans],
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
        return len(spans)


def _span_from_json(d: dict) -> Span:
    return Span(name=d["name"], cat=d.get("cat", "solver"),
                t_start=d["t_start"], duration=d["duration"],
                level=d.get("level", "summary"),
                phase=d.get("ph", "span"), args=dict(d.get("args", ())))


def load_jsonl(path) -> list:
    with open(path, encoding="utf-8") as f:
        return [_span_from_json(json.loads(line))
                for line in f if line.strip()]


def load_chrome(path) -> list:
    """Read a Chrome-trace export back into :class:`Span` records (the
    inverse of :meth:`Tracer.export_chrome`, up to float round-trip)."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    spans = []
    for ev in doc.get("traceEvents", ()):
        args = dict(ev.get("args", ()))
        level = args.pop("level", "summary")
        spans.append(Span(
            name=ev["name"], cat=ev.get("cat", "solver"),
            t_start=ev["ts"] / 1e6,
            duration=ev.get("dur", 0.0) / 1e6,
            level=level,
            phase="span" if ev.get("ph") == "X" else "instant",
            args=args))
    return spans


# ---------------------------------------------------------------------------
# process-global tracer (created lazily: obs="off" paths never touch it)
# ---------------------------------------------------------------------------

_TRACER: Tracer | None = None


def get_tracer() -> Tracer:
    global _TRACER
    if _TRACER is None:
        _TRACER = Tracer()
    return _TRACER
