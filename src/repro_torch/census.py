"""The port's spans and its run census.

Every span of the solve path opens through :func:`span`, and every
device-to-host read through :func:`host_sync` (:func:`event` marks a
point in time for the tracer alone):

  * while a ``torch.profiler`` records, a profiler range named
    ``repro.<name>`` opens (the low-overhead ``RecordFunction`` that
    ``torch.compile`` opens, ~1 us a range on a CPU core), so a device
    trace's idle gaps name the phase of the program the host was in;
  * while the obs tracer (``repro_torch.obs.trace``, imported and scoped
    by the caller's backend) records the span's level, a tracer span of
    the same name opens;
  * with neither, the call returns one shared no-op span: no clock read
    and no allocation.

This module imports nothing of ``repro_torch.obs``: ``obs="off"`` never
loads that package.

:data:`CENSUS` is what a run did, kept beside ``kernels.ops.LAUNCHES``
and zeroed with it by ``kernels.ops.reset_launches()``: the spans opened,
by name, and the host syncs, by site (``file:function``), always, as
Python ints; span seconds by name and sync seconds by site only while a
span is live (a profiler records, or the tracer takes the span).  Nothing
here launches device work or reads a device value, so a span cannot
change what the solve dispatches.
"""
from __future__ import annotations

import sys
import time

# the profiler's low-overhead range: the one torch.compile opens
from torch._C._profiler import _RecordFunctionFast as _profiler_range
from torch.autograd import profiler as _profiler

#: the obs tracer's module: looked up in ``sys.modules``, never imported
_OBS_TRACE = "repro_torch.obs.trace"

#: what a profiler range's name starts with
RANGE_PREFIX = "repro."

#: the span every host sync opens
HOST_SYNC = "host_sync"


class RunCensus:
    """Counts (always) and seconds (while spans are live) of one run."""
    __slots__ = ("spans", "syncs", "span_s", "sync_s")

    def __init__(self):
        self.spans: dict[str, int] = {}      # spans opened, by name
        self.syncs: dict[str, int] = {}      # host reads, by site
        self.span_s: dict[str, float] = {}   # live span seconds, by name
        self.sync_s: dict[str, float] = {}   # live sync seconds, by site

    def reset(self) -> None:
        for counts in (self.spans, self.syncs, self.span_s, self.sync_s):
            counts.clear()


#: the process's census (reset by ``kernels.ops.reset_launches``)
CENSUS = RunCensus()


class _NullSpan:
    """The shared span of a call that nothing records (the obs tracer's
    disabled levels return it too)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class _LiveSpan:
    """A profiler range and / or a tracer span, timed into the census."""
    __slots__ = ("_name", "_site", "_range", "_obs", "_t0")

    def __init__(self, name: str, site: str | None, rng, obs):
        self._name, self._site = name, site
        self._range, self._obs = rng, obs
        self._t0 = 0.0

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        if self._obs is not None:
            self._obs.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        c = CENSUS
        c.span_s[self._name] = c.span_s.get(self._name, 0.0) + dt
        if self._site is not None:
            c.sync_s[self._site] = c.sync_s.get(self._site, 0.0) + dt
        if self._obs is not None:
            self._obs.__exit__(*exc)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False

    def note(self, **attrs):
        """Attributes for the tracer's span (the profiler range takes
        none)."""
        if self._obs is not None:
            self._obs.note(**attrs)
        return self


def _tracer(level: str):
    """The obs tracer when it records ``level``, else None."""
    mod = sys.modules.get(_OBS_TRACE)
    if mod is None:
        return None
    tracer = mod.get_tracer()
    return tracer if tracer.enabled(level) else None


def _open(name: str, site: str | None, cat: str, level: str, attrs):
    profiling = _profiler._is_profiler_enabled
    tracer = _tracer(level)
    if tracer is None and not profiling:
        return NULL_SPAN
    rng = None
    if profiling:
        rng = _profiler_range(RANGE_PREFIX + name)
    obs = None
    if tracer is not None:
        if site is not None:
            attrs = {"site": site}
        obs = tracer.span(name, cat=cat, level=level, **attrs)
    return _LiveSpan(name, site, rng, obs)


def span(name: str, *, cat: str = "solver", level: str = "trace",
         **attrs):
    """``with span("ls_trial"): ...``; the tracer's span takes ``cat``,
    ``level`` and ``attrs`` (and ``note``), the profiler's range the
    name alone."""
    spans = CENSUS.spans
    spans[name] = spans.get(name, 0) + 1
    return _open(name, None, cat, level, attrs)


def host_sync(site: str, reads: int = 1):
    """``with host_sync("core/prox.py:prox_gradient"): v = t.tolist()``:
    counts ``reads`` device-to-host reads at ``site`` and opens a
    ``host_sync`` span around them (the site the tracer span's attribute
    and the census's key)."""
    c = CENSUS
    c.syncs[site] = c.syncs.get(site, 0) + reads
    c.spans[HOST_SYNC] = c.spans.get(HOST_SYNC, 0) + 1
    return _open(HOST_SYNC, site, "sync", "trace", None)


def event(name: str, *, cat: str = "solver", level: str = "trace",
          **attrs) -> None:
    """An instant event for the obs tracer, when it records ``level``
    (the profiler gets no range for a point in time)."""
    tracer = _tracer(level)
    if tracer is not None:
        tracer.event(name, cat=cat, level=level, **attrs)
