"""The device trace of a window: busy time, time by kernel, idle gaps.

``torch.profiler`` (CUPTI on the card) records the window; this module
reads the recorded events once, in bulk, from the profiler's raw kineto
results rather than building an event object per record.

* busy: the union of the device intervals (kernels, copies, sets);
* kernels: total device seconds and count per name;
* idle gaps: the stretches of the window with nothing on the device,
  each named by the innermost host operation or range running at its
  middle, summed per name.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)   # name -> [seconds, count]
    gaps: dict = field(default_factory=dict)      # host name -> seconds

    def seconds_of(self, *patterns: str) -> tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds any
        of ``patterns`` (case-insensitive)."""
        pats = [p.lower() for p in patterns]
        secs, count = 0.0, 0
        for name, (s, c) in self.kernels.items():
            low = name.lower()
            if any(p in low for p in pats):
                secs += s
                count += c
        return secs, count

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v[0]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


@contextlib.contextmanager
def profiled(enabled: bool, device_type: str):
    """A profiler over the block when ``enabled`` (CPU activity, plus the
    device's on a card), else nothing; yields the profiler or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def _raw_events(prof):
    """(name, is_device, start_ns, end_ns) of every recorded event."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:
            start, dur = e.start_us() * 1000, e.duration_us() * 1000
        out.append((e.name(), e.device_type() != DeviceType.CPU,
                    int(start), int(start) + int(dur)))
    return out


#: the host range the window loops run under; it bounds the traced window
WINDOW_RANGE = "hpbench.window"

#: idle gaps named one by one, longest first; the rest are summed apart
NAMED_GAPS = 512


def summarize(prof) -> TraceSummary:
    """Reduce the profiler's events over the ``WINDOW_RANGE`` range."""
    events = _raw_events(prof)
    host = [(n, s, e) for n, d, s, e in events
            if not d and e > s and n != WINDOW_RANGE]
    # a host range (record_function) has a device-side twin of the same
    # name spanning its work; only kernels, copies and sets are device work
    ranges = {n for n, d, _, _ in events if not d}
    dev = [(n, s, e) for n, d, s, e in events
           if d and e > s and n not in ranges]
    marks = [(s, e) for n, d, s, e in events if n == WINDOW_RANGE]
    if not marks:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE!r} range")
    w0, w1 = marks[0]
    kernels: dict = {}
    dev = [(n, s, e) for n, s, e in dev if e > w0 and s < w1]
    for name, s, e in dev:
        slot = kernels.setdefault(name, [0.0, 0])
        slot[0] += (e - s) * 1e-9
        slot[1] += 1
    # union of device intervals, and the gaps between them
    iv = sorted((max(s, w0), min(e, w1)) for _, s, e in dev)
    busy, gaps, cur = 0, [], w0
    for s, e in iv:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if w1 > cur:
        gaps.append((cur, w1))
    named: dict = {}
    gaps.sort(key=lambda g: g[0] - g[1])
    rest = sum(g1 - g0 for g0, g1 in gaps[NAMED_GAPS:])
    if rest:
        named[f"(gaps shorter than the {NAMED_GAPS} longest)"] = rest * 1e-9
    if gaps and host:
        hs = np.array([s for _, s, _ in host], dtype=np.int64)
        he = np.array([e for _, _, e in host], dtype=np.int64)
        hn = [n for n, _, _ in host]
        dur = he - hs
        for g0, g1 in gaps[:NAMED_GAPS]:
            mid = (g0 + g1) // 2
            hit = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = hn[int(hit[np.argmin(dur[hit])])] if hit.size else \
                "(no host op)"
            named[name] = named.get(name, 0.0) + (g1 - g0) * 1e-9
    return TraceSummary(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                        kernels=kernels, gaps=named)
