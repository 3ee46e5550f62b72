"""Counters, gauges and exponential-bucket histograms with Prometheus
and JSON exporters.

Port of ``repro.obs.metrics``, with the same ``repro_*`` metric names
and export formats, so one dashboard reads both packages.  Everything
here is host-side bookkeeping over Python floats — metrics are fed at
chunk/solve boundaries, never from inside a device loop.

Histograms use exponential buckets (upper bounds ``start * growth**i``)
so p50/p95/p99 latency quantiles stay meaningful across six decades of
solve time with O(64) cells; :meth:`Histogram.quantile` interpolates
linearly inside the winning bucket, so on known samples it matches
``numpy.quantile`` to within one bucket's relative width (= ``growth``).

Flop/byte work counters are fed from :mod:`repro_torch.core.costmodel`'s
analytic formulas (paper Lemma 3.4) evaluated at the *observed* problem
shape, iteration count and density — see :func:`record_solve_cost`.
"""
from __future__ import annotations

import json
import threading
from bisect import bisect_left
from dataclasses import dataclass, field


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _label_str(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


@dataclass
class Counter:
    """Monotone accumulator (events, flops, bytes)."""
    name: str
    labels: tuple = ()
    value: float = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc by {amount})")
        self.value += amount


@dataclass
class Gauge:
    """Last-write-wins instantaneous value (queue depth, occupancy)."""
    name: str
    labels: tuple = ()
    value: float = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


DEFAULT_START = 1e-6        # 1 us
DEFAULT_GROWTH = 2 ** 0.25  # 4 buckets per octave, ~19% relative error
DEFAULT_BUCKETS = 96        # covers 1 us .. ~16e3 s


@dataclass
class Histogram:
    """Exponential-bucket histogram with interpolated quantiles.

    Bucket ``i`` holds samples in ``(bounds[i-1], bounds[i]]`` with
    ``bounds[i] = start * growth**i``; one underflow cell catches
    ``v <= start`` and one overflow cell catches ``v > bounds[-1]``.
    """
    name: str
    labels: tuple = ()
    start: float = DEFAULT_START
    growth: float = DEFAULT_GROWTH
    n_buckets: int = DEFAULT_BUCKETS
    counts: list = field(default_factory=list)
    total: int = 0
    sum: float = 0.0
    min: float = float("inf")
    max: float = float("-inf")

    def __post_init__(self):
        if self.growth <= 1.0:
            raise ValueError(f"growth must exceed 1, got {self.growth}")
        self.bounds = [self.start * self.growth ** i
                       for i in range(self.n_buckets)]
        if not self.counts:
            self.counts = [0] * (self.n_buckets + 1)

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect_left(self.bounds, v)
        self.counts[i] += 1
        self.total += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def quantile(self, q: float) -> float:
        """Linear interpolation inside the bucket holding rank
        ``q * (total - 1)`` (the same rank convention as
        ``numpy.quantile``'s default)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.total == 0:
            return float("nan")
        rank = q * (self.total - 1)
        seen = 0
        for i, c in enumerate(self.counts):
            if c and seen + c > rank:
                lo = self.bounds[i - 1] if i > 0 else min(self.min,
                                                          self.bounds[0])
                hi = self.bounds[i] if i < self.n_buckets else self.max
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if c == 1:
                    return (lo + hi) / 2
                # position of the target rank inside this bucket's span
                frac = (rank - seen) / (c - 1) if c > 1 else 0.0
                return lo + frac * (hi - lo)
            seen += c
        return self.max

    def percentiles(self) -> dict:
        return {"p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def to_json(self) -> dict:
        out = {"count": self.total, "sum": self.sum}
        if self.total:
            out.update(min=self.min, max=self.max, **self.percentiles())
        return out


class MetricsRegistry:
    """Get-or-create registry keyed on (name, sorted labels)."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: dict, **kwargs):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name=name, labels=key[1], **kwargs)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name}{dict(key[1])} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, *, start: float = DEFAULT_START,
                  growth: float = DEFAULT_GROWTH,
                  n_buckets: int = DEFAULT_BUCKETS, **labels) -> Histogram:
        return self._get(Histogram, name, labels, start=start,
                         growth=growth, n_buckets=n_buckets)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    def __len__(self) -> int:
        return len(self._metrics)

    # -- export ----------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able snapshot: ``{"name{labels}": value-or-summary}``."""
        out = {}
        with self._lock:
            items = sorted(self._metrics.items())
        for (name, labels), m in items:
            key = name + _label_str(labels)
            if isinstance(m, Histogram):
                out[key] = m.to_json()
            else:
                out[key] = m.value
        return out

    def export_json(self, path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (gauges for histogram quantiles —
        the pull-time summary form, not raw cumulative buckets)."""
        lines = []
        with self._lock:
            items = sorted(self._metrics.items())
        for (name, labels), m in items:
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name}{_label_str(labels)} {m.value:g}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name}{_label_str(labels)} {m.value:g}")
            else:
                lines.append(f"# TYPE {name} summary")
                base = dict(labels)
                for q, v in (("0.5", m.quantile(.5)),
                             ("0.95", m.quantile(.95)),
                             ("0.99", m.quantile(.99))):
                    if m.total:
                        ql = _label_str(_label_key({**base, "quantile": q}))
                        lines.append(f"{name}{ql} {v:g}")
                lines.append(f"{name}_sum{_label_str(labels)} {m.sum:g}")
                lines.append(f"{name}_count{_label_str(labels)} {m.total}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# analytic work accounting (costmodel formulas at observed shapes)
# ---------------------------------------------------------------------------

def record_solve_cost(registry: MetricsRegistry, *, variant: str,
                      p: int, n: int | None, iters: int, ls_total: int,
                      density: float = 1.0, n_devices: int = 1,
                      c_x: int = 1, c_omega: int = 1,
                      wall_s: float | None = None) -> dict:
    """Feed the flop/word counters from the paper's Lemma 3.4 cost model
    evaluated at the OBSERVED shape: ``s`` = outer iterations, ``t`` =
    mean line-search trials per iteration, ``d`` = observed nnz/row.

    Returns the computed ``{"flops", "words"}`` so callers can attach
    them to telemetry without re-deriving.  Flops and words do not depend
    on the machine (only the cost model's ``t_*`` terms do), so the
    port's ``H100`` constants give the reference's counts."""
    from ..core import costmodel

    s = max(int(iters), 1)
    t = max(float(ls_total) / s, 1.0)
    # n is unknown when the caller handed a precomputed Gram (fit_cov
    # without n_samples) — the solve then performs no Gram-formation
    # flops, so the 2np^2 term is correctly zero
    shape = costmodel.ProblemShape(p=p, n=n if n is not None else 0,
                                   d=max(density * p, 1.0), s=s, t=t)
    fn = costmodel.cov_costs if variant == "cov" else costmodel.obs_costs
    cb = fn(shape, max(n_devices, 1), c_x, c_omega, costmodel.H100)
    registry.counter("repro_solve_flops_total", variant=variant).inc(cb.flops)
    registry.counter("repro_solve_comm_words_total",
                     variant=variant).inc(cb.words)
    registry.counter("repro_solves_total", variant=variant).inc()
    registry.counter("repro_solve_iters_total", variant=variant).inc(iters)
    registry.counter("repro_solve_ls_total", variant=variant).inc(ls_total)
    if wall_s is not None:
        registry.histogram("repro_solve_wall_seconds",
                           variant=variant).observe(wall_s)
    return {"flops": cb.flops, "words": cb.words}


# ---------------------------------------------------------------------------
# process-global registry (created lazily, like the tracer)
# ---------------------------------------------------------------------------

_REGISTRY: MetricsRegistry | None = None


def get_registry() -> MetricsRegistry:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = MetricsRegistry()
    return _REGISTRY
