"""Runtime observability for the port's solver stack.

Port of ``repro.obs``.  Three layers, all host-side (nothing here
launches device work or reads a device value inside a solve, so
enabling observability cannot change an estimate):

  * :mod:`repro_torch.obs.trace` — span/event tracer with an in-memory
    ring buffer and JSONL / Chrome-trace (Perfetto ``trace_event``)
    exporters, in the reference's formats.
  * :mod:`repro_torch.obs.metrics` — counters, gauges and
    exponential-bucket latency histograms (p50/p95/p99) with
    Prometheus-text and JSON snapshot exporters, plus flop/word
    accounting fed from :mod:`repro_torch.core.costmodel`'s analytic
    formulas at observed shapes.
  * :mod:`repro_torch.obs.commwatch` — measured-vs-predicted
    communication reconciliation: the collectives a distributed solve
    actually posts (counted at ``comm.group``'s wrappers) are checked
    for EXACT per-(prim, axes) count and bytes-on-wire equality against
    the analytic ``core.costmodel.comm_volume`` predictions.

The estimator plumbs ``SolverConfig.obs = "off" | "summary" | "trace"``
through every backend; ``"off"`` (the default) never imports this
package at all.  ``python -m repro_torch.obs.cli`` prints, diffs,
converts and reconciles.
"""
from __future__ import annotations

from .metrics import MetricsRegistry, get_registry
from .trace import Span, Tracer, get_tracer

__all__ = [
    "MetricsRegistry",
    "Span",
    "Tracer",
    "get_registry",
    "get_tracer",
]
