"""The program's own run census, for the readers of per-layer metrics
measured inside the program.

``repro_torch.census.CENSUS`` counts the spans the program opened (by
name) and its host syncs (by site), and, while a profiler records, the
seconds of each; ``kernels.ops.reset_launches()`` zeroes it right before
the window, so after the window it holds the window alone.  A program
without it (one older than the census) reads as None, and each reader
then reports nothing.
"""
from __future__ import annotations


def census(run: dict):
    """The census after ``run``'s window, or None where the run was not
    traced (span seconds are live only under the profiler) or the
    program keeps none."""
    if run.get("trace") is None:
        return None
    try:
        from repro_torch.kernels import ops
    except ImportError:
        return None
    return getattr(ops, "CENSUS", None)


def host_ms_per_flat_step(run: dict) -> float | None:
    """The batched engine's host time per flat step: the seconds of the
    ``batch.flat_step`` spans less those blocked in the step's own sync
    (``core/batch.py:_apply_trial``), over the flat steps, in ms."""
    c = census(run)
    if c is None:
        return None
    steps = c.spans.get("batch.flat_step", 0)
    if not steps or "batch.flat_step" not in c.span_s:
        return None
    host_s = (c.span_s["batch.flat_step"]
              - c.sync_s.get("core/batch.py:_apply_trial", 0.0))
    return 1e3 * host_s / steps
