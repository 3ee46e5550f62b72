"""Small sums the metric readers share."""
from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float | None:
    """The q-th percentile (linear between order statistics); None for
    no values or a non-finite result."""
    if not values:
        return None
    v = float(np.percentile(np.asarray(values, dtype=np.float64), q))
    return v if np.isfinite(v) else None


def points(run: dict):
    """Every path point the window ran: (path, report row)."""
    for path in run.get("paths") or ():
        for rep in path["reports"]:
            yield path, rep


def lanes(run: dict):
    """Every request a group of the window solved: (group, report row)."""
    for group in run.get("groups") or ():
        for rep in group["reports"]:
            yield group, rep


def idle_percent(run: dict) -> float | None:
    tr = run["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def share(least_s: float, measured_s: float) -> float | None:
    """least_s as a percentage of measured_s; None where nothing ran."""
    if measured_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / measured_s
