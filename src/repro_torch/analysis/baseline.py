"""Checked-in suppression baseline.

Port of ``repro.analysis.baseline``, unchanged: each package's
``load_baseline`` reads the other's ``write_baseline``.  The port's
baseline file (``analysis_baseline_torch.json`` at the repo root) is a
JSON list of finding fingerprints — rule + path + enclosing symbol +
stripped source text, deliberately line-number-free so unrelated edits
don't invalidate it.  The intended steady state is an EMPTY list: the
baseline exists to land the analyzer on a codebase with pre-existing
findings and burn them down, not to park new ones.  ``--write-baseline``
regenerates it from the current findings; entries that no longer match
anything are reported as stale so the file shrinks monotonically.
"""
from __future__ import annotations

import json
from pathlib import Path

_KEYS = ("rule", "path", "context", "snippet")


def load_baseline(path) -> list[tuple]:
    p = Path(path)
    if not p.exists():
        return []
    data = json.loads(p.read_text(encoding="utf-8"))
    if not isinstance(data, list):
        raise ValueError(f"baseline {p} must be a JSON list, got "
                         f"{type(data).__name__}")
    out = []
    for i, item in enumerate(data):
        if not isinstance(item, dict) or not all(k in item for k in _KEYS):
            raise ValueError(
                f"baseline {p} entry {i} must be an object with keys "
                f"{_KEYS}, got {item!r}")
        out.append(tuple(item[k] for k in _KEYS))
    return out


def write_baseline(findings, path) -> None:
    entries = sorted({f.fingerprint() for f in findings})
    data = [dict(zip(_KEYS, e)) for e in entries]
    Path(path).write_text(
        json.dumps(data, indent=2) + "\n", encoding="utf-8")


def split_by_baseline(findings, baseline: list[tuple]):
    """-> (new, suppressed, stale_baseline_entries)."""
    allowed = set(baseline)
    new, suppressed = [], []
    matched = set()
    for f in findings:
        fp = f.fingerprint()
        if fp in allowed:
            suppressed.append(f)
            matched.add(fp)
        else:
            new.append(f)
    stale = sorted(allowed - matched)
    return new, suppressed, stale
