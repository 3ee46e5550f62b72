"""Dispatch engine: semantic contract rules for torch (CA2xx).

The torch counterpart of ``repro.analysis.jaxprpass``.  The port traces
nothing, so this engine does not trace either: it RUNS every entry of the
layers' ``ANALYSIS_ENTRIES`` manifests (collected by
:mod:`repro_torch.analysis.manifest`) at float64 under a
``TorchDispatchMode`` that records every aten op, and checks

  * CA200 — the entry raised (the checks did not run);
  * CA201 — an op took a float64 input and produced a narrower float
    output; the finding is located at the innermost stack frame inside
    ``src/repro_torch/`` (outside this package), so it names the line
    that narrowed;
  * CA202 — an entry's ``same_ops`` recipe (``obs.commwatch``) runs the
    same solve at ``obs="off"`` and at ``obs="trace"``; both must
    dispatch the same aten ops, op for op.

It also takes a host-sync census of every entry: ``aten._local_scalar_dense``
(``.item()``, ``float(t)``, ``bool(t)``) and device-to-host copies
(``_to_copy`` / ``copy_`` from a CUDA tensor to the host, which is what
``.tolist()`` and ``.cpu()`` dispatch).  On the CPU no op crosses a
device, so only the scalar pulls count there.

Entry schema (each item of a module's ``ANALYSIS_ENTRIES`` list)::

    {
      "name": "core.prox.solve_reference",   # finding context
      "path": "src/repro_torch/core/prox.py",
      "build": device -> {                    # a thunk of the device
          "fn": callable,
          "args": tuple, "kwargs": dict,      # float64, on the device
      },
      "same_ops": optional device -> {"off": thunk, "trace": thunk},
      "skip": ("CA201", ...),                 # optional per-entry opt-outs
    }                                         # (a declared narrowing lives
                                              # next to its contract)

``build``/``same_ops`` take only a device, so importing a layer module
never builds a tensor.
"""
from __future__ import annotations

import traceback
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .findings import Finding
from .rules import Profile

NARROW_FLOATS = (torch.float32, torch.float16, torch.bfloat16)

_PORT = Path(__file__).resolve().parents[1]          # src/repro_torch
_ROOT = _PORT.parents[1]                             # the repo
_ANALYSIS = Path(__file__).resolve().parent

_aten = torch.ops.aten
_SCALAR_PULL = _aten._local_scalar_dense.default
_COPIES = (_aten._to_copy.default, _aten.copy_.default)


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _site() -> tuple[str, int, str]:
    """(repo-relative path, line, function) of the innermost frame inside
    the port, outside this package; ("", 0, "") when none is."""
    for frame in reversed(traceback.extract_stack()):
        path = Path(frame.filename).resolve()
        if _PORT in path.parents and _ANALYSIS not in path.parents:
            return (path.relative_to(_ROOT).as_posix(), frame.lineno or 0,
                    frame.name)
    return "", 0, ""


@dataclass
class Census:
    """What one run dispatched: the op sequence, the host syncs (and how
    many each ``path:function`` made) and the float64 -> narrow ops with
    their sites."""
    ops: list = field(default_factory=list)
    syncs: int = 0
    sync_sites: Counter = field(default_factory=Counter)
    downcasts: list = field(default_factory=list)

    def to_json(self) -> dict:
        return {"ops": len(self.ops), "syncs": self.syncs,
                "downcasts": len(self.downcasts)}


class OpRecorder(TorchDispatchMode):
    """Records every aten op dispatched inside the ``with`` block into
    :attr:`census`."""

    def __init__(self):
        super().__init__()
        self.census = Census()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.census
        c.ops.append(str(func))
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        sync = func is _SCALAR_PULL
        if func in _COPIES:
            src = ins[1] if func is _aten.copy_.default else ins[0]
            sync = src.device.type == "cuda" and outs[0].device.type == "cpu"
        if sync:
            path, _, fn = _site()
            c.syncs += 1
            c.sync_sites[f"{path}:{fn}"] += 1
        if any(t.dtype == torch.float64 for t in ins):
            narrow = [t.dtype for t in outs if t.dtype in NARROW_FLOATS]
            if narrow:
                c.downcasts.append((str(func), narrow[0], *_site()[:2]))
        return out


def record(fn, *args, **kwargs):
    """(fn(*args, **kwargs), :class:`Census`) of one run."""
    with OpRecorder() as rec:
        out = fn(*args, **kwargs)
    return out, rec.census


# -- per-entry checks -------------------------------------------------------

def check_downcasts(entry: dict, census: Census) -> list:
    """CA201: one finding per (site, op) that narrowed a float64 value."""
    out, seen = [], set()
    for op, dst, path, line in census.downcasts:
        if (path, line, op) in seen:
            continue
        seen.add((path, line, op))
        out.append(Finding(
            rule="CA201", path=path or entry["path"], line=line,
            context=entry["name"], snippet=f"{op} float64 -> {_dt(dst)}",
            message=f"float64 value narrowed to {_dt(dst)} by `{op}` in "
                    f"entry '{entry['name']}': the f64 contract must not "
                    f"silently downcast (derive the dtype from the operand "
                    f"or name a *_DTYPE policy)"))
    return out


def check_same_ops(entry: dict, device) -> list:
    """CA202: the recipe's ``off`` and ``trace`` runs dispatch the same
    aten ops, op for op (a warm-up ``off`` run first, unrecorded, so a
    first call's one-time work is not counted)."""
    runs = entry["same_ops"](device)
    runs["off"]()
    _, off = record(runs["off"])
    _, traced = record(runs["trace"])
    if off.ops == traced.ops:
        return []
    n = min(len(off.ops), len(traced.ops))
    at = next((i for i in range(n) if off.ops[i] != traced.ops[i]), n)
    a = off.ops[at] if at < len(off.ops) else "<end>"
    b = traced.ops[at] if at < len(traced.ops) else "<end>"
    return [Finding(
        rule="CA202", path=entry["path"], line=0, context=entry["name"],
        snippet=f"op {at}: {a} (off) vs {b} (trace)",
        message=f"obs=\"trace\" dispatched {len(traced.ops)} aten ops "
                f"against {len(off.ops)} at obs=\"off\", first differing at "
                f"op {at}: the instrumentation changed the device work")]


def _dt(dtype) -> str:
    return str(dtype).removeprefix("torch.")


# -- driver -----------------------------------------------------------------

def _error_finding(entry: dict, stage: str, exc: BaseException) -> Finding:
    tb = traceback.format_exception_only(type(exc), exc)[-1].strip()
    return Finding(
        rule="CA200", path=entry["path"], line=0, context=entry["name"],
        message=f"manifest entry failed during {stage}: {tb} — a broken "
                f"entry point means the contract checks did not run",
        snippet=stage)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_entry(entry: dict, profile: Profile, device="cpu") -> tuple:
    """Run + check one manifest entry.  Returns (findings, census record).
    Never raises: failures surface as CA200 findings so one broken entry
    can't mask the rest."""
    findings = []
    skip = set(entry.get("skip") or ())
    active = ({"CA201", "CA202"} & profile.rules) - skip
    record_ = {"entry": entry["name"], "device": str(device)}
    try:
        spec = entry["build"](device)
        fn, args = spec["fn"], tuple(spec.get("args", ()))
        kwargs = dict(spec.get("kwargs", {}))
        _, census = record(fn, *args, **kwargs)
        _sync(device)
    except Exception as e:               # noqa: BLE001 - report, don't die
        return [_error_finding(entry, "run", e)], record_
    record_.update(census.to_json())
    if "CA201" in active:
        findings.extend(check_downcasts(entry, census))
    if "CA202" in active and entry.get("same_ops") is not None:
        try:
            findings.extend(check_same_ops(entry, device))
            _sync(device)
        except Exception as e:           # noqa: BLE001
            findings.append(_error_finding(entry, "same_ops", e))
    return findings, record_


def run_entries(entries, profile: Profile, device="cpu") -> tuple:
    """Returns (findings, [census record per entry])."""
    findings, records = [], []
    for entry in entries:
        f, r = run_entry(entry, profile, device)
        findings.extend(f)
        records.append(r)
    return findings, records

