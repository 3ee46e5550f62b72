"""``python -m repro_torch.analysis`` — run the engines, gate on findings.

Port of ``repro.analysis.cli``.  Exit status: 0 = clean (after the
baseline), 1 = unsuppressed findings, stale baseline entries, kernel-fuzz
failures, checked-build findings (CA401-CA403) or sanitizer errors, 2 =
usage / internal error (a missing compute-sanitizer or a checked build
that fails to compile included).  ``--format json`` (optionally with
``--output``) emits the machine report; it carries the dispatch engine's
host-sync census (``dispatch_census``), and with ``--fuzz-kernels`` the
fuzzer's case table (``kernel_fuzz``, the reference's shape), with
``--kcheck`` the checked build's probes and cases (``kernel_kcheck``),
and with ``--sanitize`` each tool's result (``kernel_sanitize``).

The dispatch engine, the fuzzer and the sanitizer run on ``--device``,
which is the CUDA card unless the caller asks for the CPU
(``--device cpu``: the contract checks and the plain versions, no
kernel); without a card the default is an error, as everywhere in the
port (``repro_torch.device.resolve_device``).  The AST engine and CA405
need no device.  On the card the fuzzer also runs its guard
(``kernelfuzz.run_case``).  ``--kcheck`` (the kernels' checked build:
its five negative controls, each of which must trip its rule, then every
fuzz case at ``--seed``, unjittered and under three jitter seeds) and
``--sanitize`` need the card.

``--changed [BASE]`` restricts the AST engine to files touched since
``BASE`` (``git diff --name-only``, default HEAD) under the scan targets,
and the fuzzer to the kernel entries whose source or wrapper changed (the
whole registry when a shared kernel file changed).  The dispatch engine
and CA405 always run whole-program.  Stale-baseline gating is skipped
under ``--changed``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from . import astpass
from .baseline import load_baseline, split_by_baseline, write_baseline
from .findings import Finding, sort_findings
from .rules import DEFAULT_PROFILE, NO_ANALOGUE, all_rules, profile_for_path

DEFAULT_TARGETS = ("src/repro_torch", "chip_smoke.py", "examples/torch_*.py")
DEFAULT_BASELINE = "analysis_baseline_torch.json"

_SKIP_PARTS = {"__pycache__", ".git", ".venv", "build", "dist"}


def _expand(target: str, root: Path) -> list:
    if any(c in target for c in "*?["):
        return sorted(root.glob(target))
    path = (root / target) if not Path(target).is_absolute() \
        else Path(target)
    if not path.exists():
        raise FileNotFoundError(f"no such file or directory: {path}")
    return [path]


def iter_python_files(targets, root: Path):
    for target in targets:
        for path in _expand(target, root):
            if path.is_file():
                yield path
                continue
            for f in sorted(path.rglob("*.py")):
                if not _SKIP_PARTS.intersection(f.parts):
                    yield f


def changed_paths(root: Path, base: str) -> list:
    """Every existing file ``git diff --name-only BASE`` reports."""
    out = subprocess.run(
        ["git", "diff", "--name-only", base, "--"],
        cwd=root, capture_output=True, text=True, check=True).stdout
    return [root / line for line in out.splitlines()
            if (root / line).is_file()]


def changed_files(root: Path, base: str, targets=DEFAULT_TARGETS) -> list:
    """Changed python files under the scan targets (files outside them —
    e.g. tests/ fixture code that trips rules on purpose — are
    excluded, matching the full-scan roots)."""
    roots = [p.resolve() for t in targets for p in _expand(t, root)]
    return [f for f in changed_paths(root, base)
            if f.suffix == ".py" and any(
                r == f.resolve() or r in f.resolve().parents for r in roots)]


def subset_kernel_entries(entries, changed_rel: set) -> list:
    """``--changed`` scoping of the fuzzer: the entries whose CUDA source
    or wrapper changed; every entry when a shared kernel file did."""
    from ..kernels.manifest import SHARED_KERNEL_FILES
    if any(p in changed_rel for p in SHARED_KERNEL_FILES):
        return list(entries)
    out = []
    for e in entries:
        src = Path(e["source"])
        wrapper = (src.parent.parent / f"{src.stem}.py").as_posix()
        if e["source"] in changed_rel or wrapper in changed_rel:
            out.append(e)
    return out


def run_ast_engine(targets, root: Path, *, files=None) -> list:
    findings = []
    if files is None:
        files = iter_python_files(targets, root)
    for f in files:
        try:
            rel = f.resolve().relative_to(root).as_posix()
        except ValueError:
            rel = f.as_posix()
        findings.extend(astpass.scan_file(f, rel, profile_for_path(rel)))
    return findings


def run_dispatch_engine(device):
    """Returns (findings, census records)."""
    from . import dispatchpass
    from .manifest import load_entries
    return dispatchpass.run_entries(load_entries(), DEFAULT_PROFILE, device)


def _entries(changed_rel):
    from ..kernels.manifest import KERNEL_ENTRIES
    return KERNEL_ENTRIES if changed_rel is None \
        else subset_kernel_entries(KERNEL_ENTRIES, changed_rel)


def run_kernel_fuzz(seed: int, device, changed_rel=None):
    """Returns (failed_results, report_dict)."""
    from . import kernelfuzz
    t0 = time.perf_counter()
    results = kernelfuzz.fuzz_entries(_entries(changed_rel), seed=seed,
                                      device=device)
    return kernelfuzz.failures(results), kernelfuzz.report(
        results, seed=seed, device=device,
        seconds=time.perf_counter() - t0)


def run_kcheck(seed: int, device, changed_rel=None):
    """Returns (failed, report dict): the checked build's probes, then
    its cases; a probe that does not trip its rule fails like a
    finding."""
    from . import kernelpass
    t0 = time.perf_counter()
    probe_results = kernelpass.probes(device=device)
    cases = kernelpass.kcheck(seed=seed, device=device,
                              entries=_entries(changed_rel))
    return kernelpass.kcheck_failed(probe_results, cases), \
        kernelpass.kcheck_report(probe_results, cases, seed=seed,
                                 seconds=time.perf_counter() - t0)


def run_sanitize(tools, seed: int, device, root: Path):
    """Returns (failed, {tool: result json}); a tool that refuses the
    device fails like one that reports errors."""
    from . import kernelpass
    failed, out = False, {}
    for tool in tools:
        res = kernelpass.sanitize(tool, seed=seed, device=device, root=root)
        out[tool] = res.to_json()
        failed |= not res.ok
    return failed, out


def build_parser() -> argparse.ArgumentParser:
    from .kernelpass import SANITIZER_TOOLS
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Contract checks for the PyTorch/CUDA port (AST rules "
                    "CA1xx, dispatch rules CA2xx, kernel rules CA4xx, the "
                    "differential kernel fuzzer and the memory checks).")
    ap.add_argument("targets", nargs="*", default=list(DEFAULT_TARGETS),
                    help="files/directories/globs to scan with the AST "
                         f"engine (default: {' '.join(DEFAULT_TARGETS)})")
    ap.add_argument("--root", default=".",
                    help="repo root paths are resolved against (default: .)")
    ap.add_argument("--engine", choices=("ast", "dispatch", "kernels", "all"),
                    default="all")
    ap.add_argument("--device", default=None,
                    help="device of the dispatch engine, the fuzzer and the "
                         "sanitizer (default: the CUDA card, an error "
                         "without one; cpu runs the plain versions)")
    ap.add_argument("--changed", nargs="?", const="HEAD", default=None,
                    metavar="BASE",
                    help="AST engine: only scan files changed since BASE "
                         "(git diff --name-only; default HEAD); the fuzzer "
                         "subsets KERNEL_ENTRIES to changed kernels. "
                         "Stale-baseline gating is skipped")
    ap.add_argument("--fuzz-kernels", action="store_true",
                    help="also run the differential kernel fuzzer: every "
                         "kernel against its plain version at every config "
                         "and card config, enforcing the declared tolerance "
                         "classes (failures fail the gate)")
    ap.add_argument("--seed", "--fuzz-seed", dest="seed", type=int, default=0,
                    metavar="N",
                    help="base seed of the fuzzer (default: 0; per-case "
                         "seeds derive deterministically from it)")
    ap.add_argument("--kcheck", action="store_true",
                    help="run every fuzz case through the kernels' checked "
                         "build on the card (bounds, write counts, jitter: "
                         "CA401-CA403) after its five negative controls; "
                         "a finding, or a control that does not trip, "
                         "fails the gate")
    ap.add_argument("--sanitize", action="append", default=[],
                    choices=SANITIZER_TOOLS,
                    help="re-run the fuzz cases under compute-sanitizer "
                         "TOOL on the card; repeatable; an error, or a "
                         "tool that refuses the card, fails the gate")
    ap.add_argument("--format", choices=("human", "json"), default="human")
    ap.add_argument("--output", default=None,
                    help="write the report here as well as stdout")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="suppression baseline JSON, relative to --root "
                         f"(default: {DEFAULT_BASELINE})")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the baseline from current findings "
                         "and exit 0")
    ap.add_argument("--list-rules", action="store_true")
    return ap


def _render_kcheck(kc) -> list:
    lines = [""]
    for pr in kc["probes"]:
        hit = [f["message"] for f in pr["findings"] if f["rule"] == pr["rule"]]
        lines.append(f"kcheck probe {pr['probe']}: "
                     + ("tripped " if pr["tripped"] else "DID NOT TRIP ")
                     + pr["rule"] + (f" — {hit[0]}" if hit else ""))
    for c in kc["cases"]:
        for f in c["findings"]:
            lines.append(Finding(**f).render())
        lines.extend(f"  {c['entry']} [{c['config']}]: {why}"
                     for why in c["failures"])
    n = kc["counts"]
    lines.append(f"kcheck (seed {kc['seed']}): {n['cases']} case(s), "
                 f"{n['findings']} finding(s), {n['failures']} failure(s), "
                 f"{n['probes_tripped']} of {n['probes']} probes tripped.")
    return lines


def _render_report(new, suppressed, stale, fmt: str, census=None,
                   kernel_fuzz=None, sanitize=None, kcheck=None) -> str:
    if fmt == "json":
        report = {
            "findings": [f.to_json() for f in new],
            "suppressed": [f.to_json() for f in suppressed],
            "stale_baseline": [list(e) for e in stale],
            "counts": {
                "findings": len(new),
                "suppressed": len(suppressed),
                "stale_baseline": len(stale),
            },
        }
        if census is not None:
            report["dispatch_census"] = census
        if kernel_fuzz is not None:
            report["kernel_fuzz"] = kernel_fuzz
        if sanitize:
            report["kernel_sanitize"] = sanitize
        if kcheck is not None:
            report["kernel_kcheck"] = kcheck
        return json.dumps(report, indent=2)
    lines = [f.render() for f in new]
    if stale:
        lines.append("")
        lines.append(f"{len(stale)} stale baseline entr"
                     f"{'y' if len(stale) == 1 else 'ies'} (no longer "
                     f"match anything — remove them):")
        lines.extend(f"  {e}" for e in stale)
    if kernel_fuzz is not None:
        counts = kernel_fuzz["counts"]
        if counts["failures"]:
            lines.append("")
            lines.extend(f"  {c['entry']} [{c['config']}] {c['output']} "
                         f"({c['tolerance']}): {c['detail'] or 'failed'}"
                         for c in kernel_fuzz["cases"] if not c["ok"])
        lines.append("")
        lines.append(f"kernel fuzz (seed {kernel_fuzz['seed']}): "
                     f"{counts['cases']} case(s), "
                     f"{counts['failures']} failure(s).")
    if kcheck is not None:
        lines.extend(_render_kcheck(kcheck))
    for tool, res in (sanitize or {}).items():
        lines.append(f"sanitize {tool}: {res['status']}, {res['errors']} "
                     f"error(s) in {res['seconds']:.1f} s"
                     + (f" — {res['detail']}" if res["detail"] else ""))
    lines.append("")
    lines.append(f"{len(new)} finding{'s' if len(new) != 1 else ''}"
                 + (f", {len(suppressed)} baseline-suppressed"
                    if suppressed else "")
                 + ".")
    return "\n".join(lines).lstrip("\n")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for r in all_rules():
            print(f"{r.id}  [{r.engine:8}]  {r.name}\n    {r.description}")
        for rid, why in sorted(NO_ANALOGUE.items()):
            print(f"{rid}  [no analogue]\n    {why}")
        return 0

    root = Path(args.root).resolve()
    findings, census = [], None
    changed_rel = None
    device = None
    try:
        if args.engine in ("dispatch", "all") or args.fuzz_kernels \
                or args.kcheck or args.sanitize:
            from ..device import resolve_device
            device = resolve_device(args.device)
        if args.changed is not None:
            changed_rel = {f.resolve().relative_to(root).as_posix()
                           for f in changed_paths(root, args.changed)}
        if args.engine in ("ast", "all"):
            files = None
            if args.changed is not None:
                files = changed_files(root, args.changed, args.targets)
            findings.extend(run_ast_engine(args.targets, root, files=files))
        if args.engine in ("dispatch", "all"):
            dispatch_findings, records = run_dispatch_engine(device)
            findings.extend(dispatch_findings)
            census = {r.pop("entry"): r for r in records}
        if args.engine in ("kernels", "all"):
            from .kernelpass import check_registry
            findings.extend(check_registry())
    except (FileNotFoundError, ImportError, AttributeError, ValueError,
            RuntimeError, subprocess.CalledProcessError) as e:
        print(f"repro_torch.analysis: error: {e}", file=sys.stderr)
        return 2
    findings = sort_findings(findings)

    baseline_path = root / args.baseline
    if args.write_baseline:
        write_baseline(findings, baseline_path)
        print(f"wrote {len(findings)} fingerprint"
              f"{'s' if len(findings) != 1 else ''} to {baseline_path}")
        return 0

    fuzz_failed, fuzz_report = [], None
    kc_failed, kc_report = False, None
    san_failed, san_report = False, {}
    try:
        if args.fuzz_kernels:
            fuzz_failed, fuzz_report = run_kernel_fuzz(
                args.seed, device, changed_rel)
        if args.kcheck:
            kc_failed, kc_report = run_kcheck(args.seed, device, changed_rel)
        if args.sanitize:
            san_failed, san_report = run_sanitize(
                args.sanitize, args.seed, device, root)
    except (ImportError, AttributeError, ValueError, RuntimeError,
            subprocess.TimeoutExpired) as e:
        print(f"repro_torch.analysis: error: {e}", file=sys.stderr)
        return 2

    baseline = load_baseline(baseline_path)
    new, suppressed, stale = split_by_baseline(findings, baseline)
    if args.changed is not None:
        stale = []      # a partial scan cannot adjudicate staleness
    report = _render_report(new, suppressed, stale, args.format, census,
                            fuzz_report, san_report, kc_report)
    print(report)
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(report + "\n", encoding="utf-8")
    return 1 if (new or stale or fuzz_failed or kc_failed
                 or san_failed) else 0
