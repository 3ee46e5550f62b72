"""Kernel engine: the CUDA kernels' registry and memory checks (CA4xx).

The torch-side counterpart of ``repro.analysis.pallaspass``.  The port's
kernels are pointer-indexed CUDA C++ loaded by ``ctypes``
(``kernels/build.py``), not Pallas grids, so there is no index map to
evaluate; what stands in for the reference's geometry rules is checked
where the kernels run:

  * CA405 (static) — every ``kernels/csrc/*.cu`` (not ``probes/``) has
    exactly one ``kernels.manifest.KERNEL_ENTRIES`` entry; each entry's
    plain twin exists in ``kernels.ref``, its ``__global__`` functions are
    in its source, its exact outputs are among its outputs, and it has a
    positive rtol for every dtype it is fuzzed in;
  * :func:`kcheck` — CA401-CA403 on the card, by the kernels' checked
    build (``csrc/kcheck.cuh``, ``kernels.build.checked``): every fuzz
    case runs through the checked library with its buffers registered,
    inputs placed between unregistered gaps.  An access outside its
    buffers or the block's shared memory, or a store into an input, is
    CA403; an output element stored 0 times, or scratch read before its
    store, is CA402; an element stored more than once (against the
    manifest's write contract, "once" by default) is CA401, and so is an
    output whose bits move when the case re-runs under schedule jitter
    (no kernel sums its outputs with atomics, so a race is the only way
    they can).  :func:`probes` first runs five kernels with planted
    faults (``csrc/probes/kcheck_faults.cu``), each of which must trip
    its rule: a checker that finds nothing proves nothing until it finds
    these;
  * :func:`sanitize` — the fuzz cases re-run under NVIDIA's
    ``compute-sanitizer`` in a subprocess, the tool taken from beside
    ``nvcc`` and filtered to the port's kernels: ``memcheck`` (out-of-
    bounds and misaligned accesses: CA403's hazard), ``racecheck``
    (shared-memory races: CA401's) and ``initcheck`` (reads of device
    memory never written: CA402's), with
    ``PYTORCH_NO_CUDA_MEMORY_CACHING=1`` so every torch buffer is a fresh
    allocation the tool tracks.  Only a clean summary passes: an error
    reported, a tool that refuses the device (status ``refused``) or a
    run with no summary is a failure, and a missing tool raises.

The fuzzer's guard (``kernelfuzz.run_case`` on a CUDA device: guard
bands, a poisoned allocator, every case twice) checks the same hazards
as far as a result can show them; the checked build instruments the
accesses themselves.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path

import numpy as np

from .findings import Finding
from .kernelfuzz import _compare, case_rng, entry_cases

_SRC = Path(__file__).resolve().parents[2]           # the repo's src/
_ROOT = _SRC.parent

#: the compute-sanitizer tools ``--sanitize`` runs
SANITIZER_TOOLS = ("memcheck", "racecheck", "initcheck")

_GLOBAL_RE = r"__global__[^;{{]*?\b{}\s*\("
_SUMMARY_RE = re.compile(r"ERROR SUMMARY:\s*(\d+)\s+errors?")
_RACE_RE = re.compile(r"RACECHECK SUMMARY:\s*(\d+)\s+hazards?\s+displayed\s*"
                      r"\((\d+)\s+errors?,\s*(\d+)\s+warnings?\)")
_REFUSED = "Device not supported"


# ---------------------------------------------------------------------------
# CA405: the registry
# ---------------------------------------------------------------------------

def _ca405(path: str, context: str, message: str) -> Finding:
    return Finding(rule="CA405", path=path, line=0, context=context,
                   message=message, snippet=path)


def check_registry(entries=None, csrc: Path | None = None) -> list:
    """CA405 over the whole registry: one entry per CUDA source, each with
    its plain twin, its kernels, its tolerance classes and its cases."""
    import torch

    from ..kernels import build, ref
    from ..kernels.manifest import KERNEL_ENTRIES
    entries = KERNEL_ENTRIES if entries is None else entries
    csrc = build.CSRC if csrc is None else Path(csrc)
    out = []
    for cu in sorted(csrc.glob("*.cu")):
        rel = cu.resolve().relative_to(_ROOT).as_posix() \
            if _ROOT in cu.resolve().parents else cu.as_posix()
        owners = [e["name"] for e in entries
                  if Path(e.get("source", "")).name == cu.name]
        if len(owners) != 1:
            out.append(_ca405(
                rel, "<registry>",
                f"CUDA source {rel} has {len(owners)} KERNEL_ENTRIES "
                f"registrations {owners}: every kernel needs exactly one "
                f"(its plain twin, tolerance classes and fuzz cases)"))
    for e in entries:
        path, name = e.get("source", "?"), e.get("name", "?")
        src = _ROOT / path
        if not src.is_file():
            out.append(_ca405(path, name, f"entry '{name}' names a CUDA "
                              f"source {path} that does not exist"))
        else:
            text = src.read_text(encoding="utf-8")
            for k in e.get("kernels", ()):
                if not re.search(_GLOBAL_RE.format(re.escape(k)), text):
                    out.append(_ca405(path, name, f"entry '{name}' names "
                                      f"kernel '{k}', which is no "
                                      f"__global__ function of {path}"))
            if not e.get("kernels"):
                out.append(_ca405(path, name, f"entry '{name}' names no "
                                  f"__global__ function"))
        if not callable(getattr(ref, str(e.get("oracle")), None)):
            out.append(_ca405(path, name, f"entry '{name}' names plain twin "
                              f"{e.get('oracle')!r}, which kernels.ref "
                              f"does not define"))
        outputs = tuple(e.get("outputs", ()))
        stray = [o for o in e.get("exact", ()) if o not in outputs]
        if not outputs or stray:
            out.append(_ca405(path, name, f"entry '{name}' declares exact "
                              f"outputs {stray} outside its outputs "
                              f"{outputs}" if outputs else
                              f"entry '{name}' declares no outputs"))
        rtol = e.get("rtol")
        bad = (not isinstance(rtol, dict) or not rtol
               or any(not isinstance(getattr(torch, str(k), None),
                                     torch.dtype) or not float(v) > 0
                      for k, v in rtol.items()))
        if bad:
            out.append(_ca405(path, name, f"entry '{name}' has no positive "
                              f"rtol per dtype ({rtol!r}): the fp-tolerant "
                              f"class is unknown"))
        if not callable(e.get("fuzz")) or not entry_cases(e):
            out.append(_ca405(path, name, f"entry '{name}' has no fuzz "
                              f"builder or no cases"))
    return out


# ---------------------------------------------------------------------------
# compute-sanitizer
# ---------------------------------------------------------------------------

@dataclass
class SanitizeResult:
    """One tool's run over the fuzz cases."""
    tool: str
    status: str             # ok | errors | refused | failed
    errors: int
    warnings: int
    seconds: float
    returncode: int
    cases: int
    fuzz_failures: int
    detail: str = ""
    tail: str = ""

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def to_json(self) -> dict:
        return asdict(self)

    def render(self) -> str:
        return (f"{self.tool}: {self.status}, {self.errors} error(s), "
                f"{self.warnings} warning(s), {self.cases} case(s) in "
                f"{self.seconds:.1f} s"
                + (f" — {self.detail}" if self.detail else ""))


def sanitizer_path() -> Path:
    """compute-sanitizer from the CUDA toolkit whose ``nvcc`` builds the
    kernels (``kernels.build``); raises when it is not there."""
    from ..kernels import build
    nvcc = Path(build._nvcc()).resolve()
    for cand in (nvcc.parent / "compute-sanitizer",
                 nvcc.parents[1] / "compute-sanitizer" / "compute-sanitizer"):
        if cand.is_file() and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        f"compute-sanitizer not found beside {nvcc} (looked in "
        f"{nvcc.parent} and {nvcc.parents[1] / 'compute-sanitizer'}): "
        f"the memory checks of --sanitize need the CUDA toolkit's "
        f"sanitizer")


def kernel_filters(entries) -> list:
    """``--kernel-name kns=...`` for every ``__global__`` function the
    entries register: the tool checks the port's kernels only."""
    args = []
    for e in entries:
        for k in e.get("kernels", ()):
            args += ["--kernel-name", f"kns={k}"]
    return args


def parse_sanitizer(tool: str, output: str) -> tuple:
    """(status, errors, warnings, detail) from the tool's output; the
    status is ``refused`` when it refuses the device, ``failed`` when it
    printed no summary."""
    for line in output.splitlines():
        if _REFUSED in line:
            return "refused", 0, 0, line.strip("= ").strip()
    if tool == "racecheck":
        m = _RACE_RE.search(output)
        if m:
            errors, warns = int(m.group(2)), int(m.group(3))
            return ("errors" if errors else "ok"), errors, warns, ""
    else:
        m = _SUMMARY_RE.search(output)
        if m:
            errors = int(m.group(1))
            return ("errors" if errors else "ok"), errors, 0, ""
    return "failed", 0, 0, "the tool printed no summary"


def sanitize(tool: str, *, seed: int = 0, device="cuda", root=None,
             timeout: float = 1800.0) -> SanitizeResult:
    """Re-run every fuzz case of the registry at ``seed`` under
    ``compute-sanitizer --tool tool`` in a subprocess (the CLI's
    ``--engine kernels --fuzz-kernels``).  Raises when the device is not
    CUDA or the tool is missing; never skips."""
    import torch

    from ..kernels import build
    from ..kernels.manifest import KERNEL_ENTRIES
    if tool not in SANITIZER_TOOLS:
        raise ValueError(f"unknown sanitizer tool {tool!r}; one of "
                         f"{SANITIZER_TOOLS}")
    if torch.device(device).type != "cuda":
        raise ValueError(f"--sanitize {tool} checks the CUDA kernels on the "
                         f"card; got device {device!r}")
    exe = sanitizer_path()
    build.build()               # compile outside the tool
    root = Path(root or _ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        report = Path(tmp) / "fuzz.json"
        cmd = [str(exe), "--tool", tool, "--error-exitcode", "86",
               "--print-limit", "64", *kernel_filters(KERNEL_ENTRIES),
               sys.executable, "-m", "repro_torch.analysis",
               "--engine", "kernels", "--root", str(root),
               "--baseline", str(Path(tmp) / "baseline.json"),
               "--fuzz-kernels", "--device", str(device),
               "--seed", str(seed), "--format", "json",
               "--output", str(report)]
        env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
        env["PYTHONPATH"] = os.pathsep.join(
            [str(_SRC)] + [p for p in [env.get("PYTHONPATH")] if p])
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=timeout)
        seconds = time.perf_counter() - t0
        try:
            fuzz = json.loads(report.read_text(encoding="utf-8"))[
                "kernel_fuzz"]["counts"]
        except (OSError, ValueError, KeyError):
            fuzz = {}           # the child died before its report
    output = proc.stdout + proc.stderr
    status, errors, warns, detail = parse_sanitizer(tool, output)
    cases, bad = fuzz.get("cases", 0), fuzz.get("failures", 0)
    if status == "ok" and (proc.returncode != 0 or bad or not cases):
        status = "failed"
        detail = (f"exit {proc.returncode}, {cases} fuzz case(s), "
                  f"{bad} failure(s)")
    return SanitizeResult(
        tool=tool, status=status, errors=errors, warnings=warns,
        seconds=seconds, returncode=proc.returncode, cases=cases,
        fuzz_failures=bad, detail=detail, tail=output[-4000:])


# ---------------------------------------------------------------------------
# the checked build: CA401-CA403 on the card
# ---------------------------------------------------------------------------

#: a checked library's record, in ``kcheck_read``'s order (``kcheck.cuh``)
RECORD_FIELDS = ("code", "region", "offset", "extent", "site", "block_x",
                 "block_y", "block_z", "thread_x", "thread_y", "thread_z",
                 "errors", "accesses")

#: the record's error codes (``kcheck.cuh``'s ``Code``): (rule, what)
KC_CODES = {
    1: ("CA403", "global access outside every registered buffer"),
    2: ("CA403", "store into an input"),
    3: ("CA403", "shared-memory access outside the block's allocation"),
    4: ("CA403", "global access off its natural alignment"),
    5: ("CA402", "read of output or scratch memory before its store"),
    6: ("CA403", "TMA tensor map reaching past its tensor"),
}

#: buffer roles, in ``kcheck.cuh``'s order
ROLES = ("input", "output", "scratch")

#: buffers a checked launch can register (``kcheck.cuh``'s kMaxRegions)
MAX_REGIONS = 8

#: the jitter seeds each checked case re-runs under (after seed 0, none)
JITTER_SEEDS = (1, 2, 3)

#: unregistered bytes on each side of every input a checked case places:
#: a small overrun lands outside every registered buffer
GAP_BYTES = 4096

#: the negative controls (``csrc/probes/kcheck_faults.cu``) and the rule
#: each must trip
PROBES = (("store_past_end", "CA403"), ("tile_unstored", "CA402"),
          ("double_store", "CA401"), ("smem_race", "CA401"),
          ("smem_past_end", "CA403"))
PROBE_SOURCE = "src/repro_torch/kernels/csrc/probes/kcheck_faults.cu"
PROBE_N = 4096


@dataclass
class Buffer:
    """One registered buffer of a checked launch, with its write counts
    after the launch (``None`` for an input)."""
    name: str
    role: str
    elem: int
    counts: np.ndarray | None = None


@dataclass
class Launch:
    """One checked launch (one wrapper call): the library, its buffers in
    registration order and the record ``kcheck_read`` returned."""
    library: str
    buffers: list
    record: tuple

    def field(self, name: str) -> int:
        return int(self.record[RECORD_FIELDS.index(name)])


def _kc_finding(rule, ent, config, line, message, snippet) -> Finding:
    return Finding(rule=rule, path=ent.get("source", "?"), line=line,
                   context=f"{ent['name']} [{config}]", message=message,
                   snippet=snippet)


def launch_findings(ent: dict, config: str, launch: Launch) -> list:
    """CA401-CA403 of one checked launch: the record's first error (at
    its source line), then each output and scratch buffer's write counts
    against the entry's write contract: an output element stored 0 times
    is CA402, an element stored more than once under "once" is CA401."""
    from ..kernels.manifest import write_contract
    rec = dict(zip(RECORD_FIELDS, (int(x) for x in launch.record)))
    out = []
    if rec["code"]:
        rule, what = KC_CODES.get(rec["code"], ("CA403", f"error code "
                                                f"{rec['code']}"))
        reg = rec["region"]
        where = (launch.buffers[reg].name if 0 <= reg < len(launch.buffers)
                 else "shared memory" if rec["code"] == 3 else "no buffer")
        out.append(_kc_finding(
            rule, ent, config, rec["site"],
            f"{what}: {where}, byte offset {rec['offset']} of "
            f"{rec['extent']}, block ({rec['block_x']}, {rec['block_y']}, "
            f"{rec['block_z']}) thread ({rec['thread_x']}, "
            f"{rec['thread_y']}, {rec['thread_z']}); {rec['errors']} "
            f"error(s) in the launch", f"{launch.library}: {what}"))
    for b in launch.buffers:
        if b.role == "input" or b.counts is None:
            continue
        counts = np.asarray(b.counts).reshape(-1)
        unstored = np.flatnonzero(counts == 0)
        if b.role == "output" and unstored.size:
            out.append(_kc_finding(
                "CA402", ent, config, 0,
                f"{b.name}: {unstored.size} of {counts.size} element(s) "
                f"never stored (the first at element {unstored[0]})",
                f"{launch.library}: {b.name} unstored"))
        over = np.flatnonzero(counts > 1)
        if over.size and write_contract(ent, b.name) == "once":
            out.append(_kc_finding(
                "CA401", ent, config, 0,
                f"{b.name}: {over.size} of {counts.size} element(s) stored "
                f"more than once (up to {int(counts.max())} times, the "
                f"first at element {over[0]}): a write race",
                f"{launch.library}: {b.name} stored twice"))
    return out


def _differing(a, b) -> int:
    """Elements of ``a`` and ``b`` whose bytes differ (all, when the
    shapes or dtypes do)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.size, b.size)
    rows = (a.size, a.itemsize)
    return int(np.count_nonzero(
        (a.view(np.uint8).reshape(rows) != b.view(np.uint8).reshape(rows))
        .any(axis=1)))


def jitter_findings(ent: dict, config: str, base, jittered: dict) -> list:
    """CA401 of a case's jittered runs: ``base`` is the unjittered run's
    [(output, array)], ``jittered`` {seed: [(output, array)]}.  An output
    whose bits moved under a seed is a race: no kernel sums its outputs
    with atomics, so nothing else can move them."""
    out = []
    for seed, outs in jittered.items():
        for (name, a), (_, b) in zip(base, outs):
            n = _differing(a, b)
            if n:
                out.append(_kc_finding(
                    "CA401", ent, config, 0,
                    f"{name} changed under jitter seed {seed}: {n} of "
                    f"{np.size(a)} element(s) differ from the unjittered "
                    f"checked run: a race", f"{name} moved under jitter"))
    return out


def _dedupe(findings) -> list:
    seen, out = set(), []
    for f in findings:
        key = (f.rule, f.line, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def span_bytes(t) -> int:
    """Bytes from ``t``'s first element to past its last, by its
    strides: the storage the launch may touch."""
    if t.numel() == 0:
        return 0
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return (last + 1) * t.element_size()


def arm_arguments(regs) -> tuple:
    """``kcheck_arm``'s arguments but the seed, for ``regs`` [(name,
    role, tensor)], and the zeroed int32 write counts (one per element)
    of each output and scratch buffer (``None`` for an input)."""
    import torch
    n = len(regs)
    if not 1 <= n <= MAX_REGIONS:
        raise ValueError(f"a checked launch registers 1 to {MAX_REGIONS} "
                         f"buffers, got {n}")
    counts = [None if role == "input" else
              torch.zeros(span_bytes(t) // t.element_size(),
                          dtype=torch.int32, device=t.device)
              for _, role, t in regs]
    u64, i32 = ctypes.c_ulonglong * n, ctypes.c_int * n
    args = (n, u64(*(t.data_ptr() for _, _, t in regs)),
            u64(*(span_bytes(t) for _, _, t in regs)),
            i32(*(t.element_size() for _, _, t in regs)),
            i32(*(ROLES.index(role) for _, role, _ in regs)),
            (ctypes.c_void_p * n)(*(None if c is None else c.data_ptr()
                                    for c in counts)))
    return args, counts


def _kcheck_fn(lib, which: str):
    fn = getattr(lib, f"kcheck_{which}")
    if which == "arm":
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong),
                       ctypes.POINTER(ctypes.c_ulonglong),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint]
    else:
        fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    return fn


class Recorder:
    """The ``kernels.build.checked`` callback of one run: arms each
    launch's checked library with the wrapper's buffers (fresh zeroed
    write counts for outputs and scratch) and the jitter seed, and reads
    the record and the counts back (:class:`Launch`) when the next launch
    comes or :meth:`finish` is called, which disarms the library."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.launches: list = []
        self._armed = None

    def __call__(self, name: str, lib, buffers: dict) -> None:
        self.finish()
        regs = [(bname, role, t) for role in ROLES
                for bname, t in buffers.get(role, {}).items()
                if t is not None]
        args, counts = arm_arguments(regs)
        rc = _kcheck_fn(lib, "arm")(*args, self.seed)
        if rc != 0:
            raise RuntimeError(f"kcheck_arm of the checked {name} library "
                               f"failed: cudaError {rc}")
        self._armed = (name, lib, regs, counts)

    def finish(self) -> None:
        import torch
        if self._armed is None:
            return
        name, lib, regs, counts = self._armed
        self._armed = None
        rec = (ctypes.c_longlong * len(RECORD_FIELDS))()
        rc = _kcheck_fn(lib, "read")(rec)
        if rc != 0:
            raise RuntimeError(f"kcheck_read of the checked {name} library "
                               f"failed: cudaError {rc}")
        # every buffer's counts in one host pull, then split
        shadows = [c for c in counts if c is not None]
        flat = (torch.cat(shadows).cpu().numpy() if shadows
                else np.zeros(0, np.int32))
        ends = np.cumsum([c.numel() for c in shadows])[:-1]
        host = iter(np.split(flat, ends))
        self.launches.append(Launch(name, [
            Buffer(bname, role, t.element_size(),
                   None if c is None else next(host))
            for (bname, role, t), c in zip(regs, counts)], tuple(rec)))


def place_gapped(a, device, dtype):
    """An input placed as the fuzz builders place it, inside a zeroed
    buffer with :data:`GAP_BYTES` of unregistered memory on each side."""
    import torch

    from ..kernels.manifest import place_tensor
    t = place_tensor(a, device, dtype)
    g = -(-GAP_BYTES // t.element_size())
    buf = torch.zeros(t.numel() + 2 * g, dtype=t.dtype, device=t.device)
    buf[g:g + t.numel()] = t.reshape(-1)
    return buf[g:g + t.numel()].view(t.shape)


@dataclass
class KcheckCase:
    """One (entry, config, dtype) case through the checked build: its
    unjittered run and one run per jitter seed."""
    entry: str
    config: str
    launches: int = 0
    accesses: int = 0
    worst_count: int = 0
    jitter_runs: int = 0
    seconds: float = 0.0
    findings: list = field(default_factory=list)
    #: a run that raised, or an output off its plain version
    failures: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings and not self.failures

    def to_json(self) -> dict:
        out = asdict(self)
        out["findings"] = [f.to_json() for f in self.findings]
        return out


def _checked_run(fn, seed: int):
    """``fn()`` inside a checked scope recording under jitter ``seed``;
    returns (its result, the launches)."""
    from ..kernels import build
    rec = Recorder(seed)
    with build.checked(rec):
        try:
            res = fn()
        finally:
            rec.finish()
    return res, rec.launches


def _tally(case: KcheckCase, ent: dict, launches) -> None:
    for launch in launches:
        case.findings += launch_findings(ent, case.config, launch)
        case.accesses += launch.field("accesses")
        case.worst_count = max([case.worst_count] + [
            int(b.counts.max()) for b in launch.buffers
            if b.counts is not None and b.counts.size])


def check_case(ent: dict, cfg: dict, dtype: str, *, seed: int = 0,
               jitter_seeds=JITTER_SEEDS, device="cuda") -> KcheckCase:
    """One fuzz case of ``ent`` through its checked library: unjittered,
    then once per jitter seed, each run's launches decoded by
    :func:`launch_findings`, the jittered outputs held bit for bit to the
    unjittered ones (:func:`jitter_findings`), and the unjittered outputs
    to the plain version at their tolerance class."""
    import torch
    label = cfg.get("label", "?")
    case = KcheckCase(ent["name"], f"{label}/{dtype}")
    t0 = time.perf_counter()
    outputs = {}
    for js in (0, *jitter_seeds):
        rng = case_rng(seed, ent.get("jax_entry", ent["name"]), label)
        try:
            pairs, launches = _checked_run(lambda: ent["fuzz"](
                cfg, rng, device, getattr(torch, dtype),
                place=place_gapped), js)
        except Exception as e:      # noqa: BLE001 - report, don't die
            case.failures.append(f"jitter seed {js}: {type(e).__name__}: "
                                 f"{e}")
            break
        _tally(case, ent, launches)
        outputs[js] = [(name, got) for name, got, _, _ in pairs]
        if js == 0:
            case.launches = len(launches)
            case.failures += [
                r.render() for r in (
                    _compare(ent, case.config, name, got, want, tol, dtype)
                    for name, got, want, tol in pairs) if not r.ok]
        else:
            case.jitter_runs += 1
    if 0 in outputs:
        case.findings += jitter_findings(
            ent, case.config, outputs[0],
            {js: o for js, o in outputs.items() if js})
    if not case.launches and not case.failures:
        case.failures.append("the case launched no checked kernel")
    case.findings = _dedupe(case.findings)
    case.seconds = time.perf_counter() - t0
    return case


def _cuda(device):
    import torch
    if torch.device(device).type != "cuda":
        raise ValueError(f"the checked build runs on the card; got device "
                         f"{device!r}")


def kcheck(*, seed: int = 0, jitter_seeds=JITTER_SEEDS, device="cuda",
           entries=None) -> list:
    """Every ``configs`` and ``card_configs`` case of every entry (default:
    the whole registry), in each declared dtype, through the checked
    build: a :class:`KcheckCase` each.  Raises when the device is not
    CUDA or a checked library does not build."""
    from ..kernels import build
    from ..kernels.manifest import KERNEL_ENTRIES
    _cuda(device)
    entries = KERNEL_ENTRIES if entries is None else entries
    build.build([Path(e["source"]).stem for e in entries], checked=True)
    return [check_case(e, cfg, dt, seed=seed, jitter_seeds=jitter_seeds,
                       device=device)
            for e in entries for cfg, dt in entry_cases(e)]


@dataclass
class ProbeResult:
    """One negative control: the rule it must trip and what the checked
    build found."""
    probe: str
    rule: str
    findings: list
    seconds: float

    @property
    def tripped(self) -> bool:
        return any(f.rule == self.rule for f in self.findings)

    def to_json(self) -> dict:
        return {"probe": self.probe, "rule": self.rule,
                "tripped": self.tripped, "seconds": self.seconds,
                "findings": [f.to_json() for f in self.findings]}


def _run_probe(probe: str, device):
    """One launch of ``kc_probe_<probe>`` on PROBE_N floats; its output
    is a view of a longer buffer, so a store past the end lands in
    unregistered memory the allocation owns."""
    import torch

    from ..kernels import build
    n = PROBE_N
    inp = place_gapped(np.arange(1, n + 1), device, torch.float32)
    out = torch.zeros(n + GAP_BYTES // 4, dtype=torch.float32,
                      device=device)[:n]
    fn = getattr(build.load("kcheck_faults"), f"kc_probe_{probe}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    build.regions("kcheck_faults", inputs={"in": inp}, outputs={"out": out})
    rc = fn(inp.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kc_probe_{probe} launch failed: cudaError {rc}")
    return out.cpu().numpy()


def probes(*, jitter_seeds=JITTER_SEEDS, device="cuda") -> list:
    """The five negative controls through the checked build, unjittered
    and under each jitter seed: a :class:`ProbeResult` each."""
    from ..kernels import build
    _cuda(device)
    build.build(["kcheck_faults"], checked=True)
    ent = {"name": "kcheck_faults", "source": PROBE_SOURCE, "writes": {}}
    results = []
    for probe, rule in PROBES:
        t0 = time.perf_counter()
        findings, outs = [], {}
        for js in (0, *jitter_seeds):
            out, launches = _checked_run(lambda: _run_probe(probe, device),
                                         js)
            outs[js] = [("out", out)]
            for launch in launches:
                findings += launch_findings(ent, probe, launch)
        findings += jitter_findings(ent, probe, outs[0],
                                    {js: o for js, o in outs.items() if js})
        results.append(ProbeResult(probe, rule, _dedupe(findings),
                                   time.perf_counter() - t0))
    return results


def kcheck_failed(probe_results, cases) -> bool:
    """Whether a checked run fails its gate: a probe that did not trip
    its rule, or a case with a finding or a failure."""
    return (any(not p.tripped for p in probe_results)
            or any(not c.ok for c in cases))


def kcheck_report(probe_results, cases, *, seed: int, seconds=None) -> dict:
    """The JSON block of the CLI's report, ``kernel_kcheck``."""
    return {
        "seed": seed,
        "probes": [p.to_json() for p in probe_results],
        "cases": [c.to_json() for c in cases],
        "counts": {"cases": len(cases),
                   "findings": sum(len(c.findings) for c in cases),
                   "failures": sum(len(c.failures) for c in cases),
                   "probes_tripped": sum(p.tripped for p in probe_results),
                   "probes": len(probe_results)},
        "seconds": seconds,
    }
