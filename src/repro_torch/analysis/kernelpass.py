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
without the tool, as far as a result can show them; it is no
substitute for the tool's instrumented accesses.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import asdict, dataclass
from pathlib import Path

from .findings import Finding
from .kernelfuzz import entry_cases

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
