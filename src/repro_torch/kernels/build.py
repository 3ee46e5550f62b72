"""Build the CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, under
``<repo>/build/repro_torch_kernels/``, at first use, and loaded with
``ctypes``.  No PyTorch header is included, so a build takes seconds
rather than the minutes ``torch.utils.cpp_extension.load`` needs.  The
library's file name carries a hash of the source, the header and the
flags, so an edited source is rebuilt and a stale library is never
loaded.

Each source also builds as a **checked** library (``checked=True``): the
same flags plus ``-DREPRO_KCHECK -lineinfo``, which turns the ``KC_*``
marks of ``csrc/kcheck.cuh`` into bounds checks, write counts and
schedule jitter on the card (``analysis.kernelpass.kcheck``).  Inside
the :func:`checked` scope :func:`load` returns the checked library, and
each wrapper hands its buffers to the scope through :func:`regions`
just before its launch; outside the scope both are what they were and
the checked library is never loaded.

Nothing here runs at import time.  A missing ``nvcc`` or a failed build
raises ``RuntimeError``; there is no fallback.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMMON_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v")
#: what a checked library adds to its source's flags
CHECK_FLAGS = ("-DREPRO_KCHECK", "-lineinfo")
#: the header every source includes (its bytes are part of each hash)
HEADER = CSRC / "kcheck.cuh"

#: per-source flags: the fused prox and the path step must not contract
#: multiply-adds into FMAs, or their outputs would drift an ulp from the
#: plain versions
EXTRA_FLAGS = {
    "softthresh": ("-fmad=false",),
    "blocksparse_matmul": (),
    "pathstep": ("-fmad=false",),
    "flash_attention": (),
}

#: the checked build's negative controls (built checked only)
PROBES = {"kcheck_faults": CSRC / "probes" / "kcheck_faults.cu"}

#: ``nvcc -Xptxas -v`` report of each library built in this process
#: (registers, shared memory and spills per kernel), and its compile
#: seconds (to its output's last write); a checked library's key is
#: ``"<name> checked"``
PTXAS_REPORT: dict[str, str] = {}
BUILD_SECONDS: dict[str, float] = {}

_LIBS: dict[tuple, ctypes.CDLL] = {}
_LOCK = threading.Lock()

#: the active :func:`checked` scope's launch callback (``None`` in a
#: scope without one), or ``_OFF`` outside every scope
_OFF = object()
_SCOPE = _OFF


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on the machine with the card")
    return nvcc


def _source(name: str) -> Path:
    return PROBES.get(name, CSRC / f"{name}.cu")


def _flags(name: str, checked: bool = False) -> list[str]:
    flags = [*ARCH_FLAGS, *COMMON_FLAGS, *EXTRA_FLAGS.get(name, ())]
    return flags + list(CHECK_FLAGS) if checked else flags


def _target(name: str, checked: bool = False) -> Path:
    src = _source(name).read_bytes() + HEADER.read_bytes()
    key = hashlib.sha256(
        src + " ".join(_flags(name, checked)).encode()).hexdigest()
    tag = "-checked" if checked else ""
    return BUILD_DIR / f"{name}{tag}-{key[:16]}.so"


def _report_key(name: str, checked: bool) -> str:
    return f"{name} checked" if checked else name


class Jobs:
    """nvcc processes started together, one per ``(name, checked)``
    library of ``jobs`` not built yet; :meth:`wait` collects them and
    :meth:`stop` kills those still running.  Each writes its report to a
    file beside its temporary output, so none blocks on a pipe while the
    caller does other work."""

    def __init__(self, jobs):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.done: dict[tuple, Path] = {}
        self._running = []
        nvcc = None
        for name, checked in jobs:
            target = _target(name, checked)
            if target.exists():
                self.done[(name, checked)] = target
                continue
            nvcc = nvcc or _nvcc()
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            log = open(tmp.with_suffix(".log"), "w+")
            cmd = [nvcc, *_flags(name, checked), "-o", str(tmp),
                   str(_source(name))]
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
            self._running.append((name, checked, target, tmp, log, proc,
                                  time.time()))

    def wait(self) -> dict[tuple, Path]:
        """Wait for every process; returns {(name, checked): library
        path}, or raises ``RuntimeError`` naming each failed build."""
        failed = []
        while self._running:
            for job in list(self._running):
                name, checked, target, tmp, log, proc, t0 = job
                if proc.poll() is None:
                    continue
                self._running.remove(job)
                key = _report_key(name, checked)
                # the last write of its output or report: when nvcc ended,
                # however late the caller waits
                BUILD_SECONDS[key] = max([0.0] + [
                    f.stat().st_mtime - t0 for f in (tmp, Path(log.name))
                    if f.exists()])
                log.seek(0)
                PTXAS_REPORT[key] = log.read()
                log.close()
                os.remove(log.name)
                if proc.returncode != 0:
                    failed.append(f"{key} (exit {proc.returncode}):\n"
                                  f"{PTXAS_REPORT[key]}")
                    continue
                os.replace(tmp, target)
                self.done[(name, checked)] = target
            if self._running:
                time.sleep(0.05)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return self.done

    def stop(self) -> None:
        """Kill the processes still running and remove their files."""
        for name, checked, target, tmp, log, proc, t0 in self._running:
            proc.kill()
            proc.wait()
            log.close()
            for f in (tmp, Path(log.name)):
                f.unlink(missing_ok=True)
        self._running = []


def build(names=None, checked: bool = False) -> dict[str, Path]:
    """Compile the named sources (default: the four kernels), production
    or ``checked``, one ``nvcc`` each, all started together; libraries
    that already exist are skipped.  Returns {name: library path};
    raises ``RuntimeError`` on a failure."""
    names = list(EXTRA_FLAGS) if names is None else list(names)
    libs = Jobs([(n, checked) for n in names]).wait()
    return {n: libs[(n, checked)] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use: the
    checked library inside a :func:`checked` scope, the production one
    everywhere else."""
    checked = _SCOPE is not _OFF
    with _LOCK:
        lib = _LIBS.get((name, checked))
        if lib is None:
            lib = ctypes.CDLL(str(build([name], checked)[name]))
            _LIBS[(name, checked)] = lib
        return lib


@contextlib.contextmanager
def checked(on_launch=None):
    """Scope in which :func:`load` returns the checked libraries, and in
    which each wrapper's :func:`regions` call, made just before its
    launch, goes to ``on_launch(name, library, buffers)`` (the caller
    arms the library's check there).  Scopes nest; leaving one restores
    the one outside it."""
    global _SCOPE
    outer, _SCOPE = _SCOPE, on_launch
    try:
        yield
    finally:
        _SCOPE = outer


def regions(name: str, *, inputs: dict, outputs: dict,
            scratch: dict | None = None) -> None:
    """A wrapper's named buffers, just before it launches ``name``'s
    kernels: handed to the :func:`checked` scope's callback as
    ``{"input": ..., "output": ..., "scratch": ...}`` (a ``None`` buffer
    is one the launch does not take).  Outside a scope with a callback it
    does nothing."""
    if _SCOPE is _OFF or _SCOPE is None:
        return
    _SCOPE(name, load(name), {"input": inputs, "output": outputs,
                              "scratch": scratch or {}})
