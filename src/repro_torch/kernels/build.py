"""Build the CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, under
``<repo>/build/repro_torch_kernels/``, at first use, and loaded with
``ctypes``.  No PyTorch header is included, so a build takes seconds
rather than the minutes ``torch.utils.cpp_extension.load`` needs.  The
library's file name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded.

Nothing here runs at import time.  A missing ``nvcc`` or a failed build
raises ``RuntimeError``; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMMON_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v")

#: per-source flags: the fused prox and the path step must not contract
#: multiply-adds into FMAs, or their outputs would drift an ulp from the
#: plain versions
EXTRA_FLAGS = {
    "softthresh": ("-fmad=false",),
    "blocksparse_matmul": (),
    "pathstep": ("-fmad=false",),
    "flash_attention": (),
}

#: ``nvcc -Xptxas -v`` report of each library built in this process
#: (registers, shared memory and spills per kernel)
PTXAS_REPORT: dict[str, str] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on the machine with the card")
    return nvcc


def _flags(name: str) -> list[str]:
    return [*ARCH_FLAGS, *COMMON_FLAGS, *EXTRA_FLAGS[name]]


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def _start(name: str, nvcc: str):
    """Start one nvcc; returns (target, process, temporary output)."""
    target = _target(name)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, proc, tmp


def build(names=None) -> dict[str, Path]:
    """Compile the named sources (default: all), one ``nvcc`` each, all
    started together.  Sources whose library already exists are skipped.
    Returns {name: library path}; raises ``RuntimeError`` on a failure."""
    names = list(EXTRA_FLAGS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    nvcc = None
    for name in names:
        target = _target(name)
        if target.exists():
            out[name] = target
            continue
        nvcc = nvcc or _nvcc()
        running.append((name, *_start(name, nvcc)))
    failed = []
    for name, target, proc, tmp in running:
        log, _ = proc.communicate()
        PTXAS_REPORT[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        out[name] = target
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LIBS[name] = lib
        return lib
