"""Differential kernel fuzzer: each CUDA kernel against its plain version.

Port of ``repro.analysis.kernelfuzz``, with no JAX in the process.  Each
``kernels.manifest.KERNEL_ENTRIES`` entry's fuzz builder draws a seeded
problem, runs the kernel through ``kernels.ops`` and its plain version
(``kernels.ref``) on the same tensors, and the declared tolerance class of
every output is ENFORCED:

  * ``bit-exact`` outputs are compared with
    ``np.testing.assert_array_equal`` — one flipped ulp fails;
  * ``fp-tolerant`` outputs use ``np.allclose`` at the entry's rtol (and
    atol) for the case's dtype.

Every ``configs`` entry (the reference's) and ``card_configs`` entry (the
CUDA kernel's own tile edges) runs in each dtype the entry declares a
tolerance for.  On a CUDA device a case is the hand-written kernel
against the plain version; on the CPU ``kernels.ops`` routes to the plain
version itself, so a CPU run holds the fuzzer's machinery (the tests hold
the plain versions against the reference's oracles).

On a CUDA device each case also runs under the guard, which looks for
memory faults in what the kernel leaves behind: every float input is
placed between two bands of NaN bytes (an out-of-bounds read poisons the
output, an out-of-bounds write into a band is counted), the caching
allocator's small-block pool is filled with NaN bytes before each run (an
output element the kernel never writes stays NaN and fails the
comparison), and the case runs twice, its outputs held bit for bit (a
race that changes a result shows as a difference).  A race that gives the
same result twice, or an access that lands in other live memory, is
beyond it: that is the checked build's work (``kernelpass.kcheck``:
write counts and bounds on every access) and compute-sanitizer's
(``kernelpass.sanitize``, where the tool runs).

Seeding is deterministic per (seed, entry, config) via
``np.random.SeedSequence`` over stable CRC32 digests, as in the
reference; an entry is seeded by the reference entry it ports
(``jax_entry``), so the same seed draws the reference's arrays.  Exposed
as ``python -m repro_torch.analysis --fuzz-kernels``.
"""
from __future__ import annotations

import os
import traceback
import zlib
from dataclasses import asdict, dataclass

import numpy as np

#: the byte the guard bands and the poisoned allocations hold (all ones:
#: a NaN in every float dtype)
POISON_BYTE = 0xFF

#: the allocator poison: this many 1 MiB blocks, the largest size the
#: caching allocator serves from its small-block pool (every buffer of a
#: fuzz case is smaller)
_POISON_BLOCK = 1 << 20
_POISON_BLOCKS = 64


@dataclass(frozen=True)
class FuzzResult:
    """One compared output of one (entry, config) fuzz case."""
    entry: str
    config: str
    output: str
    tolerance: str
    ok: bool
    max_abs_diff: float = 0.0
    detail: str = ""

    def to_json(self) -> dict:
        return asdict(self)

    def render(self) -> str:
        status = "ok" if self.ok else "FAIL"
        out = (f"{status}: {self.entry} [{self.config}] {self.output} "
               f"({self.tolerance}, max|diff|={self.max_abs_diff:.3e})")
        if self.detail:
            out += f" — {self.detail}"
        return out


def case_rng(seed: int, entry_name: str, label: str):
    """Deterministic per-case generator, stable across processes."""
    return np.random.default_rng(np.random.SeedSequence([
        seed, zlib.crc32(entry_name.encode()), zlib.crc32(label.encode())]))


def _tol(entry: dict, key: str, dtype: str, default: float) -> float:
    v = entry.get(key, default)
    return float(v[dtype]) if isinstance(v, dict) else float(v)


def _compare(entry: dict, label: str, name: str, got, want,
             tol_class: str, dtype: str | None = None) -> FuzzResult:
    """One output against its plain twin at ``tol_class``.  ``dtype``
    (the case's) picks the tolerance of an entry whose ``rtol`` is a
    per-dtype table; the port's entries take atol = rtol there, the
    reference's scalar knobs default to 1e-12 each."""
    from ..kernels.manifest import TOLERANCE_CLASSES

    g, w = np.asarray(got), np.asarray(want)
    base = dict(entry=entry["name"], config=label, output=name,
                tolerance=tol_class)
    if tol_class not in TOLERANCE_CLASSES:
        return FuzzResult(ok=False, detail=f"unknown tolerance class "
                          f"{tol_class!r} (CA405 contract)", **base)
    if g.shape != w.shape or g.dtype != w.dtype:
        return FuzzResult(
            ok=False, detail=f"shape/dtype mismatch: kernel "
            f"{g.shape}/{g.dtype} vs plain {w.shape}/{w.dtype}", **base)
    finite = np.isfinite(g) & np.isfinite(w)
    mad = float(np.max(np.abs(g[finite] - w[finite]))) \
        if finite.any() else 0.0
    if tol_class == "bit-exact":
        try:
            np.testing.assert_array_equal(g, w)
            return FuzzResult(ok=True, max_abs_diff=mad, **base)
        except AssertionError:
            n_bad = int(np.sum(~((g == w) | (np.isnan(g) & np.isnan(w)))))
            return FuzzResult(
                ok=False, max_abs_diff=mad,
                detail=f"{n_bad} element(s) differ from the plain version "
                       f"but the entry declares bit-exact", **base)
    dt = dtype or str(w.dtype)
    rtol = _tol(entry, "rtol", dt, 1e-12)
    per_dtype = isinstance(entry.get("rtol"), dict)
    atol = _tol(entry, "atol", dt, rtol if per_dtype else 1e-12)
    ok = bool(np.allclose(g, w, rtol=rtol, atol=atol))
    detail = "" if ok else f"outside rtol={rtol}/atol={atol}"
    return FuzzResult(ok=ok, max_abs_diff=mad, detail=detail, **base)


def entry_dtypes(entry: dict) -> tuple:
    """The dtypes an entry is fuzzed in: those it declares an rtol for."""
    rtol = entry.get("rtol")
    return tuple(rtol) if isinstance(rtol, dict) else ("float64",)


def entry_cases(entry: dict) -> list:
    """[(config, dtype), ...]: every configs and card_configs entry in
    every declared dtype."""
    cfgs = tuple(entry.get("configs", ())) + tuple(
        entry.get("card_configs", ()))
    return [(cfg, dt) for cfg in cfgs for dt in entry_dtypes(entry)]


# ---------------------------------------------------------------------------
# the guard: bands, a poisoned allocator, repeated runs
# ---------------------------------------------------------------------------

class Guard:
    """Places float inputs between two bands of :data:`POISON_BYTE` and
    counts, afterwards, the band bytes that changed."""

    def __init__(self):
        self.bands = []

    def place(self, a, device, dtype):
        import torch

        from ..kernels.manifest import place_tensor
        t = place_tensor(a, device, dtype)
        if not t.is_floating_point():
            return t
        n = t.numel()
        g = -(-max(n, 64) // 64) * 64        # keeps 16-byte alignment
        buf = torch.empty(n + 2 * g, dtype=t.dtype, device=t.device)
        buf.view(torch.uint8).fill_(POISON_BYTE)
        buf[g:g + n] = t.reshape(-1)
        self.bands.append((buf, g, n))
        return buf[g:g + n].view(t.shape)

    def breached(self) -> int:
        """Band bytes that no longer hold the poison."""
        import torch
        counts = []
        for buf, g, n in self.bands:
            raw, e = buf.view(torch.uint8), buf.element_size()
            counts.append((raw[:g * e] != POISON_BYTE).sum()
                          + (raw[(g + n) * e:] != POISON_BYTE).sum())
        return int(torch.stack(counts).sum()) if counts else 0


def _free_small_blocks(device) -> list:
    """Sizes of the free blocks the caching allocator's small-block pool
    holds on ``device`` (inside segments that live tensors keep)."""
    import torch
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    return [blk["size"] for seg in torch.cuda.memory_snapshot()
            if seg.get("segment_type") == "small"
            and seg.get("device") == index
            for blk in seg.get("blocks", ())
            if blk.get("state") == "inactive"]


def poison_allocator(device) -> None:
    """Fill the caching allocator's small-block pool with
    :data:`POISON_BYTE`: every free block it holds, and new segments, are
    taken, filled and given back, so the next buffers torch hands out
    (every output of a fuzz case) start as NaN.  CUDA only; raises when
    the poison does not take."""
    import torch
    if torch.device(device).type != "cuda":
        return
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    held = [torch.empty(_POISON_BLOCK, dtype=torch.uint8, device=device)
            for _ in range(_POISON_BLOCKS)]
    # largest first: best fit hands each request the block it names
    held += [torch.empty(size, dtype=torch.uint8, device=device)
             for size in sorted(_free_small_blocks(device), reverse=True)]
    for t in held:
        t.fill_(POISON_BYTE)
    del held, t
    probes = [torch.empty(n, dtype=torch.float64, device=device)
              for n in (64, 4096, _POISON_BLOCK // 16)]
    if not bool(torch.stack([torch.isnan(t).all() for t in probes]).all()):
        raise RuntimeError("the allocator poison did not take: fresh "
                           "buffers do not start as NaN")


def guards(device) -> bool:
    """Whether :func:`run_case` guards its cases on ``device``: on a
    CUDA device whose caching allocator is on.  Without the cache
    (``PYTORCH_NO_CUDA_MEMORY_CACHING=1``, as under compute-sanitizer)
    there is no pool to poison, and the tool checks the accesses
    itself."""
    import torch
    return (torch.device(device).type == "cuda"
            and not os.environ.get("PYTORCH_NO_CUDA_MEMORY_CACHING"))


def run_case(entry: dict, cfg: dict, *, seed: int = 0, device=None,
             dtype: str | None = None) -> list:
    """Fuzz one (entry, config, dtype) case on ``device`` (the card
    unless the caller asks for the CPU: ``repro_torch.device``).  Returns
    a list of :class:`FuzzResult`: one per compared output and, where
    :func:`guards` says so, one per output of the repeat
    (``<name>:repeat``) and the bands' verdict (``<guard>``).  Raises
    only when the device is unavailable: a crashed builder surfaces as a
    single failed result."""
    import torch

    from ..device import resolve_device
    device = resolve_device(device)
    label = cfg.get("label", "?")
    dtype = dtype or entry_dtypes(entry)[0]
    config = f"{label}/{dtype}"
    base = dict(entry=entry["name"], config=config)
    guard = guards(device)
    runs, breached = [], 0
    try:
        for _ in range(2 if guard else 1):
            bands = Guard()
            place = {"place": bands.place} if guard else {}
            if guard:
                poison_allocator(device)
            rng = case_rng(seed, entry.get("jax_entry", entry["name"]), label)
            # the fuzz builder's host copies and the band count wait for
            # the kernels on the stream, so a fault surfaces in this case
            runs.append(entry["fuzz"](cfg, rng, device, getattr(torch, dtype),
                                      **place))
            breached += bands.breached()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        results = [_compare(entry, config, name, got, want, tol, dtype)
                   for name, got, want, tol in runs[0]]
    except Exception as e:          # noqa: BLE001 - report, don't die
        tb = traceback.format_exception_only(type(e), e)[-1].strip()
        return [FuzzResult(output="<error>", tolerance="-", ok=False,
                           detail=f"fuzz builder raised: {tb}", **base)]
    if not results:
        return [FuzzResult(output="<empty>", tolerance="-", ok=False,
                           detail="fuzz builder compared no outputs", **base)]
    if guard:
        first, second = runs
        results += [_compare(entry, config, f"{a[0]}:repeat", b[1], a[1],
                             "bit-exact", dtype)
                    for a, b in zip(first, second)]
        results.append(FuzzResult(
            output="<guard>", tolerance="bit-exact", ok=breached == 0,
            detail="" if breached == 0 else
            f"{breached} guard-band byte(s) overwritten: an out-of-bounds "
            f"write", **base))
    return results


def fuzz_entries(entries, *, seed: int = 0, device=None) -> list:
    """Run every case of every entry.  Returns all results (use
    :func:`failures` to gate)."""
    results = []
    for entry in entries:
        for cfg, dt in entry_cases(entry):
            results.extend(run_case(entry, cfg, seed=seed, device=device,
                                    dtype=dt))
    return results


def failures(results) -> list:
    return [r for r in results if not r.ok]


def report(results, *, seed: int, device=None, seconds=None) -> dict:
    """The JSON block of the report, ``kernel_fuzz`` (the reference's
    shape; the port adds the device and the wall time)."""
    bad = failures(results)
    out = {
        "seed": seed,
        "cases": [r.to_json() for r in results],
        "counts": {"cases": len(results), "failures": len(bad)},
    }
    if device is not None:
        out["device"] = str(device)
    if seconds is not None:
        out["seconds"] = seconds
    return out

