"""Out-of-core Gram accumulation: row-blocks in, a (p, p) f64 Gram out.

Port of ``repro.data.gram``.  HP-CONCORD only ever needs the sufficient
statistic S = XᵀX/n (of suitably transformed data), so tera-scale n never
has to sit in memory:

    acc = GramAccumulator(transform="standardize")     # on the card
    for chunk in source:            # (m_i, p) row-blocks, any dtype
        acc.update(chunk)
    result = acc.finalize()         # GramResult: S, n, stream stats
    ConcordEstimator(...).fit_gram(result)

Mechanics:

  * the state (ΣXᵀX, Welford mean and M2) lives on the accumulator's
    device in float64.  A host chunk crosses to the card in its STORED
    dtype (an f32 shard moves 4 bytes per value) through a pinned staging
    buffer reused across chunks; the cast to float64 happens on the card,
    before any product, so an f32 stream still yields the f64 Gram of the
    upcast data;
  * the panel products (``core.matops.panel_gram``) add in place into row
    slabs of the f64 accumulator: no second (p, p) buffer per chunk;
  * column mean/variance stream alongside in ONE pass (Welford, with the
    Chan merge for chunk-at-a-time and ``merge()``), so ``center`` and
    ``standardize`` are applied algebraically at finalize;
  * the non-finite check of each chunk stays an error; on the card it is
    one host sync per chunk;
  * the ``rank`` (nonparanormal) transform uses the bounded two-pass mode
    (:func:`rank_gram`): ceil(p / w) sweeps of a re-iterable source with
    an (n, w) float64 panel on the device, a (n·p·8)-byte on-disk scratch
    memmap, then one streaming Gram pass over the scratch.

:func:`distributed_gram`, the multi-process twin, folds each rank's own
rows and reduces the raw moments over the process group in one
all-reduce (``comm.group``).
"""
from __future__ import annotations

import os
import tempfile
from typing import NamedTuple

import numpy as np
import torch

from ..census import span
from ..core.matops import panel_gram
from ..device import resolve_device
from .shards import ChunkSource, as_source
from .transforms import (
    StreamStats,
    Transform,
    get_transform,
    rank_transform_panel,
)

__all__ = [
    "GramAccumulator", "GramResult", "compute_gram", "distributed_gram",
    "rank_gram",
]

#: default column-panel edge for the blocked XᵀX products
DEFAULT_PANEL = 512

#: default resident-memory budget of the rank transform's column sweeps
RANK_BUDGET_BYTES = 256 * 1024 * 1024

#: edge of the diagonal blocks that symmetrize a finalized Gram in place
SYM_BLOCK = 4096


def _dtype_name(chunk) -> str:
    if isinstance(chunk, torch.Tensor):
        return str(chunk.dtype).removeprefix("torch.")
    return chunk.dtype.name


def _symmetrize_(s: torch.Tensor, block: int = SYM_BLOCK) -> torch.Tensor:
    """s <- 0.5 (s + sᵀ) in place, a block-row strip at a time, so the
    temporaries stay at block x p; every entry is the same
    0.5 * (a + b) the one-shot formula computes."""
    p = s.shape[0]
    for lo in range(0, p, block):
        hi = min(lo + block, p)
        d = s[lo:hi, lo:hi]
        d.copy_(0.5 * (d + d.T))
        up, low = s[lo:hi, hi:], s[hi:, lo:hi]
        m = 0.5 * (up + low.T)
        up.copy_(m)
        low.copy_(m.T)
    return s


class GramResult(NamedTuple):
    """A finalized streaming Gram: the solver-ready sufficient statistic
    plus the stream statistics it was derived from (float64 tensors on
    the accumulator's device)."""
    s: torch.Tensor         # (p, p) float64 Gram of the TRANSFORMED data
    n: int                  # rows streamed
    p: int
    transform: str          # transform name that produced s
    mean: torch.Tensor      # (p,) f64 column means of the RAW stream
    var: torch.Tensor       # (p,) f64 population variances of the raw stream
    n_chunks: int           # chunks consumed
    source_dtype: str       # dtype of the incoming chunks

    def to_meta(self) -> dict:
        """JSON-able metadata (everything but the arrays) for sidecar
        files written by ``launch/gram.py prep``."""
        return {
            "n": int(self.n), "p": int(self.p),
            "transform": self.transform,
            "n_chunks": int(self.n_chunks),
            "source_dtype": self.source_dtype,
            "gram_dtype": "float64",
            "mean_absmax": float(self.mean.abs().max()) if self.p else 0.0,
            "diag_mean": float(self.s.diagonal().mean()) if self.p else 0.0,
        }


class GramAccumulator:
    """Chunked one-pass Gram accumulator (moment transforms).

    ``update(chunk)`` streams an (m, p) row-block (a numpy array, a
    memmap view or a tensor on any device); ``finalize()`` returns the
    :class:`GramResult` under ``transform``.  State is O(p²) float64 on
    ``device`` (``None``: the CUDA card, raising without one).  Chunk
    order changes the result only at the f64 summation-order level.

    The ``rank`` transform cannot accumulate one-pass — construct via
    :func:`compute_gram` / :func:`rank_gram` instead; passing it here
    raises.
    """

    def __init__(self, p: int | None = None, *,
                 transform: str | Transform = "none",
                 panel: int = DEFAULT_PANEL, device=None):
        self.transform = get_transform(transform)
        if self.transform.two_pass:
            raise ValueError(
                f"transform {self.transform.name!r} needs the two-pass "
                f"mode: use compute_gram(..., transform="
                f"{self.transform.name!r}) or rank_gram")
        if panel < 1:
            raise ValueError(f"panel must be >= 1, got {panel}")
        self.device = resolve_device(device)
        self.panel = int(panel)
        self.p = int(p) if p is not None else None
        self.n = 0
        self.n_chunks = 0
        self.source_dtype: str | None = None
        self._xx = self._mean = self._m2 = None
        # pinned host staging buffer, and the event of the last copy out
        # of it (waited on before the buffer is refilled)
        self._stage: torch.Tensor | None = None
        self._staged: torch.cuda.Event | None = None
        if self.p is not None:
            self._alloc(self.p)

    def _alloc(self, p: int) -> None:
        self.p = p
        f64 = dict(dtype=torch.float64, device=self.device)
        self._xx = torch.zeros((p, p), **f64)
        self._mean = torch.zeros(p, **f64)
        self._m2 = torch.zeros(p, **f64)

    def _to_device(self, arr) -> torch.Tensor:
        """The chunk on the accumulator's device, in its stored dtype.

        A host chunk is copied into the pinned staging buffer in the
        orientation whose rows are its contiguous runs: a row block of a
        column-major shard (``.npy`` files may be Fortran-ordered) is
        staged as its transpose and handed on as a transposed view, so
        the host copy never strides across the file."""
        if isinstance(arr, torch.Tensor):
            return arr.to(self.device)
        if self.device.type != "cuda":
            return torch.from_numpy(np.array(arr))
        dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        flip = arr.strides[0] == arr.itemsize != arr.strides[1]
        src = arr.T if flip else arr
        if self._staged is not None:
            self._staged.synchronize()      # the last chunk has left it
        if self._stage is None or self._stage.dtype != dtype \
                or self._stage.numel() < src.size:
            self._stage = torch.empty(src.size, dtype=dtype,
                                      pin_memory=True)
        host = self._stage[:src.size].view(src.shape)
        np.copyto(host.numpy(), src, casting="no")
        out = torch.empty(src.shape, dtype=dtype, device=self.device)
        out.copy_(host, non_blocking=True)
        self._staged = torch.cuda.Event()
        self._staged.record()
        return out.T if flip else out

    def update(self, chunk) -> "GramAccumulator":
        """Fold one (m, p) row-block into the stream moments."""
        arr = chunk if isinstance(chunk, torch.Tensor) else np.asarray(chunk)
        if arr.ndim != 2:
            raise ValueError(
                f"chunk must be 2-D (rows, p), got {tuple(arr.shape)}")
        if arr.shape[0] == 0:
            return self
        if self._xx is None:
            self._alloc(arr.shape[1])
        elif arr.shape[1] != self.p:
            raise ValueError(
                f"chunk has {arr.shape[1]} columns, accumulator is p={self.p}")
        with span("gram.chunk", cat="data", chunk=self.n_chunks,
                  rows=int(arr.shape[0]), p=int(arr.shape[1])):
            t = self._to_device(arr)
            if not bool(torch.isfinite(t).all()):
                raise ValueError(
                    f"chunk {self.n_chunks} contains non-finite values; "
                    f"refusing to fold NaN/Inf into the Gram")
            self.source_dtype = self.source_dtype or _dtype_name(arr)
            a64 = t.to(torch.float64)       # cast first, then multiply
            m = a64.shape[0]
            panel_gram(a64, panel=self.panel, out=self._xx)
            # Welford/Chan chunk merge of mean and M2; the centered chunk
            # is formed in place when a64 is this call's own copy
            cmean = a64.mean(dim=0)
            centered = a64 - cmean if a64 is chunk else a64.sub_(cmean)
            cm2 = centered.square_().sum(dim=0)
            tot = self.n + m
            delta = cmean - self._mean
            self._mean += delta * (m / tot)
            self._m2 += cm2 + delta * delta * (self.n * m / tot)
            self.n = tot
            self.n_chunks += 1
        return self

    def merge(self, other: "GramAccumulator") -> "GramAccumulator":
        """Fold another accumulator's state in (pairwise Chan merge)."""
        if other.n == 0:
            return self
        if self._xx is None:
            self._alloc(other.p)
        elif other.p != self.p:
            raise ValueError(f"cannot merge p={other.p} into p={self.p}")
        tot = self.n + other.n
        delta = other._mean.to(self.device) - self._mean
        self._xx += other._xx.to(self.device)
        self._mean += delta * (other.n / tot)
        self._m2 += other._m2.to(self.device) \
            + delta * delta * (self.n * other.n / tot)
        self.n = tot
        self.n_chunks += other.n_chunks
        self.source_dtype = self.source_dtype or other.source_dtype
        return self

    def stats(self) -> StreamStats:
        if self.n == 0:
            raise ValueError("no rows accumulated")
        return StreamStats(n=self.n, mean=self._mean.clone(),
                           var=self._m2 / self.n, xx=self._xx)

    def finalize(self) -> GramResult:
        """Apply the transform algebraically and return the Gram (a new
        tensor; the accumulator's state is left as it was)."""
        st = self.stats()
        s = _symmetrize_(self.transform.finalize_gram(st).to(torch.float64))
        return GramResult(
            s=s, n=st.n, p=self.p, transform=self.transform.name,
            mean=st.mean, var=st.var, n_chunks=self.n_chunks,
            source_dtype=self.source_dtype or "float64")


# ---------------------------------------------------------------------------
# two-pass rank / nonparanormal mode
# ---------------------------------------------------------------------------

def _count_rows(source: ChunkSource) -> int:
    if source.n_rows is not None:
        return int(source.n_rows)
    return sum(int(c.shape[0]) for c in source.chunks())


def _column_slab(chunk, lo: int, hi: int, device) -> torch.Tensor:
    part = chunk[:, lo:hi]
    if not isinstance(part, torch.Tensor):
        part = torch.from_numpy(np.ascontiguousarray(part))
    return part.to(device)


def rank_gram(data, *, panel: int = DEFAULT_PANEL,
              budget_bytes: int = RANK_BUDGET_BYTES,
              scratch_dir: str | None = None,
              chunk_rows: int | None = None, device=None) -> GramResult:
    """Bounded two-pass nonparanormal Gram (the ``rank`` transform).

    Memory contract, as the reference's: with w = the column-panel width
    fitted to ``budget_bytes`` (the resident panel is n·w f64 values, on
    ``device``),

      * pass 1: ceil(p / w) sweeps of the (re-iterable) source; sweep j
        loads only columns [jw, (j+1)w), rank-transforms them on the
        device and writes the scores into an on-disk float64 scratch
        memmap (n·p·8 bytes, in ``scratch_dir``);
      * pass 2: one streaming :class:`GramAccumulator` pass over the
        scratch rows, after which the scratch is deleted.

    One-shot iterators are rejected up front (``reiterable`` is required).
    """
    dev = resolve_device(device)
    source = as_source(data, chunk_rows=chunk_rows)
    source.require_reiterable("the rank (nonparanormal) transform")
    n = _count_rows(source)
    if n == 0:
        raise ValueError("empty source")
    first = next(iter(source.chunks()))
    p = first.shape[1]
    w = max(1, min(p, int(budget_bytes // max(n * 8, 1))))
    fd, scratch_path = tempfile.mkstemp(suffix=".rank.f64",
                                        dir=scratch_dir)
    os.close(fd)
    z = None
    try:
        z = np.memmap(scratch_path, dtype=np.float64, mode="w+",
                      shape=(n, p))
        for lo in range(0, p, w):
            hi = min(lo + w, p)
            buf = torch.empty((n, hi - lo), dtype=torch.float64, device=dev)
            row = 0
            for chunk in source.chunks():
                part = _column_slab(chunk, lo, hi, dev)
                # the per-chunk non-finite check: one sync per chunk
                if not bool(torch.isfinite(part).all()):  # ca: allow=CA106
                    raise ValueError(
                        "non-finite values in stream; refusing to rank")
                m = part.shape[0]
                if row + m <= n:
                    buf[row:row + m] = part
                row += m
            if row != n:
                raise ValueError(
                    f"re-iteration returned {row} rows, first sweep saw "
                    f"{n} (source is not stable across sweeps)")
            # each sweep's scores go to the on-disk scratch by design
            z[:, lo:hi] = rank_transform_panel(  # ca: allow=CA106
                buf).cpu().numpy()
        z.flush()
        acc = GramAccumulator(p, transform="none", panel=panel, device=dev)
        rows = chunk_rows or max(1, int(budget_bytes // max(p * 8, 1)))
        for lo in range(0, n, rows):
            acc.update(z[lo:lo + rows])
        res = acc.finalize()
    finally:
        del z
        os.unlink(scratch_path)
    return res._replace(transform="rank", source_dtype=_dtype_name(first))


# ---------------------------------------------------------------------------
# front door + distributed twin
# ---------------------------------------------------------------------------

def compute_gram(data, *, transform: str | Transform = "none",
                 chunk_rows: int | None = None,
                 panel: int = DEFAULT_PANEL, device=None,
                 **rank_kw) -> GramResult:
    """Stream any chunk-like input (array, tensor, iterator, shard paths,
    factory — see ``shards.as_source``) into a :class:`GramResult` under
    ``transform``, accumulated on ``device`` (``None``: the CUDA card,
    raising without one).  Dispatches to the one-pass accumulator for
    moment transforms and to :func:`rank_gram` for order-based ones."""
    dev = resolve_device(device)
    tf = get_transform(transform)
    if tf.two_pass:
        return rank_gram(data, panel=panel, chunk_rows=chunk_rows,
                         device=dev, **rank_kw)
    source = as_source(data, chunk_rows=chunk_rows)
    acc = GramAccumulator(source.p, transform=tf, panel=panel, device=dev)
    for chunk in source.chunks():
        acc.update(chunk)
    return acc.finalize()


def distributed_gram(data, *, transform: str | Transform = "none",
                     chunk_rows: int | None = None,
                     panel: int = DEFAULT_PANEL, device=None) -> GramResult:
    """Multi-process streaming Gram, called on every rank of the process
    group: ``data`` is THIS rank's chunk input (anything
    ``shards.as_source`` takes).  Each rank folds its own rows into a
    partial accumulator on ``device`` (no communication), then ONE
    all-reduce of the raw-moment images (sum XᵀX, sum x,
    sum (x-μ)² + nμ², n, chunks) yields the global moments — O(p²) per
    rank, independent of n — and every rank returns the same Gram.  A
    two-integer all-reduce first checks that every rank saw the same p.
    At world size 1 it is the one rank's :func:`compute_gram`.

    The rank transform is order-based across ALL ranks' rows and cannot
    be reduced this way; it raises, as in the reference."""
    from ..comm.grid import AXES, Grid1p5D
    from ..comm.group import comm_for, world_size

    dev = resolve_device(device)
    tf = get_transform(transform)
    if tf.two_pass:
        raise ValueError(
            f"transform {tf.name!r} is order-based across all hosts' rows "
            f"and cannot be psum-reduced; rank-transform the consolidated "
            f"stream via rank_gram instead")
    source = as_source(data, chunk_rows=chunk_rows)
    acc = GramAccumulator(source.p, transform=tf, panel=panel, device=dev)
    for chunk in source.chunks():
        acc.update(chunk)
    if acc.n == 0:
        raise ValueError("this rank's source holds no rows")
    if world_size() == 1:
        return acc.finalize()
    comm = comm_for(Grid1p5D(world_size(), 1, 1), dev)
    p = acc.p
    seen = comm.pmin(torch.tensor([p, -p], device=dev), AXES).tolist()
    if seen != [p, -p]:
        raise ValueError(f"ranks saw inconsistent column counts "
                         f"{seen[0]}..{-seen[1]}")
    # raw-moment images: Welford state -> all-reducible sums (exact in
    # f64; the one lossy step is this final merge, as in any reduction)
    n_l = float(acc.n)
    raw = comm.psum(torch.cat([
        acc._xx.reshape(-1), acc._mean * n_l,
        acc._m2 + acc._mean ** 2 * n_l,
        torch.tensor([n_l, acc.n_chunks], dtype=torch.float64,
                     device=dev)]), AXES)
    n, n_chunks = (int(round(v)) for v in raw[-2:].tolist())
    xx = raw[:p * p].reshape(p, p)
    mean = raw[p * p:p * p + p] / n
    var = torch.clamp_min(raw[p * p + p:p * p + 2 * p] / n - mean ** 2, 0.0)
    st = StreamStats(n=n, mean=mean, var=var, xx=xx)
    s = _symmetrize_(tf.finalize_gram(st).to(torch.float64))
    return GramResult(
        s=s, n=n, p=p, transform=tf.name, mean=mean, var=var,
        n_chunks=n_chunks, source_dtype=acc.source_dtype or "float64")


# ---------------------------------------------------------------------------
# analysis manifest (repro_torch.analysis.dispatchpass)
# ---------------------------------------------------------------------------

def _analysis_panel_gram(device):
    x = torch.linspace(0.0, 1.0, 48, dtype=torch.float64,
                       device=device).reshape(6, 8)
    return {"fn": panel_gram, "args": (x,), "kwargs": {"panel": 4}}


def _analysis_distributed_reduce(device):
    """A standardized stream of host chunks into the f64 Gram; at world
    size 1 the reduce is the rank's own accumulator."""
    x = np.linspace(-1.0, 1.0, 96).reshape(12, 8)
    x[:, 1] **= 2
    return {"fn": distributed_gram, "args": (x,),
            "kwargs": dict(transform="standardize", chunk_rows=5,
                           device=device)}


#: the f64 compute core of every streamed Gram, and the reduce
ANALYSIS_ENTRIES = [
    {"name": "data.gram.panel_gram",
     "path": "src/repro_torch/core/matops.py",
     "build": _analysis_panel_gram},
    {"name": "data.gram.distributed_reduce",
     "path": "src/repro_torch/data/gram.py",
     "build": _analysis_distributed_reduce},
]
