"""Chunk sources: one interface over every way row-blocks of X can arrive.

Port of ``repro.data.shards``.  The streaming Gram pipeline
(``data.gram``) never wants the full (n, p) observation matrix — only
successive row-blocks ("chunks") of it.  This module normalizes the ways
callers hold such data into one :class:`ChunkSource` protocol:

  * an in-memory (n, p) array or tensor  -> :class:`ArraySource`
  * a generator / iterator of chunks     -> :class:`IterSource` (one-shot)
  * a zero-arg factory of fresh iters    -> :class:`CallableSource`
  * ``.npy`` shard files on disk         -> :class:`NpyShardSource`
    (memory-mapped; rows stream without ever loading a shard whole)
  * raw binary shards + explicit dtype/p -> :class:`RawShardSource`

    src.chunks()    -> iterator of (m_i, p) numpy arrays or tensors
    src.p           -> column count (None until known for one-shot iters)
    src.n_rows      -> total rows when knowable upfront, else None
    src.reiterable  -> True when ``chunks()`` may be called again
                       (required by two-pass transforms, e.g. rank)

Chunks keep their stored dtype and place: numpy views for disk and host
data, tensors for a source that lives on the card (a scenario sampler).
The consumer owns the float64 upcast, on its device.  The shard files are
the reference's, byte for byte: ``{prefix}_{i:05d}.npy``, or
``{prefix}_{i:05d}.bin`` with a ``shards_meta.json`` sidecar, so shards
written by either package open in the other.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

__all__ = [
    "ArraySource", "CallableSource", "ChunkSource", "IterSource",
    "NpyShardSource", "RawShardSource", "as_source", "is_streaming_input",
    "open_shards", "write_shards",
]

DEFAULT_CHUNK_ROWS = 4096

#: sidecar filename written next to raw binary shards (dtype/p metadata)
RAW_META = "shards_meta.json"


class ChunkSource:
    """Protocol base: iterate row-blocks of a conceptual (n, p) matrix."""

    reiterable: bool = False

    @property
    def p(self) -> int | None:
        raise NotImplementedError

    @property
    def n_rows(self) -> int | None:
        return None

    def chunks(self) -> Iterator:
        raise NotImplementedError

    def require_reiterable(self, what: str) -> None:
        if not self.reiterable:
            raise ValueError(
                f"{what} needs a re-iterable chunk source (an array, a "
                f"chunk list, shard files, or a zero-arg factory) — a "
                f"one-shot iterator can only be swept once")


def _as_chunk(chunk):
    """A tensor stays a tensor (wherever it lives); anything else becomes
    a numpy array."""
    return chunk if isinstance(chunk, torch.Tensor) else np.asarray(chunk)


def _check_chunk(chunk, p: int | None):
    arr = _as_chunk(chunk)
    if arr.ndim != 2:
        raise ValueError(
            f"chunks must be 2-D (rows, p), got {tuple(arr.shape)}")
    if p is not None and arr.shape[1] != p:
        raise ValueError(f"chunk has {arr.shape[1]} columns, expected {p}")
    return arr


class ArraySource(ChunkSource):
    """Row-block view over an in-memory (or memory-mapped) (n, p) array,
    or a tensor on any device."""

    reiterable = True

    def __init__(self, x, chunk_rows: int = DEFAULT_CHUNK_ROWS):
        self._x = x if isinstance(x, np.memmap) else _as_chunk(x)
        if self._x.ndim != 2:
            raise ValueError(
                f"x must be 2-D (n, p), got {tuple(self._x.shape)}")
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        self._rows = int(chunk_rows)

    @property
    def p(self) -> int:
        return self._x.shape[1]

    @property
    def n_rows(self) -> int:
        return self._x.shape[0]

    def chunks(self) -> Iterator:
        for lo in range(0, self._x.shape[0], self._rows):
            yield self._x[lo:lo + self._rows]


class IterSource(ChunkSource):
    """One-shot wrap of an iterator/generator of (m, p) chunks."""

    reiterable = False

    def __init__(self, it: Iterable):
        self._it = iter(it)
        self._consumed = False
        self._p: int | None = None

    @property
    def p(self) -> int | None:
        return self._p

    def chunks(self) -> Iterator:
        if self._consumed:
            raise ValueError("one-shot chunk iterator already consumed")
        self._consumed = True
        for chunk in self._it:
            arr = _check_chunk(chunk, self._p)
            self._p = arr.shape[1]
            yield arr


class CallableSource(ChunkSource):
    """Re-iterable source from a zero-arg factory of fresh chunk iterators
    (e.g. a seeded scenario sampler, or ``lambda: read_rows(path)``)."""

    reiterable = True

    def __init__(self, factory, p: int | None = None,
                 n_rows: int | None = None):
        if not callable(factory):
            raise TypeError(f"factory must be callable, got {factory!r}")
        self._factory = factory
        self._p = p
        self._n = n_rows

    @property
    def p(self) -> int | None:
        return self._p

    @property
    def n_rows(self) -> int | None:
        return self._n

    def chunks(self) -> Iterator:
        for chunk in self._factory():
            arr = _check_chunk(chunk, self._p)
            self._p = arr.shape[1]
            yield arr


class _FileShardSource(ChunkSource):
    """Shared row-streaming over a list of per-shard (n_i, p) arrays."""

    reiterable = True

    def __init__(self, chunk_rows: int = DEFAULT_CHUNK_ROWS):
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        self._rows = int(chunk_rows)

    def _open(self) -> Iterator[np.ndarray]:
        raise NotImplementedError

    def chunks(self) -> Iterator[np.ndarray]:
        for arr in self._open():
            for lo in range(0, arr.shape[0], self._rows):
                yield arr[lo:lo + self._rows]


class NpyShardSource(_FileShardSource):
    """Memory-mapped ``.npy`` shards, each holding (n_i, p) rows."""

    def __init__(self, paths: Sequence[str | os.PathLike],
                 chunk_rows: int = DEFAULT_CHUNK_ROWS):
        super().__init__(chunk_rows)
        self._paths = [os.fspath(p) for p in paths]
        if not self._paths:
            raise ValueError("no shard paths given")
        head = np.load(self._paths[0], mmap_mode="r")
        if head.ndim != 2:
            raise ValueError(
                f"shard {self._paths[0]} is {head.ndim}-D, want (rows, p)")
        self._p = int(head.shape[1])
        self._n = None

    @property
    def p(self) -> int:
        return self._p

    @property
    def n_rows(self) -> int | None:
        if self._n is None:
            self._n = sum(
                int(np.load(pa, mmap_mode="r").shape[0])
                for pa in self._paths)
        return self._n

    def _open(self) -> Iterator[np.ndarray]:
        for pa in self._paths:
            arr = np.load(pa, mmap_mode="r")
            _check_chunk(arr, self._p)
            yield arr


class RawShardSource(_FileShardSource):
    """Raw little-endian binary shards (row-major), dtype/p given
    explicitly or read from the ``shards_meta.json`` sidecar."""

    def __init__(self, paths: Sequence[str | os.PathLike], *,
                 p: int, dtype="float32",
                 chunk_rows: int = DEFAULT_CHUNK_ROWS):
        super().__init__(chunk_rows)
        self._paths = [os.fspath(pa) for pa in paths]
        if not self._paths:
            raise ValueError("no shard paths given")
        self._p = int(p)
        self._dtype = np.dtype(dtype)
        itemrow = self._p * self._dtype.itemsize
        for pa in self._paths:
            if os.path.getsize(pa) % itemrow:
                raise ValueError(
                    f"raw shard {pa} size is not a multiple of one row "
                    f"({self._p} x {self._dtype})")

    @property
    def p(self) -> int:
        return self._p

    @property
    def n_rows(self) -> int:
        itemrow = self._p * self._dtype.itemsize
        return sum(os.path.getsize(pa) // itemrow for pa in self._paths)

    def _open(self) -> Iterator[np.ndarray]:
        for pa in self._paths:
            yield np.memmap(pa, dtype=self._dtype, mode="r"
                            ).reshape(-1, self._p)


def write_shards(x, out_dir: str | os.PathLike, *,
                 rows_per_shard: int = 65536, raw: bool = False,
                 prefix: str = "shard") -> list[str]:
    """Split an (n, p) array (or tensor, copied to the host) into shard
    files under ``out_dir``.

    ``raw=False`` writes ``.npy`` shards (self-describing); ``raw=True``
    writes flat binary plus a ``shards_meta.json`` sidecar recording
    dtype/p so :func:`open_shards` can reopen them.  Returns the paths.
    """
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if x.ndim != 2:
        raise ValueError(f"x must be 2-D, got {x.shape}")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, lo in enumerate(range(0, x.shape[0], rows_per_shard)):
        block = x[lo:lo + rows_per_shard]
        ext = "bin" if raw else "npy"
        path = os.path.join(os.fspath(out_dir), f"{prefix}_{i:05d}.{ext}")
        if raw:
            np.ascontiguousarray(block).tofile(path)
        else:
            np.save(path, block)
        paths.append(path)
    if raw:
        meta = {"p": int(x.shape[1]), "dtype": x.dtype.name,
                "rows_per_shard": int(rows_per_shard)}
        with open(os.path.join(os.fspath(out_dir), RAW_META), "w") as f:
            json.dump(meta, f)
    return paths


def open_shards(paths_or_dir, *,
                chunk_rows: int = DEFAULT_CHUNK_ROWS) -> ChunkSource:
    """Open ``.npy``/raw shards as a re-iterable source.  Accepts a
    directory (all shards inside, sorted) or an explicit path list; raw
    shards need the ``shards_meta.json`` sidecar next to them."""
    if isinstance(paths_or_dir, (str, os.PathLike)) \
            and os.path.isdir(paths_or_dir):
        d = os.fspath(paths_or_dir)
        names = sorted(os.listdir(d))
        paths = [os.path.join(d, nm) for nm in names
                 if nm.endswith((".npy", ".bin"))]
    else:
        paths = [os.fspath(p) for p in (
            [paths_or_dir] if isinstance(paths_or_dir, (str, os.PathLike))
            else paths_or_dir)]
    if not paths:
        raise ValueError(f"no shard files in {paths_or_dir!r}")
    n_npy = sum(p.endswith(".npy") for p in paths)
    if 0 < n_npy < len(paths):
        # a stray .npy parsed as raw binary would fold its header bytes
        # into the Gram as a garbage data row — refuse mixed sets
        raise ValueError(
            f"mixed shard formats in {paths_or_dir!r} ({n_npy} .npy of "
            f"{len(paths)} files); a shard set must be all .npy or all raw")
    if n_npy == len(paths):
        return NpyShardSource(paths, chunk_rows=chunk_rows)
    meta_path = os.path.join(os.path.dirname(paths[0]), RAW_META)
    if not os.path.exists(meta_path):
        raise ValueError(
            f"raw shards need a {RAW_META} sidecar (see write_shards)")
    with open(meta_path) as f:
        meta = json.load(f)
    return RawShardSource(paths, p=meta["p"], dtype=meta["dtype"],
                          chunk_rows=chunk_rows)


def is_streaming_input(data) -> bool:
    """True when ``data`` is chunk-stream-shaped rather than one (n, p)
    matrix: a ChunkSource, shard path(s), a factory, or a generator/
    iterator.  Arrays and tensors (anything with ``__array__``) and
    nested lists are NOT streams — they take the in-memory path."""
    if isinstance(data, (ChunkSource, str, os.PathLike)) or callable(data):
        return True
    if hasattr(data, "__array__") or isinstance(data, (list, tuple)):
        return False
    return isinstance(data, Iterable)


def as_source(data, *, chunk_rows: int | None = None) -> ChunkSource:
    """Normalize anything chunk-like into a :class:`ChunkSource`.

    Arrays and tensors become re-iterable row-block views; shard paths
    open memory-mapped; callables become re-iterable factories; lists of
    2-D arrays become re-iterable chunk lists; any other iterable is
    wrapped one-shot.  ``chunk_rows=None`` means
    :data:`DEFAULT_CHUNK_ROWS` (explicit 0/negative values are rejected
    by the sources, not silently defaulted).
    """
    if chunk_rows is None:
        chunk_rows = DEFAULT_CHUNK_ROWS
    if isinstance(data, ChunkSource):
        return data
    if isinstance(data, (str, os.PathLike)):
        return open_shards(data, chunk_rows=chunk_rows)
    if callable(data):
        return CallableSource(data)
    if hasattr(data, "__array__"):
        return ArraySource(data, chunk_rows=chunk_rows)
    if isinstance(data, (list, tuple)):
        if data and all(isinstance(c, (str, os.PathLike)) for c in data):
            return open_shards(list(data), chunk_rows=chunk_rows)
        chunk_list = [_check_chunk(c, None) for c in data]
        for c in chunk_list[1:]:
            _check_chunk(c, chunk_list[0].shape[1])
        return CallableSource(lambda: iter(chunk_list),
                              p=chunk_list[0].shape[1] if chunk_list else None,
                              n_rows=sum(c.shape[0] for c in chunk_list))
    if isinstance(data, Iterable):
        return IterSource(data)
    raise TypeError(
        f"cannot interpret {type(data).__name__} as a chunk source: want "
        f"an (n, p) array, an iterator of chunks, a chunk-list, shard "
        f"paths, or a callable factory")
