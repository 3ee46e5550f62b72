"""Roofline terms of a dry-run cell, priced at the H100's data sheet.

Port of ``repro.launch.roofline``.  Three terms per (arch x shape x
mesh), in seconds per step on the TARGET part, one H100 SXM card:

    compute    = per_device_flops / PEAK_FLOPS
    memory     = per_device_hbm_bytes / HBM_BW
    collective = sum over collectives of wire_bytes / LINK_BW

The constants are NVIDIA's data-sheet figures (dense bf16 tensor-core
peak; ``core.costmodel.H100``'s HBM3 and NVLink rates), not measurements.
The counts come from ``launch.dryrun``, which runs one step of the port's
program on fake tensors: ``FlopCounterMode``'s flops, the bytes its ops
read and write, and the collectives its mesh posts.

Where the reference parses the collectives out of the compiled HLO
(``parse_collectives``), the port has no HLO: the collective watcher of
``comm.group`` announces every collective a rank posts, and
:meth:`CollectiveStats.add_watched` files it under the reference's HLO
kind.  The wire-byte conventions per kind are the reference's (ring
algorithms; n the group size):

    all-gather         (n-1)/n * result_bytes
    reduce-scatter     (n-1)/n * operand_bytes
    all-reduce         2 (n-1)/n * operand_bytes   (RS + AG)
    all-to-all         (n-1)/n * operand_bytes
    collective-permute operand_bytes

They equal ``core.costmodel.collective_wire_bytes``'s on the same
collective.  ``python -m repro_torch.launch.roofline --table FILE...``
renders the records of ``launch.dryrun --out`` as the reference's
markdown table (``scripts/roofline_table.py``), ``--by-arch`` as one row
per architecture with a column per (shape, mesh).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import dataclass, field
from fractions import Fraction

from ..core.costmodel import H100

#: H100 SXM data sheet: dense bf16 tensor-core peak (FLOP/s), HBM3
#: bandwidth and NVLink bandwidth each way (bytes/s); not measured
PEAK_FLOPS = 989e12
HBM_BW = H100.hbm_bw
LINK_BW = H100.link_bw

#: the port's collective primitives (``comm.group.Teams``) by HLO kind
WATCHED_KINDS = {
    "all_gather": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "psum": "all-reduce",
    "pmin": "all-reduce",
    "pmax": "all-reduce",
    "all_to_all": "all-to-all",
    "ppermute": "collective-permute",
}


def result_bytes(kind: str, wire_bytes, group_n: int) -> Fraction:
    """The HLO result bytes of one ``kind`` collective over ``group_n``
    members that puts ``wire_bytes`` on the wire: the inverse of
    :meth:`CollectiveStats.add`'s conventions."""
    wire = Fraction(wire_bytes)
    if kind == "collective-permute":
        return wire
    frac = Fraction(group_n - 1, group_n)
    if kind == "all-gather":
        return wire / frac
    if kind == "reduce-scatter":
        return wire / frac / group_n
    if kind == "all-reduce":
        return wire / (2 * frac)
    if kind == "all-to-all":
        return wire / frac
    raise ValueError(f"no wire-byte convention for {kind!r}")


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=dict)
    result_bytes: dict = field(default_factory=dict)
    wire_bytes: float = 0.0

    def add(self, kind: str, rbytes: int, group_n: int):
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.result_bytes[kind] = self.result_bytes.get(kind, 0) + rbytes
        frac = (group_n - 1) / group_n if group_n > 1 else 0.0
        if kind == "all-gather":
            # result is the gathered (large) buffer; each link carries
            # (n-1)/n of it but per-device INPUT is result/n
            self.wire_bytes += frac * rbytes
        elif kind == "reduce-scatter":
            # result is the scattered (small) buffer; operand = n * result
            self.wire_bytes += frac * rbytes * group_n
        elif kind == "all-reduce":
            self.wire_bytes += 2 * frac * rbytes
        elif kind == "all-to-all":
            self.wire_bytes += frac * rbytes
        elif kind == "collective-permute":
            self.wire_bytes += rbytes

    def add_watched(self, prim: str, wire_bytes, group_n: int) -> None:
        """File one collective announced by ``comm.group``'s watcher
        (``prim``, its exact wire bytes, its team's size) under its HLO
        kind.  A team of one member or a collective that moves nothing
        (a barrier, a ppermute onto itself) is left out: it puts nothing
        on the wire, and a compiled program has no such collective."""
        if group_n <= 1 or not wire_bytes or prim not in WATCHED_KINDS:
            return
        kind = WATCHED_KINDS[prim]
        self.add(kind, int(result_bytes(kind, wire_bytes, group_n)),
                 group_n)


@dataclass
class MemoryStats:
    """Per-device memory of one step, in the reference's
    ``memory_analysis()`` terms (bytes)."""
    argument_size_in_bytes: int
    output_size_in_bytes: int
    alias_size_in_bytes: int
    temp_size_in_bytes: int


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops: float                 # per-device counted flops
    hbm_bytes: float             # per-device bytes read and written
    wire_bytes: float            # per-device collective bytes on the wire
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops: float           # 6 N D useful flops (per device)
    coll_counts: dict = field(default_factory=dict)
    mem_stats: dict = field(default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound(self) -> float:
        """Roofline lower bound on step time: overlapping compute/memory/
        collective perfectly, time = max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / counted flops: how much of the step's compute is
        forward/backward matmul work (catches remat/dispatch waste)."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def mfu_at_bound(self) -> float:
        """Model-flops utilization if the step ran exactly at the
        roofline bound: the 'roofline fraction' we report."""
        return (self.model_flops / PEAK_FLOPS) / self.bound \
            if self.bound else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "wire_bytes": self.wire_bytes,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "dominant": self.dominant, "bound_s": self.bound,
            "useful_frac": self.useful_fraction,
            "mfu_at_bound": self.mfu_at_bound,
            **{f"n_{k}": v for k, v in self.coll_counts.items()},
        }


def model_flops_per_step(cfg, shape_kind: str, seq_len: int,
                         global_batch: int, n_devices: int) -> float:
    """6*N*D for training (fwd+bwd), 2*N_active per generated/processed
    token for inference, per device."""
    n_active = cfg.param_count(active_only=True)
    if shape_kind == "train":
        tokens = seq_len * global_batch
        total = 6.0 * n_active * tokens
    elif shape_kind == "prefill":
        tokens = seq_len * global_batch
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * global_batch
    return total / n_devices


def build_roofline(arch: str, shape: str, mesh_name: str, cfg, kind: str,
                   seq_len: int, global_batch: int, n_devices: int,
                   cost: dict, mem_stats: MemoryStats | None,
                   colls: CollectiveStats | None) -> Roofline:
    """The reference's ``build_roofline`` with the watched collectives in
    place of its HLO text."""
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    colls = colls if colls is not None else CollectiveStats()
    mf = model_flops_per_step(cfg, kind, seq_len, global_batch, n_devices)
    ms = {}
    if mem_stats is not None:
        ms = {"args_gb": mem_stats.argument_size_in_bytes / 1e9,
              "out_gb": mem_stats.output_size_in_bytes / 1e9,
              "temp_gb": mem_stats.temp_size_in_bytes / 1e9}
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name,
        flops=flops, hbm_bytes=hbm, wire_bytes=colls.wire_bytes,
        t_compute=flops / PEAK_FLOPS,
        t_memory=hbm / HBM_BW,
        t_collective=colls.wire_bytes / LINK_BW,
        model_flops=mf,
        coll_counts=dict(colls.counts),
        mem_stats=ms,
    )


# ---------------------------------------------------------------------------
# the table (the reference's scripts/roofline_table.py)
# ---------------------------------------------------------------------------

def _load(paths) -> dict:
    """{(arch, shape, mesh): record} of the dry-run records in ``paths``
    (later files override earlier ones), only the cells of
    ``configs.cells()``."""
    from .. import configs as C

    valid = {(C.canon(a), s) for a, s in C.cells()}
    recs = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                if line.strip():
                    r = json.loads(line)
                    key = (C.canon(r["arch"]), r["shape"], r["mesh"])
                    if key[:2] in valid:
                        recs[key] = r
    return recs


def render_table(paths, hbm_bytes: float = H100.hbm_bytes) -> list[str]:
    """The reference's markdown table of the dry-run records in
    ``paths``, one row per (arch, shape, mesh), and a last line counting
    the records that fit ``hbm_bytes``."""
    recs = _load(paths)
    out = ["| arch | shape | mesh | compute ms | memory ms | coll ms | "
           "dominant | bound s | useful | MFU@bound | fits HBM | GB/dev |",
           "|---|---|---|---:|---:|---:|---|---:|---:|---:|---|---:|"]
    for (a, s, m), r in sorted(recs.items()):
        out.append(
            f"| {a} | {s} | {m} | {1e3 * r['t_compute']:.1f} | "
            f"{1e3 * r['t_memory']:.1f} | {1e3 * r['t_collective']:.1f} | "
            f"{r['dominant']} | {r['bound_s']:.2f} | "
            f"{r['useful_frac']:.2f} | {100 * r['mfu_at_bound']:.1f}% | "
            f"{'Y' if r['fits_hbm'] else 'N'} | "
            f"{r['total_bytes_per_dev'] / 1e9:.1f} |")
    nfit = sum(bool(r["fits_hbm"]) for r in recs.values())
    out.append(f"{len(recs)} cells shown, {nfit} fit {hbm_bytes / 1e9:.0f} "
               f"GB HBM")
    return out


def render_by_arch(paths, hbm_bytes: float = H100.hbm_bytes) -> list[str]:
    """A shorter table: one row per architecture, one column per (shape,
    mesh), each entry the bound in seconds with its dominant term's
    initial (c, m or x for collective) and the peak GB per device (*
    where it does not fit ``hbm_bytes``); a last line counting the
    records that fit."""
    from .. import configs as C

    recs = _load(paths)
    cols = [(s, m) for s in C.SHAPES for m in ("16x16", "2x16x16")
            if any(k[1:] == (s, m) for k in recs)]
    out = ["| arch | " + " | ".join(f"{s} {m}" for s, m in cols) + " |",
           "|---|" + "---:|" * len(cols)]
    initial = {"compute": "c", "memory": "m", "collective": "x"}
    for a in C.ARCHS:
        cells = []
        for s, m in cols:
            r = recs.get((a, s, m))
            cells.append("-" if r is None else (
                f"{r['bound_s']:.3g}{initial[r['dominant']]} "
                f"{r['total_bytes_per_dev'] / 1e9:.1f}"
                f"{'' if r['fits_hbm'] else '*'}"))
        out.append(f"| {a} | " + " | ".join(cells) + " |")
    nfit = sum(bool(r["fits_hbm"]) for r in recs.values())
    out.append(f"{len(recs)} records, {nfit} fit {hbm_bytes / 1e9:.0f} GB "
               f"HBM")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Render dry-run records (launch.dryrun --out) as the "
                    "roofline table.")
    ap.add_argument("--table", nargs="+", required=True, metavar="FILE",
                    help="JSONL files of dry-run records")
    ap.add_argument("--by-arch", action="store_true",
                    help="one row per architecture, one column per (shape, "
                         "mesh): bound s, dominant term, GB per device")
    args = ap.parse_args(argv)
    missing = [p for p in args.table if not os.path.exists(p)]
    if missing:
        print(f"no such file: {missing}", file=sys.stderr)
        return 2
    lines = (render_by_arch if args.by_arch else render_table)(args.table)
    print("\n".join(lines[:-1]))
    print(lines[-1], file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
