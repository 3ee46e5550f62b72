"""Dry run: one step of every (architecture x input shape) cell on the
production meshes, on fake tensors in a fake process group, and its
roofline terms.

Port of ``repro.launch.dryrun``.  Where the reference lowers and
compiles each cell for 256 / 512 placeholder TPU devices and reads the
compiled program, the port runs ONE step of its own program, eagerly,
as rank 0 of a ``fake`` process group of the mesh's world size (16 x 16
or 2 x 16 x 16), on ``FakeTensorMode`` tensors: shapes, dtypes and
devices propagate and nothing is allocated, launched or sent.  Per cell:

  1. the config and its inputs (``configs.input_specs``, meta tensors of
     the reference's shapes), materialised as fake tensors;
  2. the mesh (``launch.mesh.Mesh``) on the fake group: NCCL's routes on
     ``device="cuda"`` (a reduce-scatter of the gradients where a leaf's
     spec allows), gloo's on ``"cpu"``;
  3. the state: the full-size parameters from ``transformer.model_schema``
     (as ``init_params`` builds them, without its draws); for train,
     each rank's blocks (``lm.shard_params_``) in ``lm.init_train_state``;
  4. one step through the port's entry point, on route ``"split"`` for
     every family and kind (each layer's blocks gathered over the FSDP
     axis as it runs, its compute split over ``"model"``):
     ``lm.make_train_step(..., mesh=)`` with AdamW and
     ``cosine_schedule(3e-4, 100, 10000)``; ``lm.make_prefill`` /
     ``lm.make_decode_step`` with ``mesh=``, the rank's blocks of the
     parameters and of the cache (``lm.init_cache_blocks``: the ring
     split by kv heads and / or slots, the SSM state by channels and
     heads, Whisper's encoder output by width, as the reference's
     ``cache_shardings``), its rows of the tokens (all rows where the
     batch team does not divide them) and its block of the frames, as
     the reference's jit of the cell lays them out.  A layout the split
     route cannot honour raises: nothing is replicated silently;
  5. four counters around the step: ``FlopCounterMode`` (flops; kernel 4
     counts its visible (query, key) pairs through its custom op's
     rule), a dispatch mode counting the bytes every op that touches
     storage reads and writes (views and metadata ops skipped: the
     unfused eager traffic eager PyTorch moves, NOT XLA's fused count),
     ``comm.group``'s collective watcher (wire bytes and counts per HLO
     kind, ``launch.roofline``'s conventions), and a tracker of live fake
     storages (the peak, rounded to 512 bytes on CUDA as the caching
     allocator rounds), checked against the H100's 80 GB.

The memory fields keep the reference's names: ``total_bytes_per_dev`` is
the peak, ``arg_bytes_per_dev`` the state and inputs live at entry,
``alias_bytes_per_dev`` what the step updates in place (the state the
reference donates: train state, serve cache), ``out_bytes_per_dev`` the
outputs and ``temp_bytes_per_dev`` the remainder, so that
arg + temp + out - alias = total as in the reference.

No trip-count correction: eager mode runs every layer in a Python loop,
so every layer is counted (records carry ``"extrapolated": false``).
``--no-measure`` skips the flop and byte counters (memory only).  The
reference's ``_unit`` is kept: the full-depth count equals the 1-unit /
2-unit extrapolation for layer-homogeneous cost.

``device`` defaults to ``"cuda"``, the card's routes, and needs no card
(nothing is allocated), though fake CUDA tensors need a CUDA build of
torch to be indexed; ``--device cpu`` traces the CPU routes (the plain
versions of the kernels).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k
  python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b \\
      --shape prefill_32k --override '{"attention_impl": "flash"}'
  python -m repro_torch.launch.dryrun --all --out build/torch_dryrun.jsonl
  python -m repro_torch.launch.roofline --table build/torch_dryrun.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import fnmatch
import json
import math
import os
import sys
import time
import traceback
import weakref
from fractions import Fraction
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from .. import configs as C
from ..comm import group as comm_group
from ..core.costmodel import H100
from ..models import layers as Lyr
from ..models import lm, transformer as T
from ..train.optim import AdamW, cosine_schedule
from . import roofline as R
from .mesh import MULTIPOD_AXES, MULTIPOD_SHAPE, POD_AXES, POD_SHAPE, Mesh

#: device memory of one H100 (80 GB), not measured
HBM_BYTES = H100.hbm_bytes

#: where records go unless ``--out`` says otherwise (never the
#: reference's ``results/dryrun*.jsonl``, which its table reads)
DEFAULT_OUT = "build/torch_dryrun.jsonl"

#: the caching allocator's granule on CUDA
_CUDA_GRANULE = 512

#: ops that touch no storage: metadata, aliases, uninitialised buffers
#: (every op whose schema is a view is skipped as well)
_NO_TRAFFIC = frozenset({
    "view", "_unsafe_view", "t", "transpose", "permute", "expand",
    "as_strided", "slice", "select", "unsqueeze", "squeeze", "detach",
    "alias", "lift_fresh", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "_reshape_alias",
})

#: index writes touch only the rows they index: their destination counts
#: at the size of the values written (read too where they accumulate)
_INDEX_WRITES = {"index_copy_": False, "index_copy": False,
                 "index_put_": False, "index_put": False,
                 "scatter_": False, "masked_scatter_": False,
                 "index_add_": True, "scatter_add_": True}


def _unit(cfg) -> int:
    """Smallest layer-count period over which cost is homogeneous."""
    if cfg.family == "hybrid":
        return cfg.shared_every
    if cfg.local_global:
        return 2
    return 1


def _tensors(tree) -> list:
    """The tensors of a nest of tuples, lists, dicts and NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if hasattr(tree, "tree"):
        return _tensors(tree.tree())
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounters(TorchDispatchMode):
    """Bytes read and written by the ops that touch storage
    (``hbm_bytes``, when ``count_bytes``), and the live bytes of the
    storages the ops create and of those :meth:`track` is given (``live``,
    ``peak``), each storage rounded to the caching allocator's 512-byte
    granule on CUDA.  Works on fake tensors: a storage is freed when its
    last tensor goes."""

    def __init__(self, count_bytes: bool = True):
        super().__init__()
        self.count_bytes = count_bytes
        self.hbm_bytes = 0
        self.live = 0
        self.peak = 0
        #: calls of the port's own ops (``repro_torch::*``: the kernels)
        self.kernel_calls: dict = {}
        self._sizes: dict = {}

    def storage_bytes(self, t: torch.Tensor) -> int:
        n = t.untyped_storage().nbytes()
        if t.device.type == "cuda":
            n = -(-n // _CUDA_GRANULE) * _CUDA_GRANULE
        return n

    def track(self, tensors) -> None:
        """Count these tensors' storages as live (once each)."""
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            n = self.storage_bytes(t)
            old = self._sizes.get(key)
            if old is None:
                self._sizes[key] = n
                self.live += n
                weakref.finalize(st, self._free, key)
            elif old != n:              # resized in place
                self._sizes[key] = n
                self.live += n - old
        self.peak = max(self.peak, self.live)

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key, 0)

    def _traffic(self, func, args, kwargs, out) -> int:
        name = func.overloadpacket.__name__
        if func.is_view or name in _NO_TRAFFIC:
            return 0
        outs = _tensors(out)
        if not outs:
            return 0                    # metadata queries, item()
        ins = {id(t): t for t in _tensors((args, kwargs))}
        if name in _INDEX_WRITES:
            dest = args[0]
            ins.pop(id(dest), None)
            values = [t for t in ins.values() if t.dtype == dest.dtype]
            written = max((_nbytes(t) for t in values), default=0)
            read = sum(_nbytes(t) for t in ins.values())
            return read + written * (2 if _INDEX_WRITES[name] else 1)
        return (sum(_nbytes(t) for t in ins.values())
                + sum(_nbytes(t) for t in outs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "repro_torch":
            name = func.overloadpacket.__name__
            self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        if self.count_bytes:
            self.hbm_bytes += self._traffic(func, args, kwargs, out)
        self.track(_tensors(out))
        return out


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a ``fake`` process group of
    ``world_size`` ranks (collectives return at once, moving nothing),
    destroyed on exit with the port's team cache.  Refuses to start
    inside a real process group."""
    comm_group.init_fake_process_group(world_size)
    try:
        yield
    finally:
        comm_group.destroy_process_group()


def fake_params(cfg, max_len: int, dev) -> T.DecoderLM:
    """The full-size parameters in ``cfg.param_dtype``, laid out as
    ``transformer.init_params`` lays them out, uninitialised (fake under
    ``FakeTensorMode``)."""
    schema = T.model_schema(cfg, max_len)
    stacked = T.stacked_groups(cfg)
    dtype = getattr(torch, cfg.param_dtype)

    def build(entries, lead: int):
        return {k: torch.empty(shape[lead:], dtype=dtype, device=dev)
                for k, (shape, _, _) in entries.items()}

    tree = {name: ([build(schema[name], 1) for _ in range(stacked[name])]
                   if name in stacked else build(schema[name], 0))
            for name in schema}
    return T.DecoderLM(cfg, tree)


def _on(tree, dev):
    """A tree of ``configs.step_inputs`` with each meta tensor made anew
    (fake) on ``dev``."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device=dev)
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_on(v, dev) for v in tree))
    return tree


def _prepare(cfg, kind: str, batch_size: int, seq_len: int, mesh, dev):
    """(run, entry tensors, in-place tensors, rows per device) of one
    step of ``kind`` at a global batch of ``batch_size``; ``run()``
    returns the step's outputs."""
    params = fake_params(cfg, seq_len, dev)
    specs = None
    if mesh is not None:
        specs = lm.param_shardings(cfg, mesh, seq_len)
        lm.shard_params_(params, specs, mesh)
    if kind == "train":
        opt = AdamW()
        state = lm.init_train_state(params, opt)
        step = lm.make_train_step(cfg, opt, cosine_schedule(3e-4, 100, 10000),
                                  mesh=mesh, specs=specs)
        batch = _on(C.step_inputs(cfg, kind, batch_size, seq_len)["batch"],
                    dev)
        rows = batch_size
        if mesh is not None:
            # the rows lm._sharded_step keeps on a rank
            n = mesh.axes_size(Lyr.batch_axes(cfg, mesh))
            b_micro = batch_size // cfg.n_micro
            if b_micro % n == 0 and Lyr.moe_shardable(cfg, b_micro * seq_len,
                                                      n):
                rows //= n
        held = _tensors(state)
        return (lambda: step(state, batch)), held + _tensors(batch), held, \
            rows
    spec = _on(C.step_inputs(cfg, kind, batch_size, seq_len), dev)
    serve = {}
    if mesh is not None:
        # this rank's blocks of the cache, rows of the tokens and block
        # of the frames
        serve = dict(mesh=mesh, specs=specs, batch=batch_size)
        lay = lm.serve_shardings(cfg, mesh, batch_size, seq_len)
        spec["cache"] = lm.init_cache_blocks(cfg, mesh, batch_size, seq_len,
                                             device=dev)
        for name in ("tokens", "token", "frames"):
            t = spec.get(name)
            if t is not None:
                spec[name] = torch.empty(
                    lm.block_shape(t.shape, lay[name], mesh), dtype=t.dtype,
                    device=dev)
    if kind == "prefill":
        fn = lm.make_prefill(cfg, seq_len, **serve)
        args = [params, spec["cache"], spec["tokens"]]
        if spec["frames"] is not None:
            args.append(spec["frames"])
    else:
        fn = lm.make_decode_step(cfg, **serve)
        args = [params, spec["cache"], spec["token"], spec["step"]]
    return (lambda: fn(*args)), _tensors(args), _tensors(spec["cache"]), \
        args[2].shape[0]


def _unique_bytes(counters: StepCounters, tensors) -> int:
    seen = {}
    for t in tensors:
        seen[t.untyped_storage()._cdata] = counters.storage_bytes(t)
    return sum(seen.values())


def _route(mesh_shape) -> str:
    """How the step runs: ``"split"`` on a mesh (every kind), else
    ``"one process"``."""
    return "one process" if mesh_shape is None else "split"


def trace_step(cfg, kind: str, batch_size: int, seq_len: int, *,
               mesh_shape=None, mesh_axes=None, device=None,
               measure: bool = True, backend: str | None = None) -> dict:
    """Counts of one ``kind`` step ("train", "prefill", "decode") of
    ``cfg`` at a global batch of ``batch_size`` x ``seq_len``, as rank 0
    of a fake mesh of ``mesh_shape`` over ``mesh_axes`` (None: one
    process, no mesh), on fake tensors on ``device`` (default
    ``"cuda"``).  ``backend`` picks the collectives' routes (default:
    NCCL's on CUDA, gloo's on the CPU).  Returns flops, hbm_bytes,
    wire_bytes, the :class:`roofline.CollectiveStats`, the memory fields
    (arg, out, alias, temp, peak bytes), rows per device, the route
    (:func:`_route`) and the wall."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dev = torch.device("cuda" if device is None else device)
    world = (contextlib.nullcontext() if mesh_shape is None
             else fake_world(math.prod(mesh_shape)))
    t0 = time.time()
    colls = R.CollectiveStats()
    wire = []
    with world, FakeTensorMode():
        mesh = None
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if mesh_shape is not None:
            mesh = Mesh(mesh_shape, mesh_axes, dev)
            # the fake group takes the routes of the backend it stands for
            mesh.backend = backend
        run, entry, alias, rows = _prepare(cfg, kind, batch_size, seq_len,
                                           mesh, dev)
        counters = StepCounters(count_bytes=measure)
        counters.track(entry)
        arg = counters.live

        def watch(prim, axes, nbytes):
            n = mesh.axes_size(axes) if mesh is not None else 1
            colls.add_watched(prim, nbytes, n)
            wire.append(nbytes)

        prev = comm_group.set_collective_watcher(watch)
        flop = FlopCounterMode(display=False) if measure else None
        try:
            with (flop or contextlib.nullcontext()), counters:
                out = run()
        finally:
            comm_group.set_collective_watcher(prev)
        kernel_flops = {}
        if flop is not None:
            for op, n in flop.get_flop_counts().get("Global", {}).items():
                if getattr(op, "_qualified_op_name", "").startswith(
                        "repro_torch::"):
                    kernel_flops[op._qualified_op_name.split("::")[1]] = n
        out_bytes = _unique_bytes(counters, _tensors(out))
        alias_bytes = _unique_bytes(counters, alias)
        peak = counters.peak
        del out, run
    return {
        "flops": float(flop.get_total_flops()) if flop else 0.0,
        "hbm_bytes": float(counters.hbm_bytes),
        "wire_bytes": float(colls.wire_bytes),
        "wire_exact": sum(wire, Fraction(0)),
        "colls": colls,
        "arg_bytes": arg, "out_bytes": out_bytes, "alias_bytes": alias_bytes,
        "temp_bytes": peak - arg - out_bytes + alias_bytes,
        "peak_bytes": peak, "rows_per_dev": rows, "backend": backend,
        "route": _route(mesh_shape),
        "kernel_calls": dict(counters.kernel_calls),
        "kernel_flops": kernel_flops,
        "wall_s": time.time() - t0,
    }


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               config_overrides: dict | None = None, verbose: bool = True,
               measure: bool = True, device=None, backend=None, cfg=None):
    """Trace one cell on a production mesh; returns (record_dict,
    counts), the counts :func:`trace_step`'s.  ``cfg`` (default
    ``configs.get(arch)``) lets a caller trace a smoke config."""
    cfg = cfg if cfg is not None else C.get(arch)
    if config_overrides:
        cfg = cfg.with_(**config_overrides)
    shape, axes = ((MULTIPOD_SHAPE, MULTIPOD_AXES) if multi_pod
                   else (POD_SHAPE, POD_AXES))
    mesh_name = "2x16x16" if multi_pod else "16x16"
    n_dev = math.prod(shape)
    sh = C.SHAPES[shape_name]
    dev = torch.device("cuda" if device is None else device)
    cnt = trace_step(cfg, sh["kind"], sh["global_batch"], sh["seq_len"],
                     mesh_shape=shape, mesh_axes=axes, device=dev,
                     measure=measure, backend=backend)
    mem = R.MemoryStats(cnt["arg_bytes"], cnt["out_bytes"],
                        cnt["alias_bytes"], cnt["temp_bytes"])
    roof = R.build_roofline(
        arch, shape_name, mesh_name, cfg, sh["kind"], sh["seq_len"],
        sh["global_batch"], n_dev,
        {"flops": cnt["flops"], "bytes accessed": cnt["hbm_bytes"]}, mem,
        cnt["colls"])
    total = cnt["peak_bytes"]
    rec = roof.row()
    rec.update({
        "kind": sh["kind"],
        "n_devices": n_dev,
        "lower_s": round(cnt["wall_s"], 1),
        "compile_s": 0.0,
        "extrapolated": False,
        "arg_bytes_per_dev": cnt["arg_bytes"],
        "temp_bytes_per_dev": cnt["temp_bytes"],
        "out_bytes_per_dev": cnt["out_bytes"],
        "alias_bytes_per_dev": cnt["alias_bytes"],
        "total_bytes_per_dev": total,
        "fits_hbm": bool(total <= HBM_BYTES),
        "model_flops_per_dev": roof.model_flops,
        "device": dev.type,
        "backend": cnt["backend"],
        "rows_per_dev": cnt["rows_per_dev"],
        "route": cnt["route"],
        "kernel_calls": cnt["kernel_calls"],
        "kernel_flops": cnt["kernel_flops"],
    })
    if verbose:
        print(f"== {arch} x {shape_name} on {mesh_name} "
              f"({sh['kind']}, {n_dev} devices, {dev.type} routes, "
              f"{cnt['rows_per_dev']} rows per device, route "
              f"{cnt['route']})")
        print(f"   traced in {cnt['wall_s']:.1f}s (eager, every layer "
              f"counted)")
        print(f"   memory: args {cnt['arg_bytes'] / 1e9:.2f} GB"
              f"  temp {cnt['temp_bytes'] / 1e9:.2f} GB"
              f"  out {cnt['out_bytes'] / 1e9:.2f} GB"
              f"  aliased {cnt['alias_bytes'] / 1e9:.2f} GB"
              f"  peak {total / 1e9:.2f} GB"
              f" -> fits {HBM_BYTES / 1e9:.0f}GB HBM: {rec['fits_hbm']}")
        print(f"   per-device: {cnt['flops']:.3e} flops, "
              f"{cnt['hbm_bytes']:.3e} HBM bytes, "
              f"{cnt['wire_bytes'] / 1e9:.3f} GB wire; collectives "
              f"{roof.coll_counts}")
        print(f"   roofline: compute {roof.t_compute * 1e3:.2f} ms | "
              f"memory {roof.t_memory * 1e3:.2f} ms | "
              f"collective {roof.t_collective * 1e3:.2f} ms "
              f"=> {roof.dominant}-bound, "
              f"useful {roof.useful_fraction:.2f}, "
              f"MFU@bound {roof.mfu_at_bound:.2%}")
    return rec, cnt


def _refuse_reference_glob(out: str) -> bool:
    p = Path(out)
    return p.parent.name == "results" and fnmatch.fnmatch(p.name,
                                                          "dryrun*.jsonl")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Dry run of the LM cells on fake tensors in a fake "
                    "process group of the production meshes' size.",
        epilog="--device cpu traces the CPU routes: kernel 4 (flash "
               "attention, with attention_impl 'flash') then runs its "
               "plain version, whose flops are the full L^2 products, not "
               "the kernel's visible (query, key) pairs.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(C.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-measure", action="store_true",
                    help="skip the flop and byte counters (memory only)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"JSONL file the records are appended to "
                         f"(default {DEFAULT_OUT})")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig overrides")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="whose routes to trace (default cuda; no card "
                         "needed)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="whose collective routes the fake group takes "
                         "(default: nccl on cuda, gloo on cpu)")
    args = ap.parse_args(argv)
    if _refuse_reference_glob(args.out):
        ap.error(f"--out {args.out} would mix with the reference's "
                 f"results/dryrun*.jsonl records")
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    overrides = json.loads(args.override) if args.override else None
    cells = (list(C.cells()) if args.all
             else [(args.arch, args.shape)])
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    records, failures = [], []
    for arch, shape in cells:
        for mp in meshes:
            try:
                rec, _ = lower_cell(arch, shape, multi_pod=mp,
                                    config_overrides=overrides,
                                    measure=not args.no_measure,
                                    device=args.device,
                                    backend=args.backend)
                records.append(rec)
            except Exception as e:
                traceback.print_exc()
                failures.append((arch, shape, mp, repr(e)))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    if failures:
        print(f"FAILED cells: {failures}", file=sys.stderr)
        sys.exit(1)
    print(f"dry-run OK: {len(records)} records")


if __name__ == "__main__":
    main()
