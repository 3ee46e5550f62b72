"""The port's dry run (``repro_torch.launch.dryrun`` / ``roofline``,
``configs.cells`` / ``input_specs``) against the reference, on the CPU,
on fake tensors (nothing of the reference's shapes is allocated).

The reference's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` when imported,
so it is never imported here; its record's keys are listed below from
its source."""
import json
import math
import time
from fractions import Fraction

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as RC
import repro.launch.roofline as RR
from repro_torch import configs as C
from repro_torch.core.costmodel import collective_wire_bytes
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm, transformer as T
from repro_torch.train.optim import AdamW, cosine_schedule

CELLS = list(RC.cells())

#: the keys ``repro.launch.dryrun.lower_cell`` adds to ``Roofline.row()``
REF_RECORD_KEYS = {
    "kind", "n_devices", "lower_s", "compile_s", "extrapolated",
    "arg_bytes_per_dev", "temp_bytes_per_dev", "out_bytes_per_dev",
    "alias_bytes_per_dev", "total_bytes_per_dev", "fits_hbm",
    "model_flops_per_dev"}

#: the port's collective primitives and the reference's HLO kinds
PRIM_KIND = [("all_gather", "all-gather"),
             ("reduce_scatter", "reduce-scatter"),
             ("psum", "all-reduce"), ("all_to_all", "all-to-all"),
             ("ppermute", "collective-permute")]

POD = ((16, 16), ("data", "model"))
MULTIPOD = ((2, 16, 16), ("pod", "data", "model"))


# ---------------------------------------------------------------------------
# configs: cells, long_context_ok, input_specs
# ---------------------------------------------------------------------------

def test_cells_equal_the_reference():
    assert list(C.cells()) == CELLS
    assert len(CELLS) == 34
    assert list(C.cells(include_long_skips=True)) == list(
        RC.cells(include_long_skips=True))


@pytest.mark.parametrize("arch", C.ARCHS)
def test_long_context_ok_agrees(arch):
    assert C.long_context_ok(C.get(arch)) == RC.long_context_ok(RC.get(arch))


def _leaves(tree, prefix=()):
    """{path: (shape, dtype name)} of a tree of shaped leaves."""
    if tree is None:
        return {prefix: None}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], prefix + (k,)))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_leaves(getattr(tree, k), prefix + (k,)))
        return out
    if isinstance(tree, (int, str)):
        return {prefix: tree}
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch,shape", CELLS, ids=lambda c: str(c))
def test_input_specs_equal_the_reference(arch, shape):
    """Every leaf, cache leaves included, in shape and dtype; the
    reference's keys kind, batch_size and seq_len."""
    mine = C.input_specs(C.get(arch), shape)
    theirs = RC.input_specs(RC.get(arch), shape)
    assert set(mine) == set(theirs)
    assert _leaves(mine) == _leaves(theirs)
    for t in _leaves({k: v for k, v in mine.items()
                      if k not in ("kind", "batch_size", "seq_len")}).values():
        assert t is None or isinstance(t, tuple)
    leaf = mine["batch"].tokens if mine["kind"] == "train" else (
        mine["tokens"] if mine["kind"] == "prefill" else mine["token"])
    assert leaf.device.type == "meta"


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev", [256, 512])
@pytest.mark.parametrize("arch,shape", CELLS, ids=lambda c: str(c))
def test_model_flops_per_step_equal_the_reference(arch, shape, n_dev):
    sh = C.SHAPES[shape]
    args = (sh["kind"], sh["seq_len"], sh["global_batch"], n_dev)
    assert R.model_flops_per_step(C.get(arch), *args) == \
        RR.model_flops_per_step(RC.get(arch), *args)


def _payload(prim: str, rbytes: int, n: int) -> int:
    """The bytes a port collective is handed for an HLO result of
    ``rbytes``: an all-gather's input is result / n, a reduce-scatter's
    operand n x result."""
    if prim == "all_gather":
        return rbytes // n
    if prim == "reduce_scatter":
        return rbytes * n
    return rbytes


@pytest.mark.parametrize("prim,kind", PRIM_KIND)
def test_collective_stats_equal_the_reference_and_the_cost_model(prim,
                                                                 kind):
    """Wire bytes per kind over group sizes 1-16: the reference's
    ``CollectiveStats.add``, the port's, and
    ``costmodel.collective_wire_bytes`` on the same collective (to the
    last bit of the float product); the watcher's announcement filed
    back under the same kind and result."""
    for n in range(1, 17):
        for rbytes in (n * 4, n * 1000, n * 4096 * 80):
            theirs, mine = RR.CollectiveStats(), R.CollectiveStats()
            theirs.add(kind, rbytes, n)
            mine.add(kind, rbytes, n)
            assert mine.wire_bytes == theirs.wire_bytes
            wire = collective_wire_bytes(prim, _payload(prim, rbytes, n), n)
            if n > 1 or prim != "ppermute":
                # a one-member permute moves nothing in the cost model;
                # the reference charges its operand (no HLO has one)
                assert math.isclose(mine.wire_bytes, float(wire),
                                    rel_tol=1e-15, abs_tol=0.0), (n, rbytes)
            watched = R.CollectiveStats()
            watched.add_watched(prim, wire, n)
            if n == 1:
                assert watched.counts == {} and watched.wire_bytes == 0
            else:
                assert watched.counts == theirs.counts
                assert watched.result_bytes == theirs.result_bytes
                assert watched.wire_bytes == theirs.wire_bytes


def _hlo(kind: str, dims: tuple, n: int) -> str:
    """One optimized-HLO collective line the reference's parser reads."""
    ty = "f32[%s]{0}" % ",".join(map(str, dims))
    groups = ",".join(map(str, range(n)))
    return (f"  %x.1 = {ty} {kind}(f32[4]{{0}} %p), "
            f"replica_groups={{{{{groups}}}}}")


@pytest.mark.parametrize("case", [
    dict(flops=3.0e15, bytes=1.0e12, colls=[]),
    dict(flops=1.0e13, bytes=4.0e12, colls=[("all-gather", (256, 1024), 16)]),
    dict(flops=2.0e13, bytes=1.0e10,
         colls=[("all-reduce", (4096, 4096), 16),
                ("reduce-scatter", (64, 4096), 16),
                ("all-to-all", (8, 1024), 4),
                ("collective-permute", (1 << 20,), 2)]),
    dict(flops=0.0, bytes=0.0, colls=[]),
], ids=["compute", "memory", "collective", "empty"])
def test_roofline_rows_equal_the_reference_at_equal_constants(monkeypatch,
                                                              case):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(R, name, getattr(RR, name))
    hlo = "\n".join(_hlo(*c) for c in case["colls"])
    stats = R.CollectiveStats()
    for kind, dims, n in case["colls"]:
        stats.add(kind, 4 * math.prod(dims), n)
    cost = {"flops": case["flops"], "bytes accessed": case["bytes"]}
    args = ("h2o-danube-1.8b", "train_4k", "16x16")
    cfg_args = ("train", 4096, 256, 256)
    theirs = RR.build_roofline(*args, RC.get("h2o_danube_1p8b"), *cfg_args,
                               cost, None, hlo)
    mine = R.build_roofline(*args, C.get("h2o_danube_1p8b"), *cfg_args,
                            cost, None, stats)
    assert mine.row() == theirs.row()
    assert (mine.dominant, mine.bound, mine.useful_fraction,
            mine.mfu_at_bound) == (theirs.dominant, theirs.bound,
                                   theirs.useful_fraction,
                                   theirs.mfu_at_bound)


def test_roofline_constants_are_the_h100_data_sheet():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert D.HBM_BYTES == 80e9


# ---------------------------------------------------------------------------
# kernel 4 as an opaque custom op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [
    # (B, Hq, Hkv, Lq, Lkv, D, causal, window)
    (2, 8, 2, 64, 64, 16, True, None),
    (1, 32, 8, 512, 512, 80, True, 128),
    (3, 4, 4, 1, 96, 128, True, 32),
    (2, 4, 1, 48, 48, 16, False, None),
])
def test_flash_custom_op_on_fake_cuda_tensors(monkeypatch, shape):
    """On fake CUDA tensors (no card needed) the op returns q's
    shape and dtype on q's device, counts 4 D Hq B flops per visible
    pair, and builds and launches nothing."""
    B, Hq, Hkv, Lq, Lkv, D_, causal, window = shape

    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(build, "load", no_build)
    before = dict(ops.LAUNCHES)
    with FakeTensorMode():
        q = torch.empty((B, Hq, Lq, D_), dtype=torch.bfloat16, device="cuda")
        k = torch.empty((B, Hkv, Lkv, D_), dtype=torch.bfloat16,
                        device="cuda")
        counters = D.StepCounters()
        with FlopCounterMode(display=False) as fc, counters:
            out = ops.flash_attention(q, k, k, causal=causal, window=window)
        assert counters.kernel_calls == {"flash_attention": 1}
        assert out.shape == q.shape and out.dtype == q.dtype
        assert out.device.type == "cuda"
    qpos = np.arange(Lq) + Lkv - Lq
    hi = qpos if causal else np.full(Lq, Lkv - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(Lq)
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    assert fa.visible_pairs(Lq, Lkv, causal=causal, window=window) == pairs
    assert fc.get_total_flops() == 4 * D_ * Hq * B * pairs
    assert dict(ops.LAUNCHES) == before


def test_flash_plain_route_on_the_cpu_is_unchanged():
    """CPU tensors still take the plain version, outside the op."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 4, 16, 16), generator=g)
    k = torch.randn((1, 2, 16, 16), generator=g)
    got = ops.flash_attention(q, k, k, causal=True, window=8)
    from repro_torch.kernels import ref
    assert torch.equal(got, ref.flash_attention(q, k, k, causal=True,
                                                window=8))


# ---------------------------------------------------------------------------
# lower_cell on smoke configs, fake production meshes
# ---------------------------------------------------------------------------

def _ref_keys(rec) -> set:
    row = RR.Roofline("a", "s", "m", 1.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0,
                      coll_counts={k[2:]: 0 for k in rec if k.startswith(
                          "n_") and k != "n_devices"}).row()
    return set(row) | REF_RECORD_KEYS


#: smoke cells at the reference's shapes: a dense sliding-window model,
#: the MoE, Whisper and the hybrid's decode (its train and 32k prefill
#: steps, 15-35 s of fake dispatch through the SSD's chunk loops, are
#: left to the smaller shapes below)
SMOKE_CELLS = [(a, s) for a in ("h2o_danube_1p8b", "olmoe_1b_7b",
                                "whisper_small")
               for s in ("train_4k", "prefill_32k", "decode_32k")] + [
                   ("zamba2_7b", "decode_32k")]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
@pytest.mark.parametrize("arch,shape", SMOKE_CELLS, ids=lambda c: str(c))
def test_lower_cell_on_smoke_configs(arch, shape, multi_pod):
    """The reference's record keys on the production meshes, at the
    reference's shapes, fake tensors throughout."""
    cfg = C.get_smoke(arch)
    rec, cnt = D.lower_cell(arch, shape, multi_pod=multi_pod, cfg=cfg,
                            verbose=False, device="cpu")
    assert _ref_keys(rec) <= set(rec)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert rec["n_devices"] == (512 if multi_pod else 256)
    assert rec["extrapolated"] is False and rec["compile_s"] == 0.0
    assert rec["flops"] > 0 and rec["hbm_bytes"] > 0
    assert rec["total_bytes_per_dev"] == (
        rec["arg_bytes_per_dev"] + rec["temp_bytes_per_dev"]
        + rec["out_bytes_per_dev"] - rec["alias_bytes_per_dev"])
    assert rec["temp_bytes_per_dev"] >= 0
    assert rec["fits_hbm"] is True
    json.dumps(rec)
    # every kind runs split on the mesh: each layer's blocks gathered
    # over the FSDP axis, the state (train state, serve cache) updated in
    # place
    assert rec["route"] == "split"
    assert rec["wire_bytes"] > 0 and rec.get("n_all-gather", 0) > 0
    assert rec["alias_bytes_per_dev"] > 0


def _real_inputs(cfg, kind: str, rows: int, length: int, seed: int):
    """Seeded real CPU inputs of one rank's rows."""
    rng = np.random.default_rng(seed)

    def tok(*shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab, shape,
                                             dtype=np.int64)).to(torch.int32)

    frames = (torch.from_numpy(rng.standard_normal(
        (rows, cfg.enc_len, cfg.d_model)).astype(np.float32)).to(
            getattr(torch, cfg.dtype)) if cfg.enc_dec else None)
    if kind == "train":
        return lm.Batch(tok(rows, length), tok(rows, length), frames)
    return tok(rows, length) if kind == "prefill" else tok(rows), frames


def _real_step(cfg, kind: str, rows: int, length: int):
    """(run, entry tensors) of the same step, real, on the CPU at a (1, 1)
    mesh (one process, no group) on ``rows`` rows."""
    params = T.init_params(cfg, seed=0, max_len=length, device="cpu")
    if kind == "train":
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        specs = lm.param_shardings(cfg, mesh, length)
        lm.shard_params_(params, specs, mesh)
        opt = AdamW()
        state = lm.init_train_state(params, opt)
        step = lm.make_train_step(cfg, opt, cosine_schedule(3e-4, 100, 10000),
                                  mesh=mesh, specs=specs)
        batch = _real_inputs(cfg, kind, rows, length, 1)
        entry = D._tensors(state) + D._tensors(batch)
        return (lambda: step(state, batch)), entry
    cache = T.init_cache(cfg, rows, length, device="cpu")
    toks, frames = _real_inputs(cfg, kind, rows, length, 2)
    if kind == "prefill":
        fn = lm.make_prefill(cfg, length)
        args = [params, cache, toks] + ([frames] if frames is not None
                                        else [])
        return (lambda: fn(*args)), D._tensors(args)
    if cfg.enc_dec:
        cache["enc_out"].normal_()
    fn = lm.make_decode_step(cfg)
    step = torch.tensor(length // 2, dtype=torch.int32)
    return (lambda: fn(params, cache, toks, step)), \
        D._tensors([params, cache, toks, step])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["h2o_danube_1p8b", "gemma2_27b",
                                  "mamba2_130m", "zamba2_7b",
                                  "whisper_small"])
def test_counted_flops_and_peak_equal_a_real_step(arch, kind):
    """Rank 0 of the fake 16 x 1 mesh counts the flops FlopCounterMode
    counts around the same step run for real on the CPU at a (1, 1) mesh
    (train) or in one process (prefill, decode) on rank 0's rows; at a
    fake (1, 1) mesh the peak of live storages is the real step's,
    storage for storage (on 16 x 1 the state and the cache are sharded,
    so its peak is another step's).  Every kind computes its model share
    on 16 x 16 (held in ``test_split_route_cuts_a_rank_s_flops``, in
    ``test_serve_flops_equal_a_real_gloo_rank_s`` and against real ranks
    in ``test_torch_tp*.py``), so its rank 0 is the fake 16 x 1 mesh's."""
    cfg = C.get_smoke(arch)
    batch, length = 32, 64
    shape = (16, 1)
    cnt = D.trace_step(cfg, kind, batch, length, mesh_shape=shape,
                       mesh_axes=POD[1], device="cpu")
    rows = cnt["rows_per_dev"]
    assert rows == batch // 16
    one = D.trace_step(cfg, kind, rows, length, mesh_shape=(1, 1),
                       mesh_axes=POD[1], device="cpu")
    run, entry = _real_step(cfg, kind, rows, length)
    tracker = D.StepCounters(count_bytes=False)
    tracker.track(entry)
    with FlopCounterMode(display=False) as fc, tracker:
        out = run()
    assert cnt["flops"] == one["flops"] == fc.get_total_flops() > 0
    assert one["peak_bytes"] == tracker.peak
    assert all(torch.isfinite(t.float()).all() for t in D._tensors(out)
               if t.is_floating_point())


@pytest.mark.parametrize("arch,n_units", [("h2o_danube_1p8b", 3),
                                          ("gemma2_27b", 3),
                                          ("zamba2_7b", 3)])
def test_full_depth_equals_the_unit_extrapolation(arch, n_units):
    """metric(n) = m(u) + (n_units - 1) (m(2u) - m(u)), exactly, for the
    flops, the bytes and the wire bytes of a train step: eager mode
    counts every layer."""
    base = C.get_smoke(arch)
    u = D._unit(base)
    got = {}
    for n in (u, 2 * u, n_units * u):
        cnt = D.trace_step(base.with_(n_layers=n), "train", 32, 64,
                           mesh_shape=POD[0], mesh_axes=POD[1],
                           device="cpu")
        got[n] = (cnt["flops"], cnt["hbm_bytes"], cnt["wire_bytes"])
    for i in range(3):
        m1, m2 = got[u][i], got[2 * u][i]
        assert got[n_units * u][i] == m1 + (n_units - 1) * (m2 - m1), i
    assert got[2 * u][0] > got[u][0]


class _MeshStub:
    """What ``logical_to_spec`` reads of a mesh."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


def _leaf_list(tree) -> list:
    """Leaves in ``optim.tree_leaves``' order (spec tuples are leaves)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_list(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _leaf_list(t)]
    return [tree]


def _whole_shapes(cfg, max_len: int) -> list:
    """The parameters' whole shapes, beside ``param_shardings``' leaves."""
    schema = T.model_schema(cfg, max_len)
    stacked = T.stacked_groups(cfg)
    tree = {}
    for name, entries in schema.items():
        lead = 1 if name in stacked else 0
        per = {k: tuple(shape[lead:]) for k, (shape, _, _) in entries.items()}
        tree[name] = ([per] * stacked[name] if lead else per)
    return _leaf_list(tree)


def _wire(prim: str, nbytes, n: int, backend: str) -> Fraction:
    """The watched wire bytes of one collective of ``nbytes`` over ``n``
    ranks (``costmodel.collective_wire_bytes``' conventions); a reduce-
    scatter is an all-reduce on gloo's route."""
    if n <= 1:
        return Fraction(0)
    if prim == "reduce_scatter" and backend != "nccl":
        prim = "psum"
    return collective_wire_bytes(prim, nbytes, n)


def _weight_bytes(cfg, shape, axes, backend, length, reads) -> Fraction:
    """The split route's closed form for the parameters, from
    ``param_shardings``: per leaf and layer the compute-dtype block
    gathered over "data" (the FSDP axis, first) and, where ``reads``
    names it "whole" or "partial", over "model"; backward, a reduce-
    scatter over "data" (and over "model" for a "partial" leaf) of the
    gradient gathered so far (an all-reduce on gloo); a "partial" leaf
    replicated over "model" has its gradient all-reduced over "model"
    instead (``parallel.copy_to``); a tied ``tok`` is read twice (the
    embedding, the head); then each float32 block gradient's all-reduce
    over the batch team's axes its spec lacks.  ``reads``
    maps a leaf to "whole", "partial" or the dimension it splits along
    (its own "model" block); a leaf not in it reads its own block."""
    from repro_torch.models.config import spec_axes
    sizes = dict(zip(axes, shape))
    tree = lm.param_shardings(cfg, _MeshStub(shape, axes), length)
    team = tuple(a for a in axes if a in ("pod", "data"))
    c = getattr(torch, cfg.dtype).itemsize
    want = Fraction(0)
    leaves = [(k, s, w) for (k, s), w in zip(
        [(k, s) for g in sorted(tree) for layer in (
            tree[g] if isinstance(tree[g], list) else [tree[g]])
         for k, s in sorted(layer.items())], _whole_shapes(cfg, length))]
    for name, spec, whole in leaves:
        ext = [math.prod(sizes[a] for a in spec_axes(e)) for e in spec]
        block = [d // e for d, e in zip(whole, ext)]
        read = reads.get(name)
        times = 2 if name == "tok" and cfg.tie_embeddings else 1
        for dim, e in sorted(enumerate(spec),
                             key=lambda de: "model" in spec_axes(de[1])):
            model = "model" in spec_axes(e)
            if ext[dim] == 1 or (model and read not in ("whole",
                                                        "partial")):
                continue
            want += times * (ext[dim] - 1) * c * math.prod(block)
            block[dim] *= ext[dim]
            if not model or read == "partial":
                want += times * _wire("reduce_scatter", c * math.prod(block),
                                      ext[dim], backend)
        used = {a for e in spec for a in spec_axes(e)}
        if read == "partial" and "model" not in used:
            want += _wire("psum", c * math.prod(block), sizes["model"],
                          backend)
        rest = math.prod(sizes[a] for a in team if a not in used)
        want += _wire("psum", 4 * math.prod(whole) // math.prod(ext), rest,
                      backend)
    return want


def _head_and_loss_bytes(cfg, shape, axes, backend, rows, length):
    """The vocabulary split's activation collectives over "model": the
    embedding's output and the head's input gradient (rows x L x d), the
    loss's row maxima and (sum-exp, target logit) pairs; then the loss
    pair over the batch team and the global norm over the world."""
    sizes = dict(zip(axes, shape))
    m, n_team = sizes["model"], math.prod(shape) // sizes["model"]
    act = rows * length * cfg.d_model * getattr(torch, cfg.dtype).itemsize
    return (2 * _wire("psum", act, m, backend)
            + _wire("pmax", rows * length * 4, m, backend)
            + _wire("psum", 2 * rows * length * 4, m, backend)
            + _wire("psum", 8, n_team, backend)             # loss, aux
            + _wire("psum", 4, math.prod(shape), backend))  # global norm


#: how the split route reads danube smoke's leaves on a model team of
#: 16: its 4 query heads do not split over 16, so the attention runs
#: whole (its leaves gathered whole over "model", their gradients kept
#: as the rank's block); d_ff (128) and the vocabulary (256) split, each
#: rank reading its own "model" block; the norm scales are replicated
DANUBE_16 = {"attn_wq": "whole", "attn_wk": "whole", "attn_wv": "whole",
             "attn_wo": "whole"}


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
@pytest.mark.parametrize("mesh", [POD, MULTIPOD], ids=["16x16", "2x16x16"])
def test_watched_wire_bytes_equal_the_closed_form(mesh, backend):
    """A train step's wire bytes from the watcher equal, exactly, the
    closed form of the split route on danube smoke (16 model ranks):
    :func:`_weight_bytes` under DANUBE_16, then the split pieces'
    activations all-reduced over "model": the MLP's input gradient and
    output per layer, and :func:`_head_and_loss_bytes`."""
    cfg = C.get_smoke("h2o_danube_1p8b")
    shape, axes = mesh
    batch = length = 64
    cnt = D.trace_step(cfg, "train", batch, length, mesh_shape=shape,
                       mesh_axes=axes, device="cpu", backend=backend)
    assert cnt["route"] == "split"
    m = shape[-1]
    rows = batch * m // math.prod(shape)
    act = rows * length * cfg.d_model * getattr(torch, cfg.dtype).itemsize
    want = (_weight_bytes(cfg, shape, axes, backend, length, DANUBE_16)
            + 2 * cfg.n_layers * _wire("psum", act, m, backend)
            + _head_and_loss_bytes(cfg, shape, axes, backend, rows, length))
    assert cnt["wire_exact"] == want
    assert math.isclose(cnt["wire_bytes"], float(want), rel_tol=1e-12)
    assert ("reduce-scatter" in cnt["colls"].counts) == (backend == "nccl")


#: how the split route reads Mamba2 smoke's leaves: on a model team of
#: 16 its 8 SSM heads do not split, so the block runs whole (the leaves
#: sharded over "model" gathered whole); on one of 4 each rank runs 2
#: heads, reading its rows of the out-projection and, whole, the in-
#: projection, the conv and the per-head vectors (the rank's columns cut
#: out); the vocabulary splits on both
MAMBA2_READS = {
    16: {"ssm_in": "whole", "ssm_conv": "whole", "ssm_conv_b": "whole",
         "ssm_out": "whole"},
    4: {k: "partial" for k in ("ssm_in", "ssm_conv", "ssm_conv_b",
                                 "ssm_alog", "ssm_dtb", "ssm_d",
                                 "ssm_gnorm")}}


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
@pytest.mark.parametrize("mesh", [POD, MULTIPOD, ((4, 4), POD[1])],
                         ids=["16x16", "2x16x16", "4x4"])
def test_watched_wire_bytes_of_the_split_ssm(mesh, backend):
    """The same on Mamba2 smoke: :func:`_weight_bytes` under
    MAMBA2_READS, :func:`_head_and_loss_bytes`, and where the heads split
    (4 x 4) per layer the block's input gradient and output (rows x L x
    d) and the gated norm's mean square (rows x L float32), forward and
    backward, all-reduced over "model"."""
    cfg = C.get_smoke("mamba2_130m")
    shape, axes = mesh
    batch = length = 64
    cnt = D.trace_step(cfg, "train", batch, length, mesh_shape=shape,
                       mesh_axes=axes, device="cpu", backend=backend)
    assert cnt["route"] == "split"
    m = shape[-1]
    rows = batch * m // math.prod(shape)
    want = (_weight_bytes(cfg, shape, axes, backend, length,
                          MAMBA2_READS[m])
            + _head_and_loss_bytes(cfg, shape, axes, backend, rows, length))
    if cfg.ssm_nheads % m == 0:
        act = rows * length * cfg.d_model * getattr(
            torch, cfg.dtype).itemsize
        want += 2 * cfg.n_layers * (_wire("psum", act, m, backend)
                                    + _wire("psum", rows * length * 4, m,
                                            backend))
    assert cnt["wire_exact"] == want
    assert ("reduce-scatter" in cnt["colls"].counts) == (backend == "nccl")


@pytest.mark.parametrize("arch", ["h2o_danube_1p8b", "mamba2_130m",
                                  "zamba2_7b", "whisper_small"])
def test_split_route_cuts_a_rank_s_flops(arch):
    """On a fake (4, 4) mesh a rank's counted flops fall at least 3x from
    the (4, 1) mesh's on the same rows (a model team of one splits
    nothing; 0.25-0.29 of it by count): its query heads, d_ff columns,
    SSM heads and vocabulary rows; its peak falls too, and the route is
    named "split" in the counts and the record."""
    cfg = C.get_smoke(arch)
    split = D.trace_step(cfg, "train", 32, 64, mesh_shape=(4, 4),
                         mesh_axes=POD[1], device="cpu")
    whole = D.trace_step(cfg, "train", 32, 64, mesh_shape=(4, 1),
                         mesh_axes=POD[1], device="cpu")
    assert split["rows_per_dev"] == whole["rows_per_dev"] == 8
    assert (split["route"], whole["route"]) == ("split", "split")
    assert 3 * split["flops"] <= whole["flops"], (split["flops"],
                                                  whole["flops"])
    assert split["peak_bytes"] < whole["peak_bytes"]
    rec, _ = D.lower_cell(arch, "train_4k", cfg=cfg, verbose=False,
                          device="cpu")
    assert rec["route"] == "split"


def test_split_route_gathers_each_layer_inside_remat():
    """On a fake (4, 4) mesh, danube smoke with remat gathers every
    layer's blocks again in the backward's recompute (the embedding
    tables, gathered outside the layers, once) and peaks lower: the
    gathered blocks live only while their layer runs."""
    cfg = C.get_smoke("h2o_danube_1p8b")
    got = {}
    for remat in (False, True):
        cnt = D.trace_step(cfg.with_(remat=remat), "train", 32, 64,
                           mesh_shape=(4, 4), mesh_axes=POD[1],
                           device="cpu")
        got[remat] = (cnt["colls"].counts["all-gather"], cnt["peak_bytes"])
    (plain, plain_peak), (remat, remat_peak) = got[False], got[True]
    tables = 2                                   # tok, unembed
    assert (plain - tables) % cfg.n_layers == 0
    assert remat == 2 * plain - tables
    assert remat_peak < plain_peak


#: every prefill and decode cell of the reference's table
SERVE_CELLS = [(a, s) for a, s in C.cells()
               if C.SHAPES[s]["kind"] != "train"]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
@pytest.mark.parametrize("arch,shape", SERVE_CELLS, ids=lambda c: str(c))
def test_every_serve_cell_runs_split(arch, shape, multi_pod):
    """Every prefill and decode cell on a production mesh runs on route
    "split" (the rank's blocks of the parameters and of the cache), at the
    cell's global batch, on the arch's smoke config at 64 positions (the
    route does not depend on the length): its cache blocks are what
    ``lm.init_cache_blocks`` makes, its rows the tokens spec's."""
    cfg = C.get_smoke(arch)
    sh = C.SHAPES[shape]
    mesh = MULTIPOD if multi_pod else POD
    cnt = D.trace_step(cfg, sh["kind"], sh["global_batch"], 64,
                       mesh_shape=mesh[0], mesh_axes=mesh[1], device="cpu",
                       measure=False)
    assert cnt["route"] == "split"
    n = math.prod(mesh[0][:-1])
    b = sh["global_batch"]
    assert cnt["rows_per_dev"] == (b // n if b % n == 0 else b)
    stub = _MeshStub(*mesh)
    whole = T.cache_shapes(cfg, b, 64)
    specs = lm.cache_shardings(cfg, stub, b, 64)
    blocks = lm.map_with_specs(
        lambda t, spec: math.prod(lm.block_shape(t.shape, spec, stub))
        * t.dtype.itemsize, whole, specs)
    assert cnt["alias_bytes"] == sum(_leaf_list(blocks))


def test_danube_decode_cache_bytes_equal_the_closed_form():
    """h2o-danube-1.8b ``decode_32k`` at full size on 16 x 16: a rank's
    cache is its 128 / 16 rows ("data") of every kv head over 4096 / 16
    slots ("model": 8 kv heads do not split over 16), k and v in
    bfloat16, and the whole (24, 4096) int32 ``pos``."""
    cfg = C.get("h2o_danube_1p8b")
    cnt = D.trace_step(cfg, "decode", 128, 32768, mesh_shape=POD[0],
                       mesh_axes=POD[1], device="cpu", measure=False)
    rows, slots = 128 // 16, 4096 // 16
    kv = 2 * cfg.n_layers * rows * cfg.n_kv * slots * cfg.hd * 2
    assert cnt["alias_bytes"] == kv + cfg.n_layers * 4096 * 4
    assert cnt["rows_per_dev"] == rows and cnt["route"] == "split"


@pytest.fixture(scope="module")
def gloo_pool():
    from test_torch_ranks import RankPool
    pool = RankPool(4)
    try:
        yield pool
    finally:
        pool.close()


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=str)
@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["h2o_danube_1p8b", "olmoe_1b_7b",
                                  "zamba2_7b", "whisper_small"])
def test_serve_flops_equal_a_real_gloo_rank_s(gloo_pool, arch, kind,
                                              shape):
    """On a 4-rank fake group at smoke size, rank 0's counted flops of a
    sharded prefill or decode step equal ``FlopCounterMode``'s around the
    same step on real gloo rank 0 (``lm.make_prefill`` / ``make_decode_
    step`` with ``mesh=``), as ``test_torch_tp`` holds the train step."""
    from test_torch_ranks import serve_flops
    batch, length = 4, 32
    cfg = C.get_smoke(arch)
    cnt = D.trace_step(cfg, kind, batch, length, mesh_shape=shape,
                       mesh_axes=POD[1], device="cpu")
    real = gloo_pool.run(serve_flops, arch, kind, shape, batch, length)
    assert cnt["route"] == "split"
    assert cnt["flops"] == real[0] > 0


# ---------------------------------------------------------------------------
# full size, the CLI, the table
# ---------------------------------------------------------------------------

#: the full-size decode cell's wall limit on the CPU (it takes ~5 s)
FULL_CELL_LIMIT_S = 120.0


def test_full_size_danube_decode_cell_and_the_cli(tmp_path, capsys):
    """h2o-danube-1.8b decode_32k at full size on the 16 x 16 mesh,
    through the CLI, within FULL_CELL_LIMIT_S; its record renders in the
    roofline table."""
    out = tmp_path / "build" / "torch_dryrun.jsonl"
    t0 = time.time()
    D.main(["--arch", "h2o-danube-1.8b", "--shape", "decode_32k",
            "--device", "cpu", "--out", str(out)])
    wall = time.time() - t0
    assert wall < FULL_CELL_LIMIT_S
    (rec,) = [json.loads(x) for x in out.read_text().splitlines()]
    assert _ref_keys(rec) <= set(rec)
    assert rec["rows_per_dev"] == 128 // 16
    cfg = C.get("h2o_danube_1p8b")
    weights = 4 * cfg.param_count()
    # a rank holds 1/256 of the f32 weights (embed over "data", the
    # heads, d_ff and vocabulary over "model") and its cache blocks
    assert weights / 256 < rec["arg_bytes_per_dev"] < weights / 16
    assert rec["alias_bytes_per_dev"] > 0 and rec["fits_hbm"] is True
    assert rec["dominant"] == "memory" and rec["route"] == "split"
    # every weight of the rank's model share is read at least once per
    # decode step (its blocks gathered over "data")
    assert rec["hbm_bytes"] >= weights / 16
    assert rec["flops"] >= 2 * (cfg.param_count() - cfg.vocab
                                * cfg.d_model) * rec["rows_per_dev"] / 16
    capsys.readouterr()
    assert R.main(["--table", str(out)]) == 0
    table = capsys.readouterr()
    assert "| h2o_danube_1p8b | decode_32k | 16x16 |" in table.out
    assert "1 cells shown, 1 fit 80 GB HBM" in table.err
    assert R.main(["--table", str(out), "--by-arch"]) == 0
    table = capsys.readouterr()
    lines = table.out.splitlines()
    assert lines[0] == "| arch | decode_32k 16x16 |"
    assert lines[2] == (f"| h2o_danube_1p8b | {rec['bound_s']:.3g}m "
                        f"{rec['total_bytes_per_dev'] / 1e9:.1f} |")
    assert lines[3] == "| qwen2p5_3b | - |" and len(lines) == 12
    assert "1 records, 1 fit 80 GB HBM" in table.err


def test_cli_refuses_the_reference_results_glob(tmp_path):
    with pytest.raises(SystemExit):
        D.main(["--arch", "h2o-danube-1.8b", "--shape", "decode_32k",
                "--out", str(tmp_path / "results" / "dryrun_x.jsonl")])


def test_refuses_to_start_inside_a_process_group(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            D.trace_step(C.get_smoke("h2o_danube_1p8b"), "decode", 16, 32,
                         mesh_shape=POD[0], mesh_axes=POD[1], device="cpu")
    finally:
        dist.destroy_process_group()
