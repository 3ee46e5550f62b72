"""Carry problems, penalties, configs, streamed Grams and LM weights into
the port from plain data.

The port never imports the JAX package, so these helpers are duck-typed
on numpy arrays, floats and dicts: a caller holding a ``repro`` object
unpacks it (``dataclasses.asdict(config)``, ``np.asarray(omega)``, the
spec's fields) and hands the plain values over.  The parity tests use
them to give both packages the same problem, penalty, warm start and
configuration.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.penalty import PenaltySpec, _get_def
from .device import resolve_device
from .estimator.config import SolverConfig


def _leaf(v):
    """A float for a scalar, a float64 numpy array for a lane vector."""
    arr = np.array(v, np.float64)
    return float(arr) if arr.ndim == 0 else arr


def penalty_from_numpy(kind: str, lam1, lam2=0.0, shape=None,
                       weights=None) -> PenaltySpec:
    """A validated :class:`PenaltySpec` from plain values.  Numpy scalars
    and arrays are accepted, lane-batched ones too: a (B,) ``lam1``,
    ``lam2`` or ``shape``, a shared (p, p) or per-lane (B, p, p)
    ``weights`` (kept as float64 numpy until a solve moves them to its
    device).  A lane-batched spec is validated lane by lane."""
    spec = PenaltySpec(
        kind, _leaf(lam1), _leaf(lam2),
        shape=None if shape is None else _leaf(shape),
        weights=None if weights is None else np.array(weights, np.float64))
    batched = [leaf.shape[0] for leaf, nd in
               zip(spec.leaves(), spec._expected_ndims())
               if np.ndim(leaf) == nd + 1]
    if not batched:
        _get_def(kind).validate(spec)
        return spec
    b = batched[0]
    if any(n != b for n in batched):
        raise ValueError(f"lane-batched penalty leaves disagree on the "
                         f"lane count: {batched}")
    for i in range(b):
        _get_def(kind).validate(spec.lane(i, b))
    return spec


def config_from_mapping(mapping, **overrides) -> SolverConfig:
    """A :class:`SolverConfig` from a dict of field values (e.g.
    ``dataclasses.asdict`` of the reference's config).  Keys the port
    does not know raise ``ValueError``; ``overrides`` win (e.g.
    ``device="cpu"``)."""
    known = {f.name for f in dataclasses.fields(SolverConfig)}
    fields = dict(mapping)
    fields.update(overrides)
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown SolverConfig field(s): {unknown}")
    return SolverConfig(**fields)


def omega_from_numpy(arr, device=None,
                     dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """A warm start (or any matrix) as a tensor on ``device``."""
    return torch.as_tensor(np.asarray(arr), dtype=dtype,
                           device=resolve_device(device))


def lm_params_from_numpy(cfg, tree, device=None):
    """The port's :class:`~repro_torch.models.transformer.DecoderLM` with
    the weights of a reference parameter tree.

    ``tree`` is the reference's parameter tree as nested dicts of numpy
    arrays (``jax.tree.map(np.asarray, params)``): ``embed`` (with
    Whisper's ``pos`` / ``pos_enc``), ``final``, ``blocks``, and where
    the family has them Zamba2's ``shared`` and Whisper's ``enc`` /
    ``enc_final``.  The stacked groups (``blocks``, ``enc``) are unstacked
    along the layer axis, whatever each tensor's trailing shape (the MoE
    router (d, E) and experts (E, d, f) too).  The tensors keep
    ``cfg.param_dtype`` (float32 master weights, as in the reference)."""
    from .models.transformer import DecoderLM, stacked_groups
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    stacked = stacked_groups(cfg)

    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    out = {}
    for name, group in tree.items():
        if name in stacked:
            out[name] = [{k: tensor(v[i]) for k, v in group.items()}
                         for i in range(stacked[name])]
        else:
            out[name] = {k: tensor(v) for k, v in group.items()}
    return DecoderLM(cfg, out)


def lm_params_to_numpy(params) -> dict:
    """The inverse of :func:`lm_params_from_numpy`: the reference's
    parameter tree as nested dicts of numpy arrays, the stacked groups
    (``blocks``, ``enc``) stacked on a leading layer axis.  ``params`` is
    a ``DecoderLM``, a ``Weights``, or a tree of the same structure (an
    optimizer's moments); bfloat16 leaves widen exactly to float32."""
    from .train.optim import as_tree
    tree = as_tree(params)

    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    out = {}
    for name, group in tree.items():
        if isinstance(group, list):
            out[name] = {k: np.stack([leaf(b[k]) for b in group])
                         for k in group[0]}
        else:
            out[name] = {k: leaf(v) for k, v in group.items()}
    return out


def train_state_to_numpy(state) -> dict:
    """An ``lm.TrainState`` (AdamW's or SGDM's state) as the reference's
    tree in numpy: ``{"params", "opt": {"step", "m", "v"}, "step"}``,
    the moments in :func:`lm_params_to_numpy`'s layout (``v`` is {} for
    SGDM), the step counters as int32 scalars."""
    opt = state.opt
    return {"params": lm_params_to_numpy(state.params),
            "opt": {"step": np.asarray(int(opt.step), np.int32),
                    "m": lm_params_to_numpy(opt.m),
                    "v": lm_params_to_numpy(opt.v) if opt.v else {}},
            "step": np.asarray(int(state.step), np.int32)}


def cache_from_numpy(cfg, tree, device=None):
    """The port's serve cache (``transformer.init_cache``'s layout) from
    the reference's cache tree of any family as numpy arrays: ``pos`` as
    int32, the Mamba2 state ``h`` as float32, every other leaf (``k``,
    ``v``, ``conv``, ``enc_out``) in ``cfg.dtype`` (bfloat16 arrays widen
    exactly on the way)."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)

    def leaf(name, a):
        if name == "pos":
            return torch.tensor(np.asarray(a, np.int32), device=dev)
        t = torch.tensor(np.asarray(a, np.float32), device=dev)
        return t if name == "h" else t.to(dt)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in node.items()}

    return walk(tree)


def cache_to_numpy(cache) -> dict:
    """A serve cache tree as numpy: ``pos`` as int32, every other leaf as
    float32 (exact for a bfloat16 cache)."""
    def leaf(t):
        if t.dtype.is_floating_point:
            return t.float().cpu().numpy()
        return t.to(torch.int32).cpu().numpy()

    return {k: cache_to_numpy(v) if isinstance(v, dict) else leaf(v)
            for k, v in cache.items()}


def gram_from_numpy(result, device=None):
    """The port's :class:`~repro_torch.data.GramResult` from a reference
    ``GramResult`` (numpy ``s``, ``mean`` and ``var``; the scalars and
    names as they are), with the arrays as float64 tensors on
    ``device``, so both packages solve the same statistic."""
    from .data.gram import GramResult
    dev = resolve_device(device)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    return GramResult(
        s=tensor(result.s), n=int(result.n), p=int(result.p),
        transform=str(result.transform), mean=tensor(result.mean),
        var=tensor(result.var), n_chunks=int(result.n_chunks),
        source_dtype=str(result.source_dtype))
