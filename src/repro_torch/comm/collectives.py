"""Compressed gradient collectives with error feedback.

Port of ``repro.comm.collectives``.  The data-parallel all-reduce of LM
training moves 4 bytes per parameter per step at float32; two
compressors cut that:

  * ``bf16``: 2x, round-to-nearest bfloat16 before the sum, float32
    after;
  * ``int8``: 4x, per-tensor symmetric int8 quantization with ERROR
    FEEDBACK (the quantization residual is added back into the next
    step's gradient), which keeps SGD / Adam convergence unbiased in
    practice [Seide et al. 2014; Karimireddy et al. 2019].

Where the reference runs these inside ``shard_map`` over a mesh axis,
the port runs them on a team of ranks: ``team`` is a
``launch.mesh.Mesh`` or a ``comm.group.Comm`` and ``axes`` one of its
team keys (``("data",)``, ``("k",)``, ...).  Every collective is
announced to the watcher (``comm.group.set_collective_watcher``), so the
wire bytes can be held against ``core.costmodel``'s
``compressed_psum_volume`` and ``ring_allreduce_int8_volume``.  The
training loop calls none of them, as the reference's does not.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.costmodel import compressed_psum_volume, ring_allreduce_int8_volume
from .contract import CommContract


class CompressState(NamedTuple):
    """Error-feedback residual, same structure as the gradient tree."""
    residual: dict


def _is_payload(t) -> bool:
    return (isinstance(t, tuple) and len(t) == 2
            and isinstance(t[0], torch.Tensor) and t[0].dtype == torch.int8)


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts and lists);
    an int8 payload ``(q, scale)`` is a leaf."""
    t0 = trees[0]
    if _is_payload(t0) or isinstance(t0, torch.Tensor):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def init_error_feedback(grads) -> CompressState:
    return CompressState(_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads))


def _quant_int8(x):
    # max|x| / 127 as the reference's XLA computes it: times the rounded
    # reciprocal of 127
    inv = torch.tensor(1.0 / 127.0, dtype=x.dtype, device=x.device)
    scale = torch.clamp_min(x.abs().max(), 1e-12) * inv
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_int8(q, scale):
    # float32 values, widened to the scale's dtype (float64 under x64)
    return q.to(torch.promote_types(torch.float32, scale.dtype)) * scale


def _add_dequant(acc, q, scale, sign: int = 1):
    """``acc + sign * dequant(q, scale)`` rounded once, as the reference's
    XLA computes it under jit (a fused multiply-add): for float32, the
    product (31 significant bits at most) and the sum taken in float64,
    then rounded."""
    if acc.dtype == torch.float32:
        return (acc.double() + sign * (q.double() * scale.double())).float()
    return acc + sign * _dequant_int8(q, scale)


def compress_tree(grads, state: CompressState | None, *, method: str):
    """Returns (payload_tree, new_state).  Payload leaves are (q, scale)
    for int8, bfloat16 tensors for bf16, the gradients otherwise."""
    if method == "none":
        return grads, state
    if method == "bf16":
        return _map(lambda g: g.to(torch.bfloat16), grads), state
    if method == "int8":
        if state is None:
            state = init_error_feedback(grads)
        corrected = _map(lambda g, r: g.float() + r, grads, state.residual)
        payload = _map(_quant_int8, corrected)
        new_res = _map(lambda c, t: _add_dequant(c, *t, sign=-1), corrected,
                       payload)
        return payload, CompressState(new_res)
    raise ValueError(method)


def decompress_tree(payload, *, method: str):
    if method == "none":
        return payload
    if method == "bf16":
        return _map(lambda g: g.float(), payload)
    if method == "int8":
        return _map(lambda t: _dequant_int8(*t), payload)
    raise ValueError(method)


def compressed_psum(grads, team, axes, state=None, *, method: str = "bf16"):
    """All-reduce a gradient tree over the team ``axes`` of ``team`` with
    the chosen wire format; returns (summed tree, new state).  bf16
    ships bfloat16 and sums in float32, rounding once (as XLA's bf16
    psum does); int8 sums the DEQUANTIZED float32 values (its 1-byte
    wire is the explicit ring below)."""
    payload, state = compress_tree(grads, state, method=method)
    if method == "int8":
        summed = _map(lambda t: team.psum(_dequant_int8(*t), axes), payload)
        return summed, state
    if method == "bf16":
        summed = _map(lambda g: team.psum(g, axes, accumulate=torch.float32),
                      payload)
    else:
        summed = _map(lambda g: team.psum(g, axes), payload)
    return decompress_tree(summed, method=method), state


def ring_allreduce_int8(x: torch.Tensor, team, axes) -> torch.Tensor:
    """The bandwidth-optimal ring all-reduce that ships int8 chunks over
    the team ``axes`` of ``team``: the flat input padded to a multiple of
    the team size n, n - 1 reduce-scatter rounds each shipping one int8
    chunk and its scale to the next rank, then one all-gather of the
    reduced chunks.  The chunk order is the reference's, so the result
    is too."""
    n = len(team.team(axes))
    if n == 1:
        return x
    shape, size = x.shape, x.numel()
    pad = (-size) % n
    cur = F.pad(x.reshape(-1), (0, pad)).view(n, -1).clone()
    idx = team.position(axes)
    perm = [(i, (i + 1) % n) for i in range(n)]
    # reduce-scatter: after n - 1 rounds, chunk (idx + 1) holds the sum
    for i in range(n - 1):
        q, s = _quant_int8(cur[(idx - i) % n])
        q = team.ppermute_team(q, axes, perm)
        s = team.ppermute_team(s.reshape(1), axes, perm).reshape(())
        tgt = (idx - i - 1) % n
        cur[tgt] = _add_dequant(cur[tgt], q, s)
    mine = cur[(idx + 1) % n]
    gathered = team.all_gather(mine, axes)        # row r = chunk (r+1) % n
    out = torch.roll(gathered, 1, dims=0).reshape(-1)   # row k = chunk k
    return out[:size].reshape(shape)


# ---------------------------------------------------------------------------
# declared collective schedules
# ---------------------------------------------------------------------------
# The reference's declarations, field for field (its analysis traces them
# under a 4-wide "dp" axis); the volumes take the operand's dtype, the
# reference's being float64.

_RING_AXIS = "dp"


def _ring_contract() -> CommContract:
    return CommContract(
        entry="comm.collectives.ring_allreduce_int8",
        axes=(_RING_AXIS,), kinds=("ppermute", "all_gather"),
        rounds=lambda size, extent, dtype="float64": extent - 1,
        wire=("int8", "operand"),
        volume=lambda size, extent, dtype="float64":
            ring_allreduce_int8_volume(size, extent, dtype=dtype),
        volume_class="int8 reduce-scatter ring + f64 allgather")


def _bf16_psum_contract() -> CommContract:
    return CommContract(
        entry="comm.collectives.compressed_psum[bf16]",
        axes=(_RING_AXIS,), kinds=("psum",),
        wire=("bfloat16",),
        volume=lambda size, extent: compressed_psum_volume(
            size, extent, method="bf16"),
        volume_class="bf16 all-reduce")


COMM_CONTRACT = {
    "ring_allreduce_int8": _ring_contract(),
    "compressed_psum_bf16": _bf16_psum_contract(),
}


# ---------------------------------------------------------------------------
# analysis manifest (repro_torch.analysis.dispatchpass)
# ---------------------------------------------------------------------------
# On a one-process team, where the bf16 psum still compresses and
# decompresses its payload.  The int8 ring has no entry: on one process it
# is the identity and dispatches nothing (analysis.manifest.NO_ENTRY).

def _one_process_team(device):
    from .grid import AXES, Grid1p5D
    from .group import comm_for
    return comm_for(Grid1p5D(1, 1, 1), torch.device(device)), AXES


def _entry_bf16_psum(device):
    team, axes = _one_process_team(device)
    g = {"grad": torch.linspace(0.0, 1.0, 24, dtype=torch.float64,
                                device=device).reshape(6, 4)}
    return {"fn": compressed_psum, "args": (g, team, axes),
            "kwargs": {"method": "bf16"}}


_PATH = "src/repro_torch/comm/collectives.py"
ANALYSIS_ENTRIES = [
    # f64 -> bf16 on the wire, summed in f32, is this path's declared
    # compression
    {"name": "comm.collectives.compressed_psum_bf16", "path": _PATH,
     "build": _entry_bf16_psum, "skip": ("CA201",)},
]
