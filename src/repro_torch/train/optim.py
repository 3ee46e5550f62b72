"""Optimizers (AdamW, SGD with momentum), learning-rate schedules,
global-norm clipping and micro-batch gradient accumulation.

Port of ``repro.train.optim``, with its formulas: float32 moments, bias
correction at a float32 step count, weight decay decoupled and applied
to the float32 value of each parameter, and the clip scale
``min(1, max_norm / max(norm, 1e-9))``.

The parameters and the optimizer state are *trees*: nested dicts and
lists of tensors, or a module with a ``tree()`` view (the LM's
``DecoderLM``), whose leaves the state mirrors.  On a mesh
(``launch.mesh.Mesh``) each rank holds its block of every leaf under
the leaf's spec (a tree of specs beside the tree of tensors): the global
norm counts each element once, and clipping and the update, being
elementwise, run on the blocks unchanged.  The state lives on the
parameters' device.  Where the reference returns new arrays (its jitted
step donates the old ones), ``update`` writes the parameters and the
state in place and returns them, so neither is ever held twice.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


def as_tree(params):
    """A module's tensors as its tree (``DecoderLM.tree()``), else
    ``params`` itself."""
    return params.tree() if hasattr(params, "tree") else params


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts, lists,
    tuples, NamedTuples; None stays None), in :func:`tree_leaves`'
    order."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in sorted(t0)}
    if hasattr(t0, "_fields"):
        return type(t0)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    if t0 is None:
        return None
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves in a fixed order: dict keys sorted (as ``jax.tree``
    orders them), lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [] if tree is None else [tree]


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    m: object               # tree of float32 first moments
    v: object               # tree of float32 second moments


class AdamW(NamedTuple):
    lr: float | None = None          # None -> caller passes lr per step
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        tree = as_tree(params)
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     tree)
        return AdamWState(_step0(tree), z, tree_map(torch.clone, z))

    def update(self, grads, state: AdamWState, params, lr=None, *,
               mesh=None, specs=None):
        """(params, state, grad_norm): one AdamW step on the clipped
        ``grads``, written into ``params`` and ``state`` in place.  On a
        ``mesh`` the trees hold this rank's blocks under ``specs``."""
        lr = lr if lr is not None else self.lr
        tree = as_tree(params)
        scale, gnorm = _clip_scale(grads, self.clip_norm, mesh, specs)
        step = state.step + 1
        t = step.float()
        b1, b2 = self.b1, self.b2
        mhat_scale = 1.0 / (1 - b1 ** t)
        vhat_scale = 1.0 / (1 - b2 ** t)
        with torch.no_grad():
            for p, m, v, g in zip(tree_leaves(tree), tree_leaves(state.m),
                                  tree_leaves(state.v), tree_leaves(grads)):
                g = (g.float() * scale).to(g.dtype).float()
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * torch.square(g))
                u = (m * mhat_scale) / (torch.sqrt(v * vhat_scale)
                                        + self.eps)
                u = u + self.weight_decay * p.float()
                p.copy_((p.float() - lr * u).to(p.dtype))
        return params, AdamWState(step, state.m, state.v), gnorm


class SGDM(NamedTuple):
    lr: float | None = None
    momentum: float = 0.9
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        tree = as_tree(params)
        return AdamWState(_step0(tree), tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), tree), {})

    def update(self, grads, state: AdamWState, params, lr=None):
        lr = lr if lr is not None else self.lr
        tree = as_tree(params)
        scale, gnorm = _clip_scale(grads, self.clip_norm)
        with torch.no_grad():
            for p, m, g in zip(tree_leaves(tree), tree_leaves(state.m),
                               tree_leaves(grads)):
                g = (g.float() * scale).to(g.dtype).float()
                m.mul_(self.momentum).add_(g)
                p.copy_((p.float() - lr * m).to(p.dtype))
        return params, AdamWState(state.step + 1, state.m, {}), gnorm


def _step0(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def global_norm(tree, *, mesh=None, specs=None) -> torch.Tensor:
    """The float32 global norm of ``tree``.  On a ``mesh``, ``tree``
    holds this rank's blocks under ``specs`` (a tree beside it): each
    element is counted once (a block replicated along an axis its spec
    does not use counts only at that axis's coordinate 0, see
    ``Mesh.owns``), and the squares are summed over every rank."""
    with torch.no_grad():
        if mesh is None:
            return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                                  for leaf in tree_leaves(tree)))
        squares = tree_leaves(tree_map(
            lambda leaf, spec: torch.sum(torch.square(leaf.float()))
            if mesh.owns(spec) else None, tree, specs))
        total = sum(squares) if squares else torch.zeros(
            (), device=mesh.device)
        return torch.sqrt(mesh.psum(total, mesh.axis_names))


def _clip_scale(tree, max_norm: float, mesh=None, specs=None):
    g = global_norm(tree, mesh=mesh, specs=specs)
    return torch.clamp(max_norm / torch.clamp_min(g, 1e-9), max=1.0), g


def clip_by_global_norm(tree, max_norm: float):
    """(the tree scaled to global norm at most ``max_norm``, its norm)."""
    scale, g = _clip_scale(tree, max_norm)
    return tree_map(lambda leaf: (leaf.float() * scale).to(leaf.dtype),
                    tree), g


# ---------------------------------------------------------------------------
# learning-rate schedules: step (an int or a tensor) -> float32 tensor
# ---------------------------------------------------------------------------

def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = peak_lr * (min_frac + (1 - min_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def linear_schedule(peak_lr: float, warmup: int, total: int):
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        dec = peak_lr * torch.clamp((total - step) / max(total - warmup, 1),
                                    0.0, 1.0)
        return torch.where(step < warmup, warm, dec)
    return lr


# ---------------------------------------------------------------------------
# micro-batch accumulation
# ---------------------------------------------------------------------------

def _value_and_grad(loss_fn, params, leaves, batch):
    with torch.enable_grad():
        loss, aux = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_map(torch.Tensor.detach, aux), grads


def _unflatten(tree, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def accumulate_gradients(loss_fn, params, batch, n_micro: int):
    """((loss, aux), grads) of ``loss_fn(params, batch) -> (loss, aux)``
    with respect to the leaves of ``params`` (which must require grad),
    the batch's leading axis split into ``n_micro`` equal micro-batches:
    the loss and the float32 gradients averaged over them, the aux of the
    last one (the reference's scan).  ``grads`` mirrors ``params``' tree.
    One micro-batch's graph is live at a time."""
    tree = as_tree(params)
    leaves = tree_leaves(tree)
    if not all(p.requires_grad for p in leaves):
        raise ValueError("accumulate_gradients differentiates with respect "
                         "to the parameters' leaves; make them require "
                         "grad (lm.init_train_state does)")
    if n_micro <= 1:
        loss, aux, grads = _value_and_grad(loss_fn, params, leaves, batch)
        return (loss, aux), _unflatten(tree, grads)

    def micro(i):
        return tree_map(lambda x: x.reshape(
            (n_micro, x.shape[0] // n_micro) + x.shape[1:])[i], batch)

    acc_l = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    acc_g = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    aux = None
    for i in range(n_micro):
        loss, aux, grads = _value_and_grad(loss_fn, params, leaves,
                                           micro(i))
        acc_l = acc_l + loss / n_micro
        for a, g in zip(acc_g, grads):
            a.add_(g / n_micro)
        del grads
    return (acc_l, aux), _unflatten(tree, acc_g)
