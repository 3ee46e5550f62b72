"""Atomic checkpoint and restore, in the reference's format.

Port of ``repro.train.checkpoint``; a checkpoint written by either
package is restored by the other.  One directory per step holds

  * ``manifest.json``: the step, the data cursor, the mesh shape (None
    off a mesh) and each leaf's file, shape and dtype;
  * ``<key>.npy``: one file per leaf, keyed by the reference's
    ``//``-flattened path (``params//blocks//attn_wq``,
    ``opt//m//embed//tok``, ``opt//step``, ``step``), ``//`` written as
    ``__`` in the file name.

The reference stacks the layers of ``blocks`` (and Whisper's ``enc``) on
a leading axis; the port keeps one tensor per layer, so it stacks them
on save and copies each layer's slice back on restore.  bfloat16 leaves
are stored as their uint16 bits (npy has no bfloat16) and read back
through ``torch.Tensor.view(torch.bfloat16)``.

Writes go to ``<dir>.tmp`` and end with one ``os.rename``: a crash
mid-save never leaves a partial checkpoint under a step's name.
``restore`` writes into a template's tensors in place (the state a
resumed run would start from), on whatever device they live.

On a mesh (``launch.mesh.Mesh``) each rank holds its blocks of the state
under a tree of specs (``shardings``): ``save`` gathers each leaf whole,
one at a time, rank 0 writes it, and a barrier after the rename keeps
every rank from reading the step before it is complete; ``restore``
reads the whole leaves and keeps this rank's blocks, onto any mesh (the
file format does not depend on the mesh the state was saved from).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from .optim import as_tree

SEP = "//"


def _flatten(tree, prefix: str = "") -> dict:
    """{key: tensor, or a list of per-layer tensors for a stacked leaf}.
    A module with a ``tree()`` view (``DecoderLM``) is flattened through
    it; a list of dicts is a stacked group."""
    tree = as_tree(tree)
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{SEP}"))
    elif hasattr(tree, "_fields"):          # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}{SEP}"))
    elif isinstance(tree, list):
        for name in sorted(tree[0]):
            out[f"{prefix}{name}"] = [layer[name] for layer in tree]
    elif tree is not None:
        out[prefix[:-len(SEP)]] = tree
    return out


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(array, dtype name): bfloat16 as its uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, state, *, data_cursor: int = 0,
         mesh=None, shardings=None, keep: int = 3) -> str:
    """Atomically write ``state`` (dicts, NamedTuples such as
    ``lm.TrainState``, a ``DecoderLM``, tensors) as step ``step``, then
    keep only the newest ``keep`` steps.  With ``shardings`` (a spec tree
    beside ``state``) the state holds this rank's blocks on ``mesh``:
    every rank calls ``save``, each leaf is gathered whole and rank 0
    writes.  The manifest records ``mesh``'s shape (None without)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = path + ".tmp"
    writer = mesh is None or mesh.rank == 0
    specs = _flatten(shardings) if shardings is not None else {}
    if writer:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "data_cursor": data_cursor,
                "mesh_shape": dict(mesh.shape) if mesh is not None else None,
                "leaves": {}}
    for key, leaf in _flatten(state).items():
        if key in specs:
            spec = specs[key]
            leaf = ([mesh.gather(t, s) for t, s in zip(leaf, spec)]
                    if isinstance(leaf, list) else mesh.gather(leaf, spec))
        if not writer:
            continue
        if isinstance(leaf, list):
            parts = [_to_numpy(t) for t in leaf]
            arr, dtype_name = np.stack([a for a, _ in parts]), parts[0][1]
        else:
            arr, dtype_name = _to_numpy(leaf)
        fname = key.replace(SEP, "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": dtype_name}
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        _gc(ckpt_dir, keep)
    if mesh is not None:
        mesh.barrier()
    return path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template, *, step: int | None = None,
            shardings=None, mesh=None):
    """Load step ``step`` (default: the latest) into ``template``'s
    tensors in place; returns (template, manifest).  Every leaf of the
    template must be in the checkpoint with its shape and dtype (a
    stacked leaf: one slice per layer); leaves the template does not
    have are ignored, as the reference ignores them.  With
    ``shardings`` (a spec tree beside ``template``) the template holds
    this rank's blocks on ``mesh``, and each whole leaf read is cut to
    the rank's block: the elastic restore, onto any mesh."""
    specs = _flatten(shardings) if shardings is not None else {}
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = manifest["leaves"]
    with torch.no_grad():
        for key, dst in _flatten(template).items():
            if key not in leaves:
                raise KeyError(f"{key} is not in the checkpoint at {path}")
            info = leaves[key]
            src = _from_numpy(np.load(os.path.join(path, info["file"])),
                              info["dtype"])
            stacked = isinstance(dst, list)
            targets = dst if stacked else [dst]
            if not stacked:
                src = src[None]
            if key in specs:
                spec = specs[key] if stacked else [specs[key]]
                src = torch.stack([mesh.shard(layer, s)
                                   for layer, s in zip(src, spec)])
                info = dict(info, shape=list(src.shape[int(not stacked):]))
            want = ((len(dst),) if stacked else ()) + tuple(targets[0].shape)
            if tuple(info["shape"]) != want or src.dtype != targets[0].dtype:
                raise ValueError(
                    f"{key}: the checkpoint holds {info['dtype']} "
                    f"{tuple(info['shape'])}, the template "
                    f"{targets[0].dtype} {want}")
            for i, t in enumerate(targets):
                t.copy_(src[i])
    return template, manifest


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
