"""Launchers of the PyTorch port: the Gram-prep, solver, serving and
training CLIs, and the meshes of ranks.

  python -m repro_torch.launch.gram prep --shards DIR --out ART
  python -m repro_torch.launch.solve --from-gram ART --lam1 0.3
  python -m repro_torch.launch.serve --workload concord --requests 16
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh host ...

Port of ``repro.launch``.  Each ``main(argv, *, device=None)`` runs on
the CUDA card unless ``device="cpu"`` is passed.  The dry-run and
roofline launchers are later slices of the port.
"""

__all__ = ["gram", "mesh", "serve", "solve", "train"]
