"""Launchers of the PyTorch port: the Gram-prep, solver and serving CLIs.

  python -m repro_torch.launch.gram prep --shards DIR --out ART
  python -m repro_torch.launch.solve --from-gram ART --lam1 0.3
  python -m repro_torch.launch.serve --workload concord --requests 16

Port of ``repro.launch``'s single-device CLIs and the concord serving
drain.  Each ``main(argv, *, device=None)`` runs on the CUDA card unless
``device="cpu"`` is passed.  ``serve --workload lm`` waits for the LM
zoo's caches (ROADMAP item 5.1); the mesh, dry-run, roofline and train
launchers are later slices of the port.
"""

__all__ = ["gram", "serve", "solve"]
