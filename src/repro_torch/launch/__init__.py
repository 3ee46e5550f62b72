"""Launchers of the PyTorch port: the Gram-prep and solver CLIs.

  python -m repro_torch.launch.gram prep --shards DIR --out ART
  python -m repro_torch.launch.solve --from-gram ART --lam1 0.3

Port of ``repro.launch``'s single-device CLIs.  Each ``main(argv, *,
device=None)`` runs on the CUDA card unless ``device="cpu"`` is passed.
The serving, mesh, dry-run, roofline and train launchers are later
slices of the port (ROADMAP A10 and A12).
"""
