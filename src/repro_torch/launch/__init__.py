"""Launchers of the PyTorch port: the Gram-prep, solver, serving and
training CLIs, the meshes of ranks, and the dry run with its roofline.

  python -m repro_torch.launch.gram prep --shards DIR --out ART
  python -m repro_torch.launch.solve --from-gram ART --lam1 0.3
  python -m repro_torch.launch.serve --workload concord --requests 16
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh host ...
  python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b --shape train_4k
  python -m repro_torch.launch.roofline --table build/torch_dryrun.jsonl

Port of ``repro.launch``.  Each ``main(argv, *, device=None)`` runs on
the CUDA card unless ``device="cpu"`` is passed.  ``dryrun`` runs one
step of a cell on fake tensors in a fake process group of the production
meshes' size and needs no card; ``roofline`` prices its counts at the
H100's data-sheet constants and renders the table.
"""

__all__ = ["dryrun", "gram", "mesh", "roofline", "serve", "solve", "train"]
