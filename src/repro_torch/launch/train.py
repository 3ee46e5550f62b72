"""Training launcher CLI.  Port of ``repro.launch.train``, with the same
flags:

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --smoke --steps 200 --seq-len 512 --batch 8 --ckpt-dir build/ckpt

``--smoke`` selects the reduced config; without it the full config is
used.  It trains on the CUDA card; ``main(argv, device="cpu")`` runs it
on the host (no flag: the reference has none).  ``--mesh`` picks the
mesh of ranks (``launch.mesh``): ``host`` factors the world as the
reference factors its devices (``make_host_mesh``: (1, 1) in one
process, (1, 4) for 4 ranks), ``pod`` and ``multipod`` are the
production meshes (16, 16) and (2, 16, 16), which raise unless the
world has 256 or 512 ranks, and ``none`` trains on the one device with
no mesh.  Started under torchrun the CLI joins the process group itself
(NCCL on the card; gloo with ``device="cpu"``), one rank per process,
and only rank 0 prints:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh host \
      --arch h2o-danube-1.8b --smoke --steps 20
"""
from __future__ import annotations

import argparse
import os

import torch.distributed as dist

from .. import configs as C
from ..comm import group
from ..device import resolve_device
from ..train.loop import TrainerConfig, train
from .mesh import make_host_mesh, make_production_mesh


def main(argv=None, *, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--heartbeat", default="")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "pod", "multipod", "none"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    joined = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if joined:
        group.init_process_group(dev)
    try:
        return _main(args, dev)
    finally:
        if joined:
            group.destroy_process_group()


def _main(args, device):
    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    mesh = None
    if args.mesh == "host":
        mesh = make_host_mesh(device=device)
    elif args.mesh == "pod":
        mesh = make_production_mesh(device=device)
    elif args.mesh == "multipod":
        mesh = make_production_mesh(multi_pod=True, device=device)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    tc = TrainerConfig(
        seq_len=args.seq_len, global_batch=args.batch, n_micro=args.micro,
        steps=args.steps, peak_lr=args.lr, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, heartbeat_path=args.heartbeat,
        seed=args.seed)
    res = train(cfg, tc, mesh=mesh, device=device)
    if res.losses:
        say(f"done: {res.final_step} steps, "
            f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}, "
            f"preempted={res.preempted}")
    else:
        say(f"done: {res.final_step} steps (nothing left to run), "
            f"preempted={res.preempted}")
    return res


if __name__ == "__main__":
    main()
