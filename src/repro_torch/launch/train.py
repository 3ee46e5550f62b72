"""Training launcher CLI.  Port of ``repro.launch.train``, with the same
flags:

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --smoke --steps 200 --seq-len 512 --batch 8 --ckpt-dir build/ckpt

``--smoke`` selects the reduced config; without it the full config is
used.  It trains on one CUDA card; ``main(argv, device="cpu")`` runs it
on the host (no flag: the reference has none).  ``--mesh host`` and
``--mesh none`` both mean the one device.  ``--mesh pod`` and
``--mesh multipod`` (the reference's sharded multi-host meshes) are
refused until the multi-rank training slice (ROADMAP A1b) brings the
sharding rules.
"""
from __future__ import annotations

import argparse

from .. import configs as C
from ..train.loop import TrainerConfig, train


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
    if args.mesh in ("pod", "multipod"):
        raise SystemExit(
            f"--mesh {args.mesh}: sharded multi-rank training is not in "
            f"the port yet (ROADMAP A1b); --mesh host or none trains on "
            f"one device")

    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    tc = TrainerConfig(
        seq_len=args.seq_len, global_batch=args.batch, n_micro=args.micro,
        steps=args.steps, peak_lr=args.lr, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, heartbeat_path=args.heartbeat,
        seed=args.seed)
    res = train(cfg, tc, device=device)
    if res.losses:
        print(f"done: {res.final_step} steps, "
              f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}, "
              f"preempted={res.preempted}")
    else:
        print(f"done: {res.final_step} steps (nothing left to run), "
              f"preempted={res.preempted}")
    return res


if __name__ == "__main__":
    main()
