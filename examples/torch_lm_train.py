"""End-to-end training on the PyTorch port: a ~100M-parameter LM for a few
hundred steps through the whole loop (checkpoints, heartbeat, straggler
monitor, the deterministic data pipeline); the port of
``examples/lm_train.py``.

  PYTHONPATH=src python examples/torch_lm_train.py [--steps 300]

The model is a scaled-down h2o-danube (the same family: GQA, sliding
window, SwiGLU).  The loss must drop by at least 0.5.  It runs on the
CUDA card; ``main(argv, device="cpu")`` runs it on the host.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile

from repro_torch import configs as C
from repro_torch.train.loop import TrainerConfig, train


def model_config():
    """~100M parameters: 12 layers x d 512 x 8 heads (4 KV), vocab 32000."""
    return C.get("h2o-danube-1.8b").with_(
        name="danube-100m", n_layers=12, d_model=512, n_heads=8, n_kv=4,
        d_ff=1536, window=256, remat=False, n_micro=1, dtype="float32")


def trainer_config(steps: int, ckpt_dir: str) -> TrainerConfig:
    return TrainerConfig(seq_len=256, global_batch=8, steps=steps,
                         peak_lr=1e-3, warmup=30, ckpt_dir=ckpt_dir,
                         ckpt_every=100, log_every=20,
                         heartbeat_path=f"{ckpt_dir}/heartbeat.json")


def main(argv=None, *, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    cfg = model_config()
    n = cfg.param_count()
    print(f"model: {cfg.name}, {n / 1e6:.1f}M params")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="lm_train_ckpt_")
    os.makedirs(ckpt_dir, exist_ok=True)     # the heartbeat lands there
    res = train(cfg, trainer_config(args.steps, ckpt_dir), device=device)
    uniform = math.log(cfg.vocab)
    print(f"\nloss: {res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
          f"(uniform baseline {uniform:.3f})")
    assert res.losses[-1] < res.losses[0] - 0.5, "training did not learn"
    print(f"checkpoints in {ckpt_dir}")
    return res


if __name__ == "__main__":
    main()
