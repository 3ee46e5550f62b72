"""The assigned architecture configs of the LM zoo.

Port of ``repro.configs``: the ten config modules are data and are
copied as they are.  ``get(name)`` returns the full-size ``ModelConfig``;
``get_smoke(name)`` a reduced same-family config for CPU tests.
``cells`` lists the dry run's (arch x shape) cells and ``input_specs``
builds each cell's inputs as meta tensors of the reference's shapes and
dtypes (no allocation), for ``launch.dryrun``.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "h2o_danube_1p8b",
    "qwen2p5_3b",
    "gemma2_27b",
    "qwen1p5_110b",
    "mixtral_8x22b",
    "olmoe_1b_7b",
    "chameleon_34b",
    "mamba2_130m",
    "zamba2_7b",
    "whisper_small",
]

ALIASES = {
    "h2o-danube-1.8b": "h2o_danube_1p8b",
    "qwen2.5-3b": "qwen2p5_3b",
    "gemma2-27b": "gemma2_27b",
    "qwen1.5-110b": "qwen1p5_110b",
    "mixtral-8x22b": "mixtral_8x22b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "chameleon-34b": "chameleon_34b",
    "mamba2-130m": "mamba2_130m",
    "zamba2-7b": "zamba2_7b",
    "whisper-small": "whisper_small",
}

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def canon(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


def get(name: str):
    mod = importlib.import_module(f".{canon(name)}", __package__)
    return mod.CONFIG


def get_smoke(name: str):
    mod = importlib.import_module(f".{canon(name)}", __package__)
    return mod.SMOKE


def long_context_ok(cfg) -> bool:
    """True iff the arch has a sub-quadratic decode memory/compute path:
    SSM state, hybrid, or uniform sliding-window attention."""
    return cfg.family in ("ssm", "hybrid") or bool(cfg.window)


def cells(include_long_skips: bool = False):
    """Yield every (arch, shape) cell per the assignment."""
    for a in ARCHS:
        cfg = get(a)
        for s in SHAPES:
            if s == "long_500k" and not long_context_ok(cfg) \
                    and not include_long_skips:
                continue
            yield a, s


def input_specs(cfg, shape_name: str, *, device=None):
    """One dry-run cell's inputs, shaped and typed as the reference's
    ``ShapeDtypeStruct`` stand-ins, on ``device`` (default ``"meta"``: no
    allocation):

      train   -> {"batch": lm.Batch}                  for the train step
      prefill -> {"tokens", "frames", "cache"}        for ``make_prefill``
      decode  -> {"token", "step", "cache"}           for the decode step

    ``frames`` is None but for an enc-dec model; the cache is
    ``transformer.init_cache``'s tree."""
    sh = SHAPES[shape_name]
    return step_inputs(cfg, sh["kind"], sh["global_batch"], sh["seq_len"],
                       device=device)


def step_inputs(cfg, kind: str, batch_size: int, seq_len: int, *,
                device=None):
    """:func:`input_specs` of a step of ``kind`` ("train", "prefill" or
    "decode") at any global batch and sequence length."""
    import torch

    from ..models import lm, transformer as T

    dev = torch.device("meta" if device is None else device)
    B, Lseq = batch_size, seq_len
    i32 = torch.int32
    dt = getattr(torch, cfg.dtype)

    def tok(*shape):
        return torch.empty(shape, dtype=i32, device=dev)

    def frames():
        return (torch.empty((B, cfg.enc_len, cfg.d_model), dtype=dt,
                            device=dev) if cfg.enc_dec else None)

    if kind == "train":
        return {"kind": "train",
                "batch": lm.Batch(tokens=tok(B, Lseq), targets=tok(B, Lseq),
                                  frames=frames())}
    cache = T.init_cache(cfg, B, Lseq, device=dev)
    if kind == "prefill":
        return {"kind": "prefill", "tokens": tok(B, Lseq),
                "frames": frames(), "cache": cache,
                "batch_size": B, "seq_len": Lseq}
    return {"kind": "decode", "token": tok(B), "step": tok(),
            "cache": cache, "batch_size": B, "seq_len": Lseq}
