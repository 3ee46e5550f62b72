"""The assigned architecture configs of the LM zoo.

Port of ``repro.configs``: the ten config modules are data and are
copied as they are.  ``get(name)`` returns the full-size ``ModelConfig``;
``get_smoke(name)`` a reduced same-family config for CPU tests.  The
reference's ``input_specs`` (shape stand-ins for its dry run) waits for
the port's launch tools.
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
