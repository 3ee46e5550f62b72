"""Shared set-up of the benchmark's own tests (``python -m pytest -q
hpbench/tests`` from the repository's root; the repository's tier-1 run
does not collect them).  Cells run here on the CPU at small sizes."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: small sizes of each configuration, for runs on the CPU
SMALL = {
    "chain-p16384": {"p": 96, "n": 64},
    "cortex-p4096": {"p": 64, "n": 48,
                     "graph": {"rows": 8, "cols": 8, "region": 4}},
}


def small(workload: str, traffic: dict | None = None) -> dict:
    config = workload.split(".")[0]
    out = {"config": SMALL[config]}
    if traffic:
        out["traffic"] = traffic
    return out


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; runs on the chip")
    return "cuda"
