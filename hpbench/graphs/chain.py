"""The chain graph of HP-CONCORD's synthetic problems: a tridiagonal
Omega0 with 1 on the diagonal and ``graph["weight"]`` beside it."""
from __future__ import annotations

import torch


def omega(graph: dict, p: int, device, dtype=torch.float64) -> torch.Tensor:
    weight = graph["weight"]
    out = torch.eye(p, dtype=dtype, device=device)
    idx = torch.arange(p - 1, device=device)
    out[idx, idx + 1] = weight
    out[idx + 1, idx] = weight
    return out
