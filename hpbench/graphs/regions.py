"""Functional regions on a cortical grid (Section 5 of the paper): the
variables lie on a ``rows`` x ``cols`` grid cut into ``region`` x
``region`` blocks; 4-neighbours within a block are joined by
``graph["weight"]``, none across blocks; the diagonal is the row's
absolute off-diagonal sum plus 1, so Omega0 is diagonally dominant."""
from __future__ import annotations

import torch


def omega(graph: dict, p: int, device, dtype=torch.float64) -> torch.Tensor:
    rows, cols, region = graph["rows"], graph["cols"], graph["region"]
    if rows * cols != p:
        raise ValueError(f"regions graph: {rows} x {cols} != p {p}")
    if rows % region or cols % region:
        raise ValueError(f"regions graph: {region} does not divide "
                         f"{rows} x {cols}")
    r, c = torch.meshgrid(torch.arange(rows, device=device),
                          torch.arange(cols, device=device), indexing="ij")
    idx = (r * cols + c).reshape(-1)
    label = ((r // region) * (cols // region) + c // region).reshape(-1)
    out = torch.zeros((p, p), dtype=dtype, device=device)
    for dr, dc in ((0, 1), (1, 0)):
        rr, cc = r + dr, c + dc
        ok = ((rr < rows) & (cc < cols)).reshape(-1)
        nb = (rr.clamp(max=rows - 1) * cols
              + cc.clamp(max=cols - 1)).reshape(-1)
        ok &= label == label[nb]
        i, j = idx[ok], nb[ok]
        out[i, j] = graph["weight"]
        out[j, i] = graph["weight"]
    out.diagonal().copy_(out.abs().sum(1) + 1.0)
    return out
