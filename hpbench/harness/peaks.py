"""Published peaks of the chips the benchmark runs on.

NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit: 67 TFLOP/s in float64 on the tensor cores and 3.35
TB/s of HBM3.  A card set below 700 W runs slower under load; the
result line carries the card's power limit beside every share.
"""
from __future__ import annotations

H100_SXM = {"name": "H100 SXM data sheet", "flops_per_s": 67e12,
            "bytes_per_s": 3.35e12, "power_w": 700.0}

#: device name (``torch.cuda.get_device_name``) -> its peaks
PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def peaks_for(kind: str) -> dict:
    """The peaks of ``kind``; an unknown device gets the H100 SXM's."""
    return PEAKS.get(kind, H100_SXM)
