"""Entry-point manifest collection.

Port of ``repro.analysis.manifest``.  Each solver layer declares its own
entry points in a module-level ``ANALYSIS_ENTRIES`` list (schema in
:mod:`repro_torch.analysis.dispatchpass`) — the manifest lives WITH the
code it describes.  This module only knows which layers to ask.
"""
from __future__ import annotations

import importlib

#: the solver layers that export ``ANALYSIS_ENTRIES`` (the reference's
#: ``MANIFEST_MODULES``, re-rooted)
MANIFEST_MODULES = (
    "repro_torch.core.prox",          # sequential reference solve
    "repro_torch.core.batch",         # batched lambda-path / multi-problem
    "repro_torch.core.distributed",   # 1.5D drivers on a one-process grid
    "repro_torch.data.gram",          # streaming Gram + panel compute core
    "repro_torch.kernels.ops",        # kernel dispatch (plain on the CPU)
    "repro_torch.comm.matmul1p5d",    # 1.5D ring products
    "repro_torch.comm.sparse1p5d",    # masked ring products
    "repro_torch.comm.collectives",   # compressed wire formats
    "repro_torch.obs.commwatch",      # obs off vs trace: same device work
)

#: the reference's manifest entries with no port entry, and why
NO_ENTRY: dict[str, str] = {
    "comm.collectives.ring_allreduce_int8":
        "the dispatch engine runs on one process, where the ring is the "
        "identity and dispatches no op; the int8 ring's narrowing is its "
        "wire format, held by the multi-rank tests "
        "(tests/test_torch_ranks.py, tests/test_torch_sharding.py) and "
        "its COMM_CONTRACT",
}


def load_entries(modules=MANIFEST_MODULES) -> list:
    """Import the manifest modules and concatenate their entries.

    Raises ImportError eagerly: a layer that fails to import is a finding
    in itself and must not be silently skipped.
    """
    entries: list = []
    for name in modules:
        mod = importlib.import_module(name)
        declared = getattr(mod, "ANALYSIS_ENTRIES", None)
        if declared is None:
            raise AttributeError(
                f"manifest module {name} exports no ANALYSIS_ENTRIES; "
                f"every solver layer must declare its entry points")
        entries.extend(declared)
    names = [e["name"] for e in entries]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(f"duplicate manifest entry names: {sorted(dupes)}")
    return entries
