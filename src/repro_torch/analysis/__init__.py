"""Contract checks for the PyTorch/CUDA port: the torch side of
``repro.analysis``.

Three engines over one rule registry (:mod:`repro_torch.analysis.rules`),
re-aimed at what the port is — eager PyTorch plus CUDA C++ kernels loaded
by ``ctypes``:

* :mod:`repro_torch.analysis.astpass` — CA1xx, pure stdlib-``ast`` source
  rules (mutable defaults, narrow dtypes in f64-contract modules,
  ``torch.distributed`` calls outside the collective layer, host syncs
  in loops);
* :mod:`repro_torch.analysis.dispatchpass` — CA2xx, the layers'
  ``ANALYSIS_ENTRIES`` run at f64 under a ``TorchDispatchMode`` (f64
  downcasts, obs changing the device work, a host-sync census);
* :mod:`repro_torch.analysis.kernelpass` — CA405, the CUDA kernels'
  registry; CA401-CA403, write races, unwritten outputs and out-of-range
  accesses found by the kernels' checked build on the card; and the
  opt-in compute-sanitizer runs; the companion
  :mod:`repro_torch.analysis.kernelfuzz`
  differentially fuzzes each kernel against its plain version, on the
  card under its guard (bands, a poisoned allocator, each case twice).

The reference's rules without a torch counterpart are listed, with the
reason, in :data:`repro_torch.analysis.rules.NO_ANALOGUE`.  Imports
nothing of JAX or of the JAX package.  Run it as ``python -m
repro_torch.analysis``; see README "Static analysis
(``repro_torch.analysis``)".
"""
from .findings import Finding, sort_findings
from .rules import (
    DEFAULT_PROFILE,
    NO_ANALOGUE,
    SCRIPTS_PROFILE,
    Profile,
    Rule,
    all_rules,
    get_rule,
    profile_for_path,
    register_rule,
)

__all__ = [
    "Finding",
    "sort_findings",
    "Rule",
    "Profile",
    "register_rule",
    "get_rule",
    "all_rules",
    "profile_for_path",
    "DEFAULT_PROFILE",
    "SCRIPTS_PROFILE",
    "NO_ANALOGUE",
]
