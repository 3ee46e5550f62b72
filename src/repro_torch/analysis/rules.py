"""Rule registry and per-directory profiles.

Port of ``repro.analysis.rules``, under the reference's rule ids, re-aimed
at what the port is: eager PyTorch plus CUDA C++ kernels loaded by
``ctypes``.  Three engines share the registry:

  * ``CA1xx`` — AST engine (``astpass``): pure-syntax contracts, no torch
    import needed, run on any python file.
  * ``CA2xx`` — dispatch engine (``dispatchpass``): semantic contracts
    checked by RUNNING the entry-point manifest at f64 under a
    ``TorchDispatchMode`` that records every aten op.
  * ``CA4xx`` — kernel engine (``kernelpass``): every CUDA source in
    ``kernels/csrc`` is registered, with its plain twin and tolerance
    classes (CA405); the checked build (``kernelpass.kcheck``) finds write
    races, unwritten outputs and out-of-range accesses on the card
    (CA401-CA403); the differential fuzzer (``kernelfuzz``) and the
    opt-in compute-sanitizer runs (``kernelpass.sanitize``) hold the
    kernels on the card too.

Reference rules with no torch counterpart are listed in
:data:`NO_ANALOGUE` with the reason, the way ``kernels.manifest.NOT_PORTED``
lists kernels.

A :class:`Profile` is the set of rule ids active for a directory tree.
``src/repro_torch`` runs the full ``default`` profile; ``chip_smoke.py``
and ``examples/torch_*.py`` run the relaxed ``scripts`` profile (host
code by construction), ``repro_torch/obs/`` the ``obs`` profile.

Adding a rule: register it here (the next free id in the engine's range),
implement it in the engine module keyed on the id, and add a tripping
fixture and a clean counterpart to ``tests/test_torch_analysis.py`` — the
registry test asserts every registered rule has both.
"""
from __future__ import annotations

from dataclasses import dataclass, field

ENGINES = ("ast", "dispatch", "kernels")


@dataclass(frozen=True)
class Rule:
    id: str
    name: str
    engine: str             # "ast" | "dispatch" | "kernels"
    description: str


_RULES: dict[str, Rule] = {}


def register_rule(rule: Rule, *, overwrite: bool = False) -> Rule:
    if not overwrite and rule.id in _RULES:
        raise ValueError(f"rule {rule.id} already registered")
    if rule.engine not in ENGINES:
        raise ValueError(f"unknown engine {rule.engine!r}")
    _RULES[rule.id] = rule
    return rule


def get_rule(rule_id: str) -> Rule:
    try:
        return _RULES[rule_id]
    except KeyError:
        raise ValueError(
            f"unknown rule {rule_id!r}; registered: {sorted(_RULES)}"
        ) from None


def all_rules() -> list[Rule]:
    return [_RULES[k] for k in sorted(_RULES)]


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

register_rule(Rule(
    "CA100", "unparseable-source", "ast",
    "file failed to parse: nothing else can be checked until it does "
    "(always reported, independent of the active profile)",
))
register_rule(Rule(
    "CA103", "mutable-default-argument", "ast",
    "mutable default argument (a list/dict/set literal or list()/dict()/"
    "set() call): the default is built once and aliased across every "
    "call, so state leaks from one solve into the next",
))
register_rule(Rule(
    "CA104", "dtype-literal-in-f64-module", "ast",
    "sub-64-bit float dtype literal (torch.float32/float16/bfloat16/half, "
    "np.float32/float16, a narrow dtype= string, or .float()/.half()/"
    ".bfloat16()) in an f64-contract module: the Gram/solve chain "
    "accumulates in float64 by contract — declare any intentional narrow "
    "dtype once as a module-level *_DTYPE constant so the policy is named "
    "and greppable",
))
register_rule(Rule(
    "CA105", "raw-collective-bypass", "ast",
    "torch.distributed collective, barrier or group set-up called outside "
    "the collective layer (comm/, core/distributed.py): route it through "
    "comm.group so the collective watcher sees it and gloo's host staging "
    "is counted",
))
register_rule(Rule(
    "CA106", "host-sync-in-loop", "ast",
    "device->host pull (.item()/.tolist()/.cpu()/.numpy(), float()/int()/"
    "bool() over a torch./np. expression, torch.cuda.synchronize()) inside "
    "a python loop or comprehension: one blocking transfer per iteration "
    "— batch the device work and pull once, or declare the sync with its "
    "reason",
))

register_rule(Rule(
    "CA200", "manifest-entry-error", "dispatch",
    "a manifest entry failed to build or run: the dispatch checks did not "
    "run for that entry point (always reported — a broken entry must not "
    "silently skip its contracts)",
))
register_rule(Rule(
    "CA201", "f64-downcast-in-dispatch", "dispatch",
    "an aten op of a manifest entry run at f64 takes a float64 input and "
    "yields a narrower float output: the distributed iteration must be "
    "bit-identical to the sequential one, so the f64 contract may never "
    "silently narrow",
))
register_rule(Rule(
    "CA202", "obs-changes-dispatch", "dispatch",
    "the same solve dispatched a different aten op sequence at obs=\"trace\" "
    "than at obs=\"off\": instrumentation must stay on the host and leave "
    "the device work op for op as it was",
))

register_rule(Rule(
    "CA401", "kernel-write-race", "kernels",
    "in the kernels' checked build on the card (kernelpass.kcheck), an "
    "output or scratch element stored more than once by one launch "
    "against its manifest write contract (\"once\" by default: two "
    "blocks or threads own the same element), or an output whose bits "
    "move when the case re-runs under schedule jitter (a barrier "
    "missing; no kernel sums its outputs with atomics)",
))
register_rule(Rule(
    "CA402", "kernel-coverage-gap", "kernels",
    "in the kernels' checked build on the card, an output element that "
    "no store of the launch reached (it ships whatever stale memory the "
    "buffer held), or a load of output or scratch memory before any "
    "store to it",
))
register_rule(Rule(
    "CA403", "kernel-block-oob", "kernels",
    "in the kernels' checked build on the card, a global access outside "
    "every buffer the launch registered (or off its natural alignment), "
    "a store into an input, a shared-memory access outside the block's "
    "allocation, or a TMA tensor map reaching past its tensor",
))
register_rule(Rule(
    "CA405", "kernel-missing-oracle", "kernels",
    "a CUDA source in kernels/csrc ships without exactly one "
    "KERNEL_ENTRIES registration, or its entry names a missing plain twin "
    "in kernels.ref / an unknown tolerance class: every kernel must "
    "declare bit-exact or fp-tolerant outputs and be differentially "
    "testable against plain PyTorch",
))

#: reference rules with no counterpart in the port, and why
NO_ANALOGUE: dict[str, str] = {
    "CA101": "the port traces nothing: every function runs eagerly, so a "
             "host call cannot concretize a tracer (no torch.compile, no "
             "CUDA-graph capture today)",
    "CA102": "the port traces nothing: a python branch on a tensor is an "
             "eager host sync, which CA106 and the dispatch engine's sync "
             "census count",
    "CA203": "torch.distributed names no mesh axes in a traced program; "
             "teams are process groups built by comm.group, whose wrappers "
             "announce every collective to the watcher",
    "CA300": "no comm engine: the port's collective schedule is checked "
             "at run time (obs.commwatch reconciles every posted "
             "collective against core.costmodel.comm_volume)",
    "CA301": "no traced SPMD branches: ranks run python, and the run-time "
             "reconciliation sees a divergent schedule as a mismatch",
    "CA302": "ppermute tables are checked at run time by comm.group "
             "(every rank's source and destination come from one table)",
    "CA303": "bytes on the wire are reconciled at run time against "
             "comm_volume (obs.commwatch, chip_smoke phase telemetry)",
    "CA304": "no traced schedule to search for redundant collectives; "
             "the run-time census counts every collective by kind",
    "CA305": "COMM_CONTRACT is held at run time by obs.commwatch's "
             "reconciliation, not by tracing",
    "CA306": "wire dtypes are held at run time by the watcher's byte "
             "counts against the contract's wire",
    "CA400": "the kernel engine builds no Pallas layout; a fuzz builder "
             "that raises is a failed fuzz case",
    "CA404": "no traced kernel body: a CUDA kernel's accumulators are "
             "C++ types, held by the fuzzer's f64 tolerance classes",
    "CA406": "no SMEM scalar tables or BlockSpecs: the wrappers check "
             "shapes before each launch",
}


# ---------------------------------------------------------------------------
# profiles
# ---------------------------------------------------------------------------

AST_RULES = frozenset(r.id for r in all_rules() if r.engine == "ast")
DISPATCH_RULES = frozenset(r.id for r in all_rules()
                           if r.engine == "dispatch")
KERNEL_RULES = frozenset(r.id for r in all_rules() if r.engine == "kernels")


@dataclass(frozen=True)
class Profile:
    """The rule subset + per-rule knobs active for one directory tree."""
    name: str
    rules: frozenset = AST_RULES | DISPATCH_RULES | KERNEL_RULES
    # modules under the f64 accumulation contract (CA104), matched as
    # posix path suffixes
    f64_modules: tuple = ()
    # path suffixes allowed to call torch.distributed directly (CA105)
    collective_layer: tuple = ()
    extra: dict = field(default_factory=dict)


#: modules where a 32-bit float literal would narrow the paper's f64
#: iteration/accumulation contract: the reference's list, re-rooted
#: (flash_attention is excluded: an attention kernel's f32 accumulator is
#: its own, unrelated contract)
F64_CONTRACT_MODULES = (
    "repro_torch/core/objective.py",
    "repro_torch/core/prox.py",
    "repro_torch/core/matops.py",
    "repro_torch/core/batch.py",
    "repro_torch/core/distributed.py",
    "repro_torch/core/penalty.py",
    "repro_torch/data/gram.py",
    "repro_torch/data/transforms.py",
    "repro_torch/comm/matmul1p5d.py",
    "repro_torch/comm/sparse1p5d.py",
    "repro_torch/kernels/softthresh.py",
    "repro_torch/kernels/pathstep.py",
    "repro_torch/kernels/blocksparse_matmul.py",
    "repro_torch/kernels/ref.py",
    "repro_torch/kernels/ops.py",
)

#: the blessed raw torch.distributed call sites (CA105): the comm layer
#: itself and the distributed drivers that live inside it conceptually
COLLECTIVE_LAYER = (
    "repro_torch/comm/",
    "repro_torch/core/distributed.py",
)

DEFAULT_PROFILE = Profile(
    name="default",
    rules=AST_RULES | DISPATCH_RULES | KERNEL_RULES,
    f64_modules=F64_CONTRACT_MODULES,
    collective_layer=COLLECTIVE_LAYER,
)

#: chip_smoke.py and examples/torch_*.py: host-side drivers by design.
#: Ad-hoc dtypes and per-iteration host pulls are the point of a script,
#: so CA104/CA106 are off; mutable defaults and collective-layer bypasses
#: still apply (scripts share the solver entry points).
SCRIPTS_PROFILE = Profile(
    name="scripts",
    rules=frozenset({"CA103", "CA105"}),
    f64_modules=(),
    collective_layer=COLLECTIVE_LAYER,
)

#: the observability layer (repro_torch/obs/): host-side by construction
#: (the tracer reads clocks, the registry mutates python dicts, the
#: watcher counts bytes), so the in-loop host-sync rule does not apply;
#: nothing in obs/ issues device work of its own (the CA202 recipe proves
#: it).  Mutable defaults and collective routing still apply.
OBS_PROFILE = Profile(
    name="obs",
    rules=frozenset({"CA103", "CA105"}),
    f64_modules=(),
    collective_layer=COLLECTIVE_LAYER,
)

PROFILES = {p.name: p for p in (DEFAULT_PROFILE, SCRIPTS_PROFILE,
                                OBS_PROFILE)}

_SCRIPT_DIR_HINTS = ("benchmarks/", "examples/", "scripts/")
_SCRIPT_FILES = ("chip_smoke.py",)

_OBS_DIR_HINT = "repro_torch/obs/"


def profile_for_path(relpath: str) -> Profile:
    """Per-directory profile resolution (posix relpath from repo root)."""
    rp = relpath.replace("\\", "/")
    if any(rp.startswith(h) or f"/{h}" in rp for h in _SCRIPT_DIR_HINTS):
        return SCRIPTS_PROFILE
    if rp.rsplit("/", 1)[-1] in _SCRIPT_FILES:
        return SCRIPTS_PROFILE
    if rp.startswith(_OBS_DIR_HINT) or f"/{_OBS_DIR_HINT}" in rp:
        return OBS_PROFILE
    return DEFAULT_PROFILE
