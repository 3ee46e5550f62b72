"""repro_torch.analysis: every registered rule has a tripping fixture and a
clean counterpart, the rules both packages share read a snippet the same
way, findings and baselines cross between the packages, and the port's
own tree scans clean.

The AST rules (CA1xx) are tripped on small inline snippets at
contract-relevant fake paths; the dispatch rules (CA2xx) on synthetic
manifest entries run by ``dispatchpass.run_entry`` on the CPU; CA405 on a
copy of the kernel registry with one defect each.  A registry test holds
the fixture set and the rule registry in sync.
"""
import json
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import astpass as jastpass
from repro.analysis import baseline as jbaseline
from repro.analysis import findings as jfindings
from repro.analysis import rules as jrules
from repro.analysis.manifest import load_entries as jload_entries
from repro_torch.analysis import astpass, baseline, cli, dispatchpass
from repro_torch.analysis import findings as tfindings
from repro_torch.analysis import kernelpass, manifest
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import (DEFAULT_PROFILE, NO_ANALOGUE,
                                        OBS_PROFILE, SCRIPTS_PROFILE,
                                        all_rules, get_rule,
                                        profile_for_path)
from repro_torch.kernels import manifest as kman

from conftest import REPO

ROOT = Path(REPO)

# ---------------------------------------------------------------------------
# fixtures: rule id -> (tripping thunk, clean thunk)
# ---------------------------------------------------------------------------

_TRIPS = {}
_CLEAN = {}


def trips(rule_id):
    def mark(fn):
        _TRIPS[rule_id] = fn
        return fn
    return mark


def clean(rule_id):
    def mark(fn):
        _CLEAN[rule_id] = fn
        return fn
    return mark


def _ast(relpath, source, profile=DEFAULT_PROFILE):
    return astpass.scan_source(relpath, source, profile)


@trips("CA100")
def _trip_unparseable():
    return _ast("src/repro_torch/core/broken.py", "def f(:\n    pass\n")


@clean("CA100")
def _clean_parseable():
    return _ast("src/repro_torch/core/fine.py", "def f():\n    pass\n")


@trips("CA103")
def _trip_mutable_default():
    return _ast("src/repro_torch/core/fake.py", """\
def solve(x, history=[], *, seen=dict()):
    return x
""")


@clean("CA103")
def _clean_none_default():
    return _ast("src/repro_torch/core/fake.py", """\
def solve(x, history=None, *, seen=(), tol=1e-5):
    return x
""")


@trips("CA104")
def _trip_narrow_dtype_in_f64_module():
    return _ast("src/repro_torch/core/matops.py", """\
import torch

def gramify(x):
    return x.to(torch.float32) + x.float()
""")


@clean("CA104")
def _clean_named_dtype_policy():
    return _ast("src/repro_torch/core/matops.py", """\
import torch

DENSITY_DTYPE = torch.float32

def gramify(x):
    return x.to(DENSITY_DTYPE) + x.to(x.dtype)
""")


@trips("CA105")
def _trip_raw_collective_outside_layer():
    return _ast("src/repro_torch/launch/fake.py", """\
import torch.distributed as dist

def reduce_stats(x):
    dist.all_reduce(x)
    return x
""")


@clean("CA105")
def _clean_collective_inside_layer():
    return _ast("src/repro_torch/comm/fake.py", """\
import torch.distributed as dist

def reduce_stats(x):
    dist.all_reduce(x)
    return x
""")


@trips("CA106")
def _trip_host_sync_in_loop():
    return _ast("src/repro_torch/core/fake.py", """\
def trace_path(path_points):
    return [om.trace().item() for om in path_points]
""")


@clean("CA106")
def _clean_one_pull_after_the_loop():
    return _ast("src/repro_torch/core/fake.py", """\
import torch

def trace_path(path_points):
    return torch.stack([om.trace() for om in path_points]).tolist()
""")


# -- dispatch fixtures ------------------------------------------------------

def _entry(name, build, **kw):
    return {"name": name, "path": "src/repro_torch/core/fake.py",
            "build": build, **kw}


def _run(entry):
    return dispatchpass.run_entry(entry, DEFAULT_PROFILE, "cpu")[0]


@trips("CA200")
def _trip_broken_entry():
    def build(device):
        raise RuntimeError("representative shapes unavailable")
    return _run(_entry("test.broken_build", build))


@clean("CA200")
def _clean_entry_runs():
    return _run(_entry("test.runs", lambda device: {
        "fn": torch.mm, "args": (torch.eye(3, dtype=torch.float64),) * 2}))


def _gram_finalize(x, narrow: bool):
    """A copy of the panel-Gram accumulate + finalize, with an optional
    injected narrowing of the finalized Gram."""
    n, p = x.shape
    out = torch.zeros((p, p), dtype=x.dtype)
    for lo in range(0, p, 2):
        out[lo:lo + 2] = x[:, lo:lo + 2].T @ x
    s = out / n
    return s.to(torch.float32) if narrow else s


def _gram_build(narrow: bool):
    return lambda device: {
        "fn": _gram_finalize, "args": (torch.linspace(
            0.0, 1.0, 24, dtype=torch.float64).reshape(6, 4), narrow)}


@trips("CA201")
def _trip_f64_downcast():
    return _run(_entry("test.gram_finalize_downcast", _gram_build(True)))


@clean("CA201")
def _clean_f64_throughout():
    return _run(_entry("test.gram_finalize", _gram_build(False)))


def _same_ops(extra: bool):
    x = torch.ones(4, dtype=torch.float64)

    def off():
        return x * 2.0

    def trace():
        y = x * 2.0
        return y + 0.0 if extra else y

    return _entry("test.obs_levels", lambda device: {"fn": off},
                  same_ops=lambda device: {"off": off, "trace": trace})


@trips("CA202")
def _trip_obs_changes_dispatch():
    return _run(_same_ops(True))


@clean("CA202")
def _clean_obs_keeps_dispatch():
    return _run(_same_ops(False))


# -- kernel registry fixtures -------------------------------------------------

def _registry(**changes):
    entries = [dict(e) for e in kman.KERNEL_ENTRIES]
    entries[0].update(changes)
    return entries


# -- checked-build fixtures (synthetic records and write counts) ---------------

def _checked_launch(record=(), **counts):
    """A checked fused-prox launch (inputs z, weights; outputs out,
    stats) decoded by kernelpass: every count 1 unless given, the record
    clean unless given."""
    rec = dict(zip(kernelpass.RECORD_FIELDS, [0] * 13), **dict(record))
    bufs = [kernelpass.Buffer("z", "input", 8),
            kernelpass.Buffer("weights", "input", 8),
            kernelpass.Buffer("out", "output", 8,
                              counts.get("out", np.ones(16, np.int32))),
            kernelpass.Buffer("stats", "output", 8,
                              counts.get("stats", np.ones(5, np.int32)))]
    return kernelpass.launch_findings(
        kman.entry("fused_prox_stats"), "aligned/float64",
        kernelpass.Launch("softthresh", bufs,
                          tuple(rec[f] for f in kernelpass.RECORD_FIELDS)))


@trips("CA401")
def _trip_element_stored_twice():
    return _checked_launch(stats=np.array([1, 1, 2, 1, 1], np.int32))


@clean("CA401")
def _clean_every_element_once():
    return _checked_launch()


@trips("CA402")
def _trip_element_never_stored():
    out = np.ones(16, np.int32)
    out[9] = 0
    return _checked_launch(out=out)


@clean("CA402")
def _clean_every_output_stored():
    return _checked_launch(out=np.ones(16, np.int32))


@trips("CA403")
def _trip_store_past_the_end():
    return _checked_launch({"code": 1, "region": 2, "offset": 128,
                            "extent": 128, "site": 79, "errors": 1})


@clean("CA403")
def _clean_no_error_record():
    return _checked_launch({"accesses": 4096})


@trips("CA405")
def _trip_missing_plain_twin():
    return kernelpass.check_registry(_registry(oracle="no_such_plain",
                                               exact=("not_an_output",)))


@clean("CA405")
def _clean_registry():
    return kernelpass.check_registry()


# ---------------------------------------------------------------------------
# the registry contract
# ---------------------------------------------------------------------------

def test_every_registered_rule_has_a_tripping_and_a_clean_fixture():
    registered = {r.id for r in all_rules()}
    assert registered == set(_TRIPS) == set(_CLEAN), (
        f"rule registry and fixtures out of sync: registered "
        f"{sorted(registered)}, trips {sorted(_TRIPS)}, clean "
        f"{sorted(_CLEAN)}")


@pytest.mark.parametrize("rule_id", sorted(_TRIPS))
def test_fixture_trips_its_rule(rule_id):
    rule = get_rule(rule_id)
    findings = _TRIPS[rule_id]()
    tripped = {f.rule for f in findings}
    assert rule_id in tripped, (
        f"{rule_id} ({rule.name}) fixture produced {sorted(tripped)}")
    for f in findings:
        assert f.message and f.path     # renderable findings only


@pytest.mark.parametrize("rule_id", sorted(_CLEAN))
def test_clean_counterpart_does_not_trip(rule_id):
    findings = _CLEAN[rule_id]()
    assert not [f for f in findings if f.rule == rule_id], \
        "\n".join(f.render() for f in findings)


def test_every_reference_rule_is_ported_or_has_no_analogue():
    port = {r.id for r in all_rules()}
    ref = {r.id for r in jrules.all_rules()}
    assert ref <= port | set(NO_ANALOGUE)
    assert not port & set(NO_ANALOGUE)
    assert set(NO_ANALOGUE) <= ref
    assert all(len(why) > 40 for why in NO_ANALOGUE.values())


def test_every_reference_manifest_entry_has_a_port_entry():
    port = {e["name"] for e in manifest.load_entries()}
    ref = {e["name"] for e in jload_entries()}
    assert ref <= port | set(manifest.NO_ENTRY), sorted(ref - port)
    assert not port & set(manifest.NO_ENTRY)
    assert set(manifest.NO_ENTRY) <= ref
    assert all(len(why) > 40 for why in manifest.NO_ENTRY.values())
    for e in manifest.load_entries():
        assert e["path"].startswith("src/repro_torch/")
        assert (ROOT / e["path"]).is_file()


def test_profiles_by_path():
    assert profile_for_path("chip_smoke.py") is SCRIPTS_PROFILE
    assert profile_for_path("examples/torch_quickstart.py") is SCRIPTS_PROFILE
    assert profile_for_path("src/repro_torch/obs/trace.py") is OBS_PROFILE
    assert profile_for_path("src/repro_torch/core/prox.py") is DEFAULT_PROFILE
    assert "CA104" not in SCRIPTS_PROFILE.rules
    assert "CA106" not in OBS_PROFILE.rules


# ---------------------------------------------------------------------------
# the rules both packages share read a snippet the same way
# ---------------------------------------------------------------------------

_PARITY = {
    "CA100": ("core/broken.py", "def f(:\n    pass\n"),
    "CA103": ("core/fake.py", """\
import jax

@jax.jit
def solve(x, history=[]):
    return x
"""),
    "CA104-string": ("core/matops.py", """\
import jax.numpy as jnp

def gramify(x):
    return jnp.zeros(3, dtype="float32") + x
"""),
    "CA104-numpy": ("core/matops.py", """\
import numpy as np

def gramify(x):
    return np.asarray(x, np.float32)
"""),
    "CA106-numpy": ("core/fake.py", """\
import numpy as np

def trace_path(path_points):
    return [float(np.trace(om)) for om in path_points]
"""),
}


def _key(f):
    return (f.rule, f.line, f.context, f.snippet)


@pytest.mark.parametrize("case", sorted(_PARITY))
def test_shared_rule_reads_a_snippet_as_the_reference_does(case):
    rel, src = _PARITY[case]
    want = [_key(f) for f in jastpass.scan_source(
        f"src/repro/{rel}", src, jrules.DEFAULT_PROFILE)]
    got = [_key(f) for f in astpass.scan_source(
        f"src/repro_torch/{rel}", src, DEFAULT_PROFILE)]
    assert want and got == want


# ---------------------------------------------------------------------------
# the torch forms of each rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", [
    "import torch.distributed as dist\ndef f(x):\n    dist.barrier()\n",
    "from torch import distributed as d\ndef f(x):\n    d.new_group([0])\n",
    "from torch.distributed import all_gather_into_tensor as ag\n"
    "def f(x):\n    ag(x, x)\n",
    "import torch\ndef f(x):\n    torch.distributed.reduce_scatter_tensor(x, x)\n",
    "import torch.distributed as dist\ndef f(x):\n"
    "    dist.batch_isend_irecv([])\n",
], ids=["barrier", "new_group", "all_gather_alias", "reduce_scatter",
        "p2p"])
def test_ca105_sees_every_alias_of_torch_distributed(src):
    hits = [f for f in _ast("src/repro_torch/launch/fake.py", src)
            if f.rule == "CA105"]
    assert len(hits) == 1
    assert not _ast("src/repro_torch/core/distributed.py", src)
    allowed = src.rstrip("\n") + "  # ca: allow=CA105 (set-up)\n"
    assert not _ast("src/repro_torch/launch/fake.py", allowed)


def test_ca104_forms_and_exemptions():
    src = """\
import numpy as np
import torch

WIRE_DTYPE = torch.bfloat16

def f(x):
    a = torch.zeros(3, dtype=torch.half)
    b = x.bfloat16()
    c = np.zeros(3, np.float16)
    d = torch.zeros(3, dtype="bf16")
    e = x.to(WIRE_DTYPE)
    g = x.float()  # ca: allow=CA104 (attention's own f32)
    return a, b, c, d, e, g
"""
    hits = [f.line for f in _ast("src/repro_torch/kernels/ref.py", src)
            if f.rule == "CA104"]
    assert hits == [7, 8, 9, 10]
    assert not _ast("src/repro_torch/kernels/flash_attention.py", src)


def test_ca106_forms_and_the_loops_iterable():
    src = """\
import torch

def f(xs, t):
    for v in t.tolist():
        v.item()
        float(torch.sum(v))
        bool(v.shape[0])
        torch.cuda.synchronize()
    while t.any():
        t = t.cpu()
    return [x.numpy() for x in t.cpu()]
"""
    lines = sorted(f.line for f in _ast("src/repro_torch/core/fake.py", src)
                   if f.rule == "CA106")
    # not line 4 (the loop's iterable, evaluated once) nor 7 (metadata)
    assert lines == [5, 6, 8, 10, 11]
    obs = "src/repro_torch/obs/fake.py"
    assert not _ast(obs, src, profile_for_path(obs))


# ---------------------------------------------------------------------------
# the dispatch engine
# ---------------------------------------------------------------------------

def test_ca201_is_located_at_the_narrowing_line_of_the_port():
    from repro_torch.comm import collectives
    entry = dict(collectives.ANALYSIS_ENTRIES[0])
    entry.pop("skip")
    hits = [f for f in _run(entry) if f.rule == "CA201"]
    assert len(hits) == 1
    f = hits[0]
    assert f.path == "src/repro_torch/comm/collectives.py"
    line = (ROOT / f.path).read_text().splitlines()[f.line - 1]
    assert "bfloat16" in line
    assert f.snippet == "aten._to_copy.default float64 -> bfloat16"
    # without a port frame the finding stays at the entry
    [g] = [f for f in _TRIPS["CA201"]() if f.rule == "CA201"]
    assert (g.path, g.line) == ("src/repro_torch/core/fake.py", 0)


def test_ca202_names_the_first_differing_op():
    [f] = _TRIPS["CA202"]()
    assert f.snippet == "op 1: <end> (off) vs aten.add.Tensor (trace)"


def test_census_counts_host_pulls_by_site():
    def fn(x):
        return float(x.sum()) + x.max().item()
    _, c = dispatchpass.record(fn, torch.ones(3))
    assert c.syncs == 2
    assert sum(c.sync_sites.values()) == 2


def test_dispatch_engine_runs_every_port_entry_clean_on_the_cpu():
    # a torch.device, as chip_smoke.py passes it
    findings, records = dispatchpass.run_entries(
        manifest.load_entries(), DEFAULT_PROFILE, torch.device("cpu"))
    assert findings == [], "\n".join(f.render() for f in findings)
    assert len(records) >= 20
    assert all(r["ops"] > 0 for r in records), records


def test_skips_are_declared_only_where_the_port_narrows():
    """Every CA201 skip hides a real narrowing: with the skip removed the
    entry trips, so no skip is stale."""
    for e in manifest.load_entries():
        if "CA201" not in e.get("skip", ()):
            continue
        e = dict(e, skip=())
        assert any(f.rule == "CA201" for f in _run(e)), e["name"]


# ---------------------------------------------------------------------------
# findings and baselines cross between the packages
# ---------------------------------------------------------------------------

def _findings(mod):
    return [mod.Finding(rule="CA104", path="src/repro_torch/core/prox.py",
                        line=12, message="m", context="f", snippet="x"),
            mod.Finding(rule="CA106", path="src/repro_torch/core/batch.py",
                        line=3, message="n", context="<module>",
                        snippet="y")]


def test_finding_fingerprints_match_the_reference():
    for a, b in zip(_findings(jfindings), _findings(tfindings)):
        assert a.fingerprint() == b.fingerprint()
        assert a.to_json() == b.to_json()
        assert a.render() == b.render()


@pytest.mark.parametrize("writer,reader", [
    (baseline, jbaseline), (jbaseline, baseline)], ids=["port->ref",
                                                         "ref->port"])
def test_baselines_cross_both_ways(tmp_path, writer, reader):
    path = tmp_path / "baseline.json"
    fs = _findings(jfindings)
    writer.write_baseline(fs, path)
    loaded = reader.load_baseline(path)
    assert sorted(loaded) == sorted({f.fingerprint() for f in fs})
    new, suppressed, stale = reader.split_by_baseline(
        [Finding(**f.to_json()) for f in fs], loaded)
    assert not new and len(suppressed) == 2 and not stale


# ---------------------------------------------------------------------------
# the tree and the CLI
# ---------------------------------------------------------------------------

def test_port_tree_scans_clean_with_empty_baseline(capsys):
    rc = cli.main(["--engine", "ast", "--root", REPO])
    out = capsys.readouterr().out
    assert rc == 0, f"analyzer found regressions:\n{out}"
    assert "0 findings" in out


def test_checked_in_port_baseline_is_empty():
    path = f"{REPO}/analysis_baseline_torch.json"
    assert json.loads(open(path, encoding="utf-8").read()) == []


def test_cli_default_run_is_clean_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = cli.main(["--root", REPO, "--device", "cpu", "--format", "json",
                   "--output", str(out)])
    capsys.readouterr()
    assert rc == 0
    data = json.loads(out.read_text(encoding="utf-8"))
    assert data["counts"] == {"findings": 0, "suppressed": 0,
                              "stale_baseline": 0}
    assert "core.prox.solve_reference[sparse]" in data["dispatch_census"]


def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "src" / "repro_torch" / "core" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def f(x=[]):\n    return x\n")
    assert cli.main(["src", "--engine", "ast", "--root", str(tmp_path)]) == 1
    assert cli.main(["src", "--engine", "ast", "--root", str(tmp_path),
                     "--write-baseline"]) == 0
    assert cli.main(["src", "--engine", "ast", "--root", str(tmp_path)]) == 0
    bad.write_text("def f(x=None):\n    return x\n")
    assert cli.main(["src", "--engine", "ast", "--root", str(tmp_path)]) == 1
    assert cli.main(["nowhere", "--engine", "ast",
                     "--root", str(tmp_path)]) == 2
    assert cli.main(["--engine", "kernels", "--sanitize", "memcheck",
                     "--root", str(tmp_path)]) == 2
    capsys.readouterr()


def test_cli_list_rules(capsys):
    assert cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for r in all_rules():
        assert r.id in out
    for rid in NO_ANALOGUE:
        assert f"{rid}  [no analogue]" in out


def test_cli_changed_scans_only_changed_files(tmp_path, capsys):
    def git(*a):
        subprocess.run(["git", *a], cwd=tmp_path, check=True,
                       capture_output=True)
    core = tmp_path / "src" / "repro_torch" / "core"
    core.mkdir(parents=True)
    (core / "old.py").write_text("def f(x=[]):\n    return x\n")
    (core / "new.py").write_text("def g(x):\n    return x\n")
    git("init", "-q")
    git("-c", "user.email=a@b", "-c", "user.name=n", "add", "-A")
    git("-c", "user.email=a@b", "-c", "user.name=n", "commit", "-qm", "x")
    args = ["src", "--engine", "ast", "--root", str(tmp_path),
            "--format", "json"]
    assert cli.main(args + ["--changed"]) == 0
    capsys.readouterr()
    (core / "new.py").write_text("def g(x={}):\n    return x\n")
    assert cli.main(args + ["--changed"]) == 1
    data = json.loads(capsys.readouterr().out)
    assert [f["path"] for f in data["findings"]] == [
        "src/repro_torch/core/new.py"]
    assert cli.main(args) == 1
    data = json.loads(capsys.readouterr().out)
    assert len(data["findings"]) == 2


def test_cli_changed_subsets_the_fuzzed_kernels():
    entries = kman.KERNEL_ENTRIES
    pick = cli.subset_kernel_entries(
        entries, {"src/repro_torch/kernels/pathstep.py"})
    assert [e["name"] for e in pick] == ["fused_path_step"]
    pick = cli.subset_kernel_entries(
        entries, {"src/repro_torch/kernels/csrc/flash_attention.cu"})
    assert [e["name"] for e in pick] == ["flash_attention"]
    assert len(cli.subset_kernel_entries(
        entries, {"src/repro_torch/kernels/ref.py"})) == len(entries)
    assert cli.subset_kernel_entries(entries, {"README.md"}) == []


def test_kernel_registry_defects_each_trip_ca405(tmp_path):
    extra = tmp_path / "csrc"
    extra.mkdir()
    for e in kman.KERNEL_ENTRIES:
        src = ROOT / e["source"]
        (extra / src.name).write_text(src.read_text())
    (extra / "orphan.cu").write_text("__global__ void orphan() {}\n")
    msgs = [f.message for f in kernelpass.check_registry(csrc=extra)]
    assert len(msgs) == 1 and "orphan.cu has 0" in msgs[0]
    for change, word in (({"kernels": ("not_a_kernel",)}, "no __global__"),
                         ({"rtol": {"float64": 0.0}}, "positive rtol"),
                         ({"fuzz": None}, "no fuzz builder"),
                         ({"source": "src/repro_torch/kernels/csrc/x.cu"},
                          "does not exist")):
        msgs = [f.message for f in kernelpass.check_registry(
            _registry(**change))]
        assert any(word in m for m in msgs), (change, msgs)


def test_new_package_runs_with_jax_blocked():
    import os
    import sys
    code = ("import sys\nsys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "from repro_torch.analysis import cli\n"
            "raise SystemExit(cli.main(['--engine', 'all', '--device', "
            f"'cpu', '--root', {str(REPO)!r}]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ,
                                   PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("0 findings.")
