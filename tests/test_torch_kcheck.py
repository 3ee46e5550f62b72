"""The kernels' checked build (``kernels/csrc/kcheck.cuh``,
``kernels.build.checked``, ``analysis.kernelpass.kcheck``) on the CPU,
with no card and no nvcc: the decoding of records, write counts and
jittered outputs into CA401-CA403 findings (synthetic numpy arrays), the
scoping of the checked libraries, the arming arguments, the manifest's
write contract, the sources' use of the header and the CLI's
``--kcheck``.  The checked runs themselves are card-only
(``test_torch_kernels_gpu.py``)."""
import ctypes
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import rules as jrules
from repro_torch.analysis import cli, kernelpass
from repro_torch.analysis.rules import get_rule
from repro_torch.kernels import build
from repro_torch.kernels import manifest as kman

from conftest import REPO

ROOT = Path(REPO)
ENT = kman.entry("fused_path_step")
FIELDS = kernelpass.RECORD_FIELDS


def _record(**fields):
    return tuple(fields.get(f, 0) for f in FIELDS)


def _launch(record=None, **counts):
    """A checked path-step launch: its inputs, then ``cand`` and
    ``stats`` (outputs) and ``partials`` (scratch), counts all ones
    unless given."""
    ones = {"cand": np.ones(8, np.int32), "stats": np.ones(5, np.int32),
            "partials": np.ones(10, np.int32)}
    ones.update(counts)
    bufs = [kernelpass.Buffer(n, "input", 8) for n in ("omega", "w", "scal")]
    bufs += [kernelpass.Buffer("cand", "output", 8, ones["cand"]),
             kernelpass.Buffer("stats", "output", 8, ones["stats"]),
             kernelpass.Buffer("partials", "scratch", 8, ones["partials"])]
    return kernelpass.Launch("pathstep", bufs, record or _record())


def _rules(findings):
    return sorted(f.rule for f in findings)


# ---------------------------------------------------------------------------
# decoding: records and write counts
# ---------------------------------------------------------------------------

#: (record code, region, rule, words of the message)
RECORD_CASES = [
    (1, 3, "CA403", ("outside every registered buffer", "cand")),
    (2, 0, "CA403", ("store into an input", "omega")),
    (3, -1, "CA403", ("shared-memory", "shared memory")),
    (4, 4, "CA403", ("alignment", "stats")),
    (5, 5, "CA402", ("before its store", "partials")),
    (6, 1, "CA403", ("TMA tensor map", " w,")),
]


@pytest.mark.parametrize("code,region,rule,words", RECORD_CASES,
                         ids=[f"code{c[0]}" for c in RECORD_CASES])
def test_record_decodes_to_its_rule(code, region, rule, words):
    rec = _record(code=code, region=region, offset=4096, extent=4096,
                  site=102, block_x=3, thread_y=7, errors=2, accesses=99)
    found = kernelpass.launch_findings(ENT, "cfg/float64", _launch(rec))
    assert _rules(found) == [rule]
    f = found[0]
    assert f.path == ENT["source"] and f.line == 102
    assert f.context == "fused_path_step [cfg/float64]"
    for w in words + ("byte offset 4096 of 4096", "block (3, 0, 0)",
                      "thread (0, 7, 0)", "2 error(s)"):
        assert w in f.message, (w, f.message)


@pytest.mark.parametrize("counts,rules", [
    ({}, []),
    ({"cand": np.array([1, 1, 0, 1, 1, 1, 1, 0], np.int32)}, ["CA402"]),
    ({"stats": np.array([1, 2, 1, 1, 1], np.int32)}, ["CA401"]),
    ({"partials": np.array([1, 1, 2] + [1] * 7, np.int32)}, ["CA401"]),
    # scratch may stay unstored (no launch reads it unwritten: a read
    # before the store is the record's code 5)
    ({"partials": np.zeros(10, np.int32)}, []),
    ({"cand": np.zeros(8, np.int32), "stats": np.full(5, 3, np.int32)},
     ["CA401", "CA402"]),
], ids=["clean", "unstored-output", "output-twice", "scratch-twice",
        "scratch-unstored", "both"])
def test_write_counts_decode_against_the_contract(counts, rules):
    found = kernelpass.launch_findings(ENT, "cfg/float64", _launch(**counts))
    assert _rules(found) == rules
    for f in found:
        if f.rule == "CA402":
            assert "2 of 8 element(s) never stored" in f.message or \
                "8 of 8" in f.message
        if f.rule == "CA401":
            assert "stored more than once" in f.message


def test_declared_many_writes_are_no_race():
    ent = dict(ENT, writes={"stats": ("many", "a test's declared "
                                               "accumulation")})
    launch = _launch(stats=np.array([1, 2, 1, 1, 1], np.int32))
    assert kernelpass.launch_findings(ent, "c", launch) == []
    assert _rules(kernelpass.launch_findings(ENT, "c", launch)) == ["CA401"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32])
def test_jittered_outputs_held_bit_for_bit(dtype):
    a = np.arange(12, dtype=dtype).reshape(3, 4)
    same = a.copy()
    moved = a.copy()
    moved[1, 2] += 1
    base = [("cand", a), ("stats", np.asarray(dtype(3)))]
    runs = {1: [("cand", same), ("stats", np.asarray(dtype(3)))],
            2: [("cand", moved), ("stats", np.asarray(dtype(3)))],
            3: [("cand", same), ("stats", np.asarray(dtype(4)))]}
    found = kernelpass.jitter_findings(ENT, "c", base, runs)
    assert _rules(found) == ["CA401", "CA401"]
    assert "cand changed under jitter seed 2: 1 of 12" in found[0].message
    assert "stats changed under jitter seed 3: 1 of 1" in found[1].message


def test_jitter_compares_bits_not_values():
    nan = np.array([np.nan, 0.0, 1.0])
    neg0 = np.array([np.nan, -0.0, 1.0])
    assert kernelpass.jitter_findings(ENT, "c", [("o", nan)],
                                      {1: [("o", nan.copy())]}) == []
    found = kernelpass.jitter_findings(ENT, "c", [("o", nan)],
                                       {1: [("o", neg0)]})
    assert _rules(found) == ["CA401"]


def test_codes_cover_the_header():
    """Every error code of kcheck.cuh's ``Code`` maps to a rule, and the
    record's field count is the header's."""
    text = (build.CSRC / "kcheck.cuh").read_text()
    codes = {int(v) for v in re.findall(r"k\w+ = (\d+),\s+//", text)}
    assert codes == set(kernelpass.KC_CODES)
    n = int(re.search(r"kRecordFields = (\d+);", text).group(1))
    assert n == len(FIELDS)
    assert int(re.search(r"kMaxRegions = (\d+);", text).group(1)) \
        == kernelpass.MAX_REGIONS
    assert re.findall(r"enum Role : int \{ kInput = 0, kOutput = 1, "
                      r"kScratch = 2 \}", text)
    assert kernelpass.ROLES == ("input", "output", "scratch")


@pytest.mark.parametrize("rid", ["CA401", "CA402", "CA403"])
def test_rules_keep_the_reference_names(rid):
    assert get_rule(rid).name == jrules.get_rule(rid).name
    assert get_rule(rid).engine == "kernels"


# ---------------------------------------------------------------------------
# the checked libraries: flags, names and scope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [*build.EXTRA_FLAGS, *build.PROBES])
def test_checked_flags_and_hash_differ(name):
    prod, chk = build._flags(name), build._flags(name, checked=True)
    assert not set(build.CHECK_FLAGS) & set(prod)
    assert chk == prod + list(build.CHECK_FLAGS)
    assert "-DREPRO_KCHECK" in chk and "-lineinfo" in chk and "-G" not in chk
    a, b = build._target(name), build._target(name, checked=True)
    assert a != b and b.name.startswith(f"{name}-checked-")
    assert not a.name.startswith(f"{name}-checked")
    assert a.parent == b.parent == build.BUILD_DIR


def test_header_bytes_are_part_of_the_hash(monkeypatch, tmp_path):
    a = build._target("softthresh")
    header = tmp_path / "kcheck.cuh"
    header.write_bytes(build.HEADER.read_bytes() + b"// edited\n")
    monkeypatch.setattr(build, "HEADER", header)
    assert build._target("softthresh") != a


def _fake_nvcc(tmp_path, body):
    """An executable standing in for nvcc: ``body`` runs with the output
    path in $OUT and the source in $SRC."""
    exe = tmp_path / "nvcc"
    exe.write_text("#!/bin/sh\n"
                   'while [ "$#" -gt 1 ]; do [ "$1" = -o ] && OUT="$2"; '
                   'shift; done\nSRC="$1"\n' + body)
    exe.chmod(0o755)
    return str(exe)


def test_jobs_build_in_the_background_and_report(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "libs")
    monkeypatch.setattr(build, "_nvcc", lambda: _fake_nvcc(
        tmp_path, 'echo "ptxas info    : Used 7 registers"\n'
                  'echo lib > "$OUT"\n'))
    jobs = build.Jobs([("softthresh", False), ("softthresh", True),
                       ("kcheck_faults", True)])
    libs = jobs.wait()
    assert sorted(libs) == [("kcheck_faults", True), ("softthresh", False),
                            ("softthresh", True)]
    assert all(p.is_file() for p in libs.values())
    assert libs[("softthresh", True)] == build._target("softthresh", True)
    for key in ("softthresh", "softthresh checked", "kcheck_faults checked"):
        assert "Used 7 registers" in build.PTXAS_REPORT[key]
        assert build.BUILD_SECONDS[key] >= 0
    assert sorted(p.suffix for p in (tmp_path / "libs").iterdir()) == [
        ".so"] * 3
    again = build.Jobs([("softthresh", True)])
    assert again.wait() == {("softthresh", True): libs[("softthresh", True)]}


def test_jobs_raise_on_a_failed_build_and_stop_kills(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "libs")
    monkeypatch.setattr(build, "_nvcc", lambda: _fake_nvcc(
        tmp_path, 'echo "error: no such thing" ; exit 3\n'))
    with pytest.raises(RuntimeError, match="pathstep checked .exit 3"):
        build.build(["pathstep"], checked=True)
    monkeypatch.setattr(build, "_nvcc", lambda: _fake_nvcc(
        tmp_path, "sleep 30\n"))
    jobs = build.Jobs([("flash_attention", True)])
    jobs.stop()
    assert jobs.wait() == {} and list((tmp_path / "libs").iterdir()) == []


class _FakeCDLL:
    def __init__(self, path):
        self.path = str(path)


@pytest.fixture
def fake_libs(monkeypatch, tmp_path):
    """load() without nvcc: build() names a path per (name, checked) and
    ctypes.CDLL records what was loaded."""
    built = []

    def fake_build(names, checked=False):
        built.append((tuple(names), checked))
        return {n: tmp_path / build._target(n, checked).name for n in names}
    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", _FakeCDLL)
    monkeypatch.setattr(build, "_LIBS", {})
    return built


def test_load_takes_the_checked_library_only_inside_the_scope(fake_libs):
    prod = build._target("pathstep").name
    chk = build._target("pathstep", checked=True).name
    assert Path(build.load("pathstep").path).name == prod
    with build.checked():
        assert Path(build.load("pathstep").path).name == chk
        with build.checked(lambda *a: None):
            assert Path(build.load("pathstep").path).name == chk
        assert Path(build.load("pathstep").path).name == chk
    assert Path(build.load("pathstep").path).name == prod
    try:
        with build.checked():
            raise KeyError("leave the scope by an exception")
    except KeyError:
        pass
    assert Path(build.load("pathstep").path).name == prod
    assert fake_libs == [(("pathstep",), False), (("pathstep",), True)]


def test_regions_reach_only_a_scope_with_a_callback(fake_libs):
    seen = []
    t = torch.zeros(4)
    build.regions("softthresh", inputs={"z": t}, outputs={"out": t})
    with build.checked():
        build.regions("softthresh", inputs={"z": t}, outputs={"out": t})
    assert seen == [] and fake_libs == []
    with build.checked(lambda *a: seen.append(a)):
        build.regions("softthresh", inputs={"z": t, "weights": None},
                      outputs={"out": t})
    (name, lib, bufs), = seen
    assert name == "softthresh"
    assert Path(lib.path).name == build._target("softthresh", True).name
    assert bufs == {"input": {"z": t, "weights": None},
                    "output": {"out": t}, "scratch": {}}


@pytest.mark.parametrize("module,name", [
    ("softthresh", "softthresh"), ("pathstep", "pathstep"),
    ("blocksparse_matmul", "blocksparse_matmul"),
    ("flash_attention", "flash_attention")])
def test_every_wrapper_hands_its_buffers_over_before_its_launch(module,
                                                                 name):
    """Each wrapper calls ``build.regions`` with its library's name after
    loading it and before calling the kernel."""
    src = (ROOT / "src/repro_torch/kernels" / f"{module}.py").read_text()
    calls = [m.start() for m in re.finditer(
        rf'build\.regions\("{name}"', src)]
    launches = [m.start() for m in re.finditer(r"\n    rc = fn\(", src)]
    assert calls and len(calls) == len(launches)
    for c, launch in zip(calls, launches):
        assert c < launch


# ---------------------------------------------------------------------------
# arming and reading, with a fake library
# ---------------------------------------------------------------------------

def test_span_bytes_follows_the_strides():
    t = torch.zeros((4, 6), dtype=torch.float64)
    assert kernelpass.span_bytes(t) == 4 * 6 * 8
    assert kernelpass.span_bytes(t.t()) == 4 * 6 * 8
    assert kernelpass.span_bytes(t[:, :3]) == (3 * 6 + 3) * 8
    assert kernelpass.span_bytes(t[1:3, ::2]) == (6 + 4 + 1) * 8
    assert kernelpass.span_bytes(t[:0]) == 0


def test_arm_arguments_and_limits():
    x = torch.zeros((3, 5), dtype=torch.float64)
    y = torch.zeros(7, dtype=torch.int8)
    out = torch.zeros((2, 4), dtype=torch.float32)
    (n, base, nbytes, elem, role, counts), shadows = kernelpass.arm_arguments(
        [("x", "input", x), ("y", "input", y), ("out", "output", out),
         ("tmp", "scratch", x[:, 1:3])])
    assert n == 4
    assert list(base) == [x.data_ptr(), y.data_ptr(), out.data_ptr(),
                          x.data_ptr() + 8]
    assert list(nbytes) == [120, 7, 32, (2 * 5 + 2) * 8]
    assert list(elem) == [8, 1, 4, 8] and list(role) == [0, 0, 1, 2]
    assert shadows[0] is None and shadows[1] is None
    assert [s.numel() for s in shadows[2:]] == [8, 12]
    assert all(s.dtype == torch.int32 and not s.any() for s in shadows[2:])
    assert counts[0] is None and counts[2] == shadows[2].data_ptr()
    with pytest.raises(ValueError, match="1 to 8"):
        kernelpass.arm_arguments([("x", "input", x)] * 9)
    with pytest.raises(ValueError, match="1 to 8"):
        kernelpass.arm_arguments([])


class _FakeLib:
    """kcheck_arm / kcheck_read of a checked library, in Python: arm
    keeps the arguments, read writes a record with one error."""

    def __init__(self, rc_arm=0, rc_read=0):
        self.armed = []

        def kcheck_arm(n, base, nbytes, elem, role, counts, seed):
            self.armed.append((n, [base[i] for i in range(n)], seed))
            return rc_arm

        def kcheck_read(rec):
            for i, f in enumerate(FIELDS):
                rec[i] = {"code": 1, "region": 1, "site": 74,
                          "accesses": 42}.get(f, 0)
            return rc_read
        self.kcheck_arm, self.kcheck_read = kcheck_arm, kcheck_read


def test_recorder_arms_reads_and_disarms_each_launch():
    lib = _FakeLib()
    rec = kernelpass.Recorder(seed=2)
    z, out = torch.ones(6, dtype=torch.float64), torch.zeros(6)
    rec("softthresh", lib, {"input": {"z": z, "diag_mask": None},
                            "output": {"out": out}})
    assert rec.launches == [] and lib.armed[0][0] == 2
    rec("softthresh", lib, {"input": {"z": z}, "output": {"out": out}})
    rec.finish()
    rec.finish()
    assert len(rec.launches) == 2 and [a[2] for a in lib.armed] == [2, 2]
    first = rec.launches[0]
    assert [b.name for b in first.buffers] == ["z", "out"]
    assert first.buffers[0].counts is None
    assert first.buffers[1].counts.tolist() == [0] * 6
    assert first.field("accesses") == 42 and first.field("site") == 74
    found = kernelpass.launch_findings(kman.entry("fused_prox_stats"),
                                       "c", first)
    assert _rules(found) == ["CA402", "CA403"]
    assert "out, byte offset" in [f for f in found
                                  if f.rule == "CA403"][0].message


@pytest.mark.parametrize("which", ["arm", "read"])
def test_recorder_raises_on_a_failed_arm_or_read(which):
    lib = _FakeLib(rc_arm=700 if which == "arm" else 0,
                   rc_read=700 if which == "read" else 0)
    rec = kernelpass.Recorder()
    t = torch.zeros(2)
    with pytest.raises(RuntimeError, match=f"kcheck_{which}.*700"):
        rec("pathstep", lib, {"input": {"o": t}, "output": {"c": t}})
        rec.finish()


def test_kcheck_functions_take_pointers():
    lib = _FakeLib()
    arm = kernelpass._kcheck_fn(lib, "arm")
    assert arm.argtypes[0] is ctypes.c_int
    assert arm.argtypes[-1] is ctypes.c_uint
    assert kernelpass._kcheck_fn(lib, "read").argtypes == [
        ctypes.POINTER(ctypes.c_longlong)]


def test_checked_runs_refuse_the_cpu():
    with pytest.raises(ValueError, match="on the card"):
        kernelpass.kcheck(device="cpu")
    with pytest.raises(ValueError, match="on the card"):
        kernelpass.probes(device="cpu")


def test_place_gapped_keeps_the_values_inside_unregistered_gaps():
    a = np.arange(10.0).reshape(2, 5)
    t = kernelpass.place_gapped(a, "cpu", torch.float64)
    assert torch.equal(t, torch.as_tensor(a)) and t.is_contiguous()
    base = t._base if t._base is not None else t
    gap = kernelpass.GAP_BYTES
    assert t.data_ptr() - base.data_ptr() == gap
    assert base.numel() * 8 == 10 * 8 + 2 * gap


# ---------------------------------------------------------------------------
# the sources, the manifest, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cu", sorted(p.name for p in build.CSRC.glob("*.cu"))
                         + ["probes/kcheck_faults.cu"])
def test_every_source_includes_the_check_header(cu):
    text = (build.CSRC / cu).read_text()
    assert re.search(r'#include "(\.\./)?kcheck\.cuh"', text), cu
    assert re.search(r"\bKC_(LD|ST)\(", text), cu


def test_production_macros_expand_to_nothing():
    text = (build.CSRC / "kcheck.cuh").read_text()
    prod = text.split("#else  // production", 1)[1]
    for macro in ("KC_LD(ptr, bytes)", "KC_ST(ptr, bytes)",
                  "KC_SH(ptr, bytes)", "KC_JITTER(iter)",
                  "KC_HOST_RANGE(ptr, bytes)"):
        assert f"#define {macro} ((void)0)" in prod
    assert text.count("#ifdef REPRO_KCHECK") == 1


@pytest.mark.parametrize("name", [e["name"] for e in kman.KERNEL_ENTRIES])
def test_manifest_write_contract_defaults_to_once(name):
    ent = kman.entry(name)
    assert "writes" in ent and isinstance(ent["writes"], dict)
    for contract, reason in ent["writes"].values():
        assert contract in kman.WRITE_CONTRACTS and len(reason) > 20
    for buf in ("out", "stats", "cand", "partials", "c", "anything"):
        if buf not in ent["writes"]:
            assert kman.write_contract(ent, buf) == "once"
    assert kman.write_contract(
        dict(ent, writes={"c": ("many", "a test")}), "c") == "many"


def _case(findings=(), failures=()):
    return kernelpass.KcheckCase("fused_path_step", "aligned/float64",
                                 launches=1, accesses=10, worst_count=1,
                                 jitter_runs=3, findings=list(findings),
                                 failures=list(failures))


def _probe(tripped=True):
    f = kernelpass.launch_findings(ENT, "p", _launch(
        cand=np.zeros(8, np.int32)))
    return kernelpass.ProbeResult("tile_unstored",
                                  "CA402" if tripped else "CA401", f, 0.1)


@pytest.mark.parametrize("cases,probe_ok,rc", [
    ([_case()], True, 0),
    ([_case(findings=kernelpass.launch_findings(
        ENT, "aligned/float64", _launch(stats=np.full(5, 2, np.int32))))],
     True, 1),
    ([_case(failures=["jitter seed 2: RuntimeError: launch failed"])],
     True, 1),
    ([_case()], False, 1),
], ids=["clean", "finding", "failure", "blind-probe"])
def test_cli_kcheck_gates(monkeypatch, tmp_path, capsys, cases, probe_ok,
                          rc):
    calls = []
    monkeypatch.setattr(kernelpass, "probes",
                        lambda **kw: calls.append(kw) or [_probe(probe_ok)])
    monkeypatch.setattr(kernelpass, "kcheck",
                        lambda **kw: calls.append(kw) or cases)
    out = tmp_path / "report.json"
    assert cli.main(["--engine", "kernels", "--kcheck", "--device", "cpu",
                     "--seed", "5", "--root", REPO, "--format", "json",
                     "--output", str(out)]) == rc
    capsys.readouterr()
    assert calls[0]["device"] == calls[1]["device"]
    assert calls[1]["seed"] == 5
    kc = json.loads(out.read_text())["kernel_kcheck"]
    assert kc["seed"] == 5 and kc["counts"]["cases"] == 1
    assert kc["counts"]["probes_tripped"] == int(probe_ok)
    assert cli.main(["--engine", "kernels", "--kcheck", "--device", "cpu",
                     "--root", REPO]) == rc
    text = capsys.readouterr().out
    assert "kcheck (seed 0): 1 case(s)" in text
    assert ("tripped CA402" if probe_ok else "DID NOT TRIP CA401") in text


def test_cli_kcheck_flag_is_listed(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    assert "--kcheck" in capsys.readouterr().out
