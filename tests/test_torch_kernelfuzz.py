"""The port's differential kernel fuzzer (``repro_torch.analysis.kernelfuzz``)
and its memory checks (``kernelpass``): seeding and verdicts equal to the
reference's fuzzer, a harness with teeth, the plain route of every
config and card config against the reference's oracles, the guard's
bands and repeats, and the compute-sanitizer plumbing.

On the CPU ``kernels.ops`` routes each case to the plain version, so the
fuzz tests here hold the machinery; the cases that run the CUDA kernels
carry the ``gpu`` marker and skip without a card.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.analysis import kernelfuzz as jkf
from repro.kernels import ref as jref
from repro_torch.analysis import cli, kernelfuzz, kernelpass
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import manifest as kman
from repro_torch.kernels.flash_attention import HEAD_DIMS

from _torch_parity import cuda, x64  # noqa: F401
from conftest import REPO

ROOT = Path(REPO)

CASES = [(e, c) for e in kman.KERNEL_ENTRIES
         for c in tuple(e["configs"]) + tuple(e["card_configs"])]
CASE_IDS = [f"{e['name']}-{c['label']}" for e, c in CASES]


# ---------------------------------------------------------------------------
# the reference's seeding and verdicts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,name,label", [
    (0, "kernels.softthresh.fused_prox_stats", "aligned"),
    (3, "kernels.flash_attention.flash_attention", "card-decode-d80"),
    (7, "kernels.x.f", "edge"),
])
def test_case_rng_draws_the_references_arrays(seed, name, label):
    a = kernelfuzz.case_rng(seed, name, label).standard_normal(16)
    b = jkf.case_rng(seed, name, label).standard_normal(16)
    np.testing.assert_array_equal(a, b)


def _pairs():
    want = np.linspace(-1.0, 1.0, 16)
    ulp = want.copy()
    ulp[3] = np.nextafter(ulp[3], np.inf)
    return {
        "equal": (want.copy(), want, "bit-exact"),
        "one-ulp-bit-exact": (ulp, want, "bit-exact"),
        "one-ulp-fp-tolerant": (ulp, want, "fp-tolerant"),
        "outside-rtol": (want + 1e-6, want, "fp-tolerant"),
        "unknown-class": (want, want, "close-enough"),
        "shape": (np.ones(3), np.ones(4), "bit-exact"),
        "dtype": (np.ones(3, np.float32), np.ones(3), "fp-tolerant"),
        "nan-equal": (np.array([np.nan, 1.0]), np.array([np.nan, 1.0]),
                      "bit-exact"),
    }


@pytest.mark.parametrize("case", sorted(_pairs()))
def test_compare_verdicts_equal_the_references(case):
    got, want, tol = _pairs()[case]
    entry = {"name": "test.meta", "rtol": 1e-9, "atol": 1e-9}
    a = kernelfuzz._compare(entry, "cfg", "out", got, want, tol)
    b = jkf._compare(entry, "cfg", "out", got, want, tol)
    assert (a.ok, a.max_abs_diff, a.tolerance) == \
        (b.ok, b.max_abs_diff, b.tolerance)
    assert bool(a.detail) == bool(b.detail)


def test_per_dtype_tolerance_of_a_port_entry():
    ent = kman.entry("flash_attention")
    want = np.ones(8, np.float32)
    got = want * (1 + 1e-2)
    assert kernelfuzz._compare(ent, "c", "out", got, want, "fp-tolerant",
                               "bfloat16").ok
    r = kernelfuzz._compare(ent, "c", "out", got, want, "fp-tolerant",
                            "float32")
    assert not r.ok and "rtol=0.002" in r.detail


# ---------------------------------------------------------------------------
# the harness has teeth
# ---------------------------------------------------------------------------

def test_crashed_builder_surfaces_as_failed_case():
    entry = {"name": "test.crash",
             "fuzz": lambda cfg, rng, device, dtype: 1 // 0}
    [r] = kernelfuzz.run_case(entry, {"label": "boom"}, seed=0,
                              device="cpu")
    assert not r.ok and r.output == "<error>"
    assert "fuzz builder raised" in r.detail
    assert "ZeroDivisionError" in r.detail


def test_empty_builder_is_a_failure_not_a_pass():
    entry = {"name": "test.empty", "fuzz": lambda cfg, rng, device, dtype: []}
    [r] = kernelfuzz.run_case(entry, {"label": "none"}, seed=0,
                              device="cpu")
    assert not r.ok and r.output == "<empty>"


def test_report_counts_and_case_table():
    results = [
        kernelfuzz.FuzzResult("e", "c", "out", "bit-exact", True),
        kernelfuzz.FuzzResult("e", "c", "out2", "fp-tolerant", False,
                              0.5, "outside tolerance"),
    ]
    rep = kernelfuzz.report(results, seed=7, device="cpu", seconds=1.5)
    assert rep["seed"] == 7 and rep["device"] == "cpu"
    assert rep["counts"] == {"cases": 2, "failures": 1}
    assert rep["cases"][1]["detail"] == "outside tolerance"
    assert [r.output for r in kernelfuzz.failures(results)] == ["out2"]


def test_every_entry_is_fuzzed_at_every_config_and_dtype():
    for e in kman.KERNEL_ENTRIES:
        cases = kernelfuzz.entry_cases(e)
        n_cfg = len(e["configs"]) + len(e["card_configs"])
        assert len(cases) == n_cfg * len(e["rtol"])
        assert {dt for _, dt in cases} == set(e["rtol"])
    flash = kman.entry("flash_attention")
    dims = {c["D"] for c in flash["card_configs"]}
    assert dims == set(HEAD_DIMS)
    lengths = {(c["Lq"], c["Lkv"]) for c in flash["card_configs"]}
    assert {(63, 63), (64, 64), (65, 65), (1, 65)} <= lengths


def test_cpu_fuzz_of_the_registry_passes():
    results = kernelfuzz.fuzz_entries(kman.KERNEL_ENTRIES, seed=1,
                                      device="cpu")
    assert not kernelfuzz.failures(results)
    assert {r.entry for r in results} == {
        e["name"] for e in kman.KERNEL_ENTRIES}
    assert any(r.tolerance == "bit-exact" for r in results)


# ---------------------------------------------------------------------------
# the plain route of every case against the reference's oracle
# ---------------------------------------------------------------------------

def _oracle(entry, cfg, rng):
    """{output: reference value} from ``repro.kernels.ref`` run op by op
    on the numpy draws the port's builder makes from the same rng."""
    name = entry["name"]
    if name == "fused_prox_stats":
        z, mask, w = kman.softthresh_problem(cfg, rng,
                                             bool(cfg.get("weighted")))
        out = jref.fused_prox_stats(
            jnp.asarray(z), jnp.asarray(mask), cfg.get("alpha", 0.3),
            weights=None if w is None else jnp.asarray(w),
            block=tuple(cfg["block"]))
        named = dict(zip(kman.PROX_OUTPUTS, out))
        # the trial entry: z formed in numpy (no FMA), the prox and its
        # stats by the reference's oracle
        g = rng.standard_normal(z.shape)
        zt = z - kman.TRIAL_TAU * g
        tr = jref.fused_prox_stats(
            jnp.asarray(zt), jnp.asarray(mask), cfg.get("alpha", 0.3),
            weights=None if w is None else jnp.asarray(w),
            block=tuple(cfg["block"]))
        d = np.asarray(tr[0]) - z
        trial = {"out": tr[0], "diff_sq": np.sum(d * d),
                 "diff_grad": np.sum(d * g), "sumsq": tr[3],
                 "block_nnz": tr[5]}
        return {**named, **{f"implicit:{k}": v for k, v in named.items()},
                **{f"trial:{k}": v for k, v in trial.items()}}
    if name == "fused_path_step":
        *args, w = kman.pathstep_problem(cfg, rng)
        cand, stats = jref.fused_path_step(
            *(jnp.asarray(a) for a in args),
            weights=None if w is None else jnp.asarray(w))
        return {"cand": cand, "stats": stats}
    if name == "blocksparse_matmul":
        _, vals, rows, cols, b = kman.blocksparse_problem(cfg, rng)
        out = jref.blocksparse_matmul(jnp.asarray(vals), jnp.asarray(rows),
                                      jnp.asarray(cols), jnp.asarray(b),
                                      cfg["p"])
        return {"out": out, "masked:out": out}
    q, k, v, kw = kman.flash_problem(cfg, rng)
    out = jref.attention(*(jnp.asarray(x, jnp.float32) for x in (q, k, v)),
                         **kw)
    return {"out": out}


@pytest.mark.parametrize("entry,cfg", CASES, ids=CASE_IDS)
def test_plain_route_matches_the_references_oracle(x64, entry, cfg):
    """The port's builder on the CPU (its plain route) against the
    reference's oracle on the same draws: float64 (float32 for flash, the
    reference's oracle dtype), within each output's declared class."""
    dt = "float32" if entry["name"] == "flash_attention" else "float64"
    seed_name = entry["jax_entry"]
    cases = entry["fuzz"](cfg, kernelfuzz.case_rng(0, seed_name,
                                                   cfg["label"]),
                          "cpu", getattr(torch, dt))
    want = _oracle(entry, cfg, kernelfuzz.case_rng(0, seed_name,
                                                   cfg["label"]))
    assert [c[0] for c in cases] == list(want)
    tol = entry["rtol"][dt]
    for name, got, _, cls in cases:
        w = np.asarray(want[name]).astype(got.dtype)
        if cls == "bit-exact":
            np.testing.assert_array_equal(got, w, err_msg=name)
        else:
            np.testing.assert_allclose(got, w, rtol=tol, atol=tol,
                                       err_msg=name)


def test_fuzzer_runs_with_jax_blocked():
    code = ("import sys\nsys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "from repro_torch.analysis import kernelfuzz\n"
            "from repro_torch.kernels.manifest import KERNEL_ENTRIES\n"
            "res = kernelfuzz.fuzz_entries(KERNEL_ENTRIES, seed=2,\n"
            "                              device='cpu')\n"
            "assert res and not kernelfuzz.failures(res)\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
            "               for m in sys.modules if sys.modules[m] is not None)\n"
            "print('ok', len(res))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


# ---------------------------------------------------------------------------
# the CLI gate
# ---------------------------------------------------------------------------

def _fake_registry(perturb: bool):
    """A one-entry registry whose builder optionally flips an ulp."""
    def fake_fuzz(cfg, rng, device, dtype, place=None):
        want = rng.standard_normal(4)
        got = want.copy()
        if perturb:
            got[0] = np.nextafter(got[0], np.inf)
        return [("out", got, want, "bit-exact")]

    return [{"name": "fake", "source": "src/repro_torch/kernels/csrc/f.cu",
             "rtol": {"float64": 1e-12}, "configs": ({"label": "only"},),
             "fuzz": fake_fuzz}]


def test_cli_fuzz_failure_gates_even_with_zero_findings(
        tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(kman, "KERNEL_ENTRIES", _fake_registry(True))
    report = tmp_path / "fuzz.json"
    rc = cli.main(["src/repro_torch/analysis", "--engine", "ast", "--root",
                   REPO, "--device", "cpu", "--fuzz-kernels", "--format",
                   "json",
                   "--output", str(report)])
    capsys.readouterr()
    assert rc == 1
    data = json.loads(report.read_text(encoding="utf-8"))
    assert data["counts"]["findings"] == 0        # static side is clean
    assert data["kernel_fuzz"]["counts"] == {"cases": 1, "failures": 1}
    case = data["kernel_fuzz"]["cases"][0]
    assert case["entry"] == "fake" and not case["ok"]


@pytest.mark.parametrize("flag", ["--seed", "--fuzz-seed"])
def test_cli_fuzz_pass_and_seed_passthrough(capsys, monkeypatch, flag):
    monkeypatch.setattr(kman, "KERNEL_ENTRIES", _fake_registry(False))
    rc = cli.main(["src/repro_torch/analysis", "--engine", "ast", "--root",
                   REPO, "--device", "cpu", "--fuzz-kernels", flag, "3"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "kernel fuzz (seed 3): 1 case(s), 0 failure(s)." in out


def test_cli_fuzz_defaults_to_the_card(capsys, monkeypatch):
    monkeypatch.setattr(kman, "KERNEL_ENTRIES", _fake_registry(False))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["src/repro_torch/analysis", "--engine", "ast", "--root", REPO]
    assert cli.main(args + ["--fuzz-kernels"]) == 2
    assert "device='cpu'" in capsys.readouterr().err
    assert cli.main(args) == 0          # the AST engine needs no device
    with pytest.raises(RuntimeError, match="CUDA card"):
        kernelfuzz.fuzz_entries(kman.KERNEL_ENTRIES)


def test_cli_sanitize_takes_only_the_sanitizer_tools(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--engine", "ast", "--sanitize", "guard"])
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("status", ["refused", "errors", "failed"])
def test_cli_sanitizer_that_is_not_clean_fails_the_gate(
        tmp_path, capsys, monkeypatch, status):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    res = kernelpass.SanitizeResult(
        tool="memcheck", status=status, errors=int(status == "errors"),
        warnings=0, seconds=1.0, returncode=0, cases=70, fuzz_failures=0,
        detail="Error: Device not supported" if status == "refused" else "")
    monkeypatch.setattr(kernelpass, "sanitize", lambda tool, **kw: res)
    report = tmp_path / "san.json"
    rc = cli.main(["src/repro_torch/analysis", "--engine", "ast", "--root",
                   REPO, "--sanitize", "memcheck", "--format", "json",
                   "--output", str(report)])
    capsys.readouterr()
    assert rc == 1
    data = json.loads(report.read_text(encoding="utf-8"))
    assert data["kernel_sanitize"]["memcheck"]["status"] == status
    assert "kernel_guard" not in data


# ---------------------------------------------------------------------------
# the guard: bands, a poisoned allocator, repeats
# ---------------------------------------------------------------------------

@pytest.fixture
def guarded(monkeypatch):
    """The guard on the CPU too (the allocator poison is CUDA only)."""
    monkeypatch.setattr(kernelfuzz, "guards", lambda device: True)


def test_guarded_case_of_a_real_entry_passes(guarded):
    ent = kman.entry("fused_path_step")
    results = kernelfuzz.run_case(ent, ent["card_configs"][1], seed=0,
                                  device="cpu")
    assert results and not kernelfuzz.failures(results)
    outputs = [r.output for r in results]
    assert "cand:repeat" in outputs and outputs[-1] == "<guard>"


def test_guard_is_on_by_default_only_on_a_cached_cuda_device(monkeypatch):
    monkeypatch.delenv("PYTORCH_NO_CUDA_MEMORY_CACHING", raising=False)
    assert not kernelfuzz.guards("cpu")
    assert kernelfuzz.guards("cuda") and kernelfuzz.guards(
        torch.device("cuda", 0))
    monkeypatch.setenv("PYTORCH_NO_CUDA_MEMORY_CACHING", "1")
    assert not kernelfuzz.guards("cuda")
    ent = kman.entry("fused_path_step")
    results = kernelfuzz.run_case(ent, ent["card_configs"][1], seed=0,
                                  device="cpu")
    assert not any(r.output in ("<guard>", "cand:repeat") for r in results)


def test_guard_places_inputs_inside_poison_bands():
    guard = kernelfuzz.Guard()
    t = guard.place(np.arange(6.0).reshape(2, 3), "cpu", torch.float64)
    assert t.shape == (2, 3) and t.is_contiguous()
    assert t.data_ptr() % 16 == 0
    assert torch.equal(t, torch.arange(6.0, dtype=torch.float64).view(2, 3))
    assert guard.breached() == 0
    i = guard.place(np.arange(3), "cpu", torch.int32)
    assert i.dtype == torch.int32 and len(guard.bands) == 1


def _oob_entry(write_past: bool, flaky: bool):
    """A builder that writes one element past its input (an out-of-bounds
    write into the band), or returns a different value on its second run
    (a race's signature)."""
    calls = {"n": 0}

    def fuzz(cfg, rng, device, dtype, place=kman.place_tensor):
        x = place(rng.standard_normal(8), device, dtype)
        if write_past:
            torch.as_strided(x, (9,), (1,))[8] = 0.0
        calls["n"] += 1
        got = x.numpy().copy()
        if flaky and calls["n"] == 2:
            got[0] += 1.0
        return [("out", got, x.numpy().copy(), "bit-exact")]

    return {"name": "test.oob", "rtol": {"float64": 1e-12}, "fuzz": fuzz}


def test_guard_counts_an_out_of_bounds_write(guarded):
    results = kernelfuzz.run_case(_oob_entry(True, False), {"label": "x"},
                                  device="cpu")
    [bad] = kernelfuzz.failures(results)
    assert bad.output == "<guard>" and "out-of-bounds" in bad.detail


def test_guard_repeat_catches_a_nondeterministic_output(guarded):
    results = kernelfuzz.run_case(_oob_entry(False, True), {"label": "x"},
                                  device="cpu")
    [bad] = kernelfuzz.failures(results)
    assert bad.output == "out:repeat"


# ---------------------------------------------------------------------------
# compute-sanitizer plumbing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool,text,want", [
    ("memcheck", "========= ERROR SUMMARY: 0 errors\n", ("ok", 0, 0)),
    ("initcheck", "========= Uninitialized __global__ memory read\n"
                  "========= ERROR SUMMARY: 3 errors\n", ("errors", 3, 0)),
    ("racecheck", "========= RACECHECK SUMMARY: 2 hazards displayed "
                  "(1 error, 1 warning)\n", ("errors", 1, 1)),
    ("racecheck", "========= RACECHECK SUMMARY: 0 hazards displayed "
                  "(0 errors, 0 warnings)\n", ("ok", 0, 0)),
    ("memcheck", "========= Error: Device not supported. Please refer to "
                 "the \"Supported Devices\" section\n"
                 "========= ERROR SUMMARY: 3 errors\n", ("refused", 0, 0)),
    ("memcheck", "Traceback (most recent call last):\n", ("failed", 0, 0)),
], ids=["clean", "initcheck-errors", "race-error", "race-clean", "refused",
        "no-summary"])
def test_parse_sanitizer(tool, text, want):
    status, errors, warns, detail = kernelpass.parse_sanitizer(tool, text)
    assert (status, errors, warns) == want
    if status == "refused":
        assert "Device not supported" in detail


def test_sanitize_refuses_the_cpu_and_a_missing_tool(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="CUDA kernels on the card"):
        kernelpass.sanitize("memcheck", device="cpu")
    with pytest.raises(ValueError, match="unknown sanitizer tool"):
        kernelpass.sanitize("leakcheck", device="cuda")
    fake_nvcc = tmp_path / "bin" / "nvcc"
    fake_nvcc.parent.mkdir()
    fake_nvcc.write_text("")
    monkeypatch.setattr(tbuild, "_nvcc", lambda: str(fake_nvcc))
    with pytest.raises(RuntimeError, match="compute-sanitizer not found"):
        kernelpass.sanitizer_path()


def test_kernel_filters_name_every_global_function():
    args = kernelpass.kernel_filters(kman.KERNEL_ENTRIES)
    names = args[1::2]
    assert args[0::2] == ["--kernel-name"] * len(names)
    assert "kns=flash_fwd_wgmma" in names and "kns=bsmm_f64_tc" in names
    assert len(names) == sum(len(e["kernels"]) for e in kman.KERNEL_ENTRIES)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_card_fuzz_of_the_registry_passes(cuda):
    from repro_torch.kernels import ops
    ops.reset_launches()
    results = kernelfuzz.fuzz_entries(kman.KERNEL_ENTRIES, seed=0,
                                      device=cuda)
    bad = kernelfuzz.failures(results)
    assert not bad, "\n".join(r.render() for r in bad[:10])
    assert all(n > 0 for n in ops.LAUNCHES.values())


@pytest.mark.gpu
def test_card_guard_stand_in_passes(cuda):
    results = kernelfuzz.fuzz_entries(kman.KERNEL_ENTRIES, seed=0,
                                      device=cuda)
    bad = kernelfuzz.failures(results)
    assert not bad, "\n".join(r.render() for r in bad[:10])
    guarded = sum(r.output == "<guard>" for r in results)
    assert guarded == sum(len(kernelfuzz.entry_cases(e))
                          for e in kman.KERNEL_ENTRIES)
