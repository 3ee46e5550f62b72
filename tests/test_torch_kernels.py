"""The port's kernels on the CPU: their plain versions against the JAX
kernels (Pallas in interpret mode) at every manifest config, and the
port's kernel manifest against the reference's.  The CUDA kernels are
held against their plain versions on the card in
``test_torch_kernels_gpu.py``."""
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import matops as jmatops
from repro.kernels import manifest
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import blocksparse_matmul as tbsmm
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import manifest as tman
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import softthresh as tst

from _torch_parity import assert_prox_stats, x64  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

SOFT = tman.entry("fused_prox_stats")
BSR = tman.entry("blocksparse_matmul")


def _jax_entry(name):
    return next(e for e in manifest.KERNEL_ENTRIES if e["name"] == name)


def _soft_cases():
    for cfg in SOFT["configs"]:
        for weighted in sorted({False, bool(cfg.get("weighted"))}):
            for dt in ("float64", "float32"):
                yield pytest.param(cfg, weighted, dt,
                                   id=f"{cfg['label']}-w{int(weighted)}-{dt}")


@pytest.mark.parametrize("cfg,weighted,dt", list(_soft_cases()))
def test_fused_prox_stats_plain_matches_jax_kernel(x64, cfg, weighted, dt):
    """The port's CPU path (the kernel's plain version) against the
    Pallas kernel in interpret mode: out, min_diag and block_nnz exact,
    the summed stats at the stated tolerance; explicit diagonal mask and
    the implicit (index-derived) diagonal both."""
    rng = np.random.default_rng(zlib.crc32(cfg["label"].encode()))
    z, mask, w = tman.softthresh_problem(cfg, rng, weighted)
    alpha = cfg.get("alpha", 0.3)
    block = tuple(cfg["block"])
    tdt = getattr(torch, dt)
    want = jops.fused_prox_stats(
        jnp.asarray(z, dt), jnp.asarray(mask, dt), alpha,
        weights=None if w is None else jnp.asarray(w, dt), block=block,
        interpret=True)
    tw = None if w is None else torch.as_tensor(w, dtype=tdt)
    for dm in (torch.as_tensor(mask, dtype=tdt), None):
        got = tops.fused_prox_stats(torch.as_tensor(z, dtype=tdt), dm,
                                    alpha, weights=tw, block=block)
        assert got[0].dtype == tdt and got[5].dtype == tdt
        assert_prox_stats(got, want, dt)


@pytest.mark.parametrize("cfg", BSR["configs"], ids=lambda c: c["label"])
def test_blocksparse_plain_matches_jax_kernel(x64, cfg):
    rng = np.random.default_rng(cfg["seed"])
    a, vals, rows, cols, b = manifest._bsr_problem(cfg, rng)
    want = jops.blocksparse_matmul(jnp.asarray(vals), jnp.asarray(rows),
                                   jnp.asarray(cols), jnp.asarray(b),
                                   block_n=cfg["block_n"], interpret=True)
    got = tops.blocksparse_matmul(torch.as_tensor(vals), rows, cols,
                                  torch.as_tensor(b))
    tol = BSR["rtol"]["float64"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=tol, atol=tol)


@pytest.mark.parametrize("cfg", BSR["configs"], ids=lambda c: c["label"])
def test_dense_to_block_csr_matches(cfg):
    """The port's block-CSR builder, and its problem builder draw for
    draw, against the reference's."""
    a, vals, rows, cols, b = manifest._bsr_problem(
        cfg, np.random.default_rng(cfg["seed"]))
    tv, tr, tc = tref.dense_to_block_csr(a, cfg["bs"])
    np.testing.assert_array_equal(tv, vals)
    np.testing.assert_array_equal(tr, rows)
    np.testing.assert_array_equal(tc, cols)
    dense = tref.block_csr_to_dense(torch.as_tensor(tv), tr, tc, cfg["p"])
    np.testing.assert_array_equal(dense.numpy(), a)
    ported = tman.blocksparse_problem(cfg, np.random.default_rng(cfg["seed"]))
    for got, want in zip(ported, (a, vals, rows, cols, b)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cfg", tman.entry("fused_path_step")["configs"],
                         ids=lambda c: c["label"])
def test_pathstep_problem_matches(cfg):
    """The port's path-step problem builder, draw for draw, against the
    reference's ``_pathstep_problem``."""
    want = manifest._pathstep_problem(cfg, np.random.default_rng(11))
    got = tman.pathstep_problem(cfg, np.random.default_rng(11))
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", [e["name"] for e in tman.KERNEL_ENTRIES])
def test_port_manifest_mirrors_jax_manifest(name):
    """Each port entry names a real reference entry, copies its configs
    exactly, points at its CUDA source and at the TPU kernel bodies it
    replaces, and has a launch counter."""
    ent = tman.entry(name)
    assert ent["configs"] == _jax_entry(ent["jax_entry"])["configs"]
    assert (REPO / ent["source"]).is_file()
    for site in ent["replaces"]:
        path, line = site.split(":")
        text = (REPO / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith("def _kernel"), site
    assert name in tops.LAUNCHES


def test_port_manifest_lists_every_unported_kernel():
    ported = {e["jax_entry"] for e in tman.KERNEL_ENTRIES}
    jax_names = {e["name"] for e in manifest.KERNEL_ENTRIES}
    assert ported | set(tman.NOT_PORTED) == jax_names
    assert not ported & set(tman.NOT_PORTED)
    # an entry's own launch keys: its name, and ``<name>[trial]`` for the
    # fused prox's trial entry
    assert ({k.partition("[")[0] for k in tops.LAUNCHES}
            == {e["name"] for e in tman.KERNEL_ENTRIES})


def test_row_revisit_raises_in_both():
    vals = np.ones((3, 4, 4))
    rows, cols = np.asarray([0, 1, 0], np.int32), np.asarray([0, 1, 1],
                                                              np.int32)
    b = np.ones((8, 4))
    with pytest.raises(ValueError, match="non-contiguously"):
        jops.blocksparse_matmul(jnp.asarray(vals), jnp.asarray(rows),
                                jnp.asarray(cols), jnp.asarray(b),
                                interpret=True)
    with pytest.raises(ValueError, match="non-contiguously"):
        tops.blocksparse_matmul(torch.as_tensor(vals), rows, cols,
                                torch.as_tensor(b))


def _masked_problem(p, k, m, bs, density, seed):
    rng = np.random.default_rng(seed)
    nbr, nbc = -(-p // bs), -(-k // bs)
    keep = rng.random((nbr, nbc)) < density
    a = rng.standard_normal((p, k))
    a *= np.kron(keep, np.ones((bs, bs)))[:p, :k]
    b = rng.standard_normal((k, m))
    return a, b, keep.astype(np.int8), int(keep.sum())


@pytest.mark.parametrize("p,k,m,bs,density", [
    (32, 32, 16, 8, 0.3),
    (40, 24, 12, 8, 0.5),       # edge tiles in both dimensions
    (64, 64, 48, 8, 0.1),
    (16, 16, 8, 4, 0.0),        # nothing occupied
], ids=["square", "edge", "sparse", "empty"])
def test_masked_matmul_plain_matches_jax(x64, p, k, m, bs, density):
    """The matops mask entry's plain version against the reference's
    block-gather product, at the exact capacity and with slack."""
    a, b, mask, occ = _masked_problem(p, k, m, bs, density, seed=p + k)
    for cap in sorted({max(occ, 1), occ + 3}):
        want = jmatops.masked_matmul(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(mask), block_size=bs,
                                     capacity=cap)
        got = tops.masked_matmul(torch.as_tensor(a), torch.as_tensor(b),
                                 torch.as_tensor(mask), block_size=bs,
                                 capacity=cap)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-10,
                                   atol=1e-10)


def test_block_nnz_matches_jax(x64):
    a = np.asarray(_masked_problem(40, 24, 1, 8, 0.5, seed=9)[0])
    for block in [(8, 8), (16, 16), (64, 64)]:
        np.testing.assert_array_equal(
            tref.block_nnz(torch.as_tensor(a), block).numpy(),
            np.asarray(jref.block_nnz(jnp.asarray(a), block)))


def test_cpu_launches_are_not_counted():
    tops.reset_launches()
    z = torch.eye(8, dtype=torch.float64)
    tops.fused_prox_stats(z, None, 0.1, block=(4, 4))
    tops.fused_prox_trial(z, z, 0.5, 0.1, block=(4, 4))
    tops.masked_matmul(z, z, torch.ones((2, 2), dtype=torch.int8),
                       block_size=4, capacity=4)
    assert tops.LAUNCHES == {"fused_prox_stats": 0,
                             "fused_prox_stats[trial]": 0,
                             "blocksparse_matmul": 0, "fused_path_step": 0,
                             "flash_attention": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    z = torch.eye(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        tst.fused_prox_stats(z, None, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        tbsmm.masked_matmul(z, z, torch.ones((1, 1), dtype=torch.int8),
                            block_size=4)


def test_trial_entry_routes_cpu_tensors_to_its_plain_twin():
    """On the CPU the trial entry is its plain twin, uncounted; the CUDA
    wrapper refuses a CPU tensor; other devices are rejected."""
    om = torch.eye(8, dtype=torch.float64) + 0.05
    g = torch.linspace(-1.0, 1.0, 64, dtype=torch.float64).reshape(8, 8)
    tops.reset_launches()
    got = tops.fused_prox_trial(om, g, 0.5, 0.1, block=(4, 4))
    want = tref.fused_prox_trial(om, g, 0.5, 0.1, block=(4, 4))
    assert set(tops.LAUNCHES.values()) == {0}
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[4].shape == (2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tst.fused_prox_trial(om, g, 0.5, 0.1)
    meta = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tops.fused_prox_trial(meta, meta, 0.5, 0.1)


def test_dispatch_rejects_other_devices():
    z = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tops.fused_prox_stats(z, None, 0.1)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing toolkit is an error, never a silent fallback."""
    monkeypatch.setattr(tbuild.shutil, "which", lambda _: None)
    monkeypatch.setattr(tbuild.os.path, "exists", lambda _: False)
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        tbuild.build(["softthresh"])


def test_build_target_tracks_source_and_flags(monkeypatch):
    a = tbuild._target("softthresh")
    monkeypatch.setitem(tbuild.EXTRA_FLAGS, "softthresh", ())
    assert tbuild._target("softthresh") != a
    assert tbuild._target("blocksparse_matmul") != a
    assert tbuild._target("pathstep") != a
