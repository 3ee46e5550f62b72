"""Shared fixtures and checks of the ``tests/test_torch_*.py`` tests.

Each parity test feeds the same numpy inputs to the JAX reference
(``repro``, on the CPU, Pallas in interpret mode) and to the PyTorch port
(``repro_torch``, ``device="cpu"``) and compares them in float64.
Import the fixtures into a test module by name::

    from _torch_parity import cuda, x64  # noqa: F401

JAX is imported only by the ``x64`` fixture, so the card-only tests can
use this module on a machine without JAX.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import manifest as tman

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

# the suite runs under pytest-xdist with several workers on a few cores
torch.set_num_threads(1)

PROX_STATS = ("out", "logdet", "l1", "sumsq", "min_diag", "block_nnz")

#: XLA flags of every reference subprocess besides its device count: the
#: dot products in single-threaded Eigen, whose float32 bits cannot depend
#: on the size of XLA's thread pool.  The default multi-threaded
#: contraction is another kernel: it moves the reference's step-3 Mamba2
#: ``ssm_in`` by 1.06e-5 on (2, 2), more than ``_torch_tp.PARAM_TOL``
PINNED_XLA_FLAGS = "--xla_cpu_multi_thread_eigen=false"


def reference_env(n_devices: int | None = None) -> dict:
    """The environment of a JAX reference subprocess: this one's, with
    ``src`` on ``PYTHONPATH``, XLA's CPU threads pinned
    (PINNED_XLA_FLAGS) and, given ``n_devices``, that many virtual
    devices."""
    env = dict(os.environ)
    flags = [PINNED_XLA_FLAGS]
    if n_devices is not None:
        flags.insert(0, f"--xla_force_host_platform_device_count={n_devices}")
    env["XLA_FLAGS"] = " ".join(flags)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def x64():
    """JAX float64 for the module, restored afterwards."""
    import jax
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture
def cuda():
    """The CUDA device for card-only tests; skips without one.  Decided
    inside the fixture, never at import or collection time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run "
                    "on the card with `python -m pytest --noconftest -m gpu "
                    "tests/test_torch_kernels_gpu.py`")
    return torch.device("cuda")


def assert_prox_stats(got, want, dt: str) -> None:
    """The fused prox's six outputs: the manifest's exact ones bit-equal,
    the summed stats within its tolerance for ``dt``."""
    ent = tman.entry("fused_prox_stats")
    tol = ent["rtol"][dt]
    for name, g, w in zip(PROX_STATS, got, want):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        if name in ent["exact"]:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=name)
