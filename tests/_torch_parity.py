"""Shared fixtures and checks of the ``tests/test_torch_*.py`` tests.

Each parity test feeds the same numpy inputs to the JAX reference
(``repro``, on the CPU, Pallas in interpret mode) and to the PyTorch port
(``repro_torch``, ``device="cpu"``) and compares them in float64.
Import the fixtures into a test module by name::

    from _torch_parity import cuda, x64  # noqa: F401

JAX is imported only by the ``x64`` fixture, so the card-only tests can
use this module on a machine without JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import manifest as tman

# the suite runs under pytest-xdist with several workers on a few cores
torch.set_num_threads(1)

PROX_STATS = ("out", "logdet", "l1", "sumsq", "min_diag", "block_nnz")


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
