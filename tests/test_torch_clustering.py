"""The port's Section 5 clustering (``repro_torch.core.clustering``)
against ``repro.core.clustering`` on the CPU, on seeded numpy inputs:
labels and boolean graphs exactly equal, Jaccard within 1e-12.  The
tensor functions run on CPU tensors in float64 and float32; the host
functions take the same arrays or tensors.  The reference's own nine
cases (``tests/test_clustering.py``) run here against the port."""
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # minimal CPU image — deterministic fallback
    from _hypothesis_fallback import given, settings, st

from repro.core import clustering as jcl
from repro.core import graphs as jgraphs
from repro_torch.core import clustering as tcl

JACCARD_TOL = 1e-12
DTYPES = (np.float64, np.float32)


def _sym(rng, p, density):
    a = np.triu(rng.random((p, p)) < density, 1)
    return a | a.T


# ---------------------------------------------------------------------------
# tensor functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,tol", [(1, 0.0), (9, 0.0), (40, 1e-4),
                                   (65, 0.3)])
def test_estimate_support_and_degrees_equal_the_reference(dtype, p, tol):
    """``graphs.support(omega, tol) | .T`` and its degrees, on a tensor."""
    rng = np.random.default_rng(p)
    om = rng.standard_normal((p, p)) * (rng.random((p, p)) < 0.2)
    om[rng.random((p, p)) < 0.05] = tol      # exactly at the cut
    om = (om + om.T).astype(dtype)
    want = jgraphs.support(om, tol=tol)
    want = want | want.T
    got = tcl.estimate_support(torch.as_tensor(om), tol)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    deg = tcl.degrees_from_support(got)
    assert deg.dtype == torch.int64
    np.testing.assert_array_equal(deg.numpy(),
                                  jcl.degrees_from_support(want))


@pytest.mark.parametrize("seed", range(4))
def test_degrees_from_an_asymmetric_support(seed):
    """An upper-only or lopsided support is symmetrised and its diagonal
    dropped, as the reference does; numpy input is taken too."""
    rng = np.random.default_rng(seed)
    sup = rng.random((23, 23)) < 0.15
    np.fill_diagonal(sup, True)
    want = jcl.degrees_from_support(sup)
    np.testing.assert_array_equal(
        tcl.degrees_from_support(torch.as_tensor(sup)).numpy(), want)
    np.testing.assert_array_equal(tcl.degrees_from_support(sup).numpy(),
                                  want)
    assert sup[0, 0]                     # the input is left as it was


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", [2, 3, 10, 31, 64])
@pytest.mark.parametrize("keep", [0.02, 0.05, 0.1, 0.3, 0.5, 1.0])
def test_threshold_covariance_graph_equals_the_reference(dtype, p, keep):
    rng = np.random.default_rng(p)
    x = rng.standard_normal((3 * p, p)).astype(dtype)
    s = (x.T @ x) / x.shape[0]
    want = jcl.threshold_covariance_graph(s, keep)
    got = tcl.threshold_covariance_graph(torch.as_tensor(s), keep)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_threshold_quantile_in_the_upper_lerp_branch(dtype):
    """A cut strictly between two order statistics with interpolation
    weight t >= 0.5: numpy's ``_lerp`` then computes b - (b - a)(1 - t),
    which may differ from a + (b - a) t in the last ulp."""
    p, keep = 5, 0.05
    count = p * (p - 1) // 2                       # 10 values
    virtual = (count - 1) * (1.0 - keep)           # 8.55
    t = virtual - np.floor(virtual)
    assert t >= 0.5
    rng = np.random.default_rng(7)
    s = rng.standard_normal((p, p)).astype(dtype)
    s = s + s.T
    vals = np.sort(np.abs(s[np.triu_indices(p, 1)]))
    a, b = vals[int(np.floor(virtual))], vals[int(np.floor(virtual)) + 1]
    kth = np.quantile(np.abs(s[np.triu_indices(p, 1)]), 1.0 - keep)
    assert a < kth < b
    got = tcl._numpy_linear_quantile(lambda i: vals[i], count, 1.0 - keep,
                                     np.dtype(dtype))
    assert got == kth and np.asarray(got).dtype == np.dtype(dtype)
    np.testing.assert_array_equal(
        tcl.threshold_covariance_graph(torch.as_tensor(s), keep).numpy(),
        jcl.threshold_covariance_graph(s, keep))


@pytest.mark.parametrize("dtype", DTYPES)
def test_numpy_linear_quantile_equals_numpy(dtype):
    """The scalar arithmetic of ``np.quantile`` (method "linear") over
    random sizes, quantiles and scales, both lerp branches and the ends."""
    rng = np.random.default_rng(3)
    for _ in range(400):
        n = int(rng.integers(1, 300))
        v = (rng.standard_normal(n) * 10 ** rng.uniform(-4, 4)).astype(dtype)
        q = float(rng.choice([0.0, 1.0, rng.uniform()]))
        srt = np.sort(v)
        got = tcl._numpy_linear_quantile(lambda i: srt[i], n, q,
                                         np.dtype(dtype))
        want = np.quantile(v, q)
        assert got == want, (n, q)
        assert np.asarray(got).dtype == np.asarray(want).dtype


# ---------------------------------------------------------------------------
# host functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,cols", [(1, 1), (1, 5), (4, 1), (3, 7),
                                       (12, 12)])
def test_grid_neighbors_equal_the_reference(rows, cols):
    assert tcl.grid_neighbors(rows, cols) == jcl.grid_neighbors(rows, cols)


@pytest.mark.parametrize("side,levels", [(8, 2), (12, 3), (16, 5), (9, 40)])
@pytest.mark.parametrize("eps", [0.0, 0.5, 1.0, 2.0, 10.0])
def test_watershed_on_tie_heavy_degree_fields(side, levels, eps):
    """Integer degree fields of a few levels (almost every value ties),
    the pipeline's input: the stable sweep order decides every label."""
    rng = np.random.default_rng(side * levels)
    f = rng.integers(0, levels, side * side).astype(float)
    nbrs = jcl.grid_neighbors(side, side)
    want = jcl.persistence_watershed(f, nbrs, eps=eps)
    np.testing.assert_array_equal(tcl.persistence_watershed(f, nbrs, eps=eps),
                                  want)
    np.testing.assert_array_equal(
        tcl.persistence_watershed(torch.as_tensor(f), nbrs, eps=eps), want)


@pytest.mark.parametrize("seed", range(3))
def test_watershed_on_continuous_fields(seed):
    rng = np.random.default_rng(seed)
    f = rng.random(100)
    nbrs = jcl.grid_neighbors(10, 10)
    for eps in (0.0, 0.1, 0.3):
        np.testing.assert_array_equal(
            tcl.persistence_watershed(f, nbrs, eps=eps),
            jcl.persistence_watershed(f, nbrs, eps=eps))


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("p,density", [(30, 0.1), (80, 0.05), (64, 0.3)])
def test_label_propagation_equals_the_reference(seed, p, density):
    """The same visit order and tie rule over CSR neighbour lists, from a
    dense array and from a tensor (isolated vertices and a self-loop
    included)."""
    rng = np.random.default_rng(p)
    sup = np.triu(rng.random((p, p)) < density)   # upper only, diagonal in
    sup[:, :3] = sup[:3, :] = False               # three isolated vertices
    want = jcl.label_propagation(sup, seed=seed)
    np.testing.assert_array_equal(tcl.label_propagation(sup, seed=seed),
                                  want)
    np.testing.assert_array_equal(
        tcl.label_propagation(torch.as_tensor(sup), seed=seed), want)


def test_label_propagation_max_sweeps():
    rng = np.random.default_rng(2)
    sup = _sym(rng, 50, 0.2)
    for sweeps in (1, 2, 3):
        np.testing.assert_array_equal(
            tcl.label_propagation(sup, max_sweeps=sweeps, seed=4),
            jcl.label_propagation(sup, max_sweeps=sweeps, seed=4))


def test_neighbor_lists_are_the_dense_rows():
    rng = np.random.default_rng(5)
    sup = rng.random((20, 20)) < 0.2
    indptr, indices = tcl._neighbor_lists(torch.as_tensor(sup))
    a = sup | sup.T
    np.fill_diagonal(a, False)
    for v in range(20):
        np.testing.assert_array_equal(indices[indptr[v]:indptr[v + 1]],
                                      np.nonzero(a[v])[0])
    i2, x2 = tcl._neighbor_lists(sup)
    np.testing.assert_array_equal(i2, indptr)
    np.testing.assert_array_equal(x2, indices)


@pytest.mark.parametrize("seed", range(6))
def test_modified_jaccard_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 200))
    c1 = rng.integers(0, int(rng.integers(1, 12)), n)
    c2 = rng.integers(0, int(rng.integers(1, 30)), n) * 3 + 5
    want = jcl.modified_jaccard(c1, c2)
    assert abs(tcl.modified_jaccard(c1, c2) - want) <= JACCARD_TOL
    assert abs(tcl.modified_jaccard(torch.as_tensor(c1),
                                    torch.as_tensor(c2)) - want) \
        <= JACCARD_TOL


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_clustering.py), on the port
# ---------------------------------------------------------------------------

def test_grid_neighbors():
    nbrs = tcl.grid_neighbors(2, 3)
    assert len(nbrs) == 6
    assert set(nbrs[0]) == {1, 3}
    assert set(nbrs[4]) == {1, 3, 5}


def test_watershed_two_peaks():
    """Two separated peaks on a line -> two clusters at eps=0."""
    f = np.array([5, 4, 1, 4, 5], dtype=float)
    nbrs = [[1], [0, 2], [1, 3], [2, 4], [3]]
    labels = tcl.persistence_watershed(f, nbrs, eps=0.0)
    assert len(np.unique(labels)) == 2
    assert labels[0] == labels[1] and labels[3] == labels[4]
    # large eps merges everything
    labels2 = tcl.persistence_watershed(f, nbrs, eps=10.0)
    assert len(np.unique(labels2)) == 1
    np.testing.assert_array_equal(
        labels, jcl.persistence_watershed(f, nbrs, eps=0.0))


def test_watershed_eps_monotone():
    rng = np.random.default_rng(0)
    f = rng.random(64)
    nbrs = tcl.grid_neighbors(8, 8)
    prev = None
    for eps in (0.0, 0.2, 0.5, 1.0):
        k = len(np.unique(tcl.persistence_watershed(f, nbrs, eps=eps)))
        if prev is not None:
            assert k <= prev
        prev = k


def test_label_propagation_two_cliques():
    a = np.zeros((8, 8), bool)
    for grp in (range(4), range(4, 8)):
        for i in grp:
            for j in grp:
                if i != j:
                    a[i, j] = True
    labels = tcl.label_propagation(torch.as_tensor(a), seed=1)
    assert len(np.unique(labels)) == 2
    assert len(np.unique(labels[:4])) == 1
    assert len(np.unique(labels[4:])) == 1
    np.testing.assert_array_equal(labels, jcl.label_propagation(a, seed=1))


def test_modified_jaccard_identity():
    c = np.array([0, 0, 1, 1, 2, 2])
    assert tcl.modified_jaccard(c, c) == pytest.approx(1.0)


def test_modified_jaccard_invariance_to_relabeling():
    c1 = np.array([0, 0, 1, 1, 2, 2])
    c2 = np.array([5, 5, 9, 9, 7, 7])
    assert tcl.modified_jaccard(c1, c2) == pytest.approx(1.0)


@given(st.integers(0, 20))
@settings(max_examples=10, deadline=None)
def test_modified_jaccard_bounds(seed):
    rng = np.random.default_rng(seed)
    c1 = rng.integers(0, 4, 30)
    c2 = rng.integers(0, 6, 30)
    s = tcl.modified_jaccard(c1, c2)
    assert 0.0 <= s <= 1.0
    # symmetry
    assert s == pytest.approx(tcl.modified_jaccard(c2, c1), abs=1e-9)
    assert abs(s - jcl.modified_jaccard(c1, c2)) <= JACCARD_TOL


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_threshold_covariance_graph(dtype):
    rng = np.random.default_rng(0)
    s = rng.standard_normal((10, 10))
    s = s + s.T
    g = tcl.threshold_covariance_graph(torch.as_tensor(s, dtype=dtype), 0.1)
    # keeps about 10% of the upper triangle
    frac = g.numpy()[np.triu_indices(10, 1)].mean()
    assert 0.0 < frac < 0.3
    np.testing.assert_array_equal(
        g.numpy(), jcl.threshold_covariance_graph(
            s.astype(str(dtype).removeprefix("torch.")), 0.1))


def test_degrees_from_support():
    sup = torch.zeros((4, 4), dtype=torch.bool)
    sup[0, 1] = True  # only upper entry; must be symmetrized
    deg = tcl.degrees_from_support(sup)
    assert deg.tolist() == [1, 1, 0, 0]
