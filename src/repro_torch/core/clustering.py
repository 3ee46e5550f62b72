"""Graph clustering pipeline for the fMRI case-study analogue (paper Sec. 5).

A copy of ``repro.core.clustering`` with the same six functions, split by
where each belongs:

  * on tensors, on the solve's device: ``degrees_from_support``,
    ``threshold_covariance_graph`` and ``estimate_support`` (the
    reference pipeline's ``graphs.support(omega, tol) | .T`` step).  At
    p = 16384 their inputs are a 2.1 GB f64 estimate or covariance and a
    268 MB bool support, so they are counted where they live and only a
    degree vector or an edge list comes to the host;
  * in numpy, on the host, exactly as the reference: ``grid_neighbors``,
    ``persistence_watershed`` (a sequential sweep with union-find),
    ``label_propagation`` (asynchronous, in a seeded order) and
    ``modified_jaccard`` (scipy's assignment plus the edge-cover
    completion).  They are sequential by nature and their integer labels
    equal the reference's.

The two methods on the partial-correlation graph (the support of an
HP-CONCORD estimate):

  * ``persistence_watershed``: the persistent-homology method of S.3.4 —
    vertex degree on a spatial topology graph (a 2D grid here), a
    watershed sweep from high to low degree, and merging of parcels whose
    persistence is <= eps;
  * ``label_propagation``: the Louvain stand-in — asynchronous label
    propagation maximizing local agreement;

plus the modified Jaccard similarity of S.3.5.  Host functions accept a
tensor (copied to the host once) or an array.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _symmetric_offdiag(support) -> torch.Tensor:
    """``support | support.T`` without its diagonal, as a bool tensor on
    the support's device."""
    a = torch.as_tensor(support).to(torch.bool)
    a = a | a.T
    a.fill_diagonal_(False)
    return a


def estimate_support(omega, tol: float = 0.0) -> torch.Tensor:
    """The partial-correlation graph of an estimate, ``graphs.support(omega,
    tol) | its transpose`` (|Omega_ij| > tol off the diagonal), as a bool
    tensor on the estimate's device."""
    sup = torch.triu(torch.as_tensor(omega).abs() > tol, diagonal=1)
    return sup | sup.T


def degrees_from_support(support) -> torch.Tensor:
    """Vertex degrees of the partial-correlation graph (symmetric support),
    int64 on the support's device."""
    return _symmetric_offdiag(support).sum(dim=1)


def grid_neighbors(rows: int, cols: int) -> list[list[int]]:
    """4-neighborhood topology for variables laid out on a rows x cols grid
    (the synthetic analogue of the cortical-surface triangulation)."""
    nbrs: list[list[int]] = []
    for r in range(rows):
        for c in range(cols):
            cur = []
            if r > 0:
                cur.append((r - 1) * cols + c)
            if r < rows - 1:
                cur.append((r + 1) * cols + c)
            if c > 0:
                cur.append(r * cols + c - 1)
            if c < cols - 1:
                cur.append(r * cols + c + 1)
            nbrs.append(cur)
    return nbrs


def persistence_watershed(f, neighbors: list[list[int]],
                          eps: float = 0.0) -> np.ndarray:
    """Watershed of scalar field `f` on a topology graph + persistence merging.

    Sweeps vertices from highest to lowest f (ties in index order). A
    vertex with no labeled neighbor starts a new label (a local max);
    otherwise it takes the label of the neighbor whose component has the
    highest birth value. When two components first meet at vertex v, the
    merge edge gets persistence min(birth_1, birth_2) - f(v); components
    joined by persistence <= eps are merged (union-find over the dual
    graph).
    """
    f = _host(f).astype(np.float64)
    n = f.shape[0]
    order = np.argsort(-f, kind="stable")
    labels = -np.ones(n, dtype=np.int64)
    birth: list[float] = []

    parent: list[int] = []

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    comp_max: list[float] = []

    for v in order:
        lab_nbrs = {find(labels[u]) for u in neighbors[v] if labels[u] >= 0}
        if not lab_nbrs:
            lab = len(birth)
            birth.append(f[v])
            parent.append(lab)
            comp_max.append(f[v])
            labels[v] = lab
            continue
        # propagate the label with max component birth value (S.3.4)
        best = max(lab_nbrs, key=lambda l: comp_max[l])
        labels[v] = best
        for other in lab_nbrs:
            if other == best:
                continue
            pers = min(comp_max[best], comp_max[other]) - f[v]
            if pers <= eps:
                ra, rb = find(best), find(other)
                if ra != rb:
                    keep, drop = (ra, rb) if comp_max[ra] >= comp_max[rb] \
                        else (rb, ra)
                    parent[drop] = keep
                    comp_max[keep] = max(comp_max[keep], comp_max[drop])
                    best = keep
    out = np.array([find(l) for l in labels])
    # compact label ids
    _, out = np.unique(out, return_inverse=True)
    return out


def _neighbor_lists(support) -> tuple[np.ndarray, np.ndarray]:
    """CSR (indptr, indices) of the symmetric off-diagonal support, each
    row's neighbours ascending (as ``np.nonzero`` of its dense row).  A
    tensor is reduced on its device; only the edge list comes to the
    host."""
    rows, cols = _symmetric_offdiag(support).nonzero(as_tuple=True)
    rows, cols = rows.cpu().numpy(), cols.cpu().numpy()
    n = support.shape[0]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr, cols


def label_propagation(support, *, max_sweeps: int = 50,
                      seed: int = 0) -> np.ndarray:
    """Asynchronous label propagation on the partial-correlation graph.

    The reference's visit order (a ``default_rng(seed)`` shuffle per
    sweep) and tie rule (``bincount(...).argmax()``: the lowest label),
    over CSR neighbour lists instead of a dense row per visit."""
    indptr, indices = _neighbor_lists(support)
    n = indptr.shape[0] - 1
    rng = np.random.default_rng(seed)
    labels = np.arange(n)
    idx = np.arange(n)
    for _ in range(max_sweeps):
        rng.shuffle(idx)
        changed = 0
        for v in idx:
            nbr = indices[indptr[v]:indptr[v + 1]]
            if nbr.size == 0:
                continue
            counts = np.bincount(labels[nbr])
            best = np.argmax(counts)
            if labels[v] != best and counts[best] > 0:
                labels[v] = best
                changed += 1
        if changed == 0:
            break
    _, out = np.unique(labels, return_inverse=True)
    return out


def modified_jaccard(c1, c2) -> float:
    """Modified Jaccard similarity (paper eq. (S.3)).

    Sim = (1/max(k,l)) * sum of Jaccard weights over a maximum-weight edge
    cover of the bipartite cluster graph. We compute a maximum-weight
    matching (scipy assignment) and complete it to an edge cover by giving
    each unmatched cluster its heaviest incident edge.
    """
    from scipy.optimize import linear_sum_assignment

    c1 = _host(c1)
    c2 = _host(c2)
    ids1, inv1 = np.unique(c1, return_inverse=True)
    ids2, inv2 = np.unique(c2, return_inverse=True)
    k, l = len(ids1), len(ids2)
    inter = np.zeros((k, l), dtype=np.float64)
    np.add.at(inter, (inv1, inv2), 1.0)
    sz1 = np.bincount(inv1, minlength=k).astype(np.float64)
    sz2 = np.bincount(inv2, minlength=l).astype(np.float64)
    union = sz1[:, None] + sz2[None, :] - inter
    w = np.where(union > 0, inter / union, 0.0)

    rows, cols = linear_sum_assignment(-w)   # max-weight matching
    total = w[rows, cols].sum()
    covered1 = np.zeros(k, dtype=bool)
    covered2 = np.zeros(l, dtype=bool)
    covered1[rows] = True
    covered2[cols] = True
    # edge-cover completion: every cluster must be covered
    if not covered1.all():
        total += w[~covered1].max(axis=1).sum()
    if not covered2.all():
        total += w[:, ~covered2].max(axis=0).sum()
    return float(total / max(k, l))


def _numpy_linear_quantile(order_stat, count: int, q: float, dtype):
    """``np.quantile(vals, q)`` (method "linear", numpy 2.x) of ``count``
    values in ``dtype``, given ``order_stat(i)``, the i-th smallest value
    (0-based) as a numpy scalar of ``dtype``.

    The same scalar arithmetic as numpy's ``_quantile``: a Python-float
    ``q`` takes the values' dtype, the virtual index is ``(count - 1) *
    q`` in it, and ``_lerp`` interpolates as ``a + (b - a) * t`` below
    t = 0.5 and ``b - (b - a) * (1 - t)`` from it on."""
    virtual = np.asanyarray((count - 1) * np.asanyarray(q, dtype=dtype))
    previous = np.asanyarray(np.floor(virtual))
    nxt = np.asanyarray(previous + 1)      # in dtype: may round to previous
    if virtual >= count - 1:               # numpy's -1: the largest value
        previous, nxt = np.asanyarray(-1.0), np.asanyarray(-1.0)
    elif virtual < 0:
        previous, nxt = np.asanyarray(0.0), np.asanyarray(0.0)
    previous, nxt = previous.astype(np.intp), nxt.astype(np.intp)
    gamma = np.asanyarray(virtual - previous, dtype=virtual.dtype)
    a = order_stat(int(previous) % count)
    b = order_stat(int(nxt) % count)
    diff = np.subtract(b, a)
    if gamma >= 0.5:
        return np.subtract(b, diff * (1 - gamma), dtype=diff.dtype)
    return np.add(a, diff * gamma, dtype=diff.dtype)


def threshold_covariance_graph(s, keep_frac: float) -> torch.Tensor:
    """The paper's baseline: keep the largest-|S_ij| off-diagonal entries,
    as a bool tensor on ``s``'s device.

    The cut is the reference's ``np.quantile`` of the strict upper
    triangle at 1 - keep_frac, reproduced bit for bit from its two
    neighbouring order statistics (one sort on the device):
    ``torch.quantile`` refuses more than 2^24 values, and p = 16384 has
    1.34e8 of them."""
    a = torch.as_tensor(s).abs()
    a.fill_diagonal_(0.0)
    p = a.shape[0]
    count = p * (p - 1) // 2
    if count == 0:
        return torch.zeros_like(a, dtype=torch.bool)
    upper = torch.ones((p, p), dtype=torch.bool, device=a.device).triu_(1)
    vals = torch.sort(a[upper]).values
    del upper
    np_dtype = np.dtype(str(a.dtype).removeprefix("torch."))
    kth = _numpy_linear_quantile(
        lambda i: np_dtype.type(vals[i].item()), count, 1.0 - keep_frac,
        np_dtype)
    del vals
    return a >= torch.tensor(kth.item(), dtype=a.dtype, device=a.device)
