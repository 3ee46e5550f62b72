"""The inputs made from the seed: the same seed gives the same inputs,
two seeds different ones, with the same set of sizes and arrivals."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import ROOT, SMALL
from hpbench.harness import generate, manifest

MAN = manifest.manifest(ROOT)
SEEDS = (0, 7, 2**31 + 12345, 2**40 + 3)


def _config(name):
    c = manifest.config(MAN, name, ROOT)
    c.update({k: v for k, v in SMALL[name].items() if k != "graph"})
    c["graph"].update(SMALL[name].get("graph", {}))
    return c


@pytest.mark.parametrize("name", ["chain-p16384", "cortex-p4096"])
def test_datasets_repeat_per_seed_and_differ_across(name):
    cfg = _config(name)
    a = generate.datasets(cfg, 2, SEEDS[2], "cpu")
    b = generate.datasets(cfg, 2, SEEDS[2], "cpu")
    c = generate.datasets(cfg, 2, SEEDS[3], "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])
    assert a.shape == (2, cfg["n"], cfg["p"])


def test_samples_have_the_ground_truths_covariance():
    cfg = _config("chain-p16384")
    cfg.update(p=8, n=200_000)
    x = generate.datasets(cfg, 1, 3, "cpu")[0]
    s = x.T @ x / x.shape[0]
    omega0 = generate.ground_truth(cfg["graph"], 8, "cpu")
    assert torch.allclose(s @ omega0, torch.eye(8, dtype=s.dtype),
                          atol=0.03)


def _graph(kind, **graph):
    return manifest.graph(kind, ROOT).omega({"kind": kind, **graph},
                                            graph.pop("p"), "cpu")


def test_chain_graph():
    om = _graph("chain", p=6, weight=0.4)
    assert torch.equal(om, om.T)
    assert om.diagonal().eq(1).all()
    assert (om != 0).sum() == 6 + 2 * 5 and om[0, 1] == 0.4 and om[0, 2] == 0


def test_region_graph():
    om = _graph("regions", p=64, rows=8, cols=8, region=4, weight=-0.28)
    assert om.shape == (64, 64) and torch.equal(om, om.T)
    off = om - torch.diag(om.diagonal())
    # 4 regions of 4 x 4: 2 * 4 * 3 edges each, none across a region
    assert int((off != 0).sum()) == 2 * 4 * (2 * 4 * 3)
    assert off[3, 4] == 0 and off[0, 1] == -0.28 and off[0, 8] == -0.28
    assert torch.all(om.diagonal() > off.abs().sum(1))
    assert torch.linalg.eigvalsh(om).min() > 0


def test_region_graph_on_a_grid_that_is_not_square():
    om = _graph("regions", p=32, rows=4, cols=8, region=4, weight=-0.28)
    off = om - torch.diag(om.diagonal())
    # 2 regions of 4 x 4 side by side; row 0's entries 3 and 4 lie apart
    assert int((off != 0).sum()) == 2 * 2 * (2 * 4 * 3)
    assert off[3, 4] == 0 and off[0, 8] == -0.28 and off[4, 5] == -0.28
    with pytest.raises(ValueError):
        _graph("regions", p=32, rows=4, cols=8, region=3, weight=-0.28)


@pytest.mark.parametrize("mix", ["path", "backlog"])
def test_requests_repeat_per_seed_and_differ_across(mix):
    t = manifest.traffic(mix, ROOT)
    if t["driver"] == "path":
        draw = lambda s: np.asarray(generate.path_grids(t, 16, s))  # noqa
    else:
        draw = lambda s: np.stack([  # noqa
            generate.solve_requests(t, 256, s)[k] for k in
            ("subject", "lam1", "lam2")])
    assert np.array_equal(draw(SEEDS[1]), draw(SEEDS[1]))
    assert not np.array_equal(draw(SEEDS[1]), draw(SEEDS[2]))


def test_path_grids_descend_within_range_and_share_strata():
    t = manifest.traffic("path", ROOT)
    lo, hi = t["lam1_range"]
    per_seed = []
    for s in SEEDS:
        g = np.asarray(generate.path_grids(t, 8, s))
        assert np.all(np.diff(g, axis=1) < 0)
        assert g.min() >= lo and g.max() < hi
        width = (hi - lo) / t["points"] / t["block"]
        per_seed.append(sorted(np.floor((g[:4, -1] - lo) / width).astype(int)))
    assert all(p == per_seed[0] for p in per_seed)


def test_a_schedule_seed_fixes_the_requests():
    t = manifest.traffic("queue", ROOT)
    a = generate.solve_requests(t, 128, SEEDS[0])
    b = generate.solve_requests(t, 128, SEEDS[1])
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_solve_requests_same_sets_other_order():
    t = manifest.traffic("backlog", ROOT)
    a = generate.solve_requests(t, t["pool"], SEEDS[0])
    b = generate.solve_requests(t, t["pool"], SEEDS[1])
    assert sorted(a["subject"]) == sorted(b["subject"])
    assert sorted(a["lam2"]) == sorted(b["lam2"])
    lo, hi = t["lam1_range"]
    w = (hi - lo) / t["block"]
    assert sorted((a["lam1"] - lo) // w) == sorted((b["lam1"] - lo) // w)
    assert not np.array_equal(a["subject"], b["subject"])


def test_arrivals():
    t = manifest.traffic("queue", ROOT)
    rate = t["rate_per_s"]
    a = generate.arrivals(t, 30.0, SEEDS[0])
    b = generate.arrivals(t, 30.0, SEEDS[1])
    assert a[0] > 0 and np.all(np.diff(a) > 0) and a[-1] < 30.0
    # the mix fixes its schedule: every run's seed orders only the work
    assert np.array_equal(a, b)
    # a longer window's schedule begins with a shorter one's
    long = generate.arrivals(t, 300.0, SEEDS[0])
    assert np.array_equal(long[:len(a)], a)
    # Poisson: exponential gaps of mean 1 / rate, counts of a second with
    # the variance of their mean
    gaps = np.diff(np.concatenate([[0.0], long]))
    assert abs(gaps.mean() * rate - 1) < 0.1
    assert abs(np.std(gaps) / np.mean(gaps) - 1) < 0.1
    counts = np.bincount(long.astype(int), minlength=300)
    assert 0.7 < counts.var() / counts.mean() < 1.3
    seeded = {k: v for k, v in t.items() if k != "schedule_seed"}
    c = generate.arrivals(seeded, 30.0, SEEDS[0])
    assert not np.array_equal(c[:50], generate.arrivals(seeded, 30.0,
                                                        SEEDS[1])[:50])
    back = manifest.traffic("backlog", ROOT)
    assert np.all(generate.arrivals(back, 30.0, 1) == 0)
    assert len(generate.arrivals(back, 30.0, 1)) == back["requests"]


def test_scheduled_requests_are_plain_draws():
    t = manifest.traffic("queue", ROOT)
    r = generate.solve_requests(t, 4096, SEEDS[0])
    lo, hi = t["lam1_range"]
    assert r["lam1"].min() >= lo and r["lam1"].max() < hi
    assert abs(r["lam1"].mean() - 0.5 * (lo + hi)) < 0.01 * (hi - lo) * 5
    assert set(r["lam2"]) == set(t["lam2_values"])
    # no subject repeats before the pool is spent
    assert len(set(r["subject"][:t["pool"]])) == t["pool"]
